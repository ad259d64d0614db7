"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (the kernels are built for ``sm_90a``) and the
CUDA toolkit's ``nvcc``; it exits non-zero, printing no result, anywhere
else.  Phases, each of which raises on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the nine kernel sources of ``src/repro_torch/csrc``, compiled
   in parallel, with each source's registers and spills from ``ptxas``
   (and each ``cover_counts`` instantiation's registers, each
   ``flash_attention_bwd`` kernel's registers and spills);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   exact equality — ``fused_expand`` and ``lt_select_expand`` on a reduced
   graph (empty frontier, destination blocks no tile reaches,
   ``pad_tiles_to`` padding tiles, 32/64/96/256 colours) over every tile
   and over compacted tile lists (empty, one source block, full),
   ``fused_expand_q`` on the same graph's quantised stack (32/64/128/256
   colours, the same lists); the three slot-list kernels also on a graph
   whose hub rows take 300 in-edges each, against their tile-form plain
   versions; each slot list (IC, quantised, LT) holding exactly the slots
   that pass its value test and equal to the list read back from its
   stack; ``cover_counts`` and ``cover_counts_multi`` (8 masks) at the
   full pool shape and at W 1, 3, 5 and 8;
4. IC main path at full size: the serving launcher's ``run_single`` on the
   kernel backend — powerlaw_cluster(65,536, 6.0, p=0.25, seed 7), 64
   colours, a 64-batch pool (4,096 RRR sets), one mixed micro-batched flush
   (top-16, 6 σ, 6 marginal), the same flush as 100% cache hits, a 25%
   refresh, the pool saved and restored (identical stack, counters and
   top-16; the snapshot's MiB and the save and restore seconds), and
   offline ``run_imm`` (ε 0.5, θ ≤ 4,096) through a fresh pool and without
   one, both equal to the host-loop greedy.  The launch counters
   are zeroed just before and read just after; ``fused_expand`` and
   ``cover_counts`` must have run, and ``cover_counts_multi`` once for each
   marginal dispatch (one for all its query slots);
5. IC golden: batches 0-3 on the kernel backend (dense grid and compacted
   grid), 0-1 on the dense CSR backend, bit for bit against
   ``tests/data/torch_port_golden.json`` (made by
   ``scripts/make_torch_golden.py`` from the JAX reference), plus the
   top-16 seeds over that 4-batch pool;
6. IC timing: the slot list's entries and bytes, and the time to read it
   back from the stacks (equal to the layout's); every level of batch 0
   through the kernel's CUDA wrapper on the dense grid and on the
   compacted grid (device time per launch, launches replayed from a CUDA
   graph), the compaction, and the plain version (equal at every level);
   ``cover_counts`` at the pool's shape as device time, cold (a CUDA graph
   of 10 L2 flushes and launches less one of the 10 flushes) and warm,
   beside the events-around-one-eager-call figure of earlier runs, the
   8-mask form against 8 one-mask launches; each beside its bound on this
   card;
6a. the serving tier, after the IC phase's release: the launcher's
   ``run_tier --smoke --autoscale`` (3 tenants, tenant0 starved, over 2
   replicas of a 64-batch pool on the kernel backend): sheds carry a
   retry-after, every in-quota answer equals a direct ``QueryEngine`` on a
   clone, a refresh of one replica never yields a mixed-epoch gather, the
   replicas re-converge bit for bit, and an autoscale step keeps them
   consistent; p50 and p99 query latency from the tier's histogram;
   counters as in 4, ``cover_counts`` must have run;
6b. an IC streaming delta: the launcher's ``run_stream`` (``--queries 64``:
   64 deletions and 64 insertions) through the tier on the kernel backend —
   the incremental pool equals ``cold_rebuild_batches`` word for word, the
   replicas agree, a pre/post-delta gather is refused, a starved tenant's
   second delta is shed — and the delta, the mutated reversed graph, the
   touched row blocks and slots 0-3 (words, levels, the dense CSR
   sampler's edge visits) against the golden file's ``"stream"`` entry;
   it prints the touched row blocks, the dirty slots of 64, ``apply_plan``
   split into the rebind (layout and slot-list rebuild) and the
   resampling, and a cold rebuild of all 64 slots; ``fused_expand`` must
   have run.  Then ``SamplingDriver`` on the mutated pair (4 workers, 20%
   injected failures, 16 batches) equal to the store's slots 0-15, with
   ``fused_expand`` launched by its workers;
7. LT main path at full size, after the IC tile stacks are released: the
   same launcher run with ``--diffusion lt --frontier sparse`` (the
   ``lt_select_expand`` kernel on the compacted tile list's slot list);
   counters as in 4, ``lt_select_expand`` and ``cover_counts`` must have
   run, ``cover_counts_multi`` as in 4, and the pool saved and restored as
   in 4;
8. LT golden: batches 0-3 on the kernel backend, dense and compacted grid,
   0-1 on the dense CSR backend, and the top-16 seeds, against the file;
9. LT timing: as 6 (the LT slot list, both grids), with the plain version
   on the compacted list;
9a. an LT streaming delta, after the LT phase's release: as 6b with
   ``--diffusion lt --frontier sparse`` (``lt_select_expand`` must have
   run; the renormalised in-edges count among the touched rows), without
   the driver;
9b. the unfused baseline and forward σ(S), after the LT stream phase's
    release, at the main configuration (65,536 vertices, reversed, 64
    colours, batch 0's roots and seed): (a) ``run_unfused`` (64
    single-colour CSR runs) equals ``run_fused``'s mask and the golden
    batch 0 word for word, its total edge visits the golden
    ``unfused_edge_visits``, and each colour's levels, popcount and visits
    the golden ``"unfused"`` entry (``make_torch_golden.py
    --unfused-only``); these paths and (b) launch no kernel; (b)
    ``simulate_influence`` of the first 8 golden top-16 seeds, 512 trials,
    equals the golden σ exactly; (c) that forward σ lies within 4 standard
    errors (from the samples) of n × ``coverage_of`` on a fresh
    ``sample_collection`` of 4,096 RRR sets (kernel backend, master_seed
    4,242), and exceeds the forward σ of 8 random vertices; (d) batch 0 on
    the host clock, 3 runs in turns: ``run_fused`` (CSR), ``run_unfused``
    (CSR) and the kernel backend, with the unfused/fused ratio, the edge
    visits and their savings, the levels and the mean occupancy;
9c. the paper's Fig. 7/8 grid at a Table-1 size: ``powerlaw_cluster`` at
    web-Google's vertices and average degree (875,713, 11.66, seed 2),
    reversed, re-weighted to a constant p ∈ {0.05, 0.1, 0.2}, colours ∈
    {8, 32, 64} from ``random_starts(0, ...)``; at every point
    ``run_unfused`` ≡ ``run_fused`` word for word and in total visits
    (Theorem 1's coupling, exact), the fused time as the median of 3 runs,
    the unfused one of as many runs as fit in 4 s (at most 3), the
    speedup, the visit ratio, levels, occupancy and peak memory.  CSR
    against CSR, as in the reference: no tile layout at this size;
9d. the mesh paths on ranks that share the card, at the main
    configuration, and every other mesh job of the smoke, in one world
    of 4 gloo ranks started once (`run_worlds`: `launch.accel.start` of
    `mesh_smoke.rank_jobs`, each rank's programs in
    ``repro_torch/launch/mesh_smoke.py``; 16c's, 16g's and 18's jobs
    checked and printed in their own places), then a one-rank NCCL world
    ((d) and 16g's [train mesh nccl]).  Before the world, on the card, the
    one-device runs its jobs are held against (18's serving, whose tokens
    the mesh is fed; [train mesh nccl]'s); while it runs, the host draws
    the golden models' weights of phases 15 and 16f, builds phase 11's
    graph and traces 18's dry-run sweep (the ranks hold the card; the
    parent only waits).  It prints the world's start (interpreters,
    CUDA contexts, the group) and each job's seconds.  (a)
    ``graph_parallel`` IC on a 2×2 (data × model)
    mesh over gloo — batches 0-3 against the golden sha256s, the top-16
    of their pool through ``DistributedQueryEngine``, a 64-batch pool
    timed on the dense exchange leg and its first 16 batches
    (``MESH_SPARSE_BATCHES``) on the sparse one (auto capacity)
    with equal masks and the per-level ``gather_words`` of each, every
    level of batch 0 on each rank's slot list through ``fused_expand``
    against its plain version, each rank's launches of ``fused_expand``
    and ``cover_counts`` (counters zeroed just before, read just after,
    both > 0), and on each rank's block of the 64-batch pool
    ``cover_counts`` / ``cover_counts_multi`` against their plain versions
    on the engine's masks (pad slots zero); (f) on the same 2×2 mesh, the
    async front end over (a)'s 64-batch pool: rank 0 runs
    ``AsyncFrontEnd`` over a ``MeshLeader`` (deadline 0.05 s, 8 flush
    slots, a background refresh every 1.5 s) and serves a lone σ, 24
    threaded σ clients, a top-16 and a marginal query, then closes, while
    the other ranks ``follow``; every answer equals the engine's own,
    asked directly after ``STOP`` on every rank at the answer's pool
    version, and the one-device engine's on the final pool; a lone
    request flushes on its deadline, no request waits past it by more
    than 0.25 s, the refresh bumps the epoch on every rank and the
    version holds after ``close()``; every rank launched
    ``fused_expand``, ``cover_counts`` and ``cover_counts_multi`` in the
    session (counters zeroed before it, read after); the flush times per
    op (worst rank) beside one device's, and the whole-mesh broadcast of
    one message alone; (b) the same as (a) under LT
    (``lt_select_expand``); (c) ``data_parallel`` IC on the same four
    ranks as 4×1: batches 0-3 and top-16, (a)'s 64-batch snapshot
    restored onto 4×1, ``refresh(0.5)`` equal to a one-device pool's, the
    coverage check per rank; (d) a 1×1 mesh over NCCL: batches 0-3 and
    top-16 through the same code, (a)'s snapshot restored onto it, the
    coverage check;
    (e) the golden ``"mesh"`` entry (4,096 vertices, batches 0-7, IC and
    LT, dense and sparse leg) on 2×2 and on a 1×3 mesh of ranks 0-2 of
    the world (`comm.Mesh(members=...)`; rank 3 stands by): every sha256
    and every level's words.  It prints each sub-phase's seconds, each
    rank's peak device memory, the transport, the bytes staged through
    the host, and one level's exchange timed alone (all-gather,
    butterfly, pmax);
10. quantised golden, after the LT tile stacks are released: the port's
    whole quantised path at the golden file's ``"q"`` size (4,096
    vertices: generator, ``cluster`` reordering, q8 layout,
    ``run_fused_q_tiled`` on the dense grid and the compacted list),
    levels, popcount and sha256 of batches 0-1 against the reference's
    ``graph_q`` loop;
11. quantised main path at full size: powerlaw_cluster(262,144, 6.0,
    p=0.25, seed 7), deduped, ``reorder.apply(g, "cluster")``, reversed,
    128×128 tiles with the uint8 stack only (~600k tiles, ~9 GiB, tile ids
    past 2¹⁸ where the cell counter wraps), its slot count and how many
    pairs of slots share a cell; ``fused_expand_q`` against its
    plain version on 4,096 tile ids spread over the id range; then 8
    batches of 64 colours through ``run_fused_q_tiled`` on the dense grid
    and on the compacted list, in turns, with identical words; counters as
    in 4, ``fused_expand_q`` launched once per level of each;
12. quantised timing: the slot list as in 6; every level of batch 0 on
    both grids (CUDA graph of 10 launches), the compaction, each beside its
    bound on this card;
13. quantised exactness without the reference: (b) the mean RRR set size
    of the 512 quantised traversals against 512 exact CSR IC traversals
    (p = 0.25 quantises exactly), within 4 standard errors of the
    difference; (a) with every edge at p = 1 the quantised traversal
    equals the CSR sweep's BFS word for word (batches 0 and 1);
14. flash attention, after the quantised stacks are released: the
    kernels against their plain version on the card through
    ``ops.flash_attention``, which picks one of four routes by shape
    (``wgmma``: bf16 prefill at D 64/80/96/128/192; ``tf32x3``: float32
    prefill there, which every float32 case at those head dims must take;
    ``decode``: one query row; ``simt``: the rest, D 16 and 32) — float32
    and bfloat16, causal and not,
    ``kv_offset`` 0 and > 0, H/KVH 1, 3, 5, 8 and 12, head dims 16, 64,
    80, 96, 128 and 192, ragged Lq and Lk (130 over 190 and 257 over 457
    at D 80 and 96), and the LM main path's, maverick's (H 40, KVH 8, a
    group of 5), zamba2's (H = KVH 32, D 80) and phi-3-vision's (H = KVH
    32, D 96) prefill and decode shapes (their bf16 prefill on the wgmma
    route, float32 on tf32x3); each
    decode case also against the split-K plain
    version cut at the kernel's own split; float32 within 2e-5 max abs,
    bfloat16 within atol = rtol = 2e-2 (the reference's kernel test) and
    a relative RMS difference of 6e-3 (``BF16_RMS_TOL``), compared in
    float32.  It prints the cases per route and fails unless each route
    ran one;
15. LM checks: (golden) llama3.2-3b at full width and vocabulary, depth
    cut to 2 layers, float32 (TF32 off), weights from
    ``models/init.py::numpy_params(cfg, seed=0)``: prefill of 2 × 64
    tokens (tf32x3 route) and 8 teacher-forced decode steps (decode route)
    against the file's ``"lm"`` entry — logits at 32 vocabulary ids, max
    logit and log-sum-exp within 1e-3, greedy argmax equal wherever the
    golden top-2 gap exceeds 1e-3; (bf16) the same model in bf16 with the
    port's seeded init, 2 × 2,048 tokens: prefill logits through the
    wgmma route against the same forward with attention through the plain
    version, within the limits stated at ``LM_BF16_MAX_TOL``; (moe
    golden) the file's two ``"moe"`` entries the same way as the
    ``"lm"`` one (float32, TF32 off, ``numpy_params`` weights, the same
    limits): deepseek-v3 (MLA + MoE) and llama4-maverick (GQA + MoE) at
    full width and vocabulary, cut to 2 layers (one dense, one MoE) and 16
    and 8 routed experts; every expert the port's router picks, call by
    call, equal to the reference's (``routes``), its router margin
    printed; deepseek launches no flash_attention, maverick 2 tf32x3 and
    2 × 8 decode; (ssm golden) the file's two ``"ssm"`` entries the same
    way (``numpy_params`` weights with ``numpy_ssm_heads``' per-head
    draws, a prefill of 2 × 512 tokens, two SSD chunks): mamba2-1.3b cut
    to 2 layers (no flash launch) and zamba2-2.7b cut to 12 (two groups:
    its shared block 2 tf32x3 and 2 × 8 decode, each invocation on a KV
    cache of its own); (vlm golden) the file's ``"vlm"`` entry the same
    way: phi-3-vision-4.2b cut to 2 layers, each prompt of 64 tokens
    after 64 seeded patch embeddings (``numpy_patch_embeds``), 2 tf32x3
    and 2 × 8 decode at head dim 96; (ssm bf16) zamba2 at that depth in bf16
    as (bf16) checks llama, its prefill's attention on the wgmma route at
    head dim 80; (vlm bf16) phi-3-vision at 2 layers the same way, 64
    patch embeddings then 1,984 tokens, on the wgmma route at head dim
    96; (dense golden) the file's three ``"dense"`` entries the same way
    as the ``"lm"`` one: qwen1.5-110b (QKV bias) and command-r-35b at full
    width, nemotron-4-340b at ``TRAIN_FAMILY_CUTS``' width (its 96 heads
    over 8 of 192: the tf32x3 forward and the decode route at D 192), each
    2 layers with the vocabulary cut to 32,768, 2 tf32x3 and 2 × 8
    decode;
    (audio golden) the ``"audio"`` entry: musicgen-medium at full width,
    2 layers, prompts of (2, 4, 64) tokens (4 codebooks summed in, a head
    a codebook out: the logits' rows are (batch, codebook) pairs), every
    codebook's greedy token equal where its top-2 gap exceeds 1e-3;
16. LM main path at full width: llama3.2-3b, 28 layers, bf16, the port's
    seeded init, through ``launch.serve``'s ``run``: (a) the launcher's own
    mix, batch 4, prompt 32, 32 new tokens at temperature 0.7; (b) batch
    4, prompt 2,048, 32 new tokens, greedy.  Counters as in 4; each
    request batch must launch ``flash_attention`` 28 × (1 + 32) times: 28
    on the wgmma route and 28 × 32 on the decode route;
16b. MoE main path at full width, bf16, the port's seeded init, through
    ``launch.serve``'s ``serve_config`` with (a) and (b): deepseek-v3 cut
    to its 3 dense and 2 MoE layers (256 routed experts, MLA), then
    llama4-maverick cut to one dense and one MoE layer (128 routed
    experts), one model on the card at a time; finite logits, tokens in
    range, peak memory under the card's; maverick launches exactly 2
    wgmma + 2 × 32 decode a request batch, deepseek none.  It prints
    prefill tokens/s, decode ms a step beside the time to read every
    expert once, each MoE layer's capacity at prefill and at decode, and
    the MLA latent cache's bytes a token against K and V of 128 heads;
16c. the expert-parallel MoE (`_moe_forward_a2a`) on the 2×2 gloo world
    of 4 ranks sharing the card (`mesh_smoke.rank_moe_a2a`, a job of 9d's
    world), each holding
    its 8 of 16 experts at deepseek-v3's widths, float32: every rank's
    output against the golden ``"moe_a2a"`` entry within 1e-4 (256
    values, aux, the magnitude sum) with every expert pick the
    reference's; at capacity factor 64 equal to the one-device scatter
    within 1e-4; the all-to-all's bytes and host-clock ms per rank;
16d. the SSD main path at full width and full depth, bf16, the port's
    seeded init, through ``launch.serve``'s ``run`` with (a) and (b), one
    model on the card at a time: mamba2-1.3b (48 ``mamba`` layers), then
    zamba2-2.7b (54 layers, a ``mamba_attn`` every 6th applying the one
    shared attention + MLP block); finite logits, tokens in range; per
    request batch mamba2 launches no flash_attention and zamba2 exactly
    9 wgmma (head dim 80) + 9 × 32 decode, 0 simt.  It prints prefill
    tokens/s, decode ms a step beside the time to move the step's bytes
    once at 3.35 TB/s (every weight but the embedding, the shared block
    once per invocation, the SSD state and conv tail read and written,
    the shared block's KV cache read) and peak device memory;
16e. the VLM main path at full width and full depth, bf16, the port's
    seeded init: phi-3-vision-4.2b (32 layers, 32 heads of 96) through
    ``launch.serve``'s ``run`` with (a) and (b) (patches off, as the
    launcher has them), 32 wgmma + 32 × 32 decode a request batch, 0
    simt; then (c) a prefill of 64 seeded patch embeddings and 1,984
    tokens (2,048 positions) through ``engine.prefill`` and 8 greedy
    decode steps from position 2,048: 32 wgmma, then 8 × 32 decode,
    finite logits, tokens in the vocabulary.  It prints prefill tokens/s,
    decode ms a step beside the time to move the step's bytes once
    (every weight but the embedding, every layer's KV read) and peak
    device memory; then ([nemotron main b]) nemotron-4-340b cut as
    ``TRAIN_FAMILY_CUTS`` (its published attention: 96 heads over 8 of
    192) served with mix (b) through ``serve_config``: 4 wgmma (D 192) +
    4 × 32 decode launches, 0 simt; ([dense main]) qwen1.5-110b and
    command-r-35b at full width cut to 2 layers (``DENSE_MAIN``), bf16,
    through ``serve_config`` with (a) and (b): 2 wgmma + 2 × 32 decode a
    request batch, 0 simt; ([audio main]) musicgen-medium whole (48
    layers, 4 codebooks) through ``run`` with (a) and (b): 48 wgmma (D
    64) + 48 × 32 decode a request batch, 0 simt, every codebook's tokens
    in the vocabulary;
16f. training, after the VLM phases are released: ([flash bwd]) the
    flash-attention gradient (two launches of the route ``route_bwd``
    picks: bf16 on ``wgmma``, ``csrc/flash_bwd_wgmma.cu``, reading the
    log-sum-exp the forward kernel writes; float32 at D 64-192 on
    ``tf32x3``, ``csrc/flash_bwd_tf32x3.cu``, reading it too; float32 at
    D 16 and 32 on ``simt``, ``csrc/flash_attention_bwd.cu``) against its
    plain version ``ref.flash_attention_bwd_ref`` of that route — bf16 at
    D 64/80/96/128/192, float32 at D 16/32/64/80/96/128/192 (three
    launches at 192 on every route: dq, dv, dk), GQA groups 1, 3, 5, 8
    and 12, L 130, 200 and 257, causal and not, and the training shape
    (1, 4096, 24 over 8 heads, 128) bf16 and nemotron's (1, 4096, 96 over
    8, 192) in bf16 and in float32, causal, each of which, and every
    float32 case, must also give the same bits twice;
    float32 within 1e-4 max abs (``BWD_F32_TOL``; at D 192 within 1e-4 of
    the gradient's largest magnitude), bf16 as the forward's
    checks, the forward's log-sum-exp within 1e-4 (``LSE_TOL``) of
    ``ref.flash_attention_lse_ref``; ([train golden]) two steps of
    ``make_train_step`` on llama3.2-3b cut to 2 layers at full width,
    float32 (TF32 off), on the ``"lm"`` entry's ``numpy_params`` weights
    and ``SyntheticLM(seed 1)``'s 2 × 256-token batches 0-1, against the
    file's ``"train"`` entry within 1e-3 (``TRAIN_GOLD_TOL``, relative:
    losses, grad norms, every leaf's L2 norm of step 0's gradient and of
    the parameters after the steps, 64 values of three leaves of each),
    the tf32x3 forward and the tf32x3 backward at D 128, 4 tf32x3 and 4
    ``flash_bwd`` launches a step, all on tf32x3; ([train families
    golden]) the same two float32 steps of mamba2, zamba2 (the tf32x3
    backward at D 80), deepseek-v3 (MLA and MoE), maverick (the tf32x3
    backward at D 128), nemotron (the tf32x3 backward at D 192, three
    launches a call)
    and musicgen (codebooks, D 64) at the ``"train_families"`` entry's
    cuts against it within
    ``TRAIN_GOLD_TOL``, weights drawn by numpy in threads while the
    backward checks run; ([train bf16]) the same
    depth in bf16 (the port's seeded init), 2 × 1,024 tokens: each
    gradient leaf through the kernels (the wgmma forward and backward)
    against the same gradient with attention through the plain version,
    within ``TRAIN_BF16_RTOL`` relative L2, and ([train families bf16])
    the same for zamba2 (12 layers: the shared block on wgmma at D 80),
    maverick (2 layers, 8 experts), the nemotron cut
    (``TRAIN_FAMILY_CUTS``: D 192, three backward launches a call),
    phi-3-vision (its 64 patches) and musicgen (its codebooks) as
    ``TRAIN_FAMILY_BF16`` cuts them;
    ([train main]) llama3.2-3b
    at full width and depth (28 layers, bf16) through
    ``launch.train.main`` (``TRAIN_MAIN_ARGV``: train_4k's 4,096
    tokens, the global batch cut from 256 to 8 sequences, 8
    microbatches, 4 steps): finite losses and grad norms, exactly 448
    wgmma (forward and remat's recompute) and 448 ``flash_bwd`` launches
    a step, all 448 on the backward's ``wgmma`` route, no simt or decode;
    it prints the step seconds (median of steps 1-3), tokens/s, the
    share of the bf16 peak
    that 6 · N · tokens a step gives, peak device memory and the
    forward / backward / optimizer split; ([train families]) each family
    at train_4k's 4,096-token sequences, 8 in 8 microbatches, 2 steps:
    mamba2-1.3b, zamba2-2.7b, phi-3-vision-4.2b (64 patches a sequence,
    labels -1 on them) and musicgen-medium (4 codebooks) at full width
    and depth through ``launch.train.main``, deepseek-v3, maverick and
    nemotron at full
    width (nemotron: its published attention shape) cut as
    ``TRAIN_FAMILY_CUTS`` through ``train.loop.train`` with their
    configs' bf16 moments: finite losses and grad norms, the exact flash
    launches a step its config gives (zamba2 144 wgmma forwards and 144
    backward launches, maverick 32 and 32, nemotron 64 and 96,
    phi-3-vision 512 and 512, musicgen 768 and 768, 0 elsewhere; 0 simt),
    a peak under the card's memory, the step
    seconds, tokens/s, the bf16 peak's share (active parameters for the
    MoE cuts), the split, and deepseek's MLA live memory at 4,096 tokens;
    ([train f32 d192]) the nemotron cut in float32 (TF32 off, bf16
    moments) through ``train.loop.train``, one step of 2 × 4,096 tokens
    in 2 microbatches: finite loss and grad norm, per layer and
    microbatch 2 tf32x3 forwards and 3 tf32x3 backward launches (dq, dv,
    dk), nothing on simt or wgmma, a peak under the card's memory;
    ([train restart]) the smoke
    config on the card, float32: ``train_with_restarts`` with crashes
    after steps 5 and 9 against a clean run, within 1e-5
    (``TRAIN_RESTART_TOL``);
16g. sharded training (ZeRO-3 over the whole mesh, `distributed.fsdp`)
    on 4 ranks sharing card 0 over gloo (NCCL refuses two ranks on one
    card), jobs of 9d's world, each against a one-device run made here:
    ([train mesh golden]) the ``"train_mesh"`` entry's models (smoke
    configs, float32: llama3.2-3b, deepseek-v3 with MLA and the a2a MoE,
    zamba2 on 2x2, maverick on a data-only mesh of 4; 2 steps of 8 x 256
    tokens in 2 microbatches) through `mesh_smoke.rank_train_mesh`
    against the reference's sharded step within ``TRAIN_GOLD_TOL``, every
    expert pick equal, the simt forward and backward on every rank;
    ([train mesh shards]) every rank's shards of the two main configs
    drawn sharded against the one-device draw's slices, bit for bit;
    ([train mesh grads]) on llama's draws, step 0's gradient of the
    sharded step on 4 x 1,024 tokens, every leaf gathered, against the
    one-device gradient on rank 0 within ``TRAIN_MESH_GRAD_RTOL``
    (relative L2, each leaf), beside the control: the same with the
    one-device gradient's blocks rolled by one (a block on another
    rank's slice);
    ([train mesh main]) llama3.2-3b at full width cut to 2 layers, bf16,
    float32 moments, 2 steps of 4 x 4,096 tokens (one row a rank)
    through ``launch.train.main(... --mesh 2x2 --backend gloo)``, called
    on every rank of the world (torchrun's way), and
    ([train mesh moe]) maverick at full width, 2 layers of 4 experts (2
    a rank on the a2a route; at 8 four ranks' peaks passed the card),
    bf16 moments, 1 step of 4 x 1,024 tokens, the same way:
    every step's loss and grad norm within ``TRAIN_MESH_LOSS_RTOL`` and
    ``TRAIN_MESH_GN_RTOL`` of a one-device run of the same cut (at least
    2 steps, for the control: its step 1 against its step 0, another
    batch on the same weights), 2 wgmma
    forwards (the forward and remat's recompute) and 2 wgmma backward
    launches (dq, dk/dv) a layer, step and rank, no simt; it prints the
    step seconds, tokens/s, each rank's peak, the forward / backward /
    optimizer split, the collectives and bytes by axis and the bytes
    staged through the host a step; ([train
    mesh nccl]) the smoke llama on a 1x1 NCCL mesh equal to one device
    bit for bit (deterministic algorithms in both,
    `mesh_smoke.rank_train_deterministic`).  ``--train-mesh-only``
    builds the kernels and runs this phase alone; the result lines end
    with this phase's numbers;
17. flash timing at (b)'s prefill and decode shapes, at zamba2's (H =
    KVH 32, D 80) and at phi-3-vision's (H = KVH 32, D 96): the route the
    main path takes and the simt route (the CUDA-core kernel, the earlier
    design at D 80 and 96) from CUDA graphs of
    10 launches, the plain version and, as the library's time,
    ``scaled_dot_product_attention(..., enable_gqa=True)`` (timed only;
    the port never calls it) from a CUDA graph of 10 launches and with
    events around one eager call, each beside the function's bound; and
    nemotron's prefill (1, 4096, 96 over 8, 192: the wgmma route at D
    192); and the flash-attention gradient at the training shape (1,
    4096, 24 over 8, 128, bf16, causal), nemotron's (96 over 8, 192),
    zamba2's (32 over 32, 80) and phi-3-vision's (32 over 32, 96): the
    ``wgmma`` route's launches (together and each alone) from CUDA
    graphs of 10, the plain version, and the autograd backward of
    ``scaled_dot_product_attention(..., is_causal=True,
    enable_gqa=True)`` (timed only) from a CUDA graph of 10 and eager,
    beside its bound; then ([timing flash bwd f32], [timing flash f32]) the
    float32 backward and forward at the training shape and at nemotron's
    (D 192: dq, dv and dk): the ``tf32x3`` route and the ``simt`` route
    (the earlier design), each launch alone too, from CUDA graphs of 10,
    the plain version and SDPA's float32 forward and autograd backward
    (the backend PyTorch picks named, and the memory-efficient backend on
    K and V repeated to H heads outside the graph), beside both bounds:
    three TF32 passes at 495 TFLOP/s and the 67 TFLOP/s float32 peak;
18. serving on a mesh and the dry-run (`run_serve_mesh_phases`):
    ([flash decode lse]) the ``decode`` route's output and log-sum-exp
    (``ops.flash_attention(..., return_lse=True)``) against their plain
    versions at llama3.2-3b's, zamba2's, phi-3-vision's (at llama's
    positions) and maverick's (40 over 8 heads of 128) decode shapes on
    one rank's part of [serve mesh]'s cache (its 2 of the batch's 4 rows
    over ``data``, its half of the job's positions over ``model``; the
    grid's splits are those the ranks launch): every key visible, one
    split exactly, one key past the first split, the keys a ``model``
    rank 1 sees at the job's last step, and no key (output 0,
    log-sum-exp -inf, no launch); output within the decode tolerances,
    log-sum-exp within ``LSE_TOL``; the kernel timed with and without the
    lse output from a CUDA graph of 10, beside its bound and SDPA's time;
    ([serve mesh]) each of ``SERVE_MESH_JOBS`` at full width, bf16,
    seeded weights, batch 4 (see there: llama3.2-3b cut to 2 layers and
    zamba2-2.7b cut to 6, five ``mamba`` and one ``mamba_attn`` running
    the shared block, at prompt 2,048; deepseek-v3 cut to 2 layers, one
    dense and one MoE of 16 experts, and maverick cut to its dense and
    MoE layer of 8 experts, at prompt 512 and capacity factor E / top_k)
    with greedy decode steps on a 2x2 gloo mesh of 4 ranks sharing card
    0 (9d's world; `mesh_smoke.rank_serve_mesh`: the prefill's rows over
    ``data``, the MoE prefill on the reference's a2a route, each
    ``model`` rank its sequence block and E/2 experts, the caches in the
    reference's layout, the sequence-parallel decode (GQA through the
    ``decode`` kernel's lse, MLA through its plain softmax's), each
    decode step's MoE as the global scatter over ``data``) against one
    device's run of the same cut on card 0, fed the same tokens: every
    step's logits within ``SERVE_MESH_RRMS`` (bf16 relative RMS), the
    greedy tokens equal wherever one device's top-2 gap exceeds twice the
    row's largest logit difference, every MoE call's expert picks equal
    to one device's wherever the router's margin exceeds twice the two
    runs' router-logit difference (the picks that differ, the smallest
    margin and the rows left out of a step's logits printed), the exact
    ``wgmma`` and ``decode`` launches of each rank (a ``model`` rank 1
    launches none before the job's crossing step; MLA none at all); per
    rank the prefill seconds, decode ms a step, ``Mesh.stats`` by axis,
    staged bytes and peak GiB; for llama and deepseek, planted faults (a
    lost ``model`` rank 1, a merge that ignores the lse: the steps from
    the crossing decoded again on the run's caches), the lse fault's
    logits past the limit, and the split check (one decode step's
    attention alone, rank 1 seeing the last step's keys and its whole
    half) within ``SERVE_MESH_SPLIT_RRMS`` of one device's while both
    faults are not; ([dryrun check]) `launch.dryrun.lower_cell` on a
    2x2 `comm.ShapeMesh` of the exact cells that [train mesh main] and
    [serve mesh] (llama) ran: the dry collective counts by axis equal
    the measured ``Mesh.stats`` of rank 0, calls and bytes, and the dry
    peak is within ``DRYRUN_PEAK_RTOL`` of the measured
    ``max_memory_allocated`` of rank 0 (the serving run's, after the
    weights' draw; training's over its whole run), with FLOPs, bytes and
    the roofline terms; ([dryrun sweep]) `launch.dryrun` on the 16x16
    `ShapeMesh`: ``DRYRUN_SWEEP_CELLS`` (see there) and the three BPT
    cells, one line each (status, dominant term,
    per-device GiB, ``fits``), none ``error``, within
    ``DRYRUN_SWEEP_BUDGET_S``, traced on the host beside 9d's world.
    ``--serve-mesh-only`` builds the kernels and runs [train mesh main]
    (one step) and this phase alone; ``--worlds-only`` the world of 9d
    with every job and the checks of 9d, 16c, 16g and 18;
    ``--archs-only`` [flash bwd], the dense and audio goldens and main
    paths, the nemotron and musicgen train-family goldens, phi-3-vision's
    and musicgen's bf16 gradients and steps, [train f32 d192] and the
    float32 backward's and forward's timing (`run_archs_phases`).

Each phase prints its peak device memory (9b, 9c and 9d their seconds
too).  Before the kernels line, ``[time]`` gives each phase's seconds
(release to release; the mesh world's jobs apart), the whole run's and
``TIME_LIMIT_S``.
Phases 6a, 6b, 9a and 9b each build their own graph and 24.2 GiB tile
layout, after the phase before is released; a delta's rebind holds the old and new layouts for a moment.  The line before the last is the
card's name and power limit as ``nvidia-smi`` reports them; the last line
is the result object.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.json")

# Published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit: HBM3
# rate, and the rate of 32-bit operations outside the tensor cores (the
# float32 figure; the kernels' integer operations issue no faster).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12     # dense tensor-core peak (bf16 inputs)
TF32_FLOPS_PER_S = 495e12     # dense tensor-core peak (TF32 inputs)
F32_TOL, BF16_TOL, LM_TOL = 2e-5, 2e-2, 1e-3
# bf16 kernel checks also bound the relative RMS difference, rms(got -
# want) / rms(want): atol = rtol = 2e-2 alone is a third of a typical
# output at the main prefill shape (~0.07).  Both sides are rounded to
# bf16 (half a step is 2^-9..2^-8 relative), and the wgmma route rounds P
# to bf16 for P.V: a plain float32 emulation of that gives about 2e-3 at
# the flash cases' shapes, so 6e-3 passes a sound kernel and fails one
# that is off by ~1% of its output.
BF16_RMS_TOL = 6e-3
# The bf16 whole-model check (phase 15): llama3.2-3b at full width, 2
# layers, bf16, batch 2 x prompt 2,048, prefill logits through the kernels
# against the same model with attention through the plain version.  The
# two differ only in the attention output's rounding (the kernel rounds P
# to bf16 for P.V; both round the output to bf16), which the two bf16
# layers carry on to the bf16 logits.  Those have a spread of ~1 and reach
# |6|, where one bf16 step is 0.031: the max limit is about three such
# steps, the mean limit about one step at |logit| ~ 2.  Greedy tokens must
# agree wherever the plain run's top-2 gap exceeds twice the max limit.
LM_BF16_LAYERS, LM_BF16_BATCH, LM_BF16_PROMPT = 2, 2, 2048
LM_BF16_MAX_TOL, LM_BF16_MEAN_TOL = 0.1, 0.01
# The LM main path: llama3.2-3b, request mixes (a) and (b) (module docstring).
LM_ARCH, LM_BATCH, LM_NEW = "llama3.2-3b", 4, 32
LM_MIXES = {"a": (32, 0.7), "b": (2048, 0.0)}
# The MoE phases: every expert the port's router picks must be the
# reference's (the golden entries' ``routes``), so a flipped expert cannot
# hide behind LM_TOL; the golden's router margin (its nearest tie) is
# printed beside the picks.  The main path's depth cuts at full width
# (deepseek-v3: its 3 dense layers and 2 MoE layers; maverick: one dense
# and one MoE layer) are served with LM_MIXES; MOE_A2A_TOL bounds the a2a
# against the golden entry and the one-device scatter.
MOE_A2A_TOL = 1e-4
MOE_MAIN = {"deepseek-v3-671b": 5, "llama4-maverick-400b-a17b": 2}
# The SSD main path (phase 16d): both archs at full width and full depth.
SSM_MAIN = ("mamba2-1.3b", "zamba2-2.7b")
# The VLM phases (15, 16e): phi-3-vision at full width and full depth; the
# patched prefill's patch seed and greedy decode steps.
VLM_ARCH, VLM_PATCH_SEED, VLM_STEPS = "phi-3-vision-4.2b", 0, 8
# The training phases (16f, 17).  The backward kernel's float32 limit: its
# gradients sum up to L terms of magnitude ~1 (dv of an early key gathers
# every later query), where float32 sums in another order differ by
# ~1e-6 relative.  The golden steps' limit is the LM goldens' 1e-3, taken
# relative (losses ~12, parameter norms up to ~2e4).  The bf16 gradient
# check: the kernel path and the plain one differ in the attention
# output's rounding (the wgmma route rounds P to bf16; rrms ≤ 6e-3), which
# every gradient inherits, plus the bf16 rounding of each gradient
# (2^-9 relative): about 1e-2 relative L2 is expected, 3e-2 passes a
# sound kernel and fails a gradient that is off by a few percent.  The
# restart check's limit: the embedding gradient's index_put accumulates
# with atomics on the card, so two runs differ in the last bits.
BWD_F32_TOL, TRAIN_GOLD_TOL, TRAIN_BF16_RTOL = 1e-4, 1e-3, 3e-2
# The wgmma forward's log-sum-exp against its plain version: float32 sums
# of bf16 products in another order and ex2.approx move it by ~2e-6 at
# the training shape; 1e-4 passes that and fails a wrong row max or sum.
LSE_TOL = 1e-4
TRAIN_RESTART_TOL = 1e-5
TRAIN_BF16_BATCH, TRAIN_BF16_SEQ = 2, 1024
TRAIN_MAIN_STEPS, TRAIN_MAIN_MICRO = 4, 8
TRAIN_MAIN_ARGV = ["--arch", "llama3.2-3b", "--shape", "train_4k",
                   "--seq-len", "4096", "--batch", "8", "--microbatches",
                   str(TRAIN_MAIN_MICRO), "--steps", str(TRAIN_MAIN_STEPS)]
BWD_SHAPE = (1, 4096, 24, 8, 128)            # (B, L, H, KVH, D)
# nemotron-4-340b's attention at train_4k (96 query heads over 8 KV heads
# of 192), and zamba2's and phi-3-vision's, where the backward is timed too.
BWD_TIMED_SHAPES = {"training": BWD_SHAPE,
                    "nemotron": (1, 4096, 96, 8, 192),
                    "zamba2": (1, 4096, 32, 32, 80),
                    "phi": (1, 4096, 32, 32, 96)}
# The families' training (phase 16f).  mamba2, zamba2, phi-3-vision (its
# 64 patches, labels -1 on them) and musicgen (4 codebooks) go through the
# launcher at full width and depth; the others do not fit one card whole
# and go through train.loop.train at full width, cut as below, with their
# configs' optimizer_state_dtype (bf16 moments).  deepseek-v3: 3 layers (1
# dense, 2 MoE) of 16 experts; 5 layers would hold 6.2 B parameters, ~74 GB
# of bf16 weights, moments, a microbatch's bf16 gradient and the float32
# sum before MLA's ~11 GB of blocked scores a layer.  maverick: its dense
# and MoE layer, 8 experts.  nemotron: the published attention (96 heads
# over 8 of 192), relu2 MLP and vocabulary 256,000, d_model 18,432 -> 4,608,
# d_ff 73,728 -> 18,432, 96 layers -> 4 (its embedding and unembedding
# alone are 9.4 B parameters at full width).  Each arch: 2 steps of 8
# sequences of 4,096 tokens in 8 microbatches (3 until the whole smoke
# took 1,202.7 s of its 1,200 on one H100; PERF.md §6).
TRAIN_FAMILY_ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "phi-3-vision-4.2b",
                      "musicgen-medium")
TRAIN_FAMILY_CUTS = {
    "deepseek-v3-671b": dict(num_layers=3, first_dense_layers=1,
                             num_experts=16),
    "llama4-maverick-400b-a17b": dict(num_layers=2, num_experts=8),
    "nemotron-4-340b": dict(d_model=4608, d_ff=18432, num_layers=4),
}
TRAIN_FAMILY_STEPS, TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 2, 8, 4096
# Phase 16g, sharded training on 4 ranks sharing the card over gloo (in
# the one world of 9d, `run_worlds`, through ``launch.train.main`` on
# every rank): the launcher's arguments of the main path (llama3.2-3b at
# full width, 2 layers, 4 x 4,096 tokens, one row a rank), the MoE path
# (maverick, 2 layers of 4 experts: at 8, four ranks' peaks passed the
# card's memory; 4 x 1,024 tokens, 1 step: its layer gathers through the
# host set the step, 55-60 s at 2,048 and 50 s at 1,024 tokens on an
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6; 2,048 until the whole
# smoke had to fit 800 s with
# phase 18's MoE jobs, PERF.md §4) and the
# 1x1 NCCL mesh (the smoke llama), the mesh's arguments; the limits on
# every step's loss and grad norm against a one-device run of the same
# cut, and on each gradient leaf of step 0 gathered from the shards
# against the one-device gradient (relative L2, [train mesh grads]),
# each about 10x the largest reading of a sound run on the card and well
# under its control's smallest (PERF.md §6: loss 1.555e-06 / control
# 1.346e-04, grad norm 1.564e-05 / 1.599e-03, gradient leaf 5.534e-03 /
# 1.397); the configs whose sharded draw is checked, with the rows x
# tokens of the gradient check (llama's alone, to keep the phase's time:
# maverick's cut takes the specs of its smoke config on 2x2, whose
# gradient tests/test_torch_train_mesh.py checks the same way, and the
# a2a route's per-block capacity and aux are the reference's own, so its
# router gradient differs from one device's by design).
TRAIN_MESH_MAIN_ARGV = ["--arch", "llama3.2-3b", "--num-layers", "2",
                        "--batch", "4", "--seq-len", "4096", "--steps", "2"]
TRAIN_MESH_MOE_ARGV = ["--arch", "llama4-maverick-400b-a17b",
                       "--num-layers", "2", "--num-experts", "4",
                       "--batch", "4", "--seq-len", "1024", "--steps", "1"]
TRAIN_MESH_NCCL_ARGV = ["--arch", "llama3.2-3b", "--smoke", "--steps", "3"]
TRAIN_MESH_ARGS = ["--mesh", "2x2", "--backend", "gloo", "--timeout-s",
                   "600"]
TRAIN_MESH_LOSS_RTOL, TRAIN_MESH_GN_RTOL = 2e-5, 2e-4
TRAIN_MESH_GRAD_RTOL = 5e-2
TRAIN_MESH_SHARD_CHECKS = [("llama3.2-3b", {"num_layers": 2}, (4, 1024)),
                           ("llama4-maverick-400b-a17b",
                            {"num_layers": 2, "num_experts": 4}, None)]
# [train families bf16]: the kernels' gradient against plain attention,
# phi-3-vision with its patches and musicgen with its codebooks cut in
# depth: the bf16 difference grows with depth whatever the kernels do.
# Plain attention with only P rounded to bf16 (the wgmma forward's one
# extra rounding) lies from plain attention by 1.20e-02 / 2.55e-02 /
# 3.23e-02 / 3.84e-02 (worst leaf, relative L2) at phi's 2 / 8 / 16 / 32
# layers and 8.17e-03 / 1.81e-02 / 2.90e-02 / 3.53e-02 at musicgen's 2 /
# 8 / 24 / 48, the kernels within 7% of that control at each (NVIDIA H100
# 80GB HBM3 at 700 W, scripts/torch_bf16_depth.py, PERF.md §6): past
# TRAIN_BF16_RTOL at full depth, where the check could not tell a sound
# kernel.  Each keeps the deepest measured depth whose control stays
# under 2/3 of the limit.
TRAIN_FAMILY_BF16 = {
    "zamba2-2.7b": dict(num_layers=12),
    "llama4-maverick-400b-a17b": TRAIN_FAMILY_CUTS[
        "llama4-maverick-400b-a17b"],
    "nemotron-4-340b": TRAIN_FAMILY_CUTS["nemotron-4-340b"],
    "phi-3-vision-4.2b": dict(num_layers=2),
    "musicgen-medium": dict(num_layers=8),
}
# [train f32 d192]: the nemotron cut (TRAIN_FAMILY_CUTS) in float32 through
# train.loop.train, its bf16 moments (optimizer_state_dtype): sequences,
# tokens a sequence, microbatches and steps; every attention on the tf32x3
# forward and the tf32x3 backward at D 192 (dq, dv, dk).
TRAIN_F32_BATCH, TRAIN_F32_SEQ, TRAIN_F32_MICRO, TRAIN_F32_STEPS = (
    2, 4096, 2, 1)
# The dense and audio serving phases: qwen1.5-110b (QKV bias) and
# command-r-35b at full width cut to 2 layers, bf16, through the launcher's
# serve_config with mixes (a) and (b); musicgen-medium whole through run.
DENSE_MAIN = {"qwen1.5-110b": dict(num_layers=2),
              "command-r-35b": dict(num_layers=2)}
AUDIO_ARCH = "musicgen-medium"
# Phase 18, serving on a mesh: the batch, and per job the cut, prompt,
# greedy steps and the step whose cache write crosses to ``model`` rank 1
# (the caches hold 2 x (prompt + cross) positions, each ``model`` rank its
# half).  llama3.2-3b (2 layers) and zamba2-2.7b (6) at prompt 2,048: 4
# steps crossing at step 2 (8 crossing at 4 until the whole smoke had to
# fit 800 s with the MoE jobs, PERF.md §4).  deepseek-v3 (2 layers: one
# dense, one MoE of 16 experts; MLA) and maverick (2 layers: dense, then
# MoE of 8 experts, top-1) at full width, prompt 512 (their decode step
# is set by the ~3 GB of layers each rank gathers through the host, not
# by the prompt: 4.9-10.5 s a step on an NVIDIA H100 80GB HBM3 at 700
# W, PERF.md §6), 3 steps crossing
# at step 2 (the last: a model rank 1 then holds one key); each at
# capacity factor E /
# top_k (2.0 and 8.0), where the capacity equals the token count and no
# pair drops on either route: the reference's a2a capacity is per token
# block and one device's per batch, so only there do the two agree (the
# dropping capacity is held on CPU ranks, tests/test_torch_serve_mesh.py).
# The logits' limit: the mesh merges each rank's bf16 attention output in
# float32 and rounds it again, and its row blocks take other GEMM
# tilings, so its bf16 logits differ from one device's by a few bf16
# steps (2^-8 relative) on some of them; 2e-2 relative RMS passes that
# (5.87e-3) and fails a misplaced cache block (control: the logits of the
# next step, which differ by ~1.4) and a merge that ignores the
# log-sum-exp (a planted fault, `mesh_smoke._faulty_merge`: 0.47-0.66 at
# steps 4-7).  A lost ``model`` rank 1 holds 1-4 of ~2,052 visible keys
# and moves the logits to only 6.5e-3-7.1e-3, which no limit tells from a
# sound run; the split check (`mesh_smoke._split_check`: the attention of
# a decode step alone, seeded, against one device's over the whole cache)
# sees it: 1e-2 passes the sound merge's one bf16 rounding (2.9e-3) and
# fails a lost rank 1 (4.3e-2 at 4 keys, 1.0 at 2,052) and an ignored
# lse (8.9, 2.1e-2) on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6.
# The jobs whose faults are
# planted (``faults``; steps from the crossing on decoded again,
# `mesh_smoke._fault_steps`) are llama's (GQA: the ``decode`` kernel's
# lse) and deepseek's (MLA: the plain softmax's).  A MoE job's expert
# picks must equal one device's wherever the router's margin (the
# smallest gap among the top k + 1 logits of the token) exceeds twice the
# two runs' largest router-logit difference for it; a row whose own
# token's pick differs inside that margin leaves that step's logits'
# limit, counted and printed.
SERVE_MESH_BATCH = 4
SERVE_MESH_JOBS = [
    dict(arch="llama3.2-3b", cut={"num_layers": 2}, prompt=2048, steps=4,
         cross=2, faults=True),
    dict(arch="zamba2-2.7b", cut={"num_layers": 6}, prompt=2048, steps=4,
         cross=2, faults=False),
    dict(arch="deepseek-v3-671b",
         cut=dict(num_layers=2, first_dense_layers=1, num_experts=16,
                  capacity_factor=16 / 8), prompt=512, steps=3, cross=2,
         faults=True),
    dict(arch="llama4-maverick-400b-a17b",
         cut=dict(num_layers=2, num_experts=8, capacity_factor=8 / 1),
         prompt=512, steps=3, cross=2, faults=False),
]
SERVE_MESH_RRMS = 2e-2
SERVE_MESH_SPLIT_RRMS = 1e-2
# The dry-run's peak against the measured one: the allocator rounds
# blocks and keeps cuBLAS workspaces the meta trace does not see.
DRYRUN_PEAK_RTOL = 0.15
# The whole smoke's limit, the card's run included (build to last line).
TIME_LIMIT_S = 1200.0
# 9d's world of 4 gloo ranks (`run_worlds`): its default group's timeout
# (every job's barrier and the launcher's gathers), under the limit.
WORLD_TIMEOUT_S = 1100.0
# [mesh a] / [mesh b]: the batches of the sparse exchange leg, held
# against the dense leg's 64-batch pool's first ones (64 until the whole
# smoke had to fit 800 s with phase 18's MoE jobs, PERF.md §4: 18.9 s of
# the 2x2 job on the IC sparse leg alone on an NVIDIA H100 80GB HBM3 at
# 700 W).
MESH_SPARSE_BATCHES = 16
# The smoke's dry-run sweep on 16x16: a cell of every family and kind
# (dense training and prefill by llama3.2-3b, MoE by maverick, MLA by
# deepseek-v3's decode, SSD and the hybrid by mamba2's and zamba2's
# decode and long_500k, the VLM's and the codebooks' prefill and decode,
# a skipped long_500k), ~22 s; every cell took 68.9-101.8 s (PERF.md §6)
# and the whole smoke 1,130.6 s of its 1,200 on one card, so `python -m
# repro_torch.launch.dryrun --all` traces the rest.
DRYRUN_SWEEP_CELLS = [
    ("llama3.2-3b", "train_4k"), ("llama3.2-3b", "prefill_32k"),
    ("llama3.2-3b", "decode_32k"), ("llama3.2-3b", "long_500k"),
    ("llama4-maverick-400b-a17b", "train_4k"),
    ("llama4-maverick-400b-a17b", "prefill_32k"),
    ("llama4-maverick-400b-a17b", "decode_32k"),
    ("deepseek-v3-671b", "decode_32k"),
    ("mamba2-1.3b", "decode_32k"), ("mamba2-1.3b", "long_500k"),
    ("zamba2-2.7b", "decode_32k"), ("zamba2-2.7b", "long_500k"),
    ("phi-3-vision-4.2b", "prefill_32k"), ("phi-3-vision-4.2b", "decode_32k"),
    ("musicgen-medium", "prefill_32k"), ("musicgen-medium", "decode_32k")]
DRYRUN_SWEEP_BUDGET_S = 240.0
# The quantised path (phases 10-13): its graph, batches, check list and the
# statistics limit in standard errors of the difference of two means.
Q_N, Q_DEGREE, Q_PROB, Q_GRAPH_SEED = 262_144, 6.0, 0.25, 7
Q_BATCHES, Q_CHECK_TILES, Q_STAT_SE = 8, 4096, 4.0
# The fused-versus-unfused phases (9b, 9c): forward σ's trials and counter
# seed, the fresh reverse collection and the limit in standard errors;
# the Table-1 grid's graph, edge probabilities, colours, counter seed and
# the host seconds of unfused runs a point may take (at most 3 runs).
SIGMA_TRIALS, SIGMA_MASTER_SEED, SIGMA_SE = 512, 77, 4.0
FRESH_THETA, FRESH_SEED = 4096, 4242
T1_NAME, T1_GRAPH_SEED, T1_SEED = "web-Google", 2, 1
T1_PROBS, T1_COLORS, UNFUSED_BUDGET_S = (0.05, 0.1, 0.2), (8, 32, 64), 4.0


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _sha(mask: torch.Tensor) -> str:
    words = mask.cpu().numpy().view(np.uint32).astype("<u4")
    return hashlib.sha256(words.tobytes()).hexdigest()


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest difference of the uint32 words (0 when bit-identical)."""
    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64)
                                                 & 0xFFFFFFFF)
    return int(diff.abs().max()) if diff.numel() else 0


def _time_ms(fn, reps: int, before=None) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` runs; ``before`` runs
    untimed ahead of each (an L2 flush)."""
    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _random_masks(vp, colors, density, gen, dev):
    """(frontier, visited ⊇ frontier) int32 masks with random bits."""
    from repro_torch.core import bitmask
    w = bitmask.num_words(colors)
    tail = bitmask.tail_mask_tensor(colors, dev)

    def bits(p):
        lanes = torch.rand((vp, w, 32), generator=gen, device=dev) < p
        return bitmask.pack_bits(lanes) & tail

    fr = bits(density)
    return fr, fr | bits(0.2)


# ------------------------------------------------------------------ phases
def _reduced_graph(dev, lt: bool):
    """The reduced check graph: 4,096 vertices, destinations below 3,000 so
    blocks 24..31 receive no tile, 5 ``pad_tiles_to`` padding tiles; LT
    adds the normalised weights and the cb stack.  Returns (graph, tiles,
    cb or None)."""
    from repro_torch.core import lt as lt_lib
    from repro_torch.core import tiles
    from repro_torch.graph import csr

    rs = np.random.default_rng(11)
    n, e = 4096, 40_000
    src = rs.integers(0, n, e)
    dst = rs.integers(0, 3000, e)
    keep = src != dst
    g = csr.from_edges(src[keep], dst[keep],
                       rs.uniform(0, 1, keep.sum()).astype(np.float32), n,
                       dedupe=True, device=dev)
    if lt:
        g = lt_lib.normalize_lt_weights(g)
    nt = tiles.from_graph(g, edge_ids=not lt).num_tiles
    tg = tiles.from_graph(g, pad_tiles_to=nt + 5, edge_ids=not lt)
    ptr = tg.dst_run_ptr
    _check(bool((ptr[1:] == ptr[:-1]).any()), "reduced graph lacks empty "
           "destination blocks")
    cb = (tiles.lt_cb_tiles(tg, g, lt_lib.selection_cum_before(g))
          if lt else None)
    return g, tg, cb


def _hub_graph(dev, lt: bool = False):
    """4,096 vertices whose rows 5, 700 and 4,095 take 300 in-edges each
    (row 5's from three source blocks, the others' from anywhere), plus
    5,000 random edges: a warp's 32 entries often share a destination row,
    and one row's entries spread over many tiles.  Returns the tiles, and
    for LT (normalised weights) the cb stack, else None."""
    from repro_torch.core import lt as lt_lib
    from repro_torch.core import tiles
    from repro_torch.graph import csr

    n = 4096
    rs = np.random.default_rng(1)
    src = np.concatenate([np.arange(1000, 1300), rs.integers(0, n, 600),
                          rs.integers(0, n, 5000)])
    dst = np.concatenate([np.repeat([5, 700, 4095], 300),
                          rs.integers(0, n, 5000)])
    keep = src != dst
    g = csr.from_edges(src[keep], dst[keep],
                       rs.uniform(0.05, 0.5, keep.sum()).astype(np.float32),
                       n, dedupe=True, device=dev)
    if not lt:
        return tiles.from_graph(g), None
    g = lt_lib.normalize_lt_weights(g)
    tg = tiles.from_graph(g, edge_ids=False)
    return tg, tiles.lt_cb_tiles(tg, g, lt_lib.selection_cum_before(g))


def _same_lists(a, b) -> bool:
    """Two slot lists equal field for field."""
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "slot_ptr", "src_row", "dst_row", "value", "key")) \
        and a.value.dtype == b.value.dtype \
        and (a.src_rows, a.dst_rows) == (b.src_rows, b.dst_rows)


def check_slot_lists(dev, gen, err: dict) -> None:
    """The slot lists and the kernels that walk them, beyond the tile
    cases of `check_kernels`: each list (IC, quantised, LT) holds exactly
    the slots that pass its value test and equals the list read back from
    the stack; a hub destination (300 in-edges a row) and W = 8 on the
    three kernels, against the tile-form plain versions, on the dense grid
    and the full list."""
    from repro_torch.core import tiles
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_expand_q import quantize_probs

    g, tg, _ = _reduced_graph(dev, False)
    _, tl, cb = _reduced_graph(dev, True)
    tq, q8 = tiles.quantized(g)
    ic, q = tiles.ic_slot_list(tg), tiles.q_slot_list(tq, q8)
    lt = tiles.lt_slot_list(tl, cb)
    _check(ic.num_entries == int((tg.prob > 0).sum())
           and q.num_entries == int((q8 > 0).sum())
           and lt.num_entries == int((tl.prob > 0).sum()),
           "a slot list does not hold exactly the slots that pass its test")
    _check(_same_lists(ic, tiles.ic_slot_list_from_stack(tg))
           and _same_lists(q, tiles.q_slot_list_from_stack(tq, q8))
           and _same_lists(lt, tiles.lt_slot_list_from_stack(tl, cb)),
           "the list built from the host arrays differs from the one read "
           "from the stack")
    print(f"[kernels] slot lists of the reduced graph: IC {ic.num_entries} "
          f"entries (= slots with prob > 0), quantised {q.num_entries} (= "
          f"slots with q > 0, of {int((tg.prob > 0).sum())} with prob > 0), "
          f"LT {lt.num_entries} (= slots with prob > 0 of the normalised "
          "graph); each built from the host arrays and equal to the list "
          "read back from its stack")
    cases = 0
    for name, (tl, cb) in (("reduced", (tl, cb)),
                           ("hub", _hub_graph(dev, lt=True))):
        full = tiles.active_tile_ids(
            tl.tile_src, torch.ones(tl.num_blocks, dtype=torch.bool,
                                    device=dev))
        for colors, density in ((256, 0.05), (256, 0.9), (32, 0.9)):
            u = ref.lt_selection_uniforms(0xDEADBEEF, tl.padded_vertices,
                                          colors, device=dev)
            fr, vis = _random_masks(tl.padded_vertices, colors, density, gen,
                                    dev)
            want = ref.lt_select_expand_ref(tl.prob, cb, tl.tile_src,
                                            tl.tile_dst, fr, vis, u)
            for ids in (None, full):
                got = ops.lt_select_expand(tl, cb, fr, vis, u, tile_ids=ids)
                torch.cuda.synchronize()
                err["lt_select_expand"] = max(err["lt_select_expand"],
                                              _max_abs_err(got, want))
        if name == "hub":
            lt_hub = int((tiles.lt_slot_list(tl, cb).dst_row == 700).sum())
            _check(lt_hub >= 250, f"LT hub row 700 has {lt_hub} entries")
    print(f"[kernels] lt_select_expand on its slot list at W 8 and 1 (dense "
          f"grid and full list) on the reduced graph and the hub graph (row "
          f"700: {lt_hub} entries): max word diff {err['lt_select_expand']}")
    for name, (tg, _) in (("reduced", (tg, None)), ("hub", _hub_graph(dev))):
        q8 = quantize_probs(tg.prob)
        full = tiles.active_tile_ids(
            tg.tile_src, torch.ones(tg.num_blocks, dtype=torch.bool,
                                    device=dev))
        for colors, density in ((256, 0.05), (256, 0.5), (32, 0.5)):
            fr, vis = _random_masks(tg.padded_vertices, colors, density, gen,
                                    dev)
            for ids in (None, full):
                got = ops.fused_expand(tg, fr, vis, 0xDEADBEEF, 17,
                                       tile_ids=ids)
                want = ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                            tg.tile_dst, fr, vis, 0xDEADBEEF,
                                            17)
                err["fused_expand"] = max(err["fused_expand"],
                                          _max_abs_err(got, want))
                got = ops.fused_expand_q(tg, q8, fr, vis, 0xDEADBEEF, 17,
                                         tile_ids=ids)
                want = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst,
                                              fr, vis, 0xDEADBEEF, 17)
                torch.cuda.synchronize()
                err["fused_expand_q"] = max(err["fused_expand_q"],
                                            _max_abs_err(got, want))
                cases += 1
        if name == "hub":
            hub = int((tiles.ic_slot_list(tg).dst_row == 700).sum())
            _check(hub >= 250, f"hub row 700 has {hub} entries")
    print(f"[kernels] fused_expand and fused_expand_q: {cases} cases each "
          f"at W 8 and 1 (dense grid and full list) on the reduced graph and "
          f"on a hub graph (row 700: {hub} entries); max word diff "
          f"{err['fused_expand']} / {err['fused_expand_q']}")


def _tile_lists(tg, fr):
    """(name, tile_ids, frontier) cases of the compacted-list checks: every
    tile (None), the empty list, one source block, the full list."""
    from repro_torch.core import tiles

    act = torch.zeros(tg.num_blocks, dtype=torch.bool, device=fr.device)
    cases = [("dense grid", None, fr),
             ("empty list", tiles.active_tile_ids(tg.tile_src, act), fr)]
    act[int(tg.tile_src[0])] = True
    one = fr * act.repeat_interleave(tg.tile_size)[:, None]
    cases.append(("one source block", tiles.active_tile_ids(tg.tile_src, act),
                  one))
    act[:] = True
    cases.append(("full list", tiles.active_tile_ids(tg.tile_src, act), fr))
    return cases


def check_kernels(dev) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest word difference seen per kernel (0 = bit-identical)."""
    from repro_torch.kernels import ops, ref

    from repro_torch.kernels.fused_expand_q import quantize_probs

    err = {"fused_expand": 0, "cover_counts": 0, "lt_select_expand": 0,
           "fused_expand_q": 0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for lt in (False, True):
        name = "lt_select_expand" if lt else "fused_expand"
        _, tg, cb = _reduced_graph(dev, lt)
        cases = 0
        for colors in (32, 64, 96, 256):
            u = ref.lt_selection_uniforms(0xDEADBEEF, tg.padded_vertices,
                                          colors, device=dev)
            for density in (0.0, 0.02, 0.3):
                fr0, vis = _random_masks(tg.padded_vertices, colors, density,
                                         gen, dev)
                for _, ids, fr in _tile_lists(tg, fr0):
                    sel = slice(None) if ids is None else ids.long()
                    stacks = (tg.prob[sel], cb[sel] if lt else
                              tg.edge_id[sel], tg.tile_src[sel],
                              tg.tile_dst[sel])
                    if lt:
                        got = ops.lt_select_expand(tg, cb, fr, vis, u,
                                                   tile_ids=ids)
                        want = ref.lt_select_expand_ref(*stacks, fr, vis, u)
                    else:
                        got = ops.fused_expand(tg, fr, vis, 0xDEADBEEF, 17,
                                               tile_ids=ids)
                        want = ref.fused_expand_ref(*stacks, fr, vis,
                                                    0xDEADBEEF, 17)
                    torch.cuda.synchronize()
                    err[name] = max(err[name], _max_abs_err(got, want))
                    _check(bool(fr.any()) or not bool(got.any()),
                           f"{name}: an empty frontier expanded")
                    cases += 1
        print(f"[kernels] {name}: {cases} cases on a 4096-vertex graph "
              f"({tg.num_tiles} tiles, 5 padding; W 1, 2, 3, 8; every tile "
              f"and compacted lists: empty, one source block, full), max "
              f"word diff {err[name]}")
        if lt:
            continue
        # The quantised kernel on the same tiles: q8 is the reference's
        # quantize_probs of the float32 stack (its slot list read from the
        # stack); W = 1, 2, 4 and 8.
        q8, cases = quantize_probs(tg.prob), 0
        for colors in (32, 64, 128, 256):
            for density in (0.0, 0.02, 0.3):
                fr0, vis = _random_masks(tg.padded_vertices, colors, density,
                                         gen, dev)
                for _, ids, fr in _tile_lists(tg, fr0):
                    got = ops.fused_expand_q(tg, q8, fr, vis, 0xDEADBEEF, 17,
                                             tile_ids=ids)
                    want = ref.fused_expand_q_ref(
                        q8, tg.tile_src, tg.tile_dst, fr, vis, 0xDEADBEEF, 17,
                        tile_ids=ids)
                    torch.cuda.synchronize()
                    err["fused_expand_q"] = max(err["fused_expand_q"],
                                                _max_abs_err(got, want))
                    _check(bool(fr.any()) or not bool(got.any()),
                           "fused_expand_q: an empty frontier expanded")
                    cases += 1
        print(f"[kernels] fused_expand_q: {cases} cases on the same graph "
              f"(W 1, 2, 4, 8; every tile and the three compacted lists), "
              f"max word diff {err['fused_expand_q']}")
    check_slot_lists(dev, gen, err)
    shapes = ((64, 65536, 2), (64, 65536, 1), (64, 65536, 8),
              (16, 65536, 3), (1, 300, 1), (5, 257, 5))
    for b, v, w in shapes:
        vis = torch.randint(-2 ** 31, 2 ** 31, (b, v, w), dtype=torch.int32,
                            device=dev, generator=gen)
        act = torch.randint(-2 ** 31, 2 ** 31, (b, 8, w), dtype=torch.int32,
                            device=dev, generator=gen)
        got = ops.cover_counts(vis, act[:, 0])
        want = ref.cover_counts_ref(vis, act[:, 0])
        got_q = ops.cover_counts_multi(vis, act)
        want_q = ref.cover_counts_multi_ref(vis, act)
        err["cover_counts"] = max(err["cover_counts"],
                                  _max_abs_err(got, want),
                                  _max_abs_err(got_q, want_q))
    print(f"[kernels] cover_counts and cover_counts_multi (Q 8): (B, V, W) "
          f"{list(shapes)}, max diff {err['cover_counts']}")
    _check(not any(err.values()),
           f"kernel disagrees with its plain version: {err}")
    return err


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def run_main_path(golden: dict, diffusion: str) -> tuple[dict, dict]:
    """The serving launcher at full size on the kernel backend (IC on the
    dense grid, LT on the compacted grid); returns its summary and the
    launch counts of exactly this run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_influence

    extra = ["--diffusion", "lt", "--frontier", "sparse"] \
        if diffusion == "lt" else []
    args = serve_influence.parse_args([
        "--device", "cuda", "--smoke", "--sampler-backend", "kernel",
        "--n", str(golden["graph"]["n"]), "--colors", "64",
        "--batches", "64", "--max-batches", "64", "--k", "16",
        "--queries", "6", "--theta-cap", "4096", *extra])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve_influence.run_single(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"[main {diffusion}] launches on the main path: {launches}; peak "
          f"device memory {_peak_gib():.2f} GiB")
    kernel = "lt_select_expand" if diffusion == "lt" else "fused_expand"
    _check(launches[kernel] > 0 and launches["cover_counts"] > 0,
           f"a kernel of the {diffusion} path never launched: {launches}")
    # The run's flushes that compute marginal gains: the first and the one
    # after the refresh (the re-serve between them is all cache hits), each
    # one dispatch per query_slots queries, each dispatch one launch for all
    # its slots (one per slot before: query_slots launches a dispatch).
    slots = out["engine"].query_slots
    dispatches = 2 * -(-args.queries // slots)
    _check(launches["cover_counts_multi"] == dispatches,
           f"the {diffusion} marginal flushes launched cover_counts_multi "
           f"{launches['cover_counts_multi']} times, not once for each of "
           f"their {dispatches} dispatches")
    print(f"[main {diffusion}] marginal gains: {dispatches} dispatches of "
          f"{args.queries} queries in {slots} slots, "
          f"{launches['cover_counts_multi']} cover_counts_multi launches "
          f"(one a dispatch, not {slots}); the other "
          f"{launches['cover_counts'] - launches['cover_counts_multi']} "
          f"cover_counts launches are greedy picks")
    return out, launches


def check_outputs(out: dict, golden: dict) -> None:
    """Shapes, finiteness and the full-size golden values."""
    from repro_torch.core import imm
    from repro_torch.sampling import SamplerSpec, make_sampler

    store = out["store"]
    tg = store.sampler.tg_rev
    n = store.graph.num_vertices
    print(f"[main] graph: {n} vertices, {store.graph.num_edges} edges, "
          f"{tg.num_tiles} tiles")
    _check(tg.num_tiles == golden["graph"]["num_tiles"]
           and store.graph.num_edges == golden["graph"]["num_edges"],
           "graph or tile layout differs from the reference")
    tickets, results = out["tickets"], out["results"]
    seeds, sigma = results[tickets["top_k"][0]]
    _check(seeds.shape == (16,) and np.isfinite(sigma) and sigma > 0,
           "top-k answer malformed")
    for t in tickets["sigma"]:
        _check(np.isfinite(results[t]) and 0 < results[t] <= n,
               "σ answer malformed")
    for t in tickets["marginal"]:
        gains = results[t]
        _check(gains.shape == (n,) and np.isfinite(gains).all()
               and (gains >= 0).all(), "marginal answer malformed")
    res = out["imm"]
    _check(res.theta <= 4096 and 0 < res.coverage <= 1
           and res.seeds.shape == (16,), "run_imm result malformed")
    print(f"[main] run_imm: θ={res.theta}, coverage {res.coverage:.6f}, "
          f"σ̂={res.sigma_estimate:.1f}, seeds {res.seeds.tolist()}")

    torch.cuda.reset_peak_memory_stats()
    kern = store.sampler.sample_many(range(4))
    for b, gb in zip(kern, golden["batches"]):
        _check(_sha(b.visited) == gb["visited_sha256"],
               f"kernel batch {b.batch_index} differs from the reference")
    top, cov = imm.greedy_max_cover(torch.stack([b.visited for b in kern]),
                                    16, 64)
    _check(top.tolist() == golden["top_k"]["seeds"]
           and cov == golden["top_k"]["coverage"],
           f"top-16 over batches 0-3 {top.tolist()} != reference")
    dense = make_sampler(store.graph, SamplerSpec(backend="dense"),
                         g_rev=store.g_rev).sample_many(range(2))
    for d, k, gb in zip(dense, kern, golden["batches"]):
        _check(torch.equal(d.visited, k.visited)
               and _sha(d.visited) == gb["visited_sha256"]
               and d.fused_edge_visits == gb["fused_edge_visits"]
               and d.unfused_edge_visits == gb["unfused_edge_visits"],
               f"dense batch {d.batch_index} differs from kernel/reference")
    compact = make_sampler(store.graph, SamplerSpec(
        backend="kernel", frontier="sparse"), g_rev=store.g_rev)
    steps = []
    for b, gb in zip(range(4), golden["batches"]):
        _check(_sha(compact.sample(b).visited) == gb["visited_sha256"],
               f"compacted-grid kernel batch {b} differs from the reference")
        steps.append((compact.last_active_tiles, compact.last_grid_steps,
                      compact.last_levels * tg.num_tiles))
    print("[golden] kernel batches 0-3 (dense grid and compacted grid), dense "
          "batches 0-1 and the top-16 seeds equal the reference bit for bit "
          f"(fused edge visits {[d.fused_edge_visits for d in dense]}); "
          f"compacted grid (tiles walked, grid_steps, dense-grid steps) per "
          f"batch {steps}; peak device memory {_peak_gib():.2f} GiB")


def _kernel_ms(fn, launches: int = 10, stream=None) -> float:
    """Device time of one launch of ``fn``: ``launches`` launches captured
    in one CUDA graph (on ``stream``, or a stream of the graph's own) and
    replayed between two events, so no host dispatch lies between them
    (L2 warm after the first)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def time_tile_kernel(store, diffusion: str) -> dict:
    """Every level of batch 0 through the tile kernel's CUDA wrapper on the
    dense grid and on the level's compacted tile list (built outside the
    timed window; `_kernel_ms`), the compaction itself (the tile list; CUDA
    events), and the plain version (IC: the tile form over the whole
    stacks, as the dense grid; LT: the tile form on the gathered list, as
    the compacted grid its main path runs); all equal at every level.  Each
    reads its slot list back from the stacks (timed) and holds it equal to
    the one the layout built.  The
    eager timings run in a first pass over the levels, the CUDA graphs in a
    second, so graph memory does not disturb the allocator under them.
    Each level's bound counts what its data needs: prob and edge id (IC)
    or prob and cb (LT) of every edge whose source row is live, the uniform
    of every tested (edge, colour) pair (LT), the output mask, the run
    pointers, and on the dense grid the whole frontier and visited masks
    and every tile's source block; on the compacted list only the frontier
    rows of the listed tiles' source blocks, the visited rows of the
    destination blocks they reach, and each entry's id and source block;
    one edge fold and one draw per tested pair (IC), one add and two
    compares (LT)."""
    from repro_torch.core import bitmask, sparse, tiles, traversal
    from repro_torch.kernels import ref, work
    from repro_torch.kernels.fused_expand import fused_expand_cuda
    from repro_torch.kernels.lt_select_expand import lt_select_expand_cuda
    from repro_torch.sampling import make_sampler

    lt = diffusion == "lt"
    name = "lt_select_expand" if lt else "fused_expand"
    sampler, g_rev = store.sampler, store.g_rev
    tg = sampler.tg_rev
    dev = tg.prob.device
    seed = sampler.batch_seed(0)
    fr = tiles.pad_mask_rows(traversal.init_frontier(
        tg.num_vertices, 64, sampler.batch_starts(0), dev),
        tg.padded_vertices)
    vis = torch.zeros_like(fr)
    cb = u = None
    if lt:
        cb = sampler._cb_tiles
        u = ref.lt_selection_uniforms(seed, tg.padded_vertices, 64,
                                      device=dev)

    slots = tiles.lt_slot_list(tg, cb) if lt else tiles.ic_slot_list(tg)

    def kernel(level, fr, vis, ids):
        if lt:
            return lt_select_expand_cuda(slots, fr, vis, u, tile_ids=ids)
        return fused_expand_cuda(slots, fr, vis, seed, level, tile_ids=ids)

    def plain(level, fr, vis, ids):
        if lt:
            sel = ids.long()
            return ref.lt_select_expand_ref(tg.prob[sel], cb[sel],
                                            tg.tile_src[sel],
                                            tg.tile_dst[sel], fr, vis, u)
        return ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                    tg.tile_dst, fr, vis, seed, level)

    def compact(fr):
        return tiles.active_tile_ids(
            tg.tile_src, sparse.row_block_activity(fr, tg.tile_size))

    t0 = time.perf_counter()
    again = (tiles.lt_slot_list_from_stack(tg, cb) if lt
             else tiles.ic_slot_list_from_stack(tg))
    torch.cuda.synchronize()
    per = dict(slot_entries=slots.num_entries, slot_bytes=slots.nbytes,
               slot_build_ms=1e3 * (time.perf_counter() - t0))
    _check(_same_lists(again, slots), f"{name}: the slot list read from the "
           "stacks differs from the layout's")
    del again
    print(f"[timing] {name} slot list: {slots.num_entries} entries "
          f"({slots.nbytes / 2 ** 20:.2f} MiB) built with the layout "
          f"from its host arrays; read back from the stacks in "
          f"{per['slot_build_ms']:.1f} ms, equal")

    src = g_rev.src[:g_rev.num_edges].long()
    dst = g_rev.dst[:g_rev.num_edges].long()
    row_bytes = tg.tile_size * fr.shape[1] * 4
    ptr_bytes = (tg.num_blocks + 1) * 4
    t = {k: [] for k in ("dense", "compact", "compaction", "plain",
                         "bytes_dense", "bytes_compact", "ops", "tiles")}
    # Pass 1, eager: the levels' masks and lists, the checks, the bounds,
    # and the compaction and plain-version times (CUDA events).
    levels, err = [], 0
    while len(levels) < 64 and bitmask.any_set(fr):
        level = len(levels)
        vis = vis | fr
        ids = compact(fr)
        t["compaction"].append(_time_ms(lambda: compact(fr), 3))
        nf = kernel(level, fr, vis, None)
        nf_c = kernel(level, fr, vis, ids)
        want = [None]

        def run_plain():
            want[0] = plain(level, fr, vis, ids)
        t["plain"].append(_time_ms(run_plain, 1))
        err = max(err, _max_abs_err(nf, want[0]), _max_abs_err(nf_c, nf))
        fr_src = fr[src]
        live = (fr_src != 0).any(1)
        pairs = int(bitmask.popcount(fr_src[live] & ~vis[dst[live]]).sum())
        n_live = int(live.sum())
        edge_bytes = n_live * 8 + (pairs * 4 if lt else 0)
        out_bytes = fr.numel() * 4
        listed = ids.long()
        n_src = int(torch.unique(tg.tile_src[listed]).numel())
        n_dst = int(torch.unique(tg.tile_dst[listed]).numel())
        t["bytes_dense"].append(edge_bytes + 3 * out_bytes
                                + tg.num_tiles * 4 + ptr_bytes)
        t["bytes_compact"].append(edge_bytes + out_bytes
                                  + (n_src + n_dst) * row_bytes
                                  + ids.numel() * 8 + ptr_bytes)
        t["ops"].append(n_live + 3 * pairs if lt else
                        n_live * work.OPS_PER_EDGE_FOLD
                        + pairs * work.OPS_PER_DRAW)
        t["tiles"].append(int(ids.numel()))
        levels.append((fr, vis, ids))
        fr = nf
    # Pass 2: each level's kernel on both grids, device time per launch.
    for level, (fr, vis, ids) in enumerate(levels):
        t["dense"].append(_kernel_ms(lambda: kernel(level, fr, vis, None)))
        t["compact"].append(_kernel_ms(lambda: kernel(level, fr, vis, ids)))
    level = len(levels)
    del levels
    _check(err == 0, f"{name} differs from its plain version or between its "
           f"grids at full size: max word diff {err}")
    ops_s = np.asarray(t["ops"]) / SCALAR_OPS_PER_S
    per.update(levels=level, compaction_ms=float(np.mean(t["compaction"])),
               plain_ms=float(np.mean(t["plain"])), max_abs_err=err,
               tiles=float(np.mean(t["tiles"])))
    for grid in ("dense", "compact"):
        bytes_s = np.asarray(t[f"bytes_{grid}"]) / HBM_BYTES_PER_S
        per[f"{grid}_ms"] = float(np.mean(t[grid]))
        per[f"{grid}_bound_ms"] = float(np.mean(1e3 * np.maximum(bytes_s,
                                                                 ops_s)))
        per[f"{grid}_bound_by"] = ("bytes" if bytes_s.sum() >= ops_s.sum()
                                   else "operations")
    print(f"[timing] {name} over the {level} levels of batch 0, device time "
          f"per launch (CUDA graph of 10): dense grid mean "
          f"{per['dense_ms']:.4f} ms (max {np.max(t['dense']):.4f}, bound "
          f"{per['dense_bound_ms']:.6f} by {per['dense_bound_by']}); "
          f"compacted list mean {per['compact_ms']:.4f} ms (max "
          f"{np.max(t['compact']):.4f}, bound {per['compact_bound_ms']:.6f} "
          f"by {per['compact_bound_by']}; {per['tiles']:.0f} of "
          f"{tg.num_tiles} tiles on average); compaction (tile list) "
          f"{per['compaction_ms']:.4f} ms; plain {per['plain_ms']:.4f} ms")
    for k in ("dense", "compact", "compaction", "tiles"):
        print(f"[timing] {name} {k} per level: "
              f"{[round(x, 4) for x in t[k]]}")
    # Host clock around whole batches on both grids, in turns: the kernel's
    # share of a batch is how busy the per-level loop keeps the card.
    other = make_sampler(store.graph, dataclasses.replace(
        store.spec, frontier="dense" if store.spec.frontier == "sparse"
        else "sparse"))
    samplers = {store.spec.frontier: sampler, other.spec.frontier: other}
    batch_ms = {"dense": [], "sparse": []}
    for frontier in ("dense", "sparse", "sparse", "dense"):
        t0 = time.perf_counter()
        samplers[frontier].sample(0)
        torch.cuda.synchronize()
        batch_ms[frontier].append(1e3 * (time.perf_counter() - t0))
    for frontier, grid in (("dense", "dense"), ("sparse", "compact")):
        ms = float(np.mean(batch_ms[frontier]))
        per[f"batch_{grid}_ms"] = ms
        print(f"[timing] {diffusion} batch 0 end to end, {grid} grid: "
              f"{ms:.2f} ms (runs {[round(x, 2) for x in batch_ms[frontier]]})"
              f"; its levels' kernel times sum to {np.sum(t[grid]):.2f} ms "
              f"({np.sum(t[grid]) / ms:.1%})")
    return per


def check_outputs_lt(out: dict, golden: dict) -> None:
    """LT: the pool's answers, its tile stacks, and the golden batches on
    both grids and on the dense CSR backend."""
    from repro_torch.core import imm
    from repro_torch.sampling import SamplerSpec, make_sampler

    store = out["store"]
    tg = store.sampler.tg_rev
    stack_gib = 2 * tg.num_tiles * tg.tile_size ** 2 * 4 / 2 ** 30
    print(f"[main lt] {tg.num_tiles} tiles; prob + cb stacks "
          f"{stack_gib:.1f} GiB by reckoning (no edge-id stack)")
    _check(tg.num_tiles == golden["graph"]["num_tiles"]
           and tg.edge_id is None,
           "LT tile layout differs from the reference or carries edge ids")
    tickets, results = out["tickets"], out["results"]
    seeds, sigma = results[tickets["top_k"][0]]
    _check(seeds.shape == (16,) and np.isfinite(sigma) and sigma > 0,
           "LT top-k answer malformed")
    res = out["imm"]
    _check(res.theta <= 4096 and 0 < res.coverage <= 1
           and res.seeds.shape == (16,), "LT run_imm result malformed")
    print(f"[main lt] run_imm: θ={res.theta}, coverage {res.coverage:.6f}, "
          f"σ̂={res.sigma_estimate:.1f}, seeds {res.seeds.tolist()}")

    torch.cuda.reset_peak_memory_stats()
    gold = golden["lt"]
    compact = [store.sampler.sample(b) for b in range(4)]
    dense_grid = make_sampler(store.graph, SamplerSpec(
        diffusion="lt", backend="kernel")).sample_many(range(4))
    csr_lt = make_sampler(store.graph, SamplerSpec(
        diffusion="lt")).sample_many(range(2))
    for grid, batches in (("compacted", compact), ("dense", dense_grid),
                          ("CSR", csr_lt)):
        for b, gb in zip(batches, gold["batches"]):
            _check(_sha(b.visited) == gb["visited_sha256"],
                   f"LT {grid} batch {b.batch_index} differs from the "
                   "reference")
    top, cov = imm.greedy_max_cover(torch.stack([b.visited for b in compact]),
                                    16, 64)
    _check(top.tolist() == gold["top_k"]["seeds"]
           and cov == gold["top_k"]["coverage"],
           f"LT top-16 over batches 0-3 {top.tolist()} != reference")
    print("[golden] LT kernel batches 0-3 (compacted grid and dense grid), "
          "dense CSR batches 0-1 and the top-16 seeds equal the reference "
          f"bit for bit; peak device memory {_peak_gib():.2f} GiB")


# ------------------------------------------------- serving lifecycle phases
_LAST_RELEASE = [time.perf_counter()]
_PHASE_S: list = []          # (what, seconds) of each release, for [time]


def _release(what: str) -> None:
    """Free what the phase before held, so that each phase's peak device
    memory is its own (and two 24.2 GiB layouts never outlive a phase);
    with the seconds since the last release, the smoke's time by phase."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    now = time.perf_counter()
    print(f"[release] {what} freed: {held:.2f} GiB still allocated; "
          f"{now - _LAST_RELEASE[0]:.1f}s since the last release")
    _PHASE_S.append((what, now - _LAST_RELEASE[0]))
    _LAST_RELEASE[0] = now


# Host work done while the mesh world holds the card (`run_worlds`): the
# golden models' numpy weights by (config, seed, SSD heads' seed), and the
# quantised path's graph by vertex count, each a future.
_TREES: dict = {}
_Q_HOST: dict = {}
_WORLD_JOBS_S: dict = {}     # the mesh world's seconds by job, for [time]


def _numpy_tree(cfg, seed: int, heads_seed=None) -> dict:
    """`numpy_params` of ``cfg`` (an SSD config's per-head mixer
    parameters redrawn by `numpy_ssm_heads` from ``heads_seed``)."""
    from repro_torch.models import init

    tree = init.numpy_params(cfg, seed)
    if heads_seed is not None:
        init.numpy_ssm_heads(tree, cfg, heads_seed)
    return tree


def _predraw(pool, cfg, seed: int, heads_seed=None) -> None:
    _TREES[(repr(cfg), seed, heads_seed)] = pool.submit(
        _niced, _numpy_tree, cfg, seed, heads_seed)


def _tree(cfg, seed: int, heads_seed=None, keep: bool = False) -> dict:
    """`_numpy_tree`, the one drawn beside the mesh world where there is
    one (handed out once unless ``keep``: the caller must not change its
    arrays), else drawn now."""
    key = (repr(cfg), seed, heads_seed)
    fut = _TREES.get(key) if keep else _TREES.pop(key, None)
    return fut.result() if fut is not None \
        else _numpy_tree(cfg, seed, heads_seed)


def _launcher_args(golden: dict, *flags: str):
    from repro_torch.launch import serve_influence
    return serve_influence.parse_args([
        "--device", "cuda", "--sampler-backend", "kernel",
        "--n", str(golden["graph"]["n"]), "--colors", "64",
        "--batches", "64", "--max-batches", "64", "--k", "16", *flags])


def run_tier_phase(golden: dict) -> dict:
    """The serving tier at full size: ``run_tier --smoke --autoscale``, 3
    tenants over 2 replicas of the 64-batch IC pool on the kernel backend.
    The launcher checks the tier's contract; here ``cover_counts`` must
    have launched, and the latency quantiles come from the tier's own
    histogram (bucket upper bounds)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_influence

    args = _launcher_args(golden, "--tier", "--smoke", "--autoscale",
                          "--tenants", "3", "--replicas", "2")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve_influence.run_tier(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _check(launches["cover_counts"] > 0,
           f"the tier served without cover_counts: {launches}")
    lat = out["snapshot"]["latency"]["all"]
    d = out["decision"]
    res = dict(launches=launches, p50_ms=lat["p50"] * 1e3,
               p99_ms=lat["p99"] * 1e3, queries=lat["count"],
               mean_ms=lat["mean"] * 1e3, max_ms=lat["max"] * 1e3,
               shed_rate=out["snapshot"]["totals"]["shed_rate"],
               decision=f"{d.action} {d.batches_before}->{d.batches_after}",
               seconds=seconds, peak_gib=_peak_gib())
    print(f"[tier] launches {launches}; latency over {lat['count']} "
          f"queries: p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms "
          f"(histogram bucket bounds), mean {res['mean_ms']:.3f} ms, max "
          f"{res['max_ms']:.3f} ms; autoscale {res['decision']}; "
          f"{seconds:.2f}s; peak device memory {res['peak_gib']:.2f} GiB")
    return res


def _digest(g) -> dict:
    """Edge counts and the sha256 of the padded edge arrays, as the golden
    file records them."""
    out = {"num_edges": g.num_edges, "padded_edges": g.padded_edges}
    for name, dtype in (("src", "<i4"), ("dst", "<i4"), ("prob", "<f4")):
        arr = getattr(g, name).cpu().numpy().astype(dtype)
        out[f"{name}_sha256"] = hashlib.sha256(arr.tobytes()).hexdigest()
    return out


def run_stream_phase(golden: dict, diffusion: str) -> dict:
    """A streaming delta at full size through the tier on the kernel
    backend: ``run_stream`` with 64 deletions and 64 insertions (IC on the
    dense grid, LT on the compacted list).  The launcher checks the pool
    against a cold rebuild, the replicas, the refused pre/post gather and
    the shed delta; here the delta, the mutated reversed graph, the touched
    row blocks and slots 0-3 (words, levels and, for IC, the dense CSR
    sampler's edge visits) are held against the golden ``"stream"``
    entry, and the path's tile kernel must have launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_influence
    from repro_torch.sampling import SamplerSpec, make_sampler

    gold = golden["stream"]
    extra = ("--diffusion", "lt", "--frontier", "sparse") \
        if diffusion == "lt" else ()
    args = _launcher_args(golden, "--stream-smoke", "--queries",
                          str(gold["ops"]), *extra)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve_influence.run_stream(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    kernel = "lt_select_expand" if diffusion == "lt" else "fused_expand"
    _check(launches[kernel] > 0,
           f"the {diffusion} stream path never launched {kernel}: {launches}")
    peak = _peak_gib()
    report, store = out["report"], out["store"]
    d = out["delta"]
    delta_sha = hashlib.sha256(b"".join(
        np.ascontiguousarray(a).tobytes()
        for a in (d.src, d.dst, d.weight, d.insert))).hexdigest()
    _check(delta_sha == gold["delta_sha256"],
           "the delta differs from the reference's draw")
    g = gold[diffusion]
    _check(_digest(store.g_rev) == g["g_rev"],
           f"{diffusion} mutated reversed graph differs from the reference's")
    _check(report.touched_row_blocks == len(g["touched_row_blocks"]),
           f"{report.touched_row_blocks} touched row blocks, reference "
           f"{len(g['touched_row_blocks'])}")
    levels = []
    for b, gb in zip(range(4), g["batches"]):
        slot = store.batches[b]
        again = store.sampler.sample(b)
        levels.append(store.sampler.last_levels)
        _check(slot.batch_index == b
               and _sha(slot.visited) == gb["visited_sha256"]
               and torch.equal(again.visited, slot.visited)
               and store.sampler.last_levels == gb["levels"],
               f"{diffusion} slot {b} after the delta differs from the "
               f"reference (levels {store.sampler.last_levels} vs "
               f"{gb['levels']})")
    if diffusion == "ic":
        dense = make_sampler(store.graph, SamplerSpec(backend="dense"),
                             g_rev=store.g_rev).sample_many(range(4))
        for dn, gb in zip(dense, g["batches"]):
            _check(_sha(dn.visited) == gb["visited_sha256"]
                   and dn.fused_edge_visits == gb["fused_edge_visits"]
                   and dn.unfused_edge_visits == gb["unfused_edge_visits"],
                   f"dense CSR batch {dn.batch_index} on the mutated pair "
                   "differs from the reference")
        del dense
    res = dict(launches=launches, peak_gib=peak,
               touched_row_blocks=report.touched_row_blocks,
               dirty_slots=report.dirty_slots, total_slots=report.total_slots,
               refresh_s=report.refresh_s, rebind_s=report.rebind_s,
               resample_s=report.resample_s, cold_s=out["cold_s"],
               levels=levels, renormalised_edges=g["renormalised_edges"])
    print(f"[stream {diffusion}] delta +{report.inserted}/-{report.deleted}: "
          f"{report.touched_row_blocks} touched row blocks of "
          f"{-(-store.graph.num_vertices // 128)}, {report.dirty_slots}/"
          f"{report.total_slots} slots dirty; apply_plan over 2 replicas "
          f"{report.refresh_s:.3f}s = rebind {report.rebind_s:.3f}s "
          f"(layout and slot-list rebuild) + resample "
          f"{report.resample_s:.3f}s; cold rebuild of all "
          f"{report.total_slots} slots {out['cold_s']:.3f}s; slots 0-3 "
          f"(levels {levels}) equal the reference's"
          + (" (dense CSR edge visits too)" if diffusion == "ic" else
             f" (the reference's sampler renormalises "
             f"{g['renormalised_edges']} weights once more; the port "
             "samples the mutated graph as it is)")
          + f"; launches {launches}; peak device memory {peak:.2f} GiB")
    if diffusion == "ic":
        res["driver"] = run_driver_check(store)
    return res


def run_driver_check(store) -> dict:
    """`SamplingDriver` on the kernel backend over the mutated pair: 4
    worker threads, 20% injected failures, 16 batches, which must equal the
    store's slots 0-15 word for word."""
    from repro_torch.core.driver import SamplingDriver
    from repro_torch.kernels import ops

    ops.reset_launches()
    drv = SamplingDriver(store.g_rev, store.num_colors, store.master_seed,
                         num_workers=4, failure_rate=0.2, max_attempts=20,
                         spec=store.spec)
    t0 = time.perf_counter()
    batches = drv.run(16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _check(launches["fused_expand"] > 0,
           f"the driver's workers never launched fused_expand: {launches}")
    for i, b in enumerate(batches):
        _check(store.batches[i].batch_index == i
               and torch.equal(b.visited, store.batches[i].visited),
               f"driver batch {i} differs from the store's slot {i}")
    st = drv.stats
    print(f"[driver] 16 batches on 4 workers at failure rate 0.2 in "
          f"{seconds:.3f}s: {st.failures} failures, {st.reissues} "
          f"reissues, {st.speculative} speculative; equal to the store's "
          f"slots 0-15 word for word; launches {launches}")
    return dict(launches=launches, seconds=seconds, failures=st.failures,
                reissues=st.reissues, speculative=st.speculative)


def time_cover_counts(store) -> dict:
    """cover_counts at the pool's shape as device time: cold (the greedy
    loop's first pick, L2 flushed) from a CUDA graph of 10 (flush memset,
    kernel) pairs minus a graph of the 10 flushes alone, and warm (later
    picks find the 33.5 MB stack in the 50 MB L2) from a graph of 10
    launches; beside them the events-around-one-eager-call figure of
    earlier runs, and the cold time after a flush that reads 256 MB (L2
    left clean, no write-backs of the memset's dirty lines).  The Q = 8
    form on a marginal flush's eight active masks
    (8 exclusion sets of 2 vertices), cold and warm, against 8 launches of
    the Q = 1 form on the same masks.  Each beside its bound."""
    from repro_torch.core import bitmask, imm
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.influence import engine

    vis = store.visited_stack()
    b, v, w = vis.shape
    dev, q = vis.device, 8
    act = imm.initial_active(b, store.num_colors, dev)
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, v, (q, 2))).to(dev)
    act_q = (bitmask.tail_mask_tensor(store.num_colors, dev) & ~engine
             ._union_rows(vis, seeds, torch.ones_like(seeds, dtype=bool)))
    act_q = act_q.contiguous()
    slots = [act_q[:, k].contiguous() for k in range(q)]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush_ms = _kernel_ms(flush.zero_)
    # A flush that reads instead leaves L2 clean: the kernel then finds no
    # dirty lines of the memset to write back as it reads.
    flush32 = flush.view(torch.int32)
    read_ms = _kernel_ms(flush32.sum)

    def cold(fn):
        return _kernel_ms(lambda: (flush.zero_(), fn())) - flush_ms

    def one():
        return ops.cover_counts(vis, act)

    def multi():
        return ops.cover_counts_multi(vis, act_q)

    def eight():
        return [ops.cover_counts(vis, a) for a in slots]

    err = max(_max_abs_err(one(), ref.cover_counts_ref(vis, act)),
              _max_abs_err(multi(), ref.cover_counts_multi_ref(vis, act_q)),
              _max_abs_err(torch.stack(eight()), multi()))
    _check(err == 0, f"cover_counts differs from its plain version: {err}")
    per = dict(ms=cold(one), warm_ms=_kernel_ms(one),
               eager_cold_ms=_time_ms(one, 50, flush.zero_),
               plain_ms=_time_ms(lambda: ref.cover_counts_ref(vis, act), 10,
                                 flush.zero_),
               flush_ms=flush_ms, max_abs_err=err,
               clean_cold_ms=_kernel_ms(lambda: (flush32.sum(), one()))
               - read_ms)
    multi_per = dict(q=q, ms=cold(multi), warm_ms=_kernel_ms(multi),
                     eight_launches_ms=cold(eight),
                     eight_launches_warm_ms=_kernel_ms(eight),
                     plain_ms=_time_ms(lambda: ref.cover_counts_multi_ref(
                         vis, act_q), 3, flush.zero_))
    # Each visited word read once, the active words once, the counts
    # written once; and, popcount and add per (word, mask).
    for d, masks in ((per, 1), (multi_per, q)):
        bytes_ms = 1e3 * (b * v * w + b * masks * w + masks * v) * 4 \
            / HBM_BYTES_PER_S
        ops_ms = 1e3 * 3 * b * v * w * masks / SCALAR_OPS_PER_S
        d.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    per["multi"] = multi_per
    print(f"[timing] cover_counts (B, V, W)=({b}, {v}, {w}), device time: "
          f"cold {per['ms']:.4f} ms (graph of 10 flush + kernel pairs less "
          f"10 flushes of {flush_ms:.4f} ms each; events around one eager "
          f"call {per['eager_cold_ms']:.4f}; after a flush that reads, "
          f"leaving L2 clean, {per['clean_cold_ms']:.4f}), warm "
          f"{per['warm_ms']:.4f} ms, "
          f"plain {per['plain_ms']:.4f} ms, bound {per['bound_ms']:.4f} ms "
          f"({per['bound_by']})")
    m = multi_per
    print(f"[timing] cover_counts_multi Q {q} (a marginal flush's masks): "
          f"cold {m['ms']:.4f} ms, warm {m['warm_ms']:.4f} ms, against 8 "
          f"Q = 1 launches cold {m['eight_launches_ms']:.4f} ms, warm "
          f"{m['eight_launches_warm_ms']:.4f} ms; Q 8 / Q 1 cold "
          f"{m['ms'] / per['ms']:.2f}; plain {m['plain_ms']:.4f} ms; bound "
          f"{m['bound_ms']:.4f} ms ({m['bound_by']})")
    return per


# ------------------------------------------- fused-versus-unfused phases
def _host_s(fn):
    """(result, seconds) of ``fn()`` on the host clock between two
    synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _spread(times) -> str:
    return (f"{np.median(times) * 1e3:.1f} ms (range "
            f"{min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}, "
            f"{len(times)} run{'s' if len(times) > 1 else ''})")


def _forward_sizes(g, seeds, trials: int, master_seed: int) -> np.ndarray:
    """(trials,) forward IC cascade sizes from the seed set, the rounds of
    ``imm.simulate_influence`` (its mean is that function's value)."""
    from repro_torch.core import bitmask, imm

    seeds = np.asarray(seeds, np.int64)
    sizes, done = [], 0
    while done < trials:
        c = min(256, trials - done)
        fr = bitmask.set_color(
            bitmask.make_mask(g.num_vertices, c, g.device),
            torch.from_numpy(np.repeat(seeds, c)),
            torch.arange(c).repeat(len(seeds)))
        vis = imm._run_from_frontier(g, fr, c, master_seed + done)
        sizes.append(_colour_sizes(vis, c).cpu().numpy())
        done += c
    return np.concatenate(sizes)


def run_unfused_phase(golden: dict) -> dict:
    """9b: the unfused baseline and forward σ(S) at the main configuration
    (module docstring)."""
    from repro_torch.core import bitmask, imm, rrr, traversal
    from repro_torch.graph import csr, generators
    from repro_torch.kernels import ops
    from repro_torch.sampling import SamplerSpec, make_sampler

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gg, gold, b0 = golden["graph"], golden["unfused"], golden["batches"][0]
    g = csr.dedupe(generators.powerlaw_cluster(
        gg["n"], gg["avg_deg"], prob=gg["prob"], seed=gg["seed"]))
    g_rev = csr.transpose(g)
    _check(g.num_edges == gg["num_edges"], "main graph differs")
    n, colors, ms = g.num_vertices, golden["num_colors"], golden["master_seed"]
    starts = rrr.batch_starts(n, colors, ms, 0)
    seed = rrr.batch_seed(ms, 0)

    # (a) the unfused baseline against the fused run and the reference.
    ops.reset_launches()
    vis_u, total = traversal.run_unfused(g_rev, starts, colors, seed)
    fused = traversal.run_fused(g_rev, starts, colors, seed)
    fused_visits = int(fused.stats.fused_edge_visits.astype(np.int64).sum())
    unfused_visits = int(fused.stats.unfused_edge_visits.astype(np.int64)
                         .sum())
    _check(_sha(vis_u) == gold["visited_sha256"] == b0["visited_sha256"]
           and torch.equal(vis_u, fused.visited),
           "run_unfused's mask differs from run_fused's or the reference's")
    _check(total == gold["total_edge_visits"] == b0["unfused_edge_visits"]
           == unfused_visits,
           f"run_unfused visited {total} edges; fused unfused count "
           f"{unfused_visits}, reference {b0['unfused_edge_visits']}")
    levels = []
    for c, gc in enumerate(gold["colors"]):
        r = traversal.run_single_color(g_rev, int(starts[c]), c, seed)
        got = (r.stats.levels_run, int(bitmask.popcount(r.visited).sum()),
               int(r.stats.fused_edge_visits.astype(np.int64).sum()))
        _check(got == (gc["levels_run"], gc["popcount"], gc["edge_visits"]),
               f"colour {c}: (levels, popcount, visits) {got} != reference "
               f"{gc}")
        levels.append(r.stats.levels_run)
    _check(max(levels) == fused.stats.levels_run,
           "the fused run's levels are not the slowest colour's")

    # (b) forward σ(S) of the golden seeds, exactly the reference's.
    sig = gold["sigma"]
    sigma = imm.simulate_influence(g, sig["seeds"], sig["num_trials"],
                                   sig["master_seed"])
    _check(sigma == sig["value"],
           f"simulate_influence {sigma!r} != reference {sig['value']!r}")
    launches = dict(ops.LAUNCHES)
    _check(not any(launches.values()),
           f"the CSR and forward paths launched a kernel: {launches}")

    # (c) forward σ against the reverse estimate on fresh RRR sets (kernel
    # backend), and the greedy seeds against random ones.
    sizes = _forward_sizes(g, sig["seeds"], SIGMA_TRIALS, SIGMA_MASTER_SEED)
    _check(sizes.sum() / SIGMA_TRIALS == sigma,
           "per-trial cascade sizes do not sum to simulate_influence's σ")
    rand = np.random.default_rng(0).integers(0, n, len(sig["seeds"]))
    sizes_r = _forward_sizes(g, rand, SIGMA_TRIALS, SIGMA_MASTER_SEED)
    ops.reset_launches()
    fresh = rrr.sample_collection(
        g, FRESH_THETA, colors, FRESH_SEED, spec=SamplerSpec(
            backend="kernel", num_colors=colors, master_seed=FRESH_SEED))
    _check(ops.LAUNCHES["fused_expand"] > 0,
           "sample_collection on the kernel backend never launched "
           "fused_expand")
    cov = imm.coverage_of(torch.stack([b.visited for b in fresh]),
                          sig["seeds"], colors)
    del fresh
    rev = n * cov
    se_rev = n * np.sqrt(cov * (1 - cov) / FRESH_THETA)
    se_fwd = float(sizes.std(ddof=1)) / np.sqrt(SIGMA_TRIALS)
    se = float(np.hypot(se_rev, se_fwd))
    _check(abs(rev - sigma) <= SIGMA_SE * se,
           f"forward σ {sigma} and reverse n·coverage {rev:.1f} differ by "
           f"more than {SIGMA_SE} × {se:.1f}")
    sigma_r = float(sizes_r.mean())
    _check(sigma > sigma_r, f"greedy σ {sigma} ≤ random σ {sigma_r}")

    # (d) host clock, in turns: fused CSR, unfused CSR, the kernel backend.
    kern = make_sampler(g, SamplerSpec(backend="kernel"), g_rev=g_rev)
    runs = {"fused": lambda: traversal.run_fused(g_rev, starts, colors, seed),
            "unfused": lambda: traversal.run_unfused(g_rev, starts, colors,
                                                     seed),
            "kernel": lambda: kern.sample(0)}
    times = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            out, sec = _host_s(fn)
            times[k].append(sec)
    _check(_sha(out.visited) == b0["visited_sha256"],
           "kernel batch 0 differs from the reference")
    lv = fused.stats.levels_run
    occ = float(fused.stats.occupancy_num[:lv].mean())
    ratio = float(np.median(times["unfused"]) / np.median(times["fused"]))
    res = dict(
        fused_ms=float(np.median(times["fused"])) * 1e3,
        unfused_ms=float(np.median(times["unfused"])) * 1e3,
        kernel_ms=float(np.median(times["kernel"])) * 1e3,
        unfused_over_fused=ratio, fused_visits=fused_visits,
        unfused_visits=unfused_visits,
        savings=1 - fused_visits / unfused_visits, levels=lv,
        colour_levels=(min(levels), float(np.mean(levels)), max(levels)),
        occupancy=occ, sigma=sigma, sigma_random=sigma_r, reverse=rev,
        se=se, peak_gib=_peak_gib(), seconds=time.perf_counter() - t_phase)
    print(f"[unfused a] run_unfused (64 single-colour runs) on batch 0: mask "
          f"equals run_fused's and the reference's word for word; "
          f"{total} edge visits = the reference's; each colour's levels "
          f"and popcount equal the reference's (levels min/mean/max "
          f"{min(levels)}/{np.mean(levels):.2f}/{max(levels)}; fused "
          f"{lv}); no kernel launched")
    print(f"[unfused b] simulate_influence(top-16 seeds[:8], "
          f"{SIGMA_TRIALS}) = {sigma!r}, the reference's exactly")
    print(f"[unfused c] forward σ {sigma:.3f} ± {se_fwd:.3f} against "
          f"n·coverage {rev:.3f} ± {se_rev:.3f} on {FRESH_THETA} fresh RRR "
          f"sets (kernel backend, master_seed {FRESH_SEED}): |difference| "
          f"{abs(rev - sigma):.3f} ≤ {SIGMA_SE} × {se:.3f}; random 8 "
          f"vertices σ {sigma_r:.3f}, greedy/random {sigma / sigma_r:.2f}×")
    print(f"[unfused d] batch 0, host clock after synchronise: run_fused "
          f"(CSR) {_spread(times['fused'])}, run_unfused (CSR) "
          f"{_spread(times['unfused'])}, kernel backend "
          f"{_spread(times['kernel'])}; unfused/fused {ratio:.2f}×; edge "
          f"visits fused {fused_visits}, unfused {unfused_visits}, savings "
          f"{100 * res['savings']:.2f}%; {lv} levels, mean occupancy "
          f"{occ:.4f}; peak device memory {res['peak_gib']:.2f} GiB; "
          f"{res['seconds']:.1f}s")
    return res


def run_table1_grid() -> dict:
    """9c: the paper's Fig. 7/8 grid at web-Google's size (module
    docstring); every point's Theorem 1 coupling is checked exactly."""
    from repro_torch.core import traversal
    from repro_torch.graph import csr, datasets, generators

    t_phase = time.perf_counter()
    v, _, deg = datasets.TABLE1[T1_NAME]
    t0 = time.perf_counter()
    base = csr.transpose(generators.powerlaw_cluster(v, deg,
                                                     seed=T1_GRAPH_SEED))
    src, dst, _ = base.edges_numpy()
    e = base.num_edges
    del base
    print(f"[table1] {T1_NAME}'s size: powerlaw_cluster({v}, {deg}, seed "
          f"{T1_GRAPH_SEED}), reversed: {e} edges, built in "
          f"{time.perf_counter() - t0:.1f}s")
    points = []
    for p in T1_PROBS:
        g = csr.from_edges(src, dst, np.full(e, p, np.float32), v)
        for c in T1_COLORS:
            starts = traversal.random_starts(0, v, c)
            torch.cuda.reset_peak_memory_stats()
            t_f = []
            for _ in range(3):
                fused, sec = _host_s(lambda: traversal.run_fused(
                    g, starts, c, T1_SEED))
                t_f.append(sec)
            t_u = []
            while len(t_u) < 3 and sum(t_u) < UNFUSED_BUDGET_S:
                (vis, total), sec = _host_s(lambda: traversal.run_unfused(
                    g, starts, c, T1_SEED))
                t_u.append(sec)
            fv = int(fused.stats.fused_edge_visits.astype(np.int64).sum())
            uv = int(fused.stats.unfused_edge_visits.astype(np.int64).sum())
            _check(torch.equal(vis, fused.visited) and total == uv,
                   f"p {p}, {c} colours: run_unfused differs from run_fused "
                   f"(visits {total} vs {uv})")
            _check(fv <= uv, f"Theorem 1 fails at p {p}, {c} colours")
            lv = fused.stats.levels_run
            pt = dict(p=p, colors=c, fused_ms=float(np.median(t_f)) * 1e3,
                      unfused_ms=float(np.median(t_u)) * 1e3,
                      unfused_runs=len(t_u), fused_visits=fv,
                      unfused_visits=uv, levels=lv,
                      occupancy=float(fused.stats.occupancy_num[:lv].mean())
                      if lv else 0.0, peak_gib=_peak_gib())
            pt["speedup"] = pt["unfused_ms"] / pt["fused_ms"]
            points.append(pt)
            print(f"[table1] p {p} colours {c}: fused {_spread(t_f)}, "
                  f"unfused {_spread(t_u)}; speedup {pt['speedup']:.2f}×; "
                  f"visits fused/unfused {fv}/{uv} = "
                  f"{fv / max(uv, 1):.4f}; {lv} levels, occupancy "
                  f"{pt['occupancy']:.4f}; masks and totals equal; peak "
                  f"device memory {pt['peak_gib']:.2f} GiB")
        del g
    seconds = time.perf_counter() - t_phase
    print(f"[table1] 3 × 3 grid: run_unfused ≡ run_fused word for word and "
          f"in total visits at every point; {seconds:.1f}s")
    return dict(points=points, seconds=seconds)


# ----------------------------------------------------------- quantised phases
def _ranks(results, key):
    return [r[key] for r in results]


def check_mesh_front_end(a4: list) -> dict:
    """(f)'s checks and its ``[mesh async]`` lines, from the 2x2 ranks'
    results: every served answer equals the engine's own, asked directly
    after ``STOP`` on every rank at the answer's pool version, and the
    one-device engine's on the final pool; the deadline and refresh
    contract; the kernels launched on every rank; the followers made the
    leader's calls in its order.  Returns the numbers the result lines and
    the ``kernels`` line carry."""
    from repro_torch.launch import mesh_smoke

    fs = _ranks(a4, "f")
    lead = fs[0]
    st = lead["stats"]
    answers = lead["answers"]
    served = [("lone", None) + answers["lone"]] + [
        ("clients", i) + a for i, a in enumerate(answers["clients"])] + [
        ("top_k", None) + answers["top_k"],
        ("marginal", None) + answers["marginal"]]
    for kind, i, value, version in served:
        for f in fs:
            direct = f["direct"].get(version)
            _check(direct is not None and (
                direct[kind] if i is None else direct[kind][i]) == value,
                f"[mesh async] the {kind} answer {value} (pool version "
                f"{version}) differs from rank {fs.index(f)}'s direct one")
    final = lead["direct"][lead["version"]]
    one = lead["one_device"]["answers"]
    _check(one == final, "[mesh async] the one-device engine on the final "
           f"pool answers differently: {one['top_k']} vs {final['top_k']}")
    _check(lead["lone_deadline_flushes"] >= 1,
           f"[mesh async] the lone request did not flush on its deadline: "
           f"{st}")
    _check(st["max_queue_wait"] <= mesh_smoke.FE_DEADLINE_S + 0.25,
           f"[mesh async] a request waited past its deadline: {st}")
    _check(st["refreshes"] >= 1 and all(
        f["version"] == lead["version"] and f["version"][1] >= 1
        for f in fs), f"[mesh async] no refresh, or the ranks' pool "
        f"versions differ: {[f['version'] for f in fs]}")
    _check(lead["version_later"] == lead["version_closed"],
           "[mesh async] the pool version moved after close()")
    _check(all(f["launches"][k] > 0 for f in fs for k in (
        "cover_counts", "cover_counts_multi", "fused_expand")),
        f"[mesh async] a rank never launched cover_counts, "
        f"cover_counts_multi or fused_expand: {[f['launches'] for f in fs]}")
    ops_of = [[op for op, _ in f["dispatches"]] for f in fs]
    _check(all(o == ops_of[0] for o in ops_of) and all(
        f["messages"] == lead["messages"] for f in fs),
        "[mesh async] the followers' calls differ from the leader's")
    worst = [max(f["dispatches"][j][1] for f in fs)
             for j in range(len(ops_of[0]))]
    mesh_ms = {op: 1e3 * float(np.median(
        [t for o, t in zip(ops_of[0], worst) if o == op]))
        for op in sorted(set(ops_of[0]))}
    one_ms = lead["one_device"]["ms"]
    out = dict(launches={k: sum(f["launches"][k] for f in fs) for k in (
        "fused_expand", "cover_counts", "cover_counts_multi")},
        mesh_ms=mesh_ms, one_ms=one_ms,
        broadcast_ms=max(f["broadcast_ms"] for f in fs),
        seconds=max(f["seconds"] for f in fs), messages=lead["messages"])
    print(f"[mesh async] graph_parallel IC on 2x2 over (a)'s 64-batch pool: "
          f"rank 0 leads ({st['flushes']} flushes: {st['slot_flushes']} "
          f"slot / {st['deadline_flushes']} deadline / "
          f"{st['drain_flushes']} drain; {st['served']} served; "
          f"{st['refreshes']} background refresh(es), epoch "
          f"{lead['version'][1]}), 3 ranks follow; messages "
          f"{lead['messages']} of {lead['message_bytes']} bytes; every "
          f"answer equals the engine's direct one on every rank and the "
          f"one-device engine's; worst queue wait "
          f"{st['max_queue_wait'] * 1e3:.1f} ms (deadline "
          f"{mesh_smoke.FE_DEADLINE_S * 1e3:.0f} ms); launches by rank "
          + ", ".join(f"{k} {[f['launches'][k] for f in fs]}" for k in (
              "fused_expand", "cover_counts", "cover_counts_multi")))
    print(f"[mesh async] flush ms, host clock from dispatch start to "
          f"results (worst rank, median over the session's dispatches) "
          f"against one device on the final pool (mean of 3): "
          + ", ".join(f"{op} {mesh_ms[op]:.3f}"
                      + (f" vs {one_ms[op]:.3f}" if op in one_ms else "")
                      for op in mesh_ms)
          + f"; the whole-mesh broadcast of one message alone "
          f"{out['broadcast_ms']:.3f} ms (worst rank, mean of 20); "
          f"{out['seconds']:.2f}s of session, collectives by axis "
          f"{lead['collectives']}")
    return out


def check_mesh_results(a4: list, b3: list, d1: list,
                       single_build_s: dict) -> dict:
    """Phase 9d's checks and lines, from the ranks' results
    (`repro_torch.launch.mesh_smoke`); returns the numbers the result
    lines and the ``kernels`` line carry."""
    out = {"f": check_mesh_front_end(a4)}
    for tag, sub, kernel in (("a", "IC", "fused_expand"),
                             ("b", "LT", "lt_select_expand")):
        rs = _ranks(a4, tag)
        _check(all(r["shas_equal"] for r in rs),
               f"[mesh {tag}] batches 0-3 differ from the golden file")
        _check(all(r["top_equal"] for r in rs),
               f"[mesh {tag}] top-16 differs from the golden file")
        _check(all(r["sparse_equals_dense"] for r in rs),
               f"[mesh {tag}] sparse-leg pool differs from the dense leg's")
        _check(all(r["launches"][kernel] > 0
                   and r["launches"]["cover_counts"] > 0 for r in rs),
               f"[mesh {tag}] a rank never launched {kernel} or "
               f"cover_counts: {[r['launches'] for r in rs]}")
        _check(all(r["check"]["max_abs_err"] == 0 for r in rs),
               f"[mesh {tag}] {kernel} differs from its plain version")
        _check(all(r["cover_check"]["max_abs_err"] == 0 for r in rs),
               f"[mesh {tag}] cover_counts or cover_counts_multi differs "
               f"from its plain version on a rank's block: "
               f"{[r['cover_check'] for r in rs]}")
        _check(all(r["words_dense"] == rs[0]["words_dense"]
                   and r["words_sparse"] == rs[0]["words_sparse"]
                   for r in rs), f"[mesh {tag}] ranks disagree on words")
        r0 = rs[0]
        print(f"[mesh {tag}] graph_parallel {sub} on 2x2 ({a4[0]['backend']} "
              f"transport, every rank on {a4[0]['device']}): batches 0-3 "
              f"equal the golden sha256s and top-16 {r0['seeds'][:4]}... "
              f"(σ̂ {r0['sigma']:.1f}) on every rank; 64-batch pool "
              f"{max(r['build_dense_s'] for r in rs):.3f}s on the dense "
              f"leg, {max(r['build_sparse_s'] for r in rs):.3f}s for its "
              f"first {a4[0]['sparse_batches']} batches on the sparse leg "
              f"(auto capacity), masks equal, beside "
              f"{single_build_s[tag]:.3f}s on one device (phase "
              f"{'4' if tag == 'a' else '7'}); {sub} levels per batch "
              f"{sorted(set(r0['levels_dense']))}")
        print(f"[mesh {tag}] gather_words per level, dense leg "
              f"{r0['words_dense'][:8]}... ({sum(r0['words_dense'])} in "
              f"all, 64 batches), sparse leg {r0['words_sparse'][:8]}... "
              f"({sum(r0['words_sparse'])}, {a4[0]['sparse_batches']})")
        print(f"[mesh {tag}] every level of batch 0 on each rank's slot "
              f"list ({[r['check']['entries'] for r in rs]} entries, rows "
              f"{[r['check']['row_base'] for r in rs]} + "
              f"{r0['check']['rows']}, {r0['check']['levels']} levels): "
              f"{kernel} equals its plain version bit for bit; launches by "
              f"rank {kernel} {[r['launches'][kernel] for r in rs]}, "
              f"cover_counts {[r['launches']['cover_counts'] for r in rs]}")
        print(f"[mesh {tag}] cover_counts and cover_counts_multi "
              f"({r0['cover_check']['queries']} queries) on each rank's "
              f"{r0['cover_check']['shape']} block of the 64-batch pool "
              f"equal their plain versions")
        print(f"[mesh {tag}] {max(r['seconds'] for r in rs):.2f}s, peak "
              f"{[round(r['peak_gib'], 3) for r in rs]} GiB per rank, "
              f"staged {[r['staged_bytes'] for r in rs]} bytes per rank, "
              f"collectives by axis {r0['collectives']}")
        out[tag] = dict(
            launches={k: sum(r["launches"][k] for r in rs)
                      for k in (kernel, "cover_counts")},
            max_abs_err=max(r["check"]["max_abs_err"] for r in rs),
            cover_max_abs_err=max(r["cover_check"]["max_abs_err"]
                                  for r in rs),
            build_dense_s=max(r["build_dense_s"] for r in rs),
            build_sparse_s=max(r["build_sparse_s"] for r in rs),
            seconds=max(r["seconds"] for r in rs),
            peak_gib=max(r["peak_gib"] for r in rs),
            staged_bytes=max(r["staged_bytes"] for r in rs),
            words_dense=sum(r0["words_dense"]),
            words_sparse=sum(r0["words_sparse"]))
    ex = _ranks(a4, "exchange")
    out["exchange"] = {k: max(e[k] for e in ex)
                       for k in ("dense_ms", "butterfly_ms", "pmax_ms")}
    print(f"[mesh exchange] one level's exchange alone on 2x2, host clock "
          f"after synchronise (worst rank): all-gather of a "
          f"({a4[0]['a']['check']['rows']}, 2) frontier "
          f"({ex[0]['dense_bytes']} bytes a rank) "
          f"{out['exchange']['dense_ms']:.3f} ms, butterfly of "
          f"{ex[0]['tail_words']} live words "
          f"{out['exchange']['butterfly_ms']:.3f} ms, the control pmax "
          f"{out['exchange']['pmax_ms']:.3f} ms")
    cs = _ranks(a4, "c")
    _check(all(c["shas_equal"] and c["top_equal"] for c in cs),
           "[mesh c] data_parallel batches or top-16 differ from golden")
    _check(all(c["restore_equal"] for c in cs),
           "[mesh c] (a)'s snapshot restored onto 4x1 answers differently")
    _check(all(c["refresh_equal"] for c in cs),
           "[mesh c] refresh differs from the one-device pool's")
    _check(all(c["launches"]["cover_counts"] > 0 for c in cs),
           "[mesh c] a rank never launched cover_counts")
    _check(all(c["cover_check"]["max_abs_err"] == 0 for c in cs),
           "[mesh c] cover_counts or cover_counts_multi differs from its "
           "plain version on a rank's block: "
           f"{[c['cover_check'] for c in cs]}")
    print(f"[mesh c] data_parallel IC on 4x1 ({a4[0]['backend']} "
          f"transport): batches 0-3 and top-16 equal "
          f"the golden file; (a)'s 64-batch snapshot restored onto 4x1 "
          f"answers top-16 the same; refresh(0.5) slots "
          f"{cs[0]['refresh_slots']} and answers equal a one-device pool's; "
          f"cover_counts and cover_counts_multi on each rank's "
          f"{cs[0]['cover_check']['shape']} block equal their plain "
          f"versions; "
          f"{max(c['seconds'] for c in cs):.2f}s, peak "
          f"{[round(c['peak_gib'], 3) for c in cs]} GiB, staged "
          f"{[c['staged_bytes'] for c in cs]} bytes per rank")
    out["c"] = dict(launches={"cover_counts": sum(
        c["launches"]["cover_counts"] for c in cs)},
        seconds=max(c["seconds"] for c in cs),
        cover_max_abs_err=max(c["cover_check"]["max_abs_err"] for c in cs))
    d = d1[0]
    _check(d["backend"] == "nccl" and d["shas_equal"] and d["top_equal"],
           "[mesh d] the 1x1 NCCL mesh differs from the golden file")
    _check(d["restore_equal"], "[mesh d] (a)'s snapshot restored onto 1x1 "
           "answers differently")
    _check(d["launches"]["fused_expand"] > 0, "[mesh d] no fused_expand")
    _check(d["cover_check"]["max_abs_err"] == 0,
           "[mesh d] cover_counts or cover_counts_multi differs from its "
           f"plain version: {d['cover_check']}")
    print(f"[mesh d] 1x1 mesh, {d['backend']} transport: batches 0-3 and "
          f"top-16 equal the golden file; (a)'s snapshot restored onto 1x1 "
          f"answers the same; launches {d['launches']['fused_expand']} "
          f"fused_expand, {d['launches']['cover_counts']} cover_counts; "
          f"{d['seconds']:.2f}s, peak {d['peak_gib']:.3f} GiB, staged "
          f"{d['staged_bytes']} bytes")
    out["d"] = dict(launches={k: d["launches"][k]
                              for k in ("fused_expand", "cover_counts")},
                    seconds=d["seconds"],
                    cover_max_abs_err=d["cover_check"]["max_abs_err"])
    es = _ranks(a4, "e") + _ranks(b3, "e")
    cases = [c for e in es for c in e["cases"]]
    _check(len(cases) == 4 * 4 + 4 * 3 and all(
        c["shas_equal"] and c["words_equal"] for c in cases),
        "[mesh e] a case differs from the golden \"mesh\" entry: "
        + str([c for c in cases if not (c["shas_equal"]
                                        and c["words_equal"])]))
    print(f"[mesh e] reduced golden (4,096 vertices, batches 0-7): IC and "
          f"LT, dense and sparse leg, on 2x2 and 1x3: every sha256 and "
          f"every level's gather_words equal the reference on every rank "
          f"({sum(c['words'] for c in cases[:4])} words on 2x2 rank 0); "
          f"{', '.join(e['backend'] for e in es[:1])} transport; "
          f"{max(e['seconds'] for e in es):.2f}s, peak "
          f"{[round(e['peak_gib'], 3) for e in es]} GiB, staged "
          f"{[e['staged_bytes'] for e in es]} bytes per rank (2x2, then 1x3)")
    return out


def _world_seconds(ranks: list, name: str) -> float:
    """A job's seconds in the world: from its first rank's start to its
    last rank's end (`mesh_smoke.rank_jobs`)."""
    times = [r["times"][name] for r in ranks]
    return max(t[1] for t in times) - min(t[0] for t in times)


def _niced(fn, *args):
    """``fn(*args)`` on this thread at nice 10 (Linux gives each thread a
    nice value of its own): host work beside the mesh world takes what
    its ranks, whose collectives run on the host, leave."""
    import threading

    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
    return fn(*args)


def _host_beside_world(golden: dict, pool) -> None:
    """Host work started while the mesh world runs (its ranks hold the
    card; the parent waits), each task niced (`_niced`): numpy draws of
    the golden models' weights that phases 15 and 16f load (`_predraw`:
    the ``"lm"`` model, which [train golden] shares, and the ``"moe"``,
    ``"ssm"`` and ``"vlm"`` entries'; the ``"dense"`` and ``"audio"``
    ones, ~25 GB more, are drawn after the world, whose ranks leave the
    host no room for them), and the quantised path's graph on
    the host (`_q_graph_host`); the caller traces the dry-run sweep
    meanwhile."""
    from repro_torch.configs import registry

    gold = golden["lm"]
    _predraw(pool, dataclasses.replace(registry.get(gold["arch"]),
                                       num_layers=gold["num_layers"],
                                       dtype=gold["dtype"]),
             gold["param_seed"])
    _predraw_entries(pool, golden, ("moe", "ssm", "vlm"))
    _Q_HOST[Q_N] = pool.submit(_niced, _q_graph_host, Q_N)


def _predraw_entries(pool, golden: dict, names) -> None:
    """`_predraw` of every model of the golden entries ``names``."""
    from repro_torch.configs import registry

    for name in names:
        for entry in golden[name].values():
            cuts = {k: v for k, v in entry["cuts"].items() if k != "arch"}
            _predraw(pool, dataclasses.replace(registry.get(entry["arch"]),
                                               **cuts), entry["param_seed"],
                     entry.get("ssm_heads_seed"))


def run_worlds(golden: dict, *, mesh: bool = True, a2a: bool = True,
               train: bool = True, serve: bool = True,
               train_main_argv=None, beside: bool = True) -> dict:
    """Phase 9d's worlds (module docstring): every mesh job of phases 9d,
    16c, 16g and 18 in one world of 4 gloo ranks sharing the card
    (`mesh_smoke.rank_jobs`), started once; then the one-rank NCCL world
    ((d) and [train mesh nccl]).  Before it, on the card, the one-device
    runs the world's jobs are held against (serving's, whose tokens the
    mesh is fed, and [train mesh nccl]'s); while it runs, the host work of
    `_host_beside_world` and the dry-run sweep (``beside``).  Returns the
    ranks' results by job, each job's seconds and the worlds' start
    timing; the phases check and print them in their places."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.launch import accel, mesh_smoke
    from repro_torch.launch import train as tlaunch

    out = {"serve_jobs": _serve_mesh_jobs() if serve else []}
    out["one"] = []
    for job in out["serve_jobs"]:
        out["one"].append(mesh_smoke.serve_one(job, torch.device("cuda")))
        job["feed"] = out["one"][-1]["tokens"]
        _release(f"serve mesh one device {job['arch']}")
    if train:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out["nccl_one"] = tlaunch.main(TRAIN_MESH_NCCL_ARGV)
        finally:
            torch.use_deterministic_algorithms(False)
        _release("train mesh nccl: one device")
    ckpt = tempfile.mkdtemp(prefix="mesh_pool_")
    # The two jobs whose peaks [dryrun check] reads first, on fresh ranks.
    jobs = []
    if train or train_main_argv:
        jobs.append(("train_main", mesh_smoke.rank_train_launcher,
                     ((train_main_argv or TRAIN_MESH_MAIN_ARGV)
                      + TRAIN_MESH_ARGS,)))
    if serve:
        jobs.append(("serve", mesh_smoke.rank_serve_mesh,
                     (out["serve_jobs"],)))
    if mesh:
        jobs += [("mesh", mesh_smoke.rank_main_2x2,
                  (golden, ckpt, MESH_SPARSE_BATCHES)),
                 ("mesh_1x3", mesh_smoke.rank_main_1x3,
                  (golden, (0, 1, 2)))]
    if a2a:
        jobs.append(("moe_a2a", mesh_smoke.rank_moe_a2a,
                     (golden["moe_a2a"],)))
    if train:
        checks = [(dataclasses.replace(registry.get(arch), **c), rows)
                  for arch, c, rows in TRAIN_MESH_SHARD_CHECKS]
        jobs += [("train_golden", mesh_smoke.rank_train_mesh_phase,
                  (_train_mesh_jobs(golden["train_mesh"]), checks, (2, 2),
                   ("data", "model"))),
                 ("train_moe", mesh_smoke.rank_train_launcher,
                  (TRAIN_MESH_MOE_ARGV + TRAIN_MESH_ARGS,))]
    pool = ThreadPoolExecutor(4) if beside else None
    try:
        t0 = time.perf_counter()
        world = accel.start(mesh_smoke.rank_jobs, 4, args=(jobs,),
                            backend="gloo", device="cuda",
                            timeout_s=WORLD_TIMEOUT_S,
                            kernels=_build.SOURCES, env=tlaunch.RANK_ENV)
        if beside:
            _host_beside_world(golden, pool)
            out["sweep"] = _dryrun_sweep_cells()
        ranks = world.join()
        out["world_s"] = time.perf_counter() - t0
        out["timing"] = world.timing
        out["jobs_s"] = {name: _world_seconds(ranks, name)
                         for name, _, _ in jobs}
        out["ranks"] = {name: [r["results"][name] for r in ranks]
                        for name, _, _ in jobs}
        _WORLD_JOBS_S.update(out["jobs_s"])
        _release("the mesh world")
        if mesh or train:
            t1 = time.perf_counter()
            one = accel.start(
                mesh_smoke.rank_nccl_1x1, 1, args=(
                    golden if mesh else None, ckpt,
                    out["ranks"]["mesh"][0]["a"]["snapshot_top"]
                    if mesh else None,
                    TRAIN_MESH_NCCL_ARGV + ["--mesh", "1x1"]
                    if train else None),
                backend="nccl", device="cuda", timeout_s=600,
                kernels=_build.SOURCES, env=tlaunch.RANK_ENV)
            out["nccl"] = one.join()[0]
            out["nccl_s"] = time.perf_counter() - t1
            out["nccl_timing"] = one.timing
            _release("the one-rank nccl world")
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
        shutil.rmtree(ckpt, ignore_errors=True)
    t = out["timing"]
    print(f"[worlds] one world of 4 gloo ranks sharing "
          f"{torch.cuda.get_device_name(0)}: started in {t['group_s']:.1f}s "
          f"(interpreters and imports {t['enter_s']:.1f}s, CUDA contexts "
          f"by {t['device_s']:.1f}s, the group by {t['group_s']:.1f}s), "
          f"{out['world_s']:.1f}s in all; its jobs "
          + ", ".join(f"{n} {v:.1f}s" for n, v in out["jobs_s"].items())
          + (f"; beside it on the host: the dry-run sweep "
             f"{out['sweep']['seconds']:.1f}s, the golden draws and the "
             f"quantised graph" if beside else "")
          + (f"; the one-rank nccl world {out['nccl_s']:.1f}s (started in "
             f"{out['nccl_timing']['group_s']:.1f}s)" if "nccl" in out
             else ""))
    return out


def check_mesh_phase(worlds: dict, single_build_s: dict) -> dict:
    """Phase 9d's checks and lines from the worlds' results (`run_worlds`):
    the 2x2 job's (a), (b), (c), (e), (f), the 1x3 job's (e) on ranks
    0-2, the nccl world's (d)."""
    a4 = worlds["ranks"]["mesh"]
    b3 = [r for r in worlds["ranks"]["mesh_1x3"] if r["member"]]
    d1 = [worlds["nccl"]["d"]]
    t_a = worlds["jobs_s"]["mesh"]
    t_b = worlds["jobs_s"]["mesh_1x3"]
    print(f"[mesh] on {torch.cuda.get_device_name(0)}, in the 4-rank gloo "
          f"world of `run_worlds`: the 2x2 job {t_a:.1f}s, the 1x3 job "
          f"(ranks 0-2; rank 3 stands by) {t_b:.1f}s of host clock; the "
          f"1x1 nccl world {worlds['nccl_s']:.1f}s with its rank's start "
          f"and [train mesh nccl]")
    out = check_mesh_results(a4, b3, d1, single_build_s)
    out["seconds"] = dict(world_2x2=t_a, world_1x3=t_b,
                          world_1x1=worlds["nccl_s"])
    return out


def _q_graph_host(n: int):
    """The quantised path's graph on the host: powerlaw_cluster(n, 6.0, p =
    0.25, seed 7), deduped, ``cluster`` order, reversed; with the host
    seconds of the reordering."""
    from repro_torch.graph import csr, generators, reorder

    g = csr.dedupe(generators.powerlaw_cluster(n, Q_DEGREE, prob=Q_PROB,
                                               seed=Q_GRAPH_SEED,
                                               device="cpu"))
    t0 = time.perf_counter()
    g_ord, _ = reorder.apply(g, "cluster")
    reorder_s = time.perf_counter() - t0
    return csr.transpose(g_ord), reorder_s


def _q_graph(n: int, dev):
    """`_q_graph_host`'s graph (the one built beside the mesh world where
    there is one) on ``dev``, and its quantised layout.  Returns (reversed
    graph, tg, q8, host seconds of the reordering)."""
    from repro_torch.core import tiles

    fut = _Q_HOST.pop(n, None)
    g_rev, reorder_s = fut.result() if fut is not None \
        else _q_graph_host(n)
    g_rev = dataclasses.replace(
        g_rev, indptr=g_rev.indptr.to(dev), src=g_rev.src.to(dev),
        dst=g_rev.dst.to(dev), prob=g_rev.prob.to(dev), cache={})
    tg, q8 = tiles.quantized(g_rev)
    return g_rev, tg, q8, reorder_s


def _colour_sizes(visited: torch.Tensor, colors: int) -> torch.Tensor:
    """(colors,) float64 RRR set sizes: the vertices carrying each colour."""
    from repro_torch.core import bitmask
    return bitmask.unpack_bits(visited).sum(0).reshape(-1)[:colors].double()


def check_q_golden(golden: dict, dev) -> None:
    """The port's whole quantised path at the golden file's ``"q"`` size
    (generator, ``cluster``, q8 layout, ``run_fused_q_tiled`` on the dense
    grid and the compacted list) against the reference's ``graph_q`` loop,
    bit for bit."""
    from repro_torch.core import rrr, tiled_traversal

    gold = golden["q"]
    spec = gold["graph"]
    g_rev, tg, q8, _ = _q_graph(spec["n"], dev)
    _check((g_rev.num_edges, tg.num_tiles) == (spec["num_edges"],
                                               spec["num_tiles"]),
           "q golden: graph or tile layout differs from the reference")
    for frontier in ("dense", "sparse"):
        for gb in gold["batches"]:
            b = gb["batch_index"]
            vis, levels, _ = tiled_traversal.run_fused_q_tiled(
                tg, q8, rrr.batch_starts(spec["n"], gold["num_colors"],
                                         gold["master_seed"], b),
                gold["num_colors"], rrr.batch_seed(gold["master_seed"], b),
                frontier=frontier)
            bits = int(_colour_sizes(vis, gold["num_colors"]).sum())
            _check(levels == gb["levels"] and bits == gb["visited_bits"]
                   and _sha(vis) == gb["visited_sha256"],
                   f"q golden: {frontier} batch {b} differs from the "
                   f"reference ({levels} levels, {bits} bits)")
    print(f"[q golden] n {spec['n']}, cluster order, {tg.num_tiles} tiles: "
          f"batches {[gb['batch_index'] for gb in gold['batches']]} on the "
          "dense grid and the compacted list equal the reference's graph_q "
          "loop bit for bit (levels "
          f"{[gb['levels'] for gb in gold['batches']]})")


def check_q_kernel_full(tg, q8, dev) -> dict:
    """The kernel against its plain version on the main graph: a list of
    Q_CHECK_TILES tile ids spread evenly over the id range (a quarter or
    more past 2¹⁸, where the cell id wraps), two frontier densities; the
    plain version's time on that list."""
    from repro_torch.kernels import ops, ref

    nt = tg.num_tiles
    ids = torch.unique(torch.linspace(0, nt - 1, Q_CHECK_TILES, device=dev)
                       .round().long()).int()
    wrap = int((ids >= 2 ** 32 // tg.tile_size ** 2).sum())
    _check(ids.numel() == Q_CHECK_TILES and 4 * wrap >= ids.numel(),
           f"q check list: {ids.numel()} ids, {wrap} past the wrap")
    gen = torch.Generator(device=dev).manual_seed(1)
    err, plain_ms = 0, []
    for density, level in ((0.02, 3), (0.3, 40)):
        fr, vis = _random_masks(tg.padded_vertices, 64, density, gen, dev)
        got = ops.fused_expand_q(tg, q8, fr, vis, 0xDEADBEEF, level,
                                 tile_ids=ids)
        want = [None]

        def plain():
            want[0] = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst,
                                             fr, vis, 0xDEADBEEF, level,
                                             tile_ids=ids)
        plain_ms.append(_time_ms(plain, 3))
        _check(bool(want[0].any()), "q check list reached nothing")
        err = max(err, _max_abs_err(got, want[0]))
    _check(err == 0, f"fused_expand_q differs from its plain version on the "
           f"main graph's list: max word diff {err}")
    print(f"[q kernels] fused_expand_q on {ids.numel()} tile ids spread over "
          f"0..{nt - 1} ({wrap} of them ≥ {2 ** 32 // tg.tile_size ** 2}, "
          f"where the cell id wraps), frontier densities 0.02 and 0.3: max "
          f"word diff {err}; plain version {plain_ms[0]:.4f} / "
          f"{plain_ms[1]:.4f} ms")
    return dict(max_abs_err=err, plain_ms=float(np.mean(plain_ms)))


def run_q_main_path(tg, q8, g_rev) -> dict:
    """The main path: Q_BATCHES batches of 64 colours through
    ``run_fused_q_tiled`` on the dense grid and on the compacted list (in
    turns), launch counters zeroed just before and read just after; the
    two grids must give identical words."""
    from repro_torch.core import rrr, tiled_traversal
    from repro_torch.kernels import ops

    n = g_rev.num_vertices
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = {"dense": [], "sparse": []}
    for b in range(Q_BATCHES):
        starts, seed = rrr.batch_starts(n, 64, 0, b), rrr.batch_seed(0, b)
        for frontier in (("dense", "sparse") if b % 2 == 0
                         else ("sparse", "dense")):
            work = {}
            t0 = time.perf_counter()
            vis, levels, _ = tiled_traversal.run_fused_q_tiled(
                tg, q8, starts, 64, seed, frontier=frontier, work=work)
            torch.cuda.synchronize()
            out[frontier].append(dict(vis=vis, levels=levels,
                                      ms=1e3 * (time.perf_counter() - t0),
                                      tiles=work["active_tiles"]))
    launches = dict(ops.LAUNCHES)
    levels = [r["levels"] for r in out["dense"]]
    for d, c in zip(out["dense"], out["sparse"]):
        _check(d["levels"] == c["levels"] and torch.equal(d["vis"], c["vis"]),
               "q main path: the compacted list differs from the dense grid")
    _check(launches["fused_expand_q"] == 2 * sum(levels),
           f"q main path: fused_expand_q launched "
           f"{launches['fused_expand_q']} times, not {2 * sum(levels)}")
    sizes = torch.cat([_colour_sizes(r["vis"], 64) for r in out["dense"]])
    per = dict(launches=launches, levels=levels, sizes=sizes,
               batch_dense_ms=float(np.mean([r["ms"] for r in out["dense"]])),
               batch_compact_ms=float(np.mean([r["ms"]
                                               for r in out["sparse"]])),
               batch0_ms={f: out[f][0]["ms"] for f in out},
               peak_gib=_peak_gib())
    print(f"[q main] {Q_BATCHES} batches × 64 colours on the dense grid and "
          f"the compacted list: identical words; levels per batch {levels}; "
          f"launches {launches}; end to end per batch: dense grid "
          f"{per['batch_dense_ms']:.2f} ms "
          f"{[round(r['ms'], 2) for r in out['dense']]}, compacted list "
          f"{per['batch_compact_ms']:.2f} ms "
          f"{[round(r['ms'], 2) for r in out['sparse']]}; mean RRR set "
          f"{float(sizes.mean()):.1f} vertices; peak device memory "
          f"{per['peak_gib']:.2f} GiB")
    print(f"[q main] batch 0, tiles walked per level on the compacted list: "
          f"{out['sparse'][0]['tiles']}")
    return per


def time_q_kernel(tg, q8, g_rev) -> dict:
    """Every level of batch 0 through ``fused_expand_q_cuda`` on the dense
    grid and on the level's compacted list (device time per launch,
    `_kernel_ms`), and the compaction (CUDA events), as `time_tile_kernel`
    does; the slot list read back from the stack (timed), equal to the one
    `tiles.quantized` built.  Each level's bound counts what its data
    needs: the q byte of every edge whose source row is live; the output
    mask; the run pointers; on the dense grid the whole frontier and
    visited masks and every tile's
    source block, on the list the frontier rows of the listed tiles' source
    blocks, the visited rows of their destination blocks and each entry's
    id and source block.  Operations: one cell fold per live edge
    (``work.OPS_PER_EDGE_FOLD``) and one hash and byte compare per live
    nibble (``work.OPS_PER_Q_HASH``): four colours of the source row not
    all visited at the destination."""
    from repro_torch.core import bitmask, rrr, sparse, tiles, traversal
    from repro_torch.kernels import work
    from repro_torch.kernels.fused_expand_q import fused_expand_q_cuda

    n, dev = g_rev.num_vertices, tg.device
    seed = rrr.batch_seed(0, 0)
    fr = tiles.pad_mask_rows(traversal.init_frontier(
        n, 64, rrr.batch_starts(n, 64, 0, 0), dev), tg.padded_vertices)
    vis = torch.zeros_like(fr)

    slots = tiles.q_slot_list(tg, q8)
    t0 = time.perf_counter()
    again = tiles.q_slot_list_from_stack(tg, q8)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    _check(_same_lists(again, slots), "fused_expand_q: the slot list read "
           "from the stack differs from the layout's")
    del again
    print(f"[q timing] slot list: {slots.num_entries} entries "
          f"({slots.nbytes / 2 ** 20:.2f} MiB) built with the layout from "
          f"its host arrays; read back from the {q8.numel() / 2 ** 30:.2f} "
          f"GiB stack in {build_ms:.1f} ms, equal")

    def kernel(level, fr, vis, ids):
        return fused_expand_q_cuda(slots, fr, vis, seed, level, tile_ids=ids)

    def compact(fr):
        return tiles.active_tile_ids(
            tg.tile_src, sparse.row_block_activity(fr, tg.tile_size))

    src = g_rev.src[:g_rev.num_edges].long()
    dst = g_rev.dst[:g_rev.num_edges].long()
    row_bytes = tg.tile_size * fr.shape[1] * 4
    ptr_bytes = (tg.num_blocks + 1) * 4
    nibble = torch.arange(8, device=dev) * 4
    t = {k: [] for k in ("dense", "compact", "compaction", "bytes_dense",
                         "bytes_compact", "ops", "tiles", "bytes_rows")}
    levels, err = [], 0
    while len(levels) < 64 and bitmask.any_set(fr):
        level = len(levels)
        vis = vis | fr
        ids = compact(fr)
        t["compaction"].append(_time_ms(lambda: compact(fr), 3))
        nf = kernel(level, fr, vis, None)
        err = max(err, _max_abs_err(kernel(level, fr, vis, ids), nf))
        fr_src = fr[src]
        live = (fr_src != 0).any(1)
        pend = bitmask.u32(fr_src[live] & ~vis[dst[live]])
        nibbles = int(((pend[..., None] >> nibble) & 0xF).ne(0).sum())
        n_live = int(live.sum())
        out_bytes = fr.numel() * 4
        listed = ids.long()
        n_src = int(torch.unique(tg.tile_src[listed]).numel())
        n_dst = int(torch.unique(tg.tile_dst[listed]).numel())
        t["bytes_dense"].append(n_live + 3 * out_bytes + tg.num_tiles * 4
                                + ptr_bytes)
        t["bytes_compact"].append(n_live + out_bytes
                                  + (n_src + n_dst) * row_bytes
                                  + ids.numel() * 8 + ptr_bytes)
        t["ops"].append(n_live * work.OPS_PER_EDGE_FOLD
                        + nibbles * work.OPS_PER_Q_HASH)
        t["tiles"].append(int(ids.numel()))
        # Not the bound: the q rows the walk reads, T bytes per live source
        # row of every walked tile (the layout has no index of its edges).
        rows = (fr != 0).any(1).view(-1, tg.tile_size).sum(1)
        t["bytes_rows"].append(int(rows[tg.tile_src.long()].sum())
                               * tg.tile_size)
        levels.append((fr, vis, ids))
        fr = nf
    for level, (fr, vis, ids) in enumerate(levels):
        t["dense"].append(_kernel_ms(lambda: kernel(level, fr, vis, None)))
        t["compact"].append(_kernel_ms(lambda: kernel(level, fr, vis, ids)))
    n_levels = len(levels)
    del levels
    _check(err == 0, f"fused_expand_q: compacted list differs from the dense "
           f"grid at full size: max word diff {err}")
    ops_s = np.asarray(t["ops"]) / SCALAR_OPS_PER_S
    per = dict(levels=n_levels, max_abs_err=err,
               compaction_ms=float(np.mean(t["compaction"])),
               tiles=float(np.mean(t["tiles"])),
               slot_entries=slots.num_entries, slot_bytes=slots.nbytes,
               slot_build_ms=build_ms)
    for grid in ("dense", "compact"):
        bytes_s = np.asarray(t[f"bytes_{grid}"]) / HBM_BYTES_PER_S
        per[f"{grid}_ms"] = float(np.mean(t[grid]))
        per[f"{grid}_bytes_ms"] = float(1e3 * np.mean(bytes_s))
        per[f"{grid}_ops_ms"] = float(1e3 * np.mean(ops_s))
        per[f"{grid}_bound_ms"] = float(np.mean(1e3 * np.maximum(bytes_s,
                                                                 ops_s)))
        per[f"{grid}_bound_by"] = ("bytes" if bytes_s.sum() >= ops_s.sum()
                                   else "operations")
    print(f"[q timing] fused_expand_q over the {n_levels} levels of batch 0, "
          f"device time per launch (CUDA graph of 10): dense grid mean "
          f"{per['dense_ms']:.4f} ms (max {np.max(t['dense']):.4f}; bound "
          f"{per['dense_bound_ms']:.6f} by {per['dense_bound_by']}: bytes "
          f"{per['dense_bytes_ms']:.6f}, operations {per['dense_ops_ms']:.6f})"
          f"; compacted list mean {per['compact_ms']:.4f} ms (max "
          f"{np.max(t['compact']):.4f}; bound {per['compact_bound_ms']:.6f} by "
          f"{per['compact_bound_by']}: bytes {per['compact_bytes_ms']:.6f}; "
          f"{per['tiles']:.0f} of {tg.num_tiles} tiles on average); "
          f"compaction {per['compaction_ms']:.4f} ms; not bounds: the q "
          f"rows of live source rows would take "
          f"{1e3 * np.mean(t['bytes_rows']) / HBM_BYTES_PER_S:.4f} ms on "
          f"average (max {1e3 * np.max(t['bytes_rows']) / HBM_BYTES_PER_S:.4f})"
          f", the whole q8 stack {1e3 * q8.numel() / HBM_BYTES_PER_S:.4f} ms")
    per["level_ms"] = {"dense": t["dense"], "compact": t["compact"]}
    for k in ("dense", "compact", "compaction", "tiles"):
        print(f"[q timing] {k} per level: {[round(x, 4) for x in t[k]]}")
    return per


def check_q_statistics(g_rev, sizes_q: torch.Tensor) -> dict:
    """(b) The mean RRR set size of the main path's traversals against as
    many exact CSR IC traversals (batches Q_BATCHES.., other roots and
    seeds): within Q_STAT_SE standard errors of the difference, from the
    observed spread.  At p = 0.25, q = 63 and p̂ = 64/256 exactly."""
    from repro_torch.core import rrr, traversal

    n = g_rev.num_vertices
    sizes_e = torch.cat([_colour_sizes(traversal.run_fused(
        g_rev, rrr.batch_starts(n, 64, 0, b), 64,
        rrr.batch_seed(0, b)).visited, 64)
        for b in range(Q_BATCHES, 2 * Q_BATCHES)])
    mq, me = float(sizes_q.mean()), float(sizes_e.mean())
    se = float(np.sqrt(float(sizes_q.var()) / sizes_q.numel()
                       + float(sizes_e.var()) / sizes_e.numel()))
    _check(abs(mq - me) <= Q_STAT_SE * se,
           f"q statistics: mean RRR set {mq:.2f} (quantised) vs {me:.2f} "
           f"(exact CSR) differ by more than {Q_STAT_SE} × {se:.2f}")
    print(f"[q exact b] p = 0.25 quantises to q = 63, p̂ = 64/256 exactly: "
          f"mean RRR set size {mq:.3f} over {sizes_q.numel()} quantised "
          f"traversals, {me:.3f} over {sizes_e.numel()} exact CSR ones; "
          f"|difference| {abs(mq - me):.3f} ≤ {Q_STAT_SE} × standard error "
          f"{se:.3f} = {Q_STAT_SE * se:.3f}")
    return dict(mean_q=mq, mean_exact=me, se=se)


def check_q_p1(tg, g_rev) -> None:
    """(a) Every edge at p = 1 (q = 255) in the main graph's layout: the
    quantised traversal must be the CSR sweep's BFS word for word."""
    from repro_torch.core import rrr, tiled_traversal, tiles, traversal
    from repro_torch.graph import csr

    n = g_rev.num_vertices
    src, dst, _ = g_rev.edges_numpy()
    g1 = csr.from_edges(src, dst, np.ones(len(src), np.float32), n,
                        device=g_rev.device)
    tg1, q1 = tiles.quantized(g1)
    _check(torch.equal(tg1.tile_src, tg.tile_src)
           and torch.equal(tg1.dst_run_ptr, tg.dst_run_ptr),
           "the p = 1 layout differs from the main one")
    levels = []
    for b, frontier in ((0, "dense"), (1, "sparse")):
        starts, seed = rrr.batch_starts(n, 64, 0, b), rrr.batch_seed(0, b)
        vis, lv, _ = tiled_traversal.run_fused_q_tiled(
            tg1, q1, starts, 64, seed, frontier=frontier)
        want = traversal.run_fused(g1, starts, 64, seed)
        _check(lv == want.stats.levels_run and torch.equal(vis, want.visited),
               f"q at p = 1 ({frontier}, batch {b}) differs from the CSR BFS")
        levels.append(lv)
    print(f"[q exact a] every edge at p = 1 (q = 255): batches 0 (dense grid) "
          f"and 1 (compacted list) equal the CSR sweep's BFS word for word "
          f"({levels} levels, mean RRR set "
          f"{float(_colour_sizes(vis, 64).mean()):.1f} vertices)")


def run_q_phases(golden: dict, dev) -> dict:
    """Phases 10-13 (module docstring); returns the kernel's numbers."""
    from repro_torch.core import tiles

    check_q_golden(golden, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g_rev, tg, q8, reorder_s = _q_graph(Q_N, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    T2 = tg.tile_size ** 2
    q8_gib = q8.numel() / 2 ** 30
    print(f"[q graph] powerlaw_cluster({Q_N}, {Q_DEGREE}, p={Q_PROB}, seed "
          f"{Q_GRAPH_SEED}), deduped, cluster order ({reorder_s:.2f}s of host "
          f"time), reversed: {g_rev.num_edges} edges, {tg.num_tiles} tiles "
          f"({g_rev.num_edges / tg.num_tiles:.2f} edges per tile; ids up to "
          f"{tg.num_tiles - 1}, past the wrap at {2 ** 32 // T2}); q8 stack "
          f"{q8_gib:.2f} GiB; the float32 prob and int32 edge-id stacks "
          f"would take {tg.num_tiles * T2 * 8 / 2 ** 30:.2f} GiB (by "
          f"reckoning, not allocated); the graph (built on the host "
          f"beside the mesh world, where there is one) and the layout "
          f"ready in "
          f"{build_s:.2f}s; peak device memory {_peak_gib():.2f} GiB")
    slots = tiles.q_slot_list(tg, q8)
    _, counts = torch.unique(slots.key, return_counts=True)
    shared = counts[counts > 1].long()
    collide = dict(slots_sharing=int(shared.sum()),
                   pairs=int((shared * (shared - 1) // 2).sum()))
    print(f"[q graph] slot list: {slots.num_entries} slots with q > 0 "
          f"({slots.num_entries / tg.num_tiles:.2f} per tile, "
          f"{slots.nbytes / 2 ** 20:.2f} MiB); the uint32 cell counter gives "
          f"{counts.numel()} distinct cells: {collide['slots_sharing']} "
          f"slots share their cell with another, {collide['pairs']} pairs")
    del slots, counts, shared
    chk = check_q_kernel_full(tg, q8, dev)
    main = run_q_main_path(tg, q8, g_rev)
    torch.cuda.reset_peak_memory_stats()
    tim = time_q_kernel(tg, q8, g_rev)
    for grid, frontier, name in (("dense", "dense", "dense grid"),
                                 ("compact", "sparse", "compacted list")):
        ms, kern = main["batch0_ms"][frontier], float(np.sum(
            tim["level_ms"][grid]))
        print(f"[q timing] batch 0 end to end on the {name} {ms:.2f} ms "
              f"(main path); its levels' kernel times sum to {kern:.2f} ms "
              f"({kern / ms:.1%})")
    print(f"[q timing] peak device memory {_peak_gib():.2f} GiB")
    stats = check_q_statistics(g_rev, main["sizes"])
    # The p = 1 stack takes another 9 GiB: release the p = 0.25 one first.
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    check_q_p1(tg, g_rev)
    del tim["level_ms"]
    return dict(tim, launches=main["launches"]["fused_expand_q"],
                levels=main["levels"], batch_dense_ms=main["batch_dense_ms"],
                batch_compact_ms=main["batch_compact_ms"],
                plain_ms=chk["plain_ms"],
                max_abs_err=max(chk["max_abs_err"], tim["max_abs_err"]),
                reorder_s=reorder_s, num_tiles=tg.num_tiles, q8_gib=q8_gib,
                cell_collisions=collide, **stats)


# --------------------------------------------------------------- LM phases
def _flash_cases():
    """(name, B, Lq, Lk, H, KVH, D, causal, kv_offset) of the kernel
    checks: the main path's two shapes first, then maverick's (a group of
    5 query heads a KV head), zamba2's (head dim 80) and phi-3-vision's
    (96)."""
    cases = [("main prefill", 4, 2048, 2048, 24, 8, 128, True, 0),
             ("main decode", 4, 1, 2080, 24, 8, 128, True, 2079),
             ("maverick prefill", 4, 2048, 2048, 40, 8, 128, True, 0),
             ("maverick decode", 4, 1, 2080, 40, 8, 128, True, 2079),
             ("zamba2 prefill", 4, 2048, 2048, 32, 32, 80, True, 0),
             ("zamba2 decode", 4, 1, 2080, 32, 32, 80, True, 2079),
             ("phi prefill", 4, 2048, 2048, 32, 32, 96, True, 0),
             ("phi decode", 4, 1, 2080, 32, 32, 96, True, 2079)]
    for causal in (True, False):
        cases += [
            ("H/KVH 1, D 64", 2, 128, 128, 4, 4, 64, causal, 0),
            ("H/KVH 3, D 96, ragged", 2, 100, 100, 6, 2, 96, causal, 0),
            ("H/KVH 8, D 128, ragged Lk", 1, 130, 190, 8, 1, 128, causal, 60),
            ("H/KVH 3, D 192", 1, 65, 129, 6, 2, 192, causal, 64),
            ("H/KVH 1, D 16", 3, 33, 33, 4, 4, 16, causal, 0),
            ("decode, H/KVH 8, D 64", 2, 1, 77, 8, 1, 64, causal, 40),
            ("decode, H/KVH 3, D 128", 2, 1, 2080, 24, 8, 128, causal, 1500),
            ("H/KVH 3, D 64, ragged, 4 key blocks", 2, 200, 457, 6, 2, 64,
             causal, 257),
            ("decode, H/KVH 12, D 96", 1, 1, 300, 12, 1, 96, causal, 150),
            ("H/KVH 1, D 80, ragged", 2, 100, 140, 4, 4, 80, causal, 40),
            ("H/KVH 8, D 80, ragged Lk", 1, 130, 190, 8, 1, 80, causal, 60),
            ("H/KVH 8, D 96, ragged Lk", 1, 130, 190, 8, 1, 96, causal, 60),
            ("H/KVH 3, D 80, 4 key blocks", 2, 257, 457, 6, 2, 80, causal,
             17),
            ("H/KVH 5, D 96, 4 key blocks", 2, 257, 457, 10, 2, 96, causal,
             17),
            ("H/KVH 12, D 192", 1, 130, 130, 12, 1, 192, causal, 0),
            ("decode, H/KVH 12, D 192", 2, 1, 300, 96, 8, 192, causal, 150),
            ("H/KVH 12, D 192, 5 key blocks", 2, 257, 257, 24, 2, 192,
             causal, 0),
        ]
    return cases


def _flash_close(got, want, dtype, what: str) -> tuple[float, float]:
    """Hold a kernel's output against its plain version (in float32):
    float32 within F32_TOL max abs, bf16 within atol = rtol = BF16_TOL and
    a relative RMS difference within BF16_RMS_TOL; returns the largest
    absolute difference and the relative RMS difference."""
    diff = got.float() - want.float()
    worst = float(diff.abs().max())
    rrms = float(diff.square().mean().sqrt()
                 / want.float().square().mean().sqrt().clamp_min(1e-30))
    if dtype == torch.float32:
        _check(worst <= F32_TOL, f"{what}: max abs err {worst} > {F32_TOL}")
    else:
        bad = diff.abs() > BF16_TOL + BF16_TOL * want.float().abs()
        _check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements "
               f"outside atol = rtol = {BF16_TOL}")
        _check(rrms <= BF16_RMS_TOL, f"{what}: relative RMS difference "
               f"{rrms} > {BF16_RMS_TOL}")
    return worst, rrms


def check_flash(dev) -> dict:
    """flash_attention against its plain version on the card, through
    ``ops.flash_attention`` (which picks the route by shape); each decode
    case also against the split-K plain version cut at the kernel's own
    split.  Fails unless every route ran at least one case; returns the
    largest absolute difference per dtype (compared in float32), the
    largest bf16 relative RMS difference per route and the cases per
    route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    per_route = dict.fromkeys(fa.ROUTES, 0)
    rms = dict.fromkeys(fa.ROUTES, 0.0)
    n = 0
    for name, b, lq, lk, h, kvh, d, causal, off in _flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, lq, h, d), generator=gen, device=dev)
            k = torch.randn((b, lk, kvh, d), generator=gen, device=dev)
            v = torch.randn((b, lk, kvh, d), generator=gen, device=dev)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            r = fa.route(dtype, b, lq, lk, h, kvh, d, causal)
            # Every float32 prefill at D 64-192 on the tensor cores.
            _check(r == "tf32x3" or not (dtype == torch.float32 and lq > 1
                                          and d >= 64),
                   f"flash_attention {name}: float32 on route {r}")
            before = ops.LAUNCHES[f"flash_{r}"]
            got = ops.flash_attention(q, k, v, causal=causal, kv_offset=off)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           kv_offset=off)
            torch.cuda.synchronize()
            _check(ops.LAUNCHES[f"flash_{r}"] == before + 1,
                   f"flash_attention {name}: route {r} not launched")
            worst, rrms = _flash_close(got, want, dtype,
                                       f"flash_attention {r} {dtype} {name}")
            if r == "decode":
                chunk, _ = fa.decode_split(
                    b, kvh, h, fa.visible_keys(lk, causal, off), sms)
                split = ref.flash_decode_splitk_ref(
                    q, k, v, chunk=chunk, causal=causal, kv_offset=off)
                w2, r2 = _flash_close(got, split, dtype, f"flash_attention "
                                      f"decode {dtype} {name} against the "
                                      f"split-K plain version")
                worst, rrms = max(worst, w2), max(rrms, r2)
            err[dtype] = max(err[dtype], worst)
            if dtype == torch.bfloat16:
                rms[r] = max(rms[r], rrms)
            per_route[r] += 1
            n += 1
    missing = [r for r, c in per_route.items() if c == 0]
    _check(not missing, f"flash_attention: no case ran route(s) {missing}")
    print(f"[flash] {n} cases (f32 and bf16, causal and not, kv_offset 0 "
          f"and > 0, H/KVH 1/3/5/8/12, D 16-192 (bf16 prefill at 64-192 on "
          f"wgmma, float32 prefill there on tf32x3), "
          f"ragged Lq and Lk, the main "
          f"path's, maverick's, zamba2's (D 80) and phi-3-vision's (D 96) "
          f"prefill and decode shapes; decode also "
          f"against the "
          f"split-K plain version at its split) per route {per_route}: max "
          f"abs err f32 {err[torch.float32]:.3e} (limit {F32_TOL}), bf16 "
          f"{err[torch.bfloat16]:.3e} (atol = rtol = {BF16_TOL}); bf16 "
          f"relative RMS diff per route "
          + ", ".join(f"{r} {x:.3e}" for r, x in rms.items())
          + f" (limit {BF16_RMS_TOL})")
    return {"f32": err[torch.float32], "bf16": err[torch.bfloat16],
            "bf16_rrms": rms, "cases": per_route}


def _logit_errors(logits: torch.Tensor, gold: dict) -> tuple[float, int]:
    """Largest difference from the golden summary of (B, V) float32
    logits (audio's (B, K, V): a row a codebook), and the number of rows
    whose greedy token was checked."""
    lg = logits.double().reshape(-1, logits.shape[-1])
    ids = torch.as_tensor(gold["ids"], device=lg.device)
    got = {"logits_at_ids": lg[:, ids], "max": lg.max(-1).values,
           "lse": torch.logsumexp(lg, -1)}
    worst = 0.0
    for key, val in got.items():
        want = torch.as_tensor(gold[key], dtype=torch.float64,
                               device=lg.device)
        worst = max(worst, float((val - want).abs().max()))
    checked = 0
    argmax = lg.argmax(-1).tolist()
    for row, (a, want, gap) in enumerate(zip(argmax, gold["argmax"],
                                             gold["top2_gap"])):
        if gap > LM_TOL:
            _check(a == want, f"LM golden: greedy token {a} != {want} in row "
                   f"{row} (top-2 gap {gap})")
            checked += 1
    return worst, checked


def _flash_layers(cfg) -> int:
    """Layers that launch flash_attention once a forward and once a decode
    step: GQA blocks and ``mamba_attn`` layers (the shared block); MLA and
    ``mamba`` layers launch none."""
    from repro_torch.models import model

    if cfg.attention == "mla":
        return 0
    return sum(kind in ("dense", "moe", "mamba_attn")
               for kind in model.layer_kinds(cfg))


def _check_golden_model(gold: dict, cfg, dev, tag: str, tree) -> dict:
    """``cfg``'s model on the golden entry's weights (``tree``, drawn by
    `numpy_params`), prompt and teacher-forced tokens, float32 with TF32
    off, against the
    entry within LM_TOL, and every MoE call's expert picks equal to the
    entry's ``routes``; GQA layers (and ``mamba_attn`` layers' shared
    block) launch flash_attention on the tf32x3 route for the prefill
    (simt at a head dim no tensor-core route takes) and the decode route
    for each step, MLA and ``mamba`` layers none."""
    from repro_torch import convert
    from repro_torch.kernels import ops
    from repro_torch.models import mlp

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in full
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params = convert.lm_params_from_jax(tree, cfg, dev)
    del tree
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    prompt = torch.as_tensor(gold["prompt"], device=dev)
    steps = len(gold["decode"])
    picked, route = [], mlp._route

    def recording(router, xt, k, mesh=None):   # the port's picks, by call
        gate, idx, aux = route(router, xt, k, mesh)
        picked.append(idx.cpu())
        return gate, idx, aux

    mlp._route = recording
    try:
        worst, checked = _run_golden_model(gold, cfg, params, prompt, steps)
    finally:
        mlp._route = route
    torch.cuda.synchronize()
    picks = _check_routes(picked, gold.get("routes", []), tag)
    weights_gib = sum(t.numel() * t.element_size()
                      for t in params.parameters()) / 2 ** 30
    del params
    launches = ops.LAUNCHES["flash_attention"]
    routes = {r: ops.LAUNCHES[f"flash_{r}"]
              for r in ("tf32x3", "simt", "decode")}
    gqa = _flash_layers(cfg)
    _check(worst <= LM_TOL, f"{tag}: largest difference {worst} > {LM_TOL}")
    _check(launches == gqa * (1 + steps),
           f"{tag}: flash_attention launched {launches} times, not "
           f"{gqa * (1 + steps)}")
    # float32: the prefill on the tf32x3 route (simt below D 64), every
    # decode step on the decode route.
    pre = "tf32x3" if cfg.head_dim >= 64 else "simt"
    want = {"tf32x3": 0, "simt": 0, "decode": gqa * steps}
    want[pre] += gqa
    _check(routes == want, f"{tag}: routes launched {routes}, not {want}")
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers at full width "
          f"(d {cfg.d_model}, vocab {cfg.vocab_size}), float32, weights "
          f"{weights_gib:.2f} GiB loaded in {load_s:.1f}s: prefill "
          f"{tuple(prompt.shape)}"
          + (f" after {cfg.num_patches} patch embeddings"
             if "patch_seed" in gold else "")
          + f" and {steps} teacher-forced steps within "
          f"{worst:.3e} of the reference (limit {LM_TOL}); {checked} greedy "
          f"tokens equal; "
          + (f"{picks} expert picks equal; " if picks else "")
          + f"flash launches {launches} ({routes}); peak device memory "
          f"{_peak_gib():.2f} GiB")
    return {"max_abs_err": worst, "launches": launches, "load_s": load_s,
            "expert_picks": picks}


def _run_golden_model(gold: dict, cfg, params, prompt, steps: int):
    """The golden entry's prefill (a VLM entry's seeded patch embeddings
    before its prompt; an audio entry's (B, K, Lp) prompt) and
    teacher-forced steps; returns the largest logit difference and the
    greedy tokens checked."""
    from repro_torch.models import decode, init
    from repro_torch.serve import engine

    batch, positions = {"tokens": prompt}, prompt.shape[-1]
    if "patch_seed" in gold:
        batch["patch_embeds"] = torch.from_numpy(init.numpy_patch_embeds(
            cfg, gold["patch_seed"], prompt.shape[0])).to(prompt.device)
        positions += cfg.num_patches
    with torch.inference_mode():
        last, caches, _ = engine.prefill(params, cfg, batch,
                                         positions + steps)
        worst, checked = _logit_errors(last[:, -1].float(),
                                       {"ids": gold["vocab_ids"],
                                        **gold["prefill"]})
        for st in gold["decode"]:
            # (B, 1), or audio's (B, K, 1): every codebook's token.
            tok = torch.as_tensor(st["tokens"],
                                  device=prompt.device)[..., None]
            lg, caches = decode.decode_step(params, cfg, caches, tok,
                                            st["cur_len"])
            w, c = _logit_errors(lg[:, -1].float(),
                                 {"ids": gold["vocab_ids"], **st})
            worst, checked = max(worst, w), checked + c
    return worst, checked


def _check_routes(got: list, want: list, tag: str) -> int:
    """The port's expert picks (one (tokens, k) tensor per MoE call) equal
    the golden's, call for call; returns the picks compared."""
    _check(len(got) == len(want), f"{tag}: {len(got)} MoE calls, the "
           f"reference made {len(want)}")
    for call, (g, w) in enumerate(zip(got, want)):
        w = torch.as_tensor(w)
        bad = (g != w).nonzero()
        _check(g.shape == w.shape and not len(bad),
               f"{tag}: MoE call {call} picks other experts than the "
               f"reference, first at (token, slot) "
               f"{bad[0].tolist() if len(bad) else None}")
    return sum(len(w) * len(w[0]) for w in want)


def check_lm_golden(golden: dict, dev) -> dict:
    """llama3.2-3b at full width, 2 layers, float32, on the golden file's
    weights (`numpy_params`), prompt and teacher-forced tokens."""
    from repro_torch.configs import registry

    from repro_torch.models import init

    gold = golden["lm"]
    cfg = dataclasses.replace(registry.get(gold["arch"]),
                              num_layers=gold["num_layers"],
                              dtype=gold["dtype"])
    t0 = time.perf_counter()
    tree = _tree(cfg, gold["param_seed"], keep=True)
    print(f"[lm golden] weights drawn, or waited for, in "
          f"{time.perf_counter() - t0:.1f}s")
    return _check_golden_model(gold, cfg, dev, "lm golden", tree)


def check_golden_entries(entries: dict, dev, tag: str) -> dict:
    """Golden entries of models at full width, cut in depth (and experts),
    float32 (the ``"moe"`` and ``"ssm"`` entries): each model as
    `check_lm_golden` checks llama, every expert pick equal to the
    reference's.  numpy draws the entries' weights (up to ~13 GB each;
    an SSD entry's per-head parameters redrawn by `numpy_ssm_heads`) in
    threads of their own, at once (its draws release the interpreter
    lock), while the card checks the first."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import registry
    from repro_torch.models import init

    cfgs = {}
    for name, gold in entries.items():
        cuts = {k: v for k, v in gold["cuts"].items() if k != "arch"}
        cfgs[name] = dataclasses.replace(registry.get(gold["arch"]), **cuts)

    def draw(name):
        return _tree(cfgs[name], entries[name]["param_seed"],
                     entries[name].get("ssm_heads_seed"))

    t0 = time.perf_counter()
    out = {}
    with ThreadPoolExecutor(len(cfgs)) as pool:
        trees = {name: pool.submit(draw, name) for name in cfgs}
        for name, cfg in cfgs.items():
            gold = entries[name]
            tree = trees.pop(name).result()
            print(f"[{tag} {name}] cuts {gold['cuts']}; weights drawn "
                  f"{time.perf_counter() - t0:.1f}s after the draws began"
                  + (f"; the reference's router margin (nearest tie "
                     f"between the k-th and (k+1)-th expert) "
                     f"{gold['router_margin']:.3e} over "
                     f"{gold['moe_calls']} MoE calls"
                     if "router_margin" in gold else ""))
            out[name] = _check_golden_model(gold, cfg, dev,
                                            f"{tag} {name}", tree)
            del tree
            if "router_margin" in gold:
                out[name]["router_margin"] = gold["router_margin"]
            _release(f"{tag} {name}")
    return out


def check_lm_bf16(dev, arch: str = LM_ARCH, layers: int = LM_BF16_LAYERS,
                  tag: str = "lm bf16", patches: bool = False) -> dict:
    """``arch`` at full width, ``layers`` layers, bf16, the port's seeded
    init: the prefill logits of LM_BF16_BATCH prompts of LM_BF16_PROMPT
    positions (with ``patches``, the config's seeded patch embeddings,
    then tokens) through the kernels (the wgmma route: llama at head dim
    128, zamba2 at 80, phi-3-vision at 96) against the same forward with
    ``ops.flash_attention`` patched, for that one forward, to the plain
    version (float32 inside, bf16 out); limits LM_BF16_MAX_TOL (max abs)
    and LM_BF16_MEAN_TOL (mean abs), greedy tokens equal where the plain
    run's top-2 gap exceeds 2 x LM_BF16_MAX_TOL."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init, model

    cfg = dataclasses.replace(registry.get(arch), num_layers=layers,
                              dtype="bfloat16")
    if not patches:
        cfg = dataclasses.replace(cfg, num_patches=0)
    route = fa.route(torch.bfloat16, LM_BF16_BATCH, LM_BF16_PROMPT,
                     LM_BF16_PROMPT, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, True)
    params = model.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size,
        (LM_BF16_BATCH, LM_BF16_PROMPT - cfg.num_patches))).to(dev)}
    if cfg.num_patches:
        batch["patch_embeds"] = torch.from_numpy(init.numpy_patch_embeds(
            cfg, 0, LM_BF16_BATCH)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.inference_mode():
        got = model.forward(params, cfg, batch)[0]
        torch.cuda.synchronize()
        launches = ops.LAUNCHES[f"flash_{route}"]
        kernel = ops.flash_attention
        ops.flash_attention = ref.flash_attention_ref
        try:
            want = model.forward(params, cfg, batch)[0]
        finally:
            ops.flash_attention = kernel
        worst, total, checked = 0.0, 0.0, 0
        for row in range(LM_BF16_BATCH):
            g, w = got[row].float(), want[row].float()
            diff = (g - w).abs()
            worst = max(worst, float(diff.max()))
            total += float(diff.sum())
            top2 = w.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_BF16_MAX_TOL
            _check(bool((g.argmax(-1) == w.argmax(-1))[sure].all()),
                   f"{tag}: a greedy token differs in row {row} where "
                   f"the top-2 gap exceeds {2 * LM_BF16_MAX_TOL}")
            checked += int(sure.sum())
        mean = total / got.numel()
        spread = float(want.float().std())
    torch.cuda.synchronize()
    del params
    _check(launches == _flash_layers(cfg), f"{tag}: {route} route launched "
           f"{launches} times, not {_flash_layers(cfg)}")
    _check(worst <= LM_BF16_MAX_TOL and mean <= LM_BF16_MEAN_TOL,
           f"{tag}: logits differ by max {worst}, mean {mean} (limits "
           f"{LM_BF16_MAX_TOL}, {LM_BF16_MEAN_TOL})")
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers at full width, "
          f"bf16, batch {LM_BF16_BATCH} x prompt {LM_BF16_PROMPT}"
          + (f" ({cfg.num_patches} patch embeddings, then tokens)"
             if cfg.num_patches else "") + ": prefill "
          f"logits through the {route} route ({launches} launches, head "
          f"dim {cfg.head_dim}) against "
          f"plain attention: max abs diff {worst:.4e} (limit "
          f"{LM_BF16_MAX_TOL}), mean {mean:.4e} (limit {LM_BF16_MEAN_TOL}),"
          f" logit spread {spread:.3f}; {checked} greedy tokens checked "
          f"equal; peak device memory {_peak_gib():.2f} GiB")
    return {"max_abs_err": worst, "mean_abs_err": mean, "route": route,
            "launches": launches}


def run_lm_main_path() -> dict:
    """llama3.2-3b at full width through the launcher, request mixes (a)
    and (b); returns each run's numbers and the flash launches of both."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    out = {}
    ops.reset_launches()
    for mix, (prompt_len, temp) in LM_MIXES.items():
        before = dict(ops.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        r = serve.run(serve.parse_args([
            "--arch", LM_ARCH, "--device", "cuda", "--batch", str(LM_BATCH),
            "--prompt-len", str(prompt_len), "--new-tokens", str(LM_NEW),
            "--temperature", str(temp)]))
        torch.cuda.synchronize()
        cfg, tokens = r["cfg"], r["tokens"]
        launches = ops.LAUNCHES["flash_attention"] \
            - before["flash_attention"]
        routes = {r: ops.LAUNCHES[f"flash_{r}"] - before[f"flash_{r}"]
                  for r in ("wgmma", "decode", "simt")}
        want = cfg.num_layers * (1 + LM_NEW)
        # bf16: each layer's prefill on the wgmma route, each decode step
        # on the decode route.
        want_routes = {"wgmma": cfg.num_layers,
                       "decode": cfg.num_layers * LM_NEW, "simt": 0}
        _check(r["finite"], f"LM ({mix}): non-finite logits")
        _check(tokens.shape == (LM_BATCH, LM_NEW)
               and int(tokens.min()) >= 0
               and int(tokens.max()) < cfg.vocab_size,
               f"LM ({mix}): tokens malformed")
        _check(launches == want, f"LM ({mix}): flash_attention launched "
               f"{launches} times, not {want}")
        _check(routes == want_routes, f"LM ({mix}): routes launched "
               f"{routes}, not {want_routes}")
        out[mix] = dict(prompt_len=prompt_len, temperature=temp,
                        prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                        decode_ms=r["decode_ms_per_step"],
                        prefill_tok_s=LM_BATCH * prompt_len / r["prefill_s"],
                        decode_tok_s=LM_BATCH * LM_NEW / r["decode_s"],
                        launches=launches, routes=routes,
                        peak_gib=_peak_gib())
        m = out[mix]
        print(f"[lm main {mix}] {cfg.name} ({cfg.num_layers} layers, "
              f"{cfg.dtype}, {cfg.param_count() / 1e9:.3f} B parameters): "
              f"batch {LM_BATCH}, prompt {prompt_len}, {LM_NEW} new tokens "
              f"at temperature {temp}: prefill {m['prefill_s']:.4f}s "
              f"({m['prefill_tok_s']:.0f} tokens/s), decode "
              f"{m['decode_ms']:.3f} ms/step ({m['decode_tok_s']:.1f} "
              f"tokens/s); flash launches {launches} {routes}; peak "
              f"device memory {m['peak_gib']:.2f} GiB; tokens[0][:8] "
              f"{tokens[0, :8].tolist()}")
    out["launches"] = dict(ops.LAUNCHES)
    print(f"[lm main] launches over (a) and (b): {out['launches']}")
    return out


def _serve_mix(arch: str, mix: str, want: dict, cfg=None):
    """Serve one request batch of mix ``mix`` (LM_MIXES, batch LM_BATCH,
    LM_NEW new tokens; audio: every codebook's) through the launcher:
    ``arch``'s own config by `run`, or ``cfg`` (a depth cut) by
    `serve_config`; counters as in 4.
    Fails unless the logits are finite, the tokens in range, the flash
    launches ``want`` and the peak under the card's memory; returns (the
    run's numbers, the launches, peak device GiB)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    prompt_len, temp = LM_MIXES[mix]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    args = serve.parse_args([
        "--arch", arch, "--device", "cuda", "--batch", str(LM_BATCH),
        "--prompt-len", str(prompt_len), "--new-tokens", str(LM_NEW),
        "--temperature", str(temp)])
    r = serve.run(args) if cfg is None else serve.serve_config(cfg, args)
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in want}
    tokens, peak = r["tokens"], _peak_gib()
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    books = r["cfg"].num_codebooks
    _check(r["finite"], f"{arch} ({mix}): non-finite logits")
    _check(tokens.shape == ((LM_BATCH, books, LM_NEW) if books
                            else (LM_BATCH, LM_NEW))
           and int(tokens.min()) >= 0
           and int(tokens.max()) < r["cfg"].vocab_size,
           f"{arch} ({mix}): tokens malformed")
    _check(launches == want, f"{arch} ({mix}): launches {launches}, not "
           f"{want}")
    _check(peak < card, f"{arch} ({mix}): peak {peak} GiB")
    return r, launches, peak


def _serve_cut(arch: str, cuts: dict, mixes, tag: str) -> dict:
    """``arch`` at full width cut by ``cuts``, bf16, the port's seeded
    init, through the launcher's `serve_config` with each request mix of
    ``mixes`` (LM_MIXES): each attention layer's prefill on the wgmma
    route, its decode steps on ``decode``, none on simt (counters as in
    4); prints the ``[tag mix]`` lines."""
    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get(arch), **cuts)
    n = _flash_layers(cfg)
    want = {"flash_attention": n * (1 + LM_NEW), "flash_wgmma": n,
            "flash_decode": n * LM_NEW, "flash_simt": 0}
    out = {}
    for mix in mixes:
        prompt_len, temp = LM_MIXES[mix]
        r, launches, peak = _serve_mix(arch, mix, want, cfg)
        out[mix] = m = dict(
            prefill_s=r["prefill_s"], decode_ms=r["decode_ms_per_step"],
            prefill_tok_s=LM_BATCH * prompt_len / r["prefill_s"],
            weights_gib=r["param_bytes"] / 2 ** 30, launches=launches,
            peak_gib=peak)
        print(f"[{tag} {mix}] {cfg.name} cut to {cuts} (d {cfg.d_model}, "
              f"d_ff {cfg.d_ff}, {cfg.num_heads} heads over "
              f"{cfg.num_kv_heads} of {cfg.head_dim}"
              + (", QKV bias" if cfg.qkv_bias else "")
              + f"), bf16, {m['weights_gib']:.2f} GiB of weights: batch "
              f"{LM_BATCH}, prompt {prompt_len}, {LM_NEW} new tokens at "
              f"temperature {temp}: prefill {m['prefill_s']:.4f}s "
              f"({m['prefill_tok_s']:.0f} tokens/s), decode "
              f"{m['decode_ms']:.3f} ms/step; flash launches {launches}; "
              f"peak device memory {peak:.2f} GiB")
        del r
        _release(f"{tag} {arch} ({mix})")
    return out


def run_nemotron_serving() -> dict:
    """The nemotron cut (TRAIN_FAMILY_CUTS: its published attention, 96
    heads over 8 of 192) served with request mix (b) through `_serve_cut`:
    each layer's prefill on the wgmma route at D 192."""
    arch = "nemotron-4-340b"
    return _serve_cut(arch, TRAIN_FAMILY_CUTS[arch], "b",
                      "nemotron main")["b"]


def run_dense_main_path() -> dict:
    """[dense main]: each of DENSE_MAIN (qwen1.5-110b with its QKV bias,
    command-r-35b) at full width cut to 2 layers through `_serve_cut` with
    mixes (a) and (b), one model on the card at a time: 2 wgmma + 2 x 32
    decode a request batch, 0 simt."""
    return {arch: _serve_cut(arch, cuts, LM_MIXES, "dense main")
            for arch, cuts in DENSE_MAIN.items()}


def run_moe_main_path() -> dict:
    """deepseek-v3 and llama4-maverick at full width with their depth cut
    (MOE_MAIN), bf16, the port's seeded init, through the launcher's
    `serve_config`, each with request mixes (a) and (b), one model on the
    card at a time.  Counters as in 4 for each request batch: maverick's
    two GQA layers launch 2 wgmma + 2 × 32 decode, deepseek's MLA none."""
    from repro_torch.configs import registry
    from repro_torch.models import mlp, model

    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    out = {}
    for arch, layers in MOE_MAIN.items():
        cfg = dataclasses.replace(registry.get(arch), num_layers=layers,
                                  num_patches=0)
        kinds = model.layer_kinds(cfg)
        gqa = _flash_layers(cfg)
        fe = cfg.moe_d_ff or cfg.d_ff
        # Every expert's weights, bf16, in every MoE layer: a decode step's
        # bmm reads them all whenever the capacity is at least 1.
        expert_bytes = kinds.count("moe") * cfg.num_experts \
            * (3 if cfg.gated_mlp else 2) * cfg.d_model * fe * 2
        want = {"flash_attention": gqa * (1 + LM_NEW), "flash_wgmma": gqa,
                "flash_decode": gqa * LM_NEW, "flash_simt": 0}
        res = {}
        for mix, (prompt_len, temp) in LM_MIXES.items():
            r, launches, peak = _serve_mix(arch, mix, want, cfg)
            tokens = r["tokens"]
            m = dict(prompt_len=prompt_len, temperature=temp,
                     prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                     decode_ms=r["decode_ms_per_step"],
                     prefill_tok_s=LM_BATCH * prompt_len / r["prefill_s"],
                     expert_bound_ms=1e3 * expert_bytes / HBM_BYTES_PER_S,
                     weights_bound_ms=1e3 * r["param_bytes"]
                     / HBM_BYTES_PER_S,
                     weights_gib=r["param_bytes"] / 2 ** 30,
                     prefill_capacity=mlp.capacity(LM_BATCH * prompt_len,
                                                   cfg),
                     decode_capacity=mlp.capacity(LM_BATCH, cfg),
                     launches=launches, peak_gib=peak)
            res[mix] = m
            print(f"[moe main {mix}] {cfg.name}: {cfg.num_layers} layers "
                  f"({'/'.join(kinds)}) at full width, {cfg.dtype}, "
                  f"{r['param_bytes'] / 2 ** 30:.2f} GiB of weights "
                  f"(param_count {cfg.param_count() / 1e9:.3f} B); batch "
                  f"{LM_BATCH}, prompt {prompt_len}, {LM_NEW} new tokens at "
                  f"temperature {temp}: prefill {m['prefill_s']:.4f}s "
                  f"({m['prefill_tok_s']:.0f} tokens/s), decode "
                  f"{m['decode_ms']:.3f} ms/step against "
                  f"{m['expert_bound_ms']:.3f} ms to read every expert "
                  f"once ({expert_bytes / 1e9:.2f} GB at 3.35 TB/s; all "
                  f"weights {m['weights_bound_ms']:.3f} ms); capacity per "
                  f"MoE layer {m['prefill_capacity']} rows an expert at "
                  f"prefill, {m['decode_capacity']} at decode "
                  f"({cfg.num_experts} experts, top-{cfg.top_k}); flash "
                  f"launches {launches}; peak device memory {peak:.2f} GiB "
                  f"of {card:.2f}; tokens[0][:8] {tokens[0, :8].tolist()}")
            del r, tokens
            _release(f"{arch} ({mix})")
        if cfg.attention == "mla":
            latent = (cfg.kv_lora_rank + cfg.rope_head_dim) * 2
            full = cfg.num_heads * (cfg.head_dim + cfg.rope_head_dim
                                    + (cfg.v_head_dim or cfg.head_dim)) * 2
            res["cache_bytes_per_token_layer"] = latent
            res["gqa_bytes_per_token_layer"] = full
            print(f"[moe main] {cfg.name}: the MLA latent cache holds "
                  f"{latent} bytes a token a layer (c {cfg.kv_lora_rank} + "
                  f"k_rope {cfg.rope_head_dim}, bf16), against {full} for "
                  f"K ({cfg.head_dim + cfg.rope_head_dim}) and V "
                  f"({cfg.v_head_dim or cfg.head_dim}) of {cfg.num_heads} "
                  f"heads: {full / latent:.1f}x smaller")
        out[arch] = res
    return out


def _step_bytes(cfg, param_bytes: int, batch: int, kv_len: float) -> dict:
    """The bytes a bf16 decode step of ``cfg`` must move, by part: every
    weight but the embedding (one row a token, a codebook, is read), the
    shared block again for each ``mamba_attn`` invocation after the first,
    each mamba layer's state (float32) and conv tail read and written, and
    each attention layer's (each ``mamba_attn`` invocation's) K and V read
    over ``kv_len`` positions."""
    from repro_torch.models import model

    kinds = model.layer_kinds(cfg)
    d = cfg.d_model
    invocations = kinds.count("mamba_attn")
    shared = 2 * (2 * d + cfg.head_dim * d * (cfg.num_heads
                                              + 2 * cfg.num_kv_heads)
                  + cfg.num_heads * cfg.head_dim * d
                  + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff) \
        if invocations else 0
    mamba = sum(kind in model.MAMBA_KINDS for kind in kinds)
    state = 0
    if mamba:
        di, S, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        state = 2 * batch * (H * S * (di // H) * 4
                             + (cfg.conv_width - 1) * (di + 2 * S) * 2)
    parts = {"weights": param_bytes
             - max(cfg.num_codebooks, 1) * cfg.vocab_size * d * 2,
             "shared_again": max(invocations - 1, 0) * shared,
             "ssm_state": mamba * state,
             "kv_read": int(_flash_layers(cfg) * batch * kv_len * 2
                            * cfg.num_kv_heads * cfg.head_dim * 2)}
    return dict(parts, total=sum(parts.values()))


def _serve_full_depth(arch: str, tag: str) -> dict:
    """``arch`` at full width and full depth, bf16, the port's seeded
    init, through the launcher's `run` with request mixes (a) and (b).
    Counters as in 4 for each request batch: each attention layer (each
    ``mamba_attn`` invocation) launches 1 wgmma + LM_NEW decode, 0 simt.
    Prints the ``[tag a|b]`` lines: prefill tokens/s, decode ms a step
    beside the time to move the step's bytes once (`_step_bytes`), peak
    device memory."""
    from repro_torch.configs import registry

    cfg = registry.get(arch)
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    n_attn = _flash_layers(cfg)
    want = {"flash_attention": n_attn * (1 + LM_NEW), "flash_wgmma": n_attn,
            "flash_decode": n_attn * LM_NEW, "flash_simt": 0}
    res = {}
    for mix, (prompt_len, temp) in LM_MIXES.items():
        r, launches, peak = _serve_mix(arch, mix, want)
        tokens = r["tokens"]
        _check(r["cfg"].num_layers == cfg.num_layers,
               f"{arch} ({mix}): depth {r['cfg'].num_layers}")
        step = _step_bytes(r["cfg"], r["param_bytes"], LM_BATCH,
                           prompt_len + (LM_NEW + 1) / 2)
        m = dict(prompt_len=prompt_len, temperature=temp,
                 prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                 decode_ms=r["decode_ms_per_step"],
                 prefill_tok_s=LM_BATCH * prompt_len / r["prefill_s"],
                 step_bytes=step,
                 bound_ms=1e3 * step["total"] / HBM_BYTES_PER_S,
                 weights_gib=r["param_bytes"] / 2 ** 30,
                 launches=launches, peak_gib=peak)
        res[mix] = m
        print(f"[{tag} {mix}] {cfg.name}: {cfg.num_layers} layers "
              f"({n_attn} attention) at full width, {cfg.dtype}, {m['weights_gib']:.2f} GiB of weights "
              f"(param_count {cfg.param_count() / 1e9:.3f} B); batch "
              f"{LM_BATCH}, prompt {prompt_len}, {LM_NEW} new tokens at "
              f"temperature {temp}: prefill {m['prefill_s']:.4f}s "
              f"({m['prefill_tok_s']:.0f} tokens/s), decode "
              f"{m['decode_ms']:.3f} ms/step against "
              f"{m['bound_ms']:.3f} ms to move the step's "
              f"{step['total'] / 1e9:.3f} GB once at 3.35 TB/s "
              f"(weights but the embedding "
              f"{step['weights'] / 1e9:.3f}, the shared block again "
              f"{step['shared_again'] / 1e9:.3f}, SSD state and tail "
              f"read and written {step['ssm_state'] / 1e9:.3f}, KV read "
              f"{step['kv_read'] / 1e9:.3f}); flash launches "
              f"{launches}; peak device memory {peak:.2f} GiB of "
              f"{card:.2f}; tokens[0][:8] "
              f"{tokens[0].reshape(-1)[:8].tolist()}")
        del r, tokens
        _release(f"{arch} ({mix})")
    return res


def run_ssm_main_path() -> dict:
    """mamba2-1.3b and zamba2-2.7b through `_serve_full_depth`, one model
    on the card at a time: mamba2 launches no flash_attention, zamba2's 9
    shared-block invocations 9 wgmma (bf16 at head dim 80) + 9 × 32
    decode a request batch."""
    return {arch: _serve_full_depth(arch, "ssm main") for arch in SSM_MAIN}


def run_vlm_main_path(dev) -> dict:
    """phi-3-vision-4.2b through `_serve_full_depth` (the launcher turns
    its patches off, as the reference's does): 32 wgmma + 32 × 32 decode a
    request batch; then (c), a prefill of VLM_ARCH's seeded patch
    embeddings and tokens, (b)'s prompt length of positions in all,
    through ``engine.prefill`` and VLM_STEPS greedy decode steps: 32 wgmma,
    then 32 decode a step, finite logits, tokens in the vocabulary
    (counters as in 4)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import decode, init, model
    from repro_torch.serve import engine

    out = _serve_full_depth(VLM_ARCH, "vlm main")
    cfg = registry.get(VLM_ARCH)
    n_attn = _flash_layers(cfg)
    keys = ("flash_attention", "flash_wgmma", "flash_decode", "flash_simt")
    positions = LM_MIXES["b"][0]
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, seed=serve.PARAM_SEED, device=dev)
    rng = np.random.default_rng(serve.PROMPT_SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, positions - cfg.num_patches))).to(dev)
    patches = torch.from_numpy(init.numpy_patch_embeds(
        cfg, VLM_PATCH_SEED, LM_BATCH)).to(dev)
    ops.reset_launches()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, plen = engine.prefill(
            params, cfg, {"tokens": tokens, "patch_embeds": patches},
            positions + VLM_STEPS)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        at_prefill = {k: ops.LAUNCHES[k] for k in keys}
        finite = torch.isfinite(logits).all()
        picked = []
        for i in range(VLM_STEPS):
            tok = logits[:, -1].argmax(-1)[:, None]
            picked.append(tok)
            logits, caches = decode.decode_step(params, cfg, caches, tok,
                                                plen + i)
            finite &= torch.isfinite(logits).all()
        picked = torch.cat(picked, 1)
        torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in keys}
    peak = _peak_gib()
    del params, caches, logits
    want_prefill = {"flash_attention": n_attn, "flash_wgmma": n_attn,
                    "flash_decode": 0, "flash_simt": 0}
    want_all = {"flash_attention": n_attn * (1 + VLM_STEPS),
                "flash_wgmma": n_attn, "flash_decode": n_attn * VLM_STEPS,
                "flash_simt": 0}
    _check(plen == positions, f"vlm (c): prefill of {plen} positions, not "
           f"{positions}")
    _check(at_prefill == want_prefill and launches == want_all,
           f"vlm (c): launches {at_prefill} at the prefill and {launches} "
           f"after it, not {want_prefill} and {want_all}")
    _check(bool(finite), "vlm (c): non-finite logits")
    _check(int(picked.min()) >= 0 and int(picked.max()) < cfg.vocab_size,
           "vlm (c): tokens outside the vocabulary")
    out["c"] = dict(positions=positions, patches=cfg.num_patches,
                    prefill_s=prefill_s,
                    prefill_pos_s=LM_BATCH * positions / prefill_s,
                    steps=VLM_STEPS, launches=launches, peak_gib=peak)
    print(f"[vlm main c] {cfg.name}: batch {LM_BATCH}, {cfg.num_patches} "
          f"seeded patch embeddings of {model.PATCH_EMBED_DIM} (float32, "
          f"projected in float32, cast to {cfg.dtype}) then "
          f"{positions - cfg.num_patches} tokens, {positions} positions, "
          f"through engine.prefill in {prefill_s:.4f}s "
          f"({out['c']['prefill_pos_s']:.0f} positions/s), then "
          f"{VLM_STEPS} greedy decode steps at cur_len {plen}..."
          f"{plen + VLM_STEPS - 1}: logits finite, tokens in the vocabulary "
          f"(tokens[0] {picked[0].tolist()}); flash launches {at_prefill} "
          f"at the prefill, {launches} in all; peak device memory "
          f"{peak:.2f} GiB")
    return out


def run_moe_a2a_phase(golden: dict, worlds: dict) -> dict:
    """The expert-parallel MoE on the 2x2 gloo world of 4 ranks sharing
    card 0 (`mesh_smoke.rank_moe_a2a`, a job of `run_worlds`): every
    rank's gathered output against the golden ``"moe_a2a"`` entry within
    MOE_A2A_TOL (values at 256 indices, aux, the magnitude sum relative),
    and at capacity factor 64 against the one-device scatter."""
    gold = golden["moe_a2a"]
    ranks = worlds["ranks"]["moe_a2a"]
    seconds = worlds["jobs_s"]["moe_a2a"]
    want = np.asarray(gold["values"])
    worst = 0.0
    for r in ranks:
        _check(r["routes_equal"], f"moe a2a: rank {r['rank']} picks other "
               f"experts than the reference")
        err = max(float(np.abs(r["values"] - want).max()),
                  abs(r["aux"] - gold["aux"]),
                  abs(r["abs_sum"] - gold["abs_sum"]) / gold["abs_sum"])
        _check(err <= MOE_A2A_TOL, f"moe a2a: rank {r['rank']} differs from "
               f"the reference by {err} (limit {MOE_A2A_TOL})")
        worst = max(worst, err)
    cf64 = ranks[0]["cf64_max_abs_diff"]
    _check(cf64 <= MOE_A2A_TOL, f"moe a2a: at capacity factor 64 the a2a "
           f"differs from the one-device scatter by {cf64}")
    r0 = ranks[0]
    print(f"[moe a2a] {gold['arch']} widths, {gold.get('overrides', {})}, "
          f"float32, "
          f"2 x {gold['seq']} tokens on a 2x2 {r0['backend']} world sharing "
          f"the card ({seconds:.1f}s, a job of the mesh world): every rank "
          f"within {worst:.3e} of the reference's a2a (limit "
          f"{MOE_A2A_TOL}; aux {r0['aux']:.6f}, golden {gold['aux']:.6f}), "
          f"every expert pick the reference's (router margin "
          f"{gold['router_margin']:.3e}); "
          f"capacity {r0['capacity']} rows an expert for {r0['tokens']} "
          f"tokens a rank; at capacity factor 64 within {cf64:.3e} of the "
          f"one-device scatter; per rank: one all-to-all of "
          f"{r0['a2a_bytes']} bytes takes "
          + ", ".join(f"{r['a2a_ms']:.3f}" for r in ranks)
          + f" ms (host clock, staged through the host), the layer made "
          f"{r0['model_stats']['model']['calls']} calls over model "
          f"({r0['model_stats']['model']['bytes']} bytes), "
          f"{r0['staged_bytes']} bytes staged; peak "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB")
    return {"max_abs_err": worst, "cf64_max_abs_diff": cf64,
            "a2a_ms": [r["a2a_ms"] for r in ranks],
            "a2a_bytes": r0["a2a_bytes"], "seconds": seconds}


def time_flash(dev) -> dict:
    """At (b)'s prefill and decode shapes (bf16), llama3.2-3b's (H 24, KVH
    8, D 128), zamba2's (H = KVH 32, D 80) and phi-3-vision's (H = KVH 32,
    D 96), and at nemotron's train_4k prefill (B 1, L 4096, H 96, KVH 8,
    D 192): the route the main path takes there and the simt route (the
    CUDA-core design, the earlier one at D 80 and 96) from CUDA graphs of
    10 launches, the plain version (CUDA events), and SDPA both from a
    CUDA graph of 10 launches like the kernels and with events around one
    eager call; each beside the function's bound on this card."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(1)
    causal = True
    lp = LM_MIXES["b"][0]
    nb, nl, nh, nkvh, nd = BWD_TIMED_SHAPES["nemotron"]
    per = {}
    for shape, b, h, kvh, d, lq, lk, off in (
            ("prefill", LM_BATCH, 24, 8, 128, lp, lp, 0),
            ("decode", LM_BATCH, 24, 8, 128, 1, lp + LM_NEW,
             lp + LM_NEW - 1),
            ("zamba2_prefill", LM_BATCH, 32, 32, 80, lp, lp, 0),
            ("zamba2_decode", LM_BATCH, 32, 32, 80, 1, lp + LM_NEW,
             lp + LM_NEW - 1),
            ("phi_prefill", LM_BATCH, 32, 32, 96, lp, lp, 0),
            ("phi_decode", LM_BATCH, 32, 32, 96, 1, lp + LM_NEW,
             lp + LM_NEW - 1),
            ("nemotron_prefill", nb, nh, nkvh, nd, nl, nl, 0)):
        q = torch.randn((b, lq, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, lk, kvh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, lk, kvh, d), generator=gen, device=dev).bfloat16()
        scale = d ** -0.5
        main_route = fa.route(torch.bfloat16, b, lq, lk, h, kvh, d, causal)

        def kernel(r):
            return lambda: fa.CUDA_ROUTES[r](q, k, v, causal=causal,
                                             scale=scale, kv_offset=off)

        def plain():
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           kv_offset=off)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # Every key is visible at decode (kv_offset = Lk - 1): no mask.
        sdpa_causal = causal and lq == lk

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=sdpa_causal, enable_gqa=True)

        want = plain()
        errs = {r: float((kernel(r)().float() - want.float()).abs().max())
                for r in dict.fromkeys((main_route, "simt"))}
        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        del want
        ms = {r: _kernel_ms(kernel(r))
              for r in dict.fromkeys((main_route, "simt"))}
        plain_ms = _time_ms(plain, 3)
        lib_graph_ms = _kernel_ms(library)
        lib_eager_ms = _time_ms(library, 20)
        # Visible (query, key) pairs; 4·D operations each (two products).
        pairs = sum(min(lk, i + off + 1) for i in range(lq)) if causal \
            else lq * lk
        ops_ms = 1e3 * 4 * b * h * pairs * d / BF16_FLOPS_PER_S
        bytes_ms = 1e3 * 2 * (2 * b * lq * h * d + 2 * b * lk * kvh * d) \
            / HBM_BYTES_PER_S
        per[shape] = dict(
            route=main_route, ms=ms[main_route], simt_ms=ms["simt"],
            plain_ms=plain_ms, library_ms=lib_graph_ms,
            library_eager_ms=lib_eager_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            max_abs_err=errs[main_route], simt_max_abs_err=errs["simt"])
        t = per[shape]
        print(f"[timing flash] {shape} (B {b}, Lq {lq}, Lk {lk}, H {h}, KVH "
              f"{kvh}, D {d}, bf16, kv_offset {off}): {main_route} route "
              f"{t['ms']:.4f} ms"
              + (f", simt route {t['simt_ms']:.4f} ms"
                 if main_route != "simt" else "")
              + f" (CUDA graphs of 10), plain {plain_ms:.4f} ms, SDPA "
              f"{lib_graph_ms:.4f} ms from a CUDA graph of 10 and "
              f"{lib_eager_ms:.4f} ms with events around one eager call "
              f"(its max abs diff from plain {lib_err:.3e}); bound "
              f"{t['bound_ms']:.6f} ms by {t['bound_by']} ({ops_ms:.6f} "
              f"operations, {bytes_ms:.6f} bytes); max abs err from plain "
              + ", ".join(f"{r} {e:.3e}" for r, e in errs.items()))
    return per


# ---------------------------------------------------------- training phases
def _bwd_cases():
    """(name, B, L, H, KVH, D, dtype, causal) of the backward kernel's
    checks: the training shape first."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("training shape", *BWD_SHAPE, bf16, True),
             ("nemotron shape", *BWD_TIMED_SHAPES["nemotron"], bf16, True),
             ("nemotron f32 shape", *BWD_TIMED_SHAPES["nemotron"], f32,
              True)]
    for causal in (True, False):
        cases += [("bf16 D 64, H/KVH 1", 2, 130, 4, 4, 64, bf16, causal),
                  ("bf16 D 192, H/KVH 12", 1, 130, 12, 1, 192, bf16, causal),
                  ("bf16 D 192, H/KVH 12, L 257", 2, 257, 24, 2, 192, bf16,
                   causal),
                  ("bf16 D 80, H/KVH 3", 2, 257, 6, 2, 80, bf16, causal),
                  ("bf16 D 96, H/KVH 5", 1, 130, 10, 2, 96, bf16, causal),
                  ("bf16 D 128, H/KVH 8", 1, 257, 8, 1, 128, bf16, causal),
                  ("f32 D 16, H/KVH 1", 2, 257, 4, 4, 16, f32, causal),
                  ("f32 D 32, H/KVH 3", 2, 130, 6, 2, 32, f32, causal),
                  ("f32 D 64, H/KVH 1", 2, 130, 4, 4, 64, f32, causal),
                  ("f32 D 80, H/KVH 3", 2, 257, 6, 2, 80, f32, causal),
                  ("f32 D 96, H/KVH 5", 1, 200, 10, 2, 96, f32, causal),
                  ("f32 D 128, H/KVH 5", 1, 257, 10, 2, 128, f32, causal),
                  ("f32 D 128, H/KVH 8", 1, 130, 8, 1, 128, f32, causal),
                  ("f32 D 192, H/KVH 12", 1, 130, 12, 1, 192, f32, causal),
                  ("f32 D 192, H/KVH 12, L 200", 2, 200, 24, 2, 192, f32,
                   causal)]
    return cases


def _bwd_close(got, want, dtype, what: str, d: int) -> tuple[float, float]:
    """A gradient against its plain version: float32 within BWD_F32_TOL
    max abs, at D 192 (up to 4,096 terms of ~1, in float32, in another
    order, at nemotron's shape) within BWD_F32_TOL of the gradient's
    largest magnitude; bf16 as `_flash_close` holds the forward.  Returns
    (max abs err, bf16 relative RMS or the float32 relative error)."""
    if dtype == torch.bfloat16:
        return _flash_close(got, want, dtype, what)
    worst = float((got - want).abs().max())
    rel = worst / max(float(want.abs().max()), 1e-30)
    if d == 192:
        _check(rel <= BWD_F32_TOL, f"{what}: max abs err {worst} is {rel} "
               f"of the largest magnitude (limit {BWD_F32_TOL})")
    else:
        _check(worst <= BWD_F32_TOL, f"{what}: max abs err {worst} > "
               f"{BWD_F32_TOL}")
    return worst, rel


def check_flash_bwd(dev) -> dict:
    """The flash-attention gradient (two or three launches through
    ``ops.flash_attention_bwd``, on the route ``route_bwd`` picks: bf16
    on ``wgmma``, float32 on ``tf32x3`` at D 64-192 and on ``simt`` at D
    16 and 32) against ``ref.flash_attention_bwd_ref`` of that route on
    the card, on the forward's own output and (``wgmma``, ``tf32x3``) its
    log-sum-exp, which is held against ``ref.flash_attention_lse_ref``
    within LSE_TOL (a float32 case's output against
    ``ref.flash_attention_ref`` within F32_TOL); every float32 case, the training shape and nemotron's
    (bf16, and float32 at D 192) twice, bit for bit.  Returns the largest
    differences per dtype (float32 at D 192 apart, absolute and relative)
    and the cases per route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rrms, lse_err, err192, rel192, fwd_err = 0.0, 0.0, 0.0, 0.0, 0.0
    cases = {r: 0 for r in fa.BWD_ROUTES}
    for name, b, L, h, kvh, d, dtype, causal in _bwd_cases():
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, L, h, d), (b, L, kvh, d),
                                     (b, L, kvh, d), (b, L, h, d)))
        route = fa.route_bwd(dtype, L, d)
        _check(route == ("wgmma" if dtype == torch.bfloat16
                         else "tf32x3" if d >= 64 else "simt"),
               f"flash_bwd {name}: route {route}")
        cases[route] += 1
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        if route in fa.LSE_BWD_ROUTES:
            worst = float((lse - ref.flash_attention_lse_ref(
                q, k, causal=causal)).abs().max())
            _check(worst <= LSE_TOL, f"flash forward lse {name}: max abs "
                   f"err {worst} > {LSE_TOL}")
            lse_err = max(lse_err, worst)
        if dtype == torch.float32:
            # The output the gradient reads, at the case's own shape
            # (nemotron's float32 is [train f32 d192]'s): the plain
            # backward below takes this o, so an error in it would move
            # both sides alike.
            worst, _ = _flash_close(o, ref.flash_attention_ref(
                q, k, v, causal=causal), dtype, f"flash forward {name}")
            fwd_err = max(fwd_err, worst)
        before = dict(ops.LAUNCHES)
        got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                      lse=lse)
        torch.cuda.synchronize()
        n_l = fa.bwd_launches(dtype, L, d)
        _check(ops.LAUNCHES["flash_bwd"] == before["flash_bwd"] + n_l
               and ops.LAUNCHES[f"flash_bwd_{route}"]
               == before[f"flash_bwd_{route}"] + n_l,
               f"flash_bwd {name}: not launched {n_l} times on {route}")
        if name.endswith("shape") or dtype == torch.float32:
            again = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                            lse=lse)
            _check(all(torch.equal(a, c) for a, c in zip(got, again)),
                   f"flash_bwd {name}: two runs differ")
            del again
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                           lse=lse)
        for grad, a, w in zip(("dq", "dk", "dv"), got, want):
            worst, r = _bwd_close(a, w, dtype, f"flash_bwd {grad} {name} "
                                  f"{'causal' if causal else 'full'}", d)
            if dtype == torch.float32 and d == 192:
                err192 = max(err192, worst)
                rel192 = max(rel192, r)
            else:
                err[dtype] = max(err[dtype], worst)
                rrms = max(rrms, r) if dtype == torch.bfloat16 else rrms
        del q, k, v, do, o, lse, got, want
    n = len(_bwd_cases())
    _check(all(cases.values()), f"flash_bwd: a route ran no case {cases}")
    print(f"[flash bwd] {n} cases (bf16 at D 64/80/96/128/192 on wgmma, "
          f"float32 at D 64/80/96/128/192 on tf32x3 and at D 16/32 on "
          f"simt, three launches at 192: {cases}; H/KVH 1/3/5/8/12, L 130, "
          f"200 and 257, causal and not, the training shape {BWD_SHAPE} "
          f"and nemotron's {BWD_TIMED_SHAPES['nemotron']} bf16 causal and "
          f"nemotron's float32 causal, these and every float32 case "
          f"bit-identical twice): dq, dk and dv max "
          f"abs err f32 {err[torch.float32]:.3e} (limit {BWD_F32_TOL}), "
          f"f32 at D 192 {err192:.3e}, {rel192:.3e} of the largest "
          f"magnitude (limit {BWD_F32_TOL}), bf16 "
          f"{err[torch.bfloat16]:.3e} (atol = rtol = {BF16_TOL}), bf16 "
          f"relative RMS diff {rrms:.3e} (limit {BF16_RMS_TOL}); the "
          f"forward's lse within {lse_err:.3e} (limit {LSE_TOL}), its "
          f"float32 output within {fwd_err:.3e} (limit {F32_TOL}); peak "
          f"device memory {_peak_gib():.2f} GiB")
    return {"f32": err[torch.float32], "bf16": err[torch.bfloat16],
            "f32_d192": err192, "f32_d192_rel": rel192, "f32_fwd": fwd_err,
            "bf16_rrms": rrms, "lse": lse_err, "cases": n,
            "cases_by_route": cases}


def _train_batch(data, step: int, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in data.batch_at(step).items()}


def _leaf_errors(named: dict, gold: dict, what: str) -> float:
    """The golden summary's leaf norms and values against ``named``'s
    tensors, each relative (a value to the largest of its leaf's 64);
    returns the worst, checked against TRAIN_GOLD_TOL."""
    worst = 0.0
    for name, want in gold["norms"].items():
        got = float(named[name].detach().double().norm())
        worst = max(worst, abs(got - want) / max(want, 1e-30))
    for name, sel in gold["values"].items():
        flat = named[name].detach().reshape(-1)
        idx = torch.as_tensor(sel["index"], device=flat.device)
        got = flat[idx].double().cpu()
        want = torch.tensor(sel["value"], dtype=torch.float64)
        scale = float(want.abs().max())
        diff = float((got - want).abs().max())
        worst = max(worst, diff / scale if scale else diff)
    _check(worst <= TRAIN_GOLD_TOL, f"train golden {what}: relative "
           f"difference {worst} > {TRAIN_GOLD_TOL}")
    return worst


def _golden_cfg(gold: dict):
    """The config of a ``"train"`` or ``"train_families"`` golden model."""
    from repro_torch.configs import registry

    if "cuts" in gold:
        cuts = {k: v for k, v in gold["cuts"].items() if k != "arch"}
    else:
        cuts = dict(num_layers=gold["num_layers"], dtype=gold["dtype"])
    return dataclasses.replace(registry.get(gold["arch"]), **cuts)


def _draw_golden_tree(gold: dict):
    """`numpy_params` of a golden model (an SSD one's per-head mixer
    parameters redrawn, as the golden script draws them)."""
    return _tree(_golden_cfg(gold), gold["param_seed"],
                 gold.get("ssm_heads_seed"))


def _train_launches_want(route: str, n_fwd: int, n_bwd: int) -> dict:
    """The flash counters of a training run whose ``n_fwd`` forwards
    (remat's recompute among them) and ``n_bwd`` backward launches all
    took ``route`` (a backward route; its forward has the same name):
    every training route's forward and backward counter, the others 0."""
    from repro_torch.kernels import flash_attention as fa

    want = {f"flash_{r}": 0 for r in fa.BWD_ROUTES}
    want.update({f"flash_bwd_{r}": 0 for r in fa.BWD_ROUTES})
    want[f"flash_{route}"] = n_fwd
    want[f"flash_bwd_{route}"] = want["flash_bwd"] = n_bwd
    return want


def check_train_golden(gold: dict, dev, tree,
                       tag: str = "train golden") -> dict:
    """Two float32 steps of ``make_train_step`` on a golden entry's model
    (the ``"train"`` entry, or one of ``"train_families"``), weights
    (``tree``, from `numpy_params`) and batches, against the entry; step
    0's gradient is taken once more on its own to compare its leaves.
    Each GQA attention runs the tf32x3 forward (and remat's recompute) and
    the tf32x3 backward (dq, dv and dk at D 192)."""
    from repro_torch import convert
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _golden_cfg(gold)
    torch.cuda.reset_peak_memory_stats()
    params = model.trainable(convert.lm_params_from_jax(tree, cfg, dev))
    del tree
    data = SyntheticLM(cfg, gold["batch"], gold["seq_len"],
                       seed=gold["data_seed"])
    batches = [_train_batch(data, s, dev) for s in range(len(gold["steps"]))]
    named = adamw.named(params)
    loss = model.loss_fn(params, cfg, batches[0])[0]
    grads = torch.autograd.grad(loss, list(named.values()))
    g_err = _leaf_errors(dict(zip(named, grads)), gold["grad0"],
                         f"{tag}: step 0's gradient")
    del grads, loss
    step = make_train_step(cfg, lambda s: gold["lr"], gold["microbatches"])
    opt = adamw.init(params, torch.float32)
    ops.reset_launches()
    worst = 0.0
    for b, want in zip(batches, gold["steps"]):
        params, opt, m = step(params, opt, b)
        for key in ("loss", "grad_norm"):
            worst = max(worst, abs(float(m[key]) - want[key]) / want[key])
    torch.cuda.synchronize()
    _check(worst <= TRAIN_GOLD_TOL, f"{tag}: loss or grad norm differs by "
           f"{worst} relative (limit {TRAIN_GOLD_TOL})")
    p_err = _leaf_errors(adamw.named(params), gold["params"],
                         f"{tag}: parameters after the steps")
    n = len(gold["steps"]) * _flash_layers(cfg)
    n_b = n * fa.bwd_launches(torch.float32, gold["seq_len"], cfg.head_dim) \
        if n else 0
    route = "tf32x3" if cfg.head_dim >= 64 else "simt"
    want = _train_launches_want(route, 2 * n, n_b)
    launches = {k: ops.LAUNCHES[k] for k in want}
    _check(launches == want,
           f"{tag}: launches {launches}, not {2 * n} {route} (forward and "
           f"remat's recompute) and {n_b} flash_bwd on {route}")
    peak = _peak_gib()
    del params, opt, batches
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers at full width, "
          f"cuts {gold.get('cuts', {'num_layers': cfg.num_layers})}, "
          f"float32, {len(gold['steps'])} steps of {gold['batch']} x "
          f"{gold['seq_len']} tokens at lr {gold['lr']}: losses "
          f"{[s['loss'] for s in gold['steps']]} and grad norms within "
          f"{worst:.3e}, step 0's gradient leaves within {g_err:.3e}, the "
          f"parameters after the steps within {p_err:.3e} of the reference "
          f"(relative; limit {TRAIN_GOLD_TOL}); launches {launches}; peak "
          f"device memory {peak:.2f} GiB")
    return {"max_rel_err": max(worst, g_err, p_err), "launches": launches}


class _PinnedRoutes:
    """Wraps ``models.mlp._route`` for two runs of one gradient: the first
    records each call's expert picks, the second takes them again (its
    gates the softmax's probabilities at those picks, renormalised, and
    the aux loss as ``_route`` has them) and counts the tokens whose own
    picks would differ.  Attention through the plain version rounds
    differently from the kernels, and a token near a router tie may then
    pick another expert, which moves a whole token's share of an expert's
    gradient: not what the bf16 check measures."""

    def __init__(self, mlp):
        self.mlp, self.orig, self.picks, self.flips = mlp, mlp._route, [], 0
        self.tokens, self.calls = 0, 0

    def record(self, router, xt, k, mesh=None):
        gate, idx, aux = self.orig(router, xt, k, mesh)
        self.picks.append(idx.detach())
        return gate, idx, aux

    def replay(self, router, xt, k, mesh=None):    # one device: no mesh
        idx = self.picks[self.calls]
        self.calls += 1
        probs = torch.softmax(xt.float() @ router, -1)
        own = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        self.flips += int((own[:, :k] != idx).any(-1).sum())
        self.tokens += idx.shape[0]
        gate = probs.gather(1, idx)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        e, n = probs.shape[-1], xt.shape[0]
        counts = torch.bincount(idx.reshape(-1), minlength=e)
        return gate, idx, e * (counts.float() / n * (probs.sum(0) / n)).sum()


def check_train_bf16(dev, cfg=None, tag: str = "train bf16") -> dict:
    """A bf16 config at full width (llama3.2-3b at 2 layers by default),
    the port's seeded init: one step's gradient (TRAIN_BF16_BATCH x
    TRAIN_BF16_SEQ tokens) through the kernels against the same gradient
    with ``ops.flash_attention`` patched to the plain version (autograd
    through it); each leaf within TRAIN_BF16_RTOL relative L2.  Each GQA
    attention runs the wgmma forward twice (remat) and the wgmma backward
    (`flash_attention.bwd_launches` launches a call).  A MoE config's
    second run takes the first run's expert picks (`_PinnedRoutes`)."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import mlp, model
    from repro_torch.optim import adamw

    cfg = cfg or dataclasses.replace(registry.get(LM_ARCH), num_layers=2)
    torch.cuda.reset_peak_memory_stats()
    params = model.trainable(model.init_params(cfg, 0, dev))
    batch = _train_batch(SyntheticLM(cfg, TRAIN_BF16_BATCH, TRAIN_BF16_SEQ,
                                     seed=3), 0, dev)
    named = adamw.named(params)
    pinned = _PinnedRoutes(mlp)
    ops.reset_launches()
    mlp._route = pinned.record
    try:
        got = torch.autograd.grad(model.loss_fn(params, cfg, batch)[0],
                                  list(named.values()))
    finally:
        mlp._route = pinned.orig
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in (
        "flash_wgmma", "flash_bwd", "flash_bwd_wgmma", "flash_bwd_simt")}
    kernel = ops.flash_attention
    ops.flash_attention = ref.flash_attention_ref
    mlp._route = pinned.replay
    try:
        want = torch.autograd.grad(model.loss_fn(params, cfg, batch)[0],
                                   list(named.values()))
    finally:
        ops.flash_attention = kernel
        mlp._route = pinned.orig
    _check(pinned.calls == len(pinned.picks), f"{tag}: {pinned.calls} "
           f"router calls replayed of {len(pinned.picks)}")
    rel = {}
    for name, a, w in zip(named, got, want):
        rel[name] = float((a.float() - w.float()).norm()
                          / w.float().norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    calls = _flash_layers(cfg)
    n_b = calls * fa.bwd_launches(torch.bfloat16, TRAIN_BF16_SEQ,
                                  cfg.head_dim)
    _check(launches == {"flash_wgmma": 2 * calls, "flash_bwd": n_b,
                        "flash_bwd_wgmma": n_b, "flash_bwd_simt": 0},
           f"{tag}: launches {launches}, not {2 * calls} wgmma and {n_b} "
           f"flash_bwd on wgmma")
    _check(rel[worst] <= TRAIN_BF16_RTOL, f"{tag}: leaf {worst} differs by "
           f"{rel[worst]} relative L2 (limit {TRAIN_BF16_RTOL})")
    peak = _peak_gib()
    del params, got, want
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers at full width "
          f"(head dim {cfg.head_dim}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads}), bf16, {TRAIN_BF16_BATCH} x {TRAIN_BF16_SEQ} "
          f"tokens: every gradient leaf through the kernels (launches "
          f"{launches}) against attention through the plain version within "
          f"{rel[worst]:.3e} relative L2 (worst {worst}; limit "
          f"{TRAIN_BF16_RTOL}; median "
          f"{sorted(rel.values())[len(rel) // 2]:.3e})"
          + (f"; expert picks of the plain run pinned to the kernels' "
             f"({pinned.calls} router calls; {pinned.flips} of "
             f"{pinned.tokens} tokens would have picked otherwise)"
             if pinned.picks else "")
          + f"; peak device memory {peak:.2f} GiB")
    return {"max_rel_err": rel[worst], "launches": launches,
            "route_flips": pinned.flips}


def run_train_main_path() -> dict:
    """llama3.2-3b at full width and depth, bf16, through
    ``launch.train.main`` with TRAIN_MAIN_ARGV; launch counters zeroed
    just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch

    ops.reset_launches()
    out = tlaunch.main(TRAIN_MAIN_ARGV)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    cfg, steps = out["cfg"], len(out["losses"])
    per_step = {k: launches[k] / steps for k in (
        "flash_wgmma", "flash_bwd", "flash_bwd_wgmma", "flash_bwd_simt",
        "flash_simt", "flash_decode")}
    want = TRAIN_MAIN_MICRO * cfg.num_layers * 2
    _check(steps == TRAIN_MAIN_STEPS and all(
        np.isfinite(out["losses"])) and all(np.isfinite(out["grad_norms"])),
        f"train main: losses {out['losses']}, grad norms "
        f"{out['grad_norms']}")
    _check(per_step == {"flash_wgmma": want, "flash_bwd": want,
                        "flash_bwd_wgmma": want, "flash_bwd_simt": 0,
                        "flash_simt": 0, "flash_decode": 0},
           f"train main: launches a step {per_step}, not {want} wgmma and "
           f"{want} flash_bwd on wgmma")
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    _check(out["peak_gib"] < total_gib, "train main: peak memory")
    tokens = out["batch"] * out["seq_len"]
    flop = 6 * cfg.param_count() * tokens
    share = flop / out["step_s"] / BF16_FLOPS_PER_S
    split = {k: v / steps for k, v in out["clock"].items()}
    print(f"[train main] {cfg.name}, {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f} B parameters, bf16, "
          f"AdamW with float32 moments: {steps} steps of {out['batch']} x "
          f"{out['seq_len']} tokens in {TRAIN_MAIN_MICRO} microbatches "
          f"(train_4k's global batch 256 cut to {out['batch']}); losses "
          f"{[round(x, 4) for x in out['losses']]}, grad norms "
          f"{[round(x, 4) for x in out['grad_norms']]}; step seconds "
          f"{[round(x, 3) for x in out['step_seconds']]} (median of steps "
          f"1-{steps - 1} {out['step_s']:.3f}s), {out['tokens_per_s']:.0f} "
          f"tokens/s, 6·N·tokens {flop / 1e15:.3f} PFLOP a step = "
          f"{share:.1%} of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; per step "
          f"(mean of {steps}, synchronised host clock) forward "
          f"{split.get('forward', 0):.3f}s, backward "
          f"{split.get('backward', 0):.3f}s, optimizer "
          f"{split.get('optimizer', 0):.3f}s; launches a step {per_step}; "
          f"peak device memory {out['peak_gib']:.2f} GiB of "
          f"{total_gib:.2f}")
    return dict(out, cfg=None, launches=launches, per_step=per_step,
                mfu=share, split=split)


def _mla_live_gib(params, cfg, dev) -> dict:
    """deepseek's MLA (layer 0's weights, `attention.mla_forward`: float32
    blocked scores, autograd) on one 4,096-token sequence: the memory its
    forward leaves for the backward (what remat recomputes and holds while
    a layer's backward runs) and the peak over forward and backward, each
    above what was allocated before."""
    from repro_torch.models import attention, common

    gen = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn((1, TRAIN_FAMILY_SEQ, cfg.d_model), generator=gen,
                     device=dev) * 0.5).to(common.dtype_of(cfg.dtype))
    x.requires_grad_()
    pos = torch.arange(TRAIN_FAMILY_SEQ, device=dev)[None]
    p = params.layers[0].attn
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = attention.mla_forward(p, x, pos, cfg)[0]
    torch.cuda.synchronize()
    saved = torch.cuda.memory_allocated() - base
    grads = torch.autograd.grad(out, [x, *p.values()], torch.ones_like(out))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, grads, x
    return {"saved_gib": saved / 2 ** 30, "peak_gib": peak / 2 ** 30}


def run_train_families(dev, archs=None) -> dict:
    """[train families]: each arch of TRAIN_FAMILY_ARCHS through
    ``launch.train.main`` and each of TRAIN_FAMILY_CUTS through
    ``train.loop.train`` (bf16 moments, its config's
    ``optimizer_state_dtype``), TRAIN_FAMILY_STEPS steps of
    TRAIN_FAMILY_BATCH x TRAIN_FAMILY_SEQ tokens in TRAIN_FAMILY_BATCH
    microbatches, one model on the card at a time (only those of
    ``archs`` when given); launch counters zeroed just before and read
    just after each."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.train import loop

    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    b, seq, m = TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_BATCH
    out = {}
    for arch in (*TRAIN_FAMILY_ARCHS, *TRAIN_FAMILY_CUTS):
        if archs is not None and arch not in archs:
            continue
        t0 = time.perf_counter()
        extra = {}
        if arch in TRAIN_FAMILY_CUTS:
            cfg = dataclasses.replace(registry.get(arch),
                                      **TRAIN_FAMILY_CUTS[arch])
            torch.cuda.reset_peak_memory_stats()
            clock: dict = {}
            ops.reset_launches()
            res = loop.train(cfg, batch=b, seq_len=seq,
                             steps=TRAIN_FAMILY_STEPS, num_microbatches=m,
                             device=dev, clock=clock, log_every=100,
                             print_fn=lambda *a: None)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            r = dict(losses=res.losses, grad_norms=res.grad_norms,
                     step_seconds=res.step_seconds, clock=clock,
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            if cfg.attention == "mla":
                extra["mla"] = _mla_live_gib(res.params, cfg, dev)
            del res
        else:
            ops.reset_launches()
            r = tlaunch.main(["--arch", arch, "--shape", "train_4k",
                              "--seq-len", str(seq), "--batch", str(b),
                              "--microbatches", str(m), "--steps",
                              str(TRAIN_FAMILY_STEPS)])
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            cfg = r["cfg"]
        steps = len(r["losses"])
        step_s = float(np.median(r["step_seconds"][1:]))
        per_step = {k: launches[k] / steps for k in (
            "flash_wgmma", "flash_bwd", "flash_bwd_wgmma", "flash_bwd_simt",
            "flash_simt", "flash_decode")}
        calls = _flash_layers(cfg) * m
        n_b = calls * (fa.bwd_launches(torch.bfloat16, seq, cfg.head_dim)
                       if calls else 0)
        want = {"flash_wgmma": 2 * calls, "flash_bwd": n_b,
                "flash_bwd_wgmma": n_b, "flash_bwd_simt": 0,
                "flash_simt": 0, "flash_decode": 0}
        _check(steps == TRAIN_FAMILY_STEPS and all(np.isfinite(r["losses"]))
               and all(np.isfinite(r["grad_norms"])),
               f"train families {arch}: losses {r['losses']}, grad norms "
               f"{r['grad_norms']}")
        _check(per_step == want, f"train families {arch}: launches a step "
               f"{per_step}, not {want}")
        _check(r["peak_gib"] < total_gib, f"train families {arch}: peak "
               f"memory {r['peak_gib']} GiB")
        tokens = b * seq
        n_active = (cfg.active_param_count() if cfg.num_experts
                    else cfg.param_count())
        flop = 6 * n_active * tokens
        share = flop / step_s / BF16_FLOPS_PER_S
        split = {k: v / steps for k, v in r["clock"].items()}
        cuts = TRAIN_FAMILY_CUTS.get(arch, {})
        out[arch] = dict(losses=r["losses"], grad_norms=r["grad_norms"],
                         step_seconds=r["step_seconds"], step_s=step_s,
                         tokens_per_s=tokens / step_s, mfu=share,
                         split=split, peak_gib=r["peak_gib"],
                         per_step=per_step, launches=launches, cuts=cuts,
                         param_count=cfg.param_count(),
                         active_param_count=n_active,
                         seconds=time.perf_counter() - t0, **extra)
        print(f"[train families] {cfg.name}: {cfg.num_layers} layers"
              + (f" (cuts {cuts})" if cuts else " (full depth)")
              + f", d {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B "
              f"parameters ({n_active / 1e9:.3f} B active), {cfg.dtype}, "
              f"{cfg.optimizer_state_dtype} moments: {steps} steps of {b} x "
              f"{seq} tokens in {m} microbatches; losses "
              f"{[round(x, 4) for x in r['losses']]}, grad norms "
              f"{[round(x, 4) for x in r['grad_norms']]}; step seconds "
              f"{[round(x, 3) for x in r['step_seconds']]} (median of steps "
              f"1-{steps - 1} {step_s:.3f}s), {tokens / step_s:.0f} tokens/s, "
              f"6·N_active·tokens {flop / 1e15:.3f} PFLOP a step = "
              f"{share:.1%} of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; per "
              f"step forward {split.get('forward', 0):.3f}s, backward "
              f"{split.get('backward', 0):.3f}s, optimizer "
              f"{split.get('optimizer', 0):.3f}s; launches a step "
              f"{per_step}; peak device memory {r['peak_gib']:.2f} GiB of "
              f"{total_gib:.2f}"
              + (f"; MLA at {seq} tokens (layer 0, float32 blocked scores) "
                 f"leaves {extra['mla']['saved_gib']:.2f} GiB for its "
                 f"backward, peak {extra['mla']['peak_gib']:.2f} GiB over "
                 f"forward and backward" if "mla" in extra else "")
              + f"; {out[arch]['seconds']:.1f}s with set-up")
        del r
        _release(f"train families {arch}")
    return out


def run_train_f32_d192(dev) -> dict:
    """[train f32 d192]: the nemotron cut (TRAIN_FAMILY_CUTS: 96 heads over
    8 of 192, d 4,608, 4 layers, vocabulary 256,000) in float32 (TF32
    off) through ``train.loop.train``, TRAIN_F32_STEPS step of
    TRAIN_F32_BATCH x TRAIN_F32_SEQ tokens in TRAIN_F32_MICRO microbatches,
    bf16 moments (its ``optimizer_state_dtype``); launch counters zeroed
    just before and read just after: per step and microbatch each layer
    launches the tf32x3 forward twice (remat) and the tf32x3 backward three
    times (dq, dv, dk), nothing on simt or wgmma.  Fails unless the loss
    and grad norm are finite and the peak stays under the card's
    memory."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = "nemotron-4-340b"
    cfg = dataclasses.replace(registry.get(arch), **TRAIN_FAMILY_CUTS[arch],
                              dtype="float32")
    b, seq, m = TRAIN_F32_BATCH, TRAIN_F32_SEQ, TRAIN_F32_MICRO
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    clock: dict = {}
    ops.reset_launches()
    res = loop.train(cfg, batch=b, seq_len=seq, steps=TRAIN_F32_STEPS,
                     num_microbatches=m, device=dev, clock=clock,
                     log_every=100, print_fn=lambda *a: None)
    torch.cuda.synchronize()
    calls = _flash_layers(cfg) * m * TRAIN_F32_STEPS
    n_b = calls * fa.bwd_launches(torch.float32, seq, cfg.head_dim)
    want = dict(_train_launches_want("tf32x3", 2 * calls, n_b),
                flash_decode=0)
    launches = {k: ops.LAUNCHES[k] for k in want}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, gnorms, secs = res.losses, res.grad_norms, res.step_seconds
    del res
    _check(len(losses) == TRAIN_F32_STEPS and all(np.isfinite(losses))
           and all(np.isfinite(gnorms)),
           f"train f32 d192: losses {losses}, grad norms {gnorms}")
    _check(launches == want, f"train f32 d192: launches {launches}, not "
           f"{want}")
    _check(peak < total_gib, f"train f32 d192: peak memory {peak} GiB")
    split = {k: v / TRAIN_F32_STEPS for k, v in clock.items()}
    out = dict(losses=losses, grad_norms=gnorms, step_seconds=secs,
               split=split, peak_gib=peak, launches=launches,
               param_count=cfg.param_count(),
               seconds=time.perf_counter() - t0)
    print(f"[train f32 d192] {cfg.name} cut to d {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, {cfg.num_layers} layers ({cfg.num_heads} heads over "
          f"{cfg.num_kv_heads} of {cfg.head_dim}), "
          f"{cfg.param_count() / 1e9:.3f} B parameters, float32 (TF32 off), "
          f"{cfg.optimizer_state_dtype} moments: {TRAIN_F32_STEPS} step of "
          f"{b} x {seq} tokens in {m} microbatches; losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in gnorms]}; step seconds "
          f"{[round(x, 3) for x in secs]} (forward "
          f"{split.get('forward', 0):.3f}s, backward "
          f"{split.get('backward', 0):.3f}s, optimizer "
          f"{split.get('optimizer', 0):.3f}s); launches {launches}; peak "
          f"device memory {peak:.2f} GiB of {total_gib:.2f}; "
          f"{out['seconds']:.1f}s with set-up")
    return out


def run_train_restart(dev) -> dict:
    """The crash/restart contract on the card: the smoke config, float32,
    12 steps with a checkpoint every 4, crashes injected after steps 5
    and 9, against a clean run within TRAIN_RESTART_TOL."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.train import loop

    cfg = registry.smoke(LM_ARCH)
    kw = dict(batch=4, seq_len=32, steps=12, ckpt_every=4, lr=1e-3,
              log_every=100, print_fn=lambda *a: None, async_ckpt=False,
              device=dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_restart_") as d:
        clean = loop.train(cfg, checkpoint_dir=os.path.join(d, "clean"),
                           **kw)
        crashed = loop.train_with_restarts(
            cfg, checkpoint_dir=os.path.join(d, "crashy"),
            crash_schedule=(5, 9), **kw)
    worst = max(float((a - b).detach().abs().max()) for a, b in zip(
        clean.params.parameters(), crashed.params.parameters()))
    loss_err = max(abs(a - b) for a, b in zip(
        clean.losses[-crashed.steps_run:], crashed.losses))
    _check(crashed.resumed_from == 8, f"train restart: resumed from "
           f"{crashed.resumed_from}, not 8")
    _check(max(worst, loss_err) <= TRAIN_RESTART_TOL,
           f"train restart: parameters differ by {worst}, losses by "
           f"{loss_err} (limit {TRAIN_RESTART_TOL})")
    print(f"[train restart] {cfg.name}, float32 on the card: crashes after "
          f"steps 5 and 9, resumed from step {crashed.resumed_from}; "
          f"parameters within {worst:.3e}, the resumed losses within "
          f"{loss_err:.3e} of a clean run (limit {TRAIN_RESTART_TOL}); "
          f"{time.perf_counter() - t0:.1f}s")
    return {"max_abs_err": max(worst, loss_err)}


def _train_mesh_jobs(entry: dict) -> list:
    """The ``"train_mesh"`` golden's jobs (each model's job fields, not its
    results), for `mesh_smoke.rank_train_mesh`."""
    keep = ("arch", "shape", "batch", "seq", "microbatches", "num_steps", "lr",
            "param_seed", "data_seed", "ssm_heads_seed", "leaves")
    return [dict({k: gold[k] for k in keep}, name=name, full=False)
            for name, gold in entry.items()]


def run_train_mesh_golden(golden: dict, world: list,
                          seconds: float) -> dict:
    """``[train mesh golden]`` and ``[train mesh shards]``: the
    ``"train_mesh"`` entry's models (smoke configs, float32, TF32 off;
    llama3.2-3b, deepseek-v3 and zamba2 on a 2x2 mesh, maverick on a
    data-only mesh of 4) through `mesh_smoke.rank_train_mesh` on 4 gloo
    ranks sharing card 0, then `mesh_smoke.rank_shard_init` of
    ``TRAIN_MESH_SHARD_CHECKS`` in the same world (``world``: the ranks'
    results of `mesh_smoke.rank_train_mesh_phase`, a job of `run_worlds`
    that took ``seconds``): each step's loss and grad norm on every rank,
    and rank 0's parameters after the steps (`_leaf_errors`), within
    TRAIN_GOLD_TOL of the reference's sharded step; every expert pick
    equal; the simt forward and backward launched on every rank of a
    model with GQA attention (ranks run with ``device="cpu"`` rehearse it
    with the plain versions, and then fail only on those launch
    counts)."""
    from repro_torch.configs import registry

    entry = golden["train_mesh"]
    jobs = _train_mesh_jobs(entry)
    cuts = [c for _, c, _ in TRAIN_MESH_SHARD_CHECKS]
    ranks = [r["jobs"] for r in world]
    worst, out = 0.0, {}
    for i, job in enumerate(jobs):
        gold = entry[job["name"]]
        for r in ranks:
            got = r[i]
            for s, want in zip(got["steps"], gold["steps"]):
                for key in ("loss", "grad_norm"):
                    worst = max(worst, abs(s[key] - want[key]) / want[key])
            digest = hashlib.sha256()
            for call in got["routes"]:
                digest.update(np.ascontiguousarray(call, "<i4").tobytes())
            _check(len(got["routes"]) == gold["route_calls"]
                   and digest.hexdigest() == gold["routes_sha256"],
                   f"train mesh golden {job['name']}: rank {got['rank']} "
                   "picks other experts than the reference")
            if registry.smoke(job["arch"]).attention != "mla":   # flash
                _check(got["launches"]["flash_simt"] > 0
                       and got["launches"]["flash_bwd_simt"] > 0,
                       f"train mesh golden {job['name']}: rank "
                       f"{got['rank']} launched {got['launches']}")
        leaves = {k: torch.from_numpy(v) for k, v in
                  ranks[0][i]["leaves"].items()}
        p_err = _leaf_errors(leaves, gold["params"],
                             f"train mesh {job['name']}")
        worst = max(worst, p_err)
        out[job["name"]] = dict(
            launches=[r[i]["launches"] for r in ranks],
            routes=gold["route_calls"], router_margin=gold["router_margin"])
    _check(worst <= TRAIN_GOLD_TOL, f"train mesh golden: relative "
           f"difference {worst} (limit {TRAIN_GOLD_TOL})")
    print(f"[train mesh golden] {', '.join(j['name'] for j in jobs)} "
          f"(smoke configs, float32, 2 steps of {jobs[0]['batch']} x "
          f"{jobs[0]['seq']} tokens in {jobs[0]['microbatches']} "
          f"microbatches) on 4 gloo ranks sharing the card, meshes "
          f"{[tuple(j['shape']) for j in jobs]}: losses, grad norms and "
          f"the parameters after the steps within {worst:.3e} of the "
          f"reference's sharded step (limit {TRAIN_GOLD_TOL}); every expert "
          f"pick of "
          + ", ".join(f"{n} ({v['routes']} calls, router margin "
                      f"{v['router_margin']:.2e})"
                      for n, v in out.items() if v["routes"])
          + " the reference's; simt launches on rank 0 "
          + ", ".join(f"{n} {v['launches'][0]['flash_simt']} forward / "
                      f"{v['launches'][0]['flash_bwd_simt']} backward"
                      for n, v in out.items())
          + f"; the job (with the shards' and gradients' checks below) "
          f"{seconds:.1f}s in the mesh world")
    shards = [r["shards"] for r in world]
    for r in shards:
        _check(not any(c["differ"] for c in r["checks"]),
               f"train mesh shards: rank {r['rank']}'s slices differ from "
               f"the one-device draw: {r['checks']}")
    print(f"[train mesh shards] "
          + "; ".join(f"{c['name']} {cut}: {c['leaves']} leaves"
                      for c, cut in zip(shards[0]["checks"], cuts))
          + ": every rank's shards (" + ", ".join(
              f"{sum(c['bytes'] for c in r['checks']) / 2 ** 30:.3f}"
              for r in shards)
          + " GiB) equal the slices of the one-device draw bit for bit")
    grads = {}
    for c, (_, cut, rows) in zip(shards[0]["checks"],
                                 TRAIN_MESH_SHARD_CHECKS):
        if rows is None:
            continue
        g = grads[c["name"]] = c["grads"]
        _check(np.isfinite(g["err"]) and g["err"] <= TRAIN_MESH_GRAD_RTOL,
               f"train mesh grads {c['name']}: leaf {g.get('worst_leaf')} "
               f"of the sharded gradient differs from one device's by "
               f"{g['err']} (limit {TRAIN_MESH_GRAD_RTOL})")
        print(f"[train mesh grads] {c['name']} {cut}: step 0 of the sharded "
              f"step on {rows[0]} x {rows[1]} tokens (2x2, bf16), each of "
              f"its {g['leaves']} gradient leaves gathered from the shards "
              f"against one device's gradient: worst {g['err']:.3e} "
              f"({g['worst_leaf']}; limit {TRAIN_MESH_GRAD_RTOL} relative "
              f"L2), control (a block rolled onto its neighbour's slice) at "
              f"least {g['control']:.3e} ({g['control_leaf']}); loss "
              f"{g['loss']:.6f} against {g['one_device_loss']:.6f}")
    return {"max_rel_err": worst, "models": out, "seconds": seconds,
            "grads": grads}


def _mesh_step_line(tag: str, out: dict, one: dict, cfg) -> dict:
    """Check a launcher run on the mesh against the one-device run of the
    same cut and steps (the same weights and batches) and print its
    numbers; returns them."""
    steps = len(out["losses"])

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    loss_err = rel(out["losses"], one["losses"])
    gn_err = rel(out["grad_norms"], one["grad_norms"])
    # The control: what another batch on the same weights gives.
    control = dict(loss=rel(one["losses"][1:2], one["losses"][:1])[0],
                   grad_norm=rel(one["grad_norms"][1:2],
                                 one["grad_norms"][:1])[0])
    _check(all(np.isfinite(out["losses"])) and all(
        np.isfinite(out["grad_norms"])), f"{tag}: losses {out['losses']}, "
        f"grad norms {out['grad_norms']}")
    _check(len(loss_err) == steps
           and max(loss_err) <= TRAIN_MESH_LOSS_RTOL
           and max(gn_err) <= TRAIN_MESH_GN_RTOL,
           f"{tag}: the steps differ from one device's: loss {loss_err} "
           f"(limit {TRAIN_MESH_LOSS_RTOL}), grad norm {gn_err} (limit "
           f"{TRAIN_MESH_GN_RTOL})")
    from repro_torch.models import model

    attn = sum(k != "mamba" for k in model.layer_kinds(cfg))
    micro = out.get("microbatches", 1)
    per_rank = [{k: r[k] / steps for k in (
        "flash_wgmma", "flash_bwd_wgmma", "flash_simt", "flash_bwd_simt")}
        for r in out["rank_launches"]]
    want = {"flash_wgmma": 2 * attn * micro,
            "flash_bwd_wgmma": 2 * attn * micro,
            "flash_simt": 0, "flash_bwd_simt": 0}
    _check(all(p == want for p in per_rank), f"{tag}: launches a step and "
           f"rank {per_rank}, not {want}")
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    _check(sum(out["rank_peak_gib"]) < total_gib, f"{tag}: peaks "
           f"{out['rank_peak_gib']} GiB together pass the card's")
    stats = {a: {k: v / steps for k, v in st.items()}
             for a, st in out["mesh_stats"].items()}
    staged = out["staged_bytes"] / steps
    split = {k: v / steps for k, v in out["clock"].items()}
    tokens = out["batch"] * out["seq_len"]
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers at full width (d "
          f"{cfg.d_model}, vocabulary {cfg.vocab_size}"
          + (f", {cfg.num_experts} experts" if cfg.num_experts else "")
          + f"), {cfg.param_count() / 1e9:.3f} B parameters, bf16, "
          f"{cfg.optimizer_state_dtype} moments, through launch.train.main "
          f"on a 2x2 gloo mesh of 4 ranks sharing the card: {steps} steps of "
          f"{out['batch']} x {out['seq_len']} tokens ({micro} microbatch, "
          f"one row a rank); losses {[round(x, 4) for x in out['losses']]}, "
          f"grad norms {[round(x, 4) for x in out['grad_norms']]}; steps "
          f"0-{steps - 1} within "
          + ", ".join(f"{x:.3e}" for x in loss_err) + " (loss) and "
          + ", ".join(f"{x:.3e}" for x in gn_err) + " (grad norm) of one "
          f"device's (limits {TRAIN_MESH_LOSS_RTOL}, {TRAIN_MESH_GN_RTOL}; "
          f"control, one device's step 1 against its step 0: "
          f"{control['loss']:.3e}, {control['grad_norm']:.3e}); "
          f"{out['step_s']:.3f}s a step ("
          + (f"median of steps 1-{steps - 1}; " if steps > 1 else "")
          + f"step 0 {out['step_seconds'][0]:.3f}s; one device, median of "
          f"its steps after the first, {one['step_s']:.3f}s), "
          f"{tokens / out['step_s']:.0f} "
          f"tokens/s; forward / backward / optimizer "
          + " / ".join(f"{split.get(k, 0.0):.3f}" for k in (
              "forward", "backward", "optimizer"))
          + f" s a step (rank 0); peak per rank "
          + ", ".join(f"{g:.2f}" for g in out["rank_peak_gib"])
          + f" GiB (one device {one['peak_gib']:.2f}); collectives a step "
          f"(rank 0) "
          + ", ".join(f"{a} {v['calls']:.0f} calls / "
                      f"{v['bytes'] / 2 ** 30:.3f} GiB"
                      for a, v in stats.items())
          + f", {staged / 2 ** 30:.3f} GiB staged through the host a step; "
          f"flash launches a step and rank {per_rank[0]}")
    return dict(step_s=out["step_s"], tokens_per_s=tokens / out["step_s"],
                peak_gib=out["rank_peak_gib"], split=split,
                stats_per_step=stats, staged_per_step=staged,
                per_rank=per_rank, loss_err=loss_err, grad_norm_err=gn_err,
                control=control, rank_launches=out["rank_launches"],
                one_device_step_s=one["step_s"],
                one_device_peak_gib=one["peak_gib"])


def _train_mesh_result(tm: dict) -> None:
    """Print phase 16g's numbers on one result line (the end of the
    output, where a log that keeps only the tail still holds them)."""
    def run(tag):
        r = tm[tag]
        return (f"{tag} {r['step_s']:.3f}s a step ({r['tokens_per_s']:.0f} "
                f"tokens/s; one device {r['one_device_step_s']:.3f}s), "
                "forward / backward / optimizer " + " / ".join(
                    f"{r['split'].get(k, 0.0):.3f}"
                    for k in ("forward", "backward", "optimizer"))
                + "s, peak " + ", ".join(f"{g:.2f}" for g in r["peak_gib"])
                + f" GiB a rank (one device {r['one_device_peak_gib']:.2f}), "
                f"{r['staged_per_step'] / 2 ** 30:.3f} GiB staged a rank "
                "and step, loss / grad norm within "
                f"{max(r['loss_err']):.3e} / {max(r['grad_norm_err']):.3e} "
                f"of one device (control {r['control']['loss']:.3e} / "
                f"{r['control']['grad_norm']:.3e})")

    g = tm["golden"]
    print(f"[result train mesh] golden within {g['max_rel_err']:.3e}; "
          "grads " + ", ".join(
              f"{arch} {r['err']:.3e} (control {r['control']:.3e})"
              for arch, r in g["grads"].items())
          + f"; {run('main')}; {run('moe')}; 1x1 NCCL equal "
          f"{tm['nccl']['equal']}; the phases {tm['seconds']:.1f}s")


def run_train_mesh_phases(golden: dict, worlds: dict) -> dict:
    """Phase 16g (module docstring) from `run_worlds`' results: the golden,
    the shards' draw, the main path and the MoE path (jobs of the mesh
    world) each against a one-device run made here, and the 1x1 NCCL
    mesh (the nccl world) against its one-device run."""
    from repro_torch.launch import train as tlaunch

    t_all = time.perf_counter()
    out = {"golden": run_train_mesh_golden(
        golden, worlds["ranks"]["train_golden"],
        worlds["jobs_s"]["train_golden"])}
    for tag, argv in (("main", TRAIN_MESH_MAIN_ARGV),
                      ("moe", TRAIN_MESH_MOE_ARGV)):
        mesh = worlds["ranks"][f"train_{tag}"][0]
        steps = int(argv[argv.index("--steps") + 1])
        one = tlaunch.main(argv + ["--steps", str(max(steps, 2))])
        _release(f"train mesh {tag}: one device")
        out[tag] = _mesh_step_line(f"train mesh {tag}", mesh, one,
                                   mesh["cfg"])
    nccl, one = worlds["nccl"]["train"], worlds["nccl_one"]
    same = (nccl["losses"] == one["losses"]
            and nccl["grad_norms"] == one["grad_norms"])
    _check(same, f"train mesh nccl: the 1x1 mesh's losses {nccl['losses']} "
           f"and grad norms {nccl['grad_norms']} are not the one-device "
           f"step's {one['losses']}, {one['grad_norms']}")
    print(f"[train mesh nccl] {nccl['cfg'].name}, float32, "
          f"{len(one['losses'])} steps on a 1x1 NCCL mesh (every collective "
          f"over one rank: "
          + ", ".join(f"{a} {v['calls']} calls"
                      for a, v in nccl["mesh_stats"].items())
          + f"): losses {one['losses']} and grad norms {one['grad_norms']} "
          f"equal to one device's bit for bit")
    out["nccl"] = {"equal": same}
    in_world = sum(worlds["jobs_s"][n] for n in (
        "train_golden", "train_main", "train_moe"))
    out["seconds"] = time.perf_counter() - t_all + in_world
    print(f"[train mesh] the phases took {out['seconds']:.1f}s "
          f"({in_world:.1f}s of it as jobs of the mesh world; the nccl "
          f"world, shared with 9d's (d), not counted)")
    return out


def _time_bwd_shape(name: str, shape, dev) -> dict:
    """The flash-attention gradient at ``shape`` (B, L, H, KVH, D), bf16,
    causal: the ``wgmma`` route (all its launches, and each alone) from a
    CUDA graph of 10 (through the wrappers, uncounted); the ``wgmma``
    route's plain version (events); and the autograd backward of
    ``scaled_dot_product_attention(..., is_causal=True, enable_gqa=True)``
    (timed only) from a CUDA graph of 10 like the kernels — its forward
    runs on a side stream, which its backward's kernels follow and the
    graph captures — and with events around eager calls; beside the
    bound: five products of the visible (query, key) pairs at the bf16
    peak, or the bytes of q, k, v, o, do, dq, dk and dv once."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    b, L, h, kvh, d = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                   for sh in ((b, L, h, d), (b, L, kvh, d), (b, L, kvh, d),
                              (b, L, h, d)))
    scale = d ** -0.5
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    kw = dict(causal=True, scale=scale)
    delta = fa.flash_bwd_wgmma_dq_cuda(q, k, v, o, do, lse, **kw)[1]
    split = d in fa.SPLIT_DKDV_HEAD_DIMS
    # The launches after dq, each alone (reading the delta above).
    rest = ({"dv": lambda: fa.flash_bwd_wgmma_dv_cuda(q, k, v, do, lse,
                                                      delta, **kw),
             "dk": lambda: fa.flash_bwd_wgmma_dk_cuda(q, k, v, do, lse,
                                                      delta, **kw)}
            if split else
            {"dkdv": lambda: fa.flash_bwd_wgmma_dkdv_cuda(q, k, v, do, lse,
                                                          delta, **kw)})

    def wgmma():
        dq, dl = fa.flash_bwd_wgmma_dq_cuda(q, k, v, o, do, lse, **kw)
        if split:
            dv = fa.flash_bwd_wgmma_dv_cuda(q, k, v, do, lse, dl, **kw)
            return dq, fa.flash_bwd_wgmma_dk_cuda(q, k, v, do, lse, dl,
                                                  **kw), dv
        return (dq, *fa.flash_bwd_wgmma_dkdv_cuda(q, k, v, do, lse, dl,
                                                  **kw))

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)

    def max_err(got, want):
        return max(float((a.float() - w.float()).abs().max())
                   for a, w in zip(got, want))

    want = plain()
    err = max_err(wgmma(), want)
    ms = _kernel_ms(wgmma)
    part_ms = {"dq": _kernel_ms(lambda: fa.flash_bwd_wgmma_dq_cuda(
        q, k, v, o, do, lse, **kw))}
    part_ms.update({p: _kernel_ms(fn) for p, fn in rest.items()})
    plain_ms = _time_ms(plain, 2)
    library, side, backend = _sdpa_backward(q, k, v, do)
    lib_err = max_err([a.transpose(1, 2) for a in library()], want)
    del want
    library_eager_ms = _time_ms(library, 10)
    library_ms = _kernel_ms(library, stream=side)
    pairs = L * (L + 1) // 2
    ops_ms = 1e3 * 5 * 2 * b * h * pairs * d / BF16_FLOPS_PER_S
    bytes_ms = 1e3 * 2 * (4 * b * L * h * d + 4 * b * L * kvh * d) \
        / HBM_BYTES_PER_S
    bound = max(ops_ms, bytes_ms)
    res = dict(ms=ms, part_ms=part_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_eager_ms=library_eager_ms,
               library_backend=backend, bound_ms=bound,
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               max_abs_err=err, library_max_abs_err=lib_err,
               launches=fa.bwd_launches(torch.bfloat16, L, d))
    print(f"[timing flash bwd] {name} {shape} (B, L, H, KVH, D) bf16 "
          f"causal: wgmma route {ms:.4f} ms in {res['launches']} launches ("
          + ", ".join(f"{p} {t:.4f}" for p, t in part_ms.items())
          + f") (CUDA graphs of 10), plain {plain_ms:.4f} ms (the "
          f"wgmma route's), SDPA's autograd backward ({backend}) "
          f"{library_ms:.4f} ms from a CUDA graph of 10 and "
          f"{library_eager_ms:.4f} ms with events around eager calls (its "
          f"max abs diff from plain {lib_err:.3e}); bound {bound:.6f} ms by {res['bound_by']} "
          f"({ops_ms:.6f} operations, {bytes_ms:.6f} bytes): wgmma "
          f"{bound / ms:.1%} of it; max abs err from plain wgmma {err:.3e}")
    return res


def _sdpa_backward(q, k, v, do, efficient: bool = False):
    """The autograd backward of ``scaled_dot_product_attention(...,
    is_causal=True, enable_gqa=True)`` on (B, L, H, D) ``q`` and ``do``, k
    and v (B, L, KVH, D), as a callable returning (dq, dk, dv) in the
    (B, H, L, D) layout, its side stream and the backend PyTorch picks
    for these inputs (timed only, as the library's yardstick; the port
    never calls it).  Its forward runs on the side stream, which the
    backward's kernels follow, so a CUDA graph captured there holds
    them.  With ``efficient`` the memory-efficient backend is forced, on K
    and V repeated to H heads before it (dk and dv then per query head);
    a RuntimeError where that backend refuses the inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if efficient:
            g = q.shape[2] // k.shape[2]
            kt, vt = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        qt, kt, vt = (t.detach().requires_grad_() for t in (qt, kt, vt))
        if efficient:
            backend = SDPBackend.EFFICIENT_ATTENTION.name
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
        else:
            backend = SDPBackend(torch._fused_sdp_choice(
                qt, kt, vt, is_causal=True, enable_gqa=True)).name
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
    torch.cuda.current_stream().wait_stream(side)
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(out, (qt, kt, vt), dot,
                                   retain_graph=True)

    return library, side, backend


def _f32_bounds(b: int, L: int, h: int, kvh: int, d: int,
                products: int, tensors_h: int, tensors_kv: int) -> dict:
    """The float32 attention's bounds at (B, L, H, KVH, D), causal:
    ``products`` products of the visible pairs (2·D operations each) at
    the 3xTF32 rate (three TF32 passes at TF32_FLOPS_PER_S) and at the
    CUDA cores' SCALAR_OPS_PER_S, and the float32 bytes of ``tensors_h``
    (B, L, H, D) and ``tensors_kv`` (B, L, KVH, D) tensors once; bound_ms
    the larger of the 3xTF32 operations and the bytes."""
    ops_n = products * 2 * b * h * (L * (L + 1) // 2) * d
    tf32x3_ms = 1e3 * 3 * ops_n / TF32_FLOPS_PER_S
    bytes_ms = 1e3 * 4 * (tensors_h * b * L * h * d
                          + tensors_kv * b * L * kvh * d) / HBM_BYTES_PER_S
    return dict(bound_ms=max(tf32x3_ms, bytes_ms),
                bound_by="operations" if tf32x3_ms >= bytes_ms else "bytes",
                bound_tf32x3_ms=tf32x3_ms,
                bound_f32_ms=max(1e3 * ops_n / SCALAR_OPS_PER_S, bytes_ms),
                bytes_ms=bytes_ms)


def _time_fwd_f32(name: str, shape, dev) -> dict:
    """The float32 forward at ``shape`` (B, L, H, KVH, D), causal: the
    ``tf32x3`` route and the ``simt`` route (the CUDA-core kernel, the
    earlier design) from CUDA graphs of 10 (through the wrappers,
    uncounted), the plain version (events), and SDPA's float32 forward
    (timed only) from a CUDA graph of 10: with the backend PyTorch picks
    (``enable_gqa``) and the memory-efficient one on K and V repeated to H
    heads outside the graph; beside `_f32_bounds` of two products."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, L, h, kvh, d = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(sh, generator=gen, device=dev)
               for sh in ((b, L, h, d), (b, L, kvh, d), (b, L, kvh, d)))
    kw = dict(causal=True, scale=d ** -0.5, kv_offset=0)
    routes = {"tf32x3": lambda: fa.flash_prefill_tf32x3_cuda(q, k, v, **kw),
              "simt": lambda: fa.flash_attention_cuda(q, k, v, **kw)}
    want = ref.flash_attention_ref(q, k, v, causal=True)
    errs = {r: float((fn() - want).abs().max()) for r, fn in routes.items()}
    for r, e in errs.items():
        _check(e <= F32_TOL, f"[timing flash f32] {name}: the {r} forward's "
               f"max abs err {e} > {F32_TOL}")
    ms = {r: _kernel_ms(fn) for r, fn in routes.items()}
    plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                        causal=True), 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    backend = SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, is_causal=True, enable_gqa=True)).name
    g = h // kvh
    kr, vr = (t.repeat_interleave(g, dim=1) for t in (kt, vt))

    def picked():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def efficient():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)

    lib_err = float((picked().transpose(1, 2) - want).abs().max())
    library_ms = _kernel_ms(picked)
    try:
        eff_err = float((efficient().transpose(1, 2) - want).abs().max())
        eff_ms = _kernel_ms(efficient)
    except RuntimeError as e:       # the backend refuses these inputs
        eff_err, eff_ms = None, None
        print(f"[timing flash f32] {name}: SDPA's memory-efficient backend "
              f"refuses float32 here ({str(e).splitlines()[0][:120]})")
    del want
    res = dict(ms=ms["tf32x3"], simt_ms=ms["simt"], plain_ms=plain_ms,
               library_ms=library_ms, library_backend=backend,
               library_efficient_ms=eff_ms, max_abs_err=errs["tf32x3"],
               simt_max_abs_err=errs["simt"], library_max_abs_err=lib_err,
               library_efficient_max_abs_err=eff_err,
               **_f32_bounds(b, L, h, kvh, d, 2, 2, 2))
    print(f"[timing flash f32] {name} {shape} (B, L, H, KVH, D) float32 "
          f"causal forward: tf32x3 route {res['ms']:.4f} ms, simt route (the "
          f"earlier design) {res['simt_ms']:.4f} ms (CUDA graphs of 10), "
          f"plain {plain_ms:.4f} ms, SDPA float32 ({backend}) "
          f"{library_ms:.4f} ms"
          + (f", SDPA's memory-efficient backend (K/V repeated to {h} "
             f"heads) {eff_ms:.4f} ms" if eff_ms is not None else "")
          + f" (graphs of 10); bounds {res['bound_tf32x3_ms']:.6f} ms at "
          f"3xTF32 ({TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, three passes), "
          f"{res['bound_f32_ms']:.6f} ms at the {SCALAR_OPS_PER_S / 1e12:.0f}"
          f" TFLOP/s float32 peak (bytes {res['bytes_ms']:.6f}): tf32x3 "
          f"{res['bound_ms'] / res['ms']:.1%} of the first, simt "
          f"{res['bound_f32_ms'] / res['simt_ms']:.1%} of the second; max "
          f"abs err from plain tf32x3 {errs['tf32x3']:.3e}, simt "
          f"{errs['simt']:.3e}, SDPA {lib_err:.3e}"
          + (f", efficient {eff_err:.3e}" if eff_err is not None else ""))
    return res


def _time_bwd_f32(name: str, shape, dev) -> dict:
    """The flash-attention gradient at ``shape`` (B, L, H, KVH, D) in
    float32, causal: the ``tf32x3`` route and the ``simt`` route (the
    earlier design), all their launches and each alone (dq, then dk/dv,
    or dv and dk at a head dim of ``SPLIT_DKDV_HEAD_DIMS``), from CUDA
    graphs of 10 (through the wrappers, uncounted), the ``tf32x3``
    route's plain version (events), and SDPA's float32 autograd backward
    (`_sdpa_backward`: the backend PyTorch picks, and the memory-efficient
    one on K and V repeated to H heads) from a CUDA graph of 10 and (the
    picked one) with events around eager calls; beside `_f32_bounds` of
    five products and eight tensors."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    b, L, h, kvh, d = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn(sh, generator=gen, device=dev)
                   for sh in ((b, L, h, d), (b, L, kvh, d), (b, L, kvh, d),
                              (b, L, h, d)))
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    split = d in fa.SPLIT_DKDV_HEAD_DIMS
    delta = fa.flash_bwd_tf32x3_dq_cuda(q, k, v, o, do, lse, **kw)[1]
    stats = fa.flash_bwd_dq_cuda(q, k, v, o, do, **kw)[1]
    read = {"tf32x3": (lse, delta), "simt": (stats,)}
    first = {"tf32x3": lambda: fa.flash_bwd_tf32x3_dq_cuda(q, k, v, o, do,
                                                           lse, **kw),
             "simt": lambda: fa.flash_bwd_dq_cuda(q, k, v, o, do, **kw)}

    def parts(r):
        """Each launch of route ``r`` alone (the ones after dq reading
        the scratch made above)."""
        _, dkdv, dv_fn, dk_fn = fa.BWD_CUDA[r]
        out = {"dq": first[r]}
        if split:
            out["dv"] = lambda: dv_fn(q, k, v, do, *read[r], **kw)
            out["dk"] = lambda: dk_fn(q, k, v, do, *read[r], **kw)
        else:
            out["dkdv"] = lambda: dkdv(q, k, v, do, *read[r], **kw)
        return out

    def whole(r):
        _, dkdv, dv_fn, dk_fn = fa.BWD_CUDA[r]

        def run():
            dq, scratch = first[r]()
            got = (lse, scratch) if r == "tf32x3" else (scratch,)
            if split:
                dv = dv_fn(q, k, v, do, *got, **kw)
                return dq, dk_fn(q, k, v, do, *got, **kw), dv
            return (dq, *dkdv(q, k, v, do, *got, **kw))
        return run

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)

    want = plain()
    err, rel = {}, {}
    for r in ("tf32x3", "simt"):
        got = whole(r)()
        err[r] = max(float((a - w).abs().max()) for a, w in zip(got, want))
        rel[r] = max(float((a - w).abs().max() / w.abs().max())
                     for a, w in zip(got, want))
        del got
    ms = {r: _kernel_ms(whole(r)) for r in ("tf32x3", "simt")}
    part_ms = {r: {p: _kernel_ms(fn) for p, fn in parts(r).items()}
               for r in ("tf32x3", "simt")}
    plain_ms = _time_ms(plain, 2)
    library, side, backend = _sdpa_backward(q, k, v, do)
    lib_err = max(float((a.transpose(1, 2) - w).abs().max())
                  for a, w in zip(library(), want))
    library_eager_ms = _time_ms(library, 10)
    library_ms = _kernel_ms(library, stream=side)
    del library
    try:
        eff, eff_side, _ = _sdpa_backward(q, k, v, do, efficient=True)
        g = h // kvh
        got = [a.transpose(1, 2) for a in eff()]
        got[1:] = [a.reshape(b, L, kvh, g, d).sum(3) for a in got[1:]]
        eff_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        del got
        eff_ms = _kernel_ms(eff, stream=eff_side)
        del eff
    except RuntimeError as e:       # the backend refuses these inputs
        eff_err, eff_ms = None, None
        print(f"[timing flash bwd f32] {name}: SDPA's memory-efficient "
              f"backend refuses float32 here "
              f"({str(e).splitlines()[0][:120]})")
    del want
    res = dict(ms=ms["tf32x3"], part_ms=part_ms["tf32x3"],
               simt_ms=ms["simt"], simt_part_ms=part_ms["simt"],
               plain_ms=plain_ms, library_ms=library_ms,
               library_eager_ms=library_eager_ms, library_backend=backend,
               library_efficient_ms=eff_ms,
               max_abs_err=err["tf32x3"], max_rel_err=rel["tf32x3"],
               simt_max_abs_err=err["simt"], simt_max_rel_err=rel["simt"],
               library_max_abs_err=lib_err,
               library_efficient_max_abs_err=eff_err,
               launches=fa.bwd_launches(torch.float32, L, d),
               **_f32_bounds(b, L, h, kvh, d, 5, 4, 4))
    print(f"[timing flash bwd f32] {name} {shape} (B, L, H, KVH, D) "
          f"float32 causal: tf32x3 route {ms['tf32x3']:.4f} ms in "
          f"{res['launches']} launches ("
          + ", ".join(f"{p} {t:.4f}" for p, t in part_ms["tf32x3"].items())
          + f"), simt route (the earlier design) {ms['simt']:.4f} ms ("
          + ", ".join(f"{p} {t:.4f}" for p, t in part_ms["simt"].items())
          + f"; CUDA graphs of 10), plain {plain_ms:.4f} ms, SDPA's float32 "
          f"autograd backward ({backend}) {library_ms:.4f} ms from a CUDA "
          f"graph of 10 and {library_eager_ms:.4f} ms with events around "
          f"eager calls"
          + (f", SDPA's memory-efficient backend (K/V repeated to {h} "
             f"heads) {eff_ms:.4f} ms" if eff_ms is not None else "")
          + f"; bounds {res['bound_tf32x3_ms']:.6f} ms at 3xTF32 "
          f"({TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, three passes), "
          f"{res['bound_f32_ms']:.6f} ms at the "
          f"{SCALAR_OPS_PER_S / 1e12:.0f} TFLOP/s float32 peak (bytes "
          f"{res['bytes_ms']:.6f}): tf32x3 {res['bound_ms'] / ms['tf32x3']:.1%}"
          f" of the first, simt {res['bound_f32_ms'] / ms['simt']:.1%} of "
          f"the second; max abs err from plain tf32x3 {err['tf32x3']:.3e} "
          f"({rel['tf32x3']:.3e} of the largest magnitude), simt "
          f"{err['simt']:.3e} ({rel['simt']:.3e}), SDPA {lib_err:.3e}"
          + (f", efficient {eff_err:.3e}" if eff_err is not None else ""))
    return res


def time_flash_bwd(dev) -> dict:
    """`_time_bwd_shape` (the wgmma route, bf16) at each of
    BWD_TIMED_SHAPES, then `_time_bwd_f32` and `_time_fwd_f32` (the tf32x3
    and simt routes, float32) at the training shape and nemotron's (the
    forward under ``fwd``); returns the training shape's
    figures (the earlier keys, ``dq_ms`` and ``dkdv_ms`` among them) with
    every shape's under ``shapes`` and the float32 ones under ``f32``."""
    per = {name: _time_bwd_shape(name, shape, dev)
           for name, shape in BWD_TIMED_SHAPES.items()}
    _release("flash bwd timing, bf16")
    f32 = {}
    for name in ("training", "nemotron"):
        f32[name] = _time_bwd_f32(name, BWD_TIMED_SHAPES[name], dev)
        f32[name]["fwd"] = _time_fwd_f32(name, BWD_TIMED_SHAPES[name], dev)
        _release(f"flash bwd timing, float32 {name}")
    t = per["training"]
    return dict(t, dq_ms=t["part_ms"]["dq"], dkdv_ms=t["part_ms"]["dkdv"],
                shapes=per, f32=f32)


def run_train_phases(golden: dict, dev) -> dict:
    """Phase 16f: the backward kernel's checks while numpy draws the
    golden steps' weights (the ``"train"`` entry's and the
    ``"train_families"`` models') in threads (its draws release the
    interpreter lock), then the golden steps, the bf16 gradients, the main
    path, the families, nemotron's float32 step and the restart contract,
    each phase's memory released before the next."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import registry

    fams = golden["train_families"]
    torch.cuda.reset_peak_memory_stats()
    with ThreadPoolExecutor(1 + len(fams)) as pool:
        tree = pool.submit(_draw_golden_tree, golden["train"])
        trees = {name: pool.submit(_draw_golden_tree, gold)
                 for name, gold in fams.items()}
        out = {"bwd": check_flash_bwd(dev)}
        _release("flash bwd checks")
        out["golden"] = check_train_golden(golden["train"], dev,
                                           tree.result())
        del tree
        _release("train golden")
        out["families_golden"] = {}
        for name, gold in fams.items():
            out["families_golden"][name] = check_train_golden(
                gold, dev, trees.pop(name).result(),
                f"train families golden {name}")
            _release(f"train families golden {name}")
    out["bf16"] = check_train_bf16(dev)
    _release("train bf16")
    out["families_bf16"] = {}
    for arch, cuts in TRAIN_FAMILY_BF16.items():
        cfg = dataclasses.replace(registry.get(arch), **cuts)
        out["families_bf16"][arch] = check_train_bf16(
            dev, cfg, f"train families bf16 {arch.split('-')[0]}")
        _release(f"train families bf16 {arch}")
    out["main"] = run_train_main_path()
    _release("train main")
    out["families"] = run_train_families(dev)
    out["f32_d192"] = run_train_f32_d192(dev)
    _release("train f32 d192")
    out["restart"] = run_train_restart(dev)
    _release("train restart")
    return out


def run_archs_phases(golden: dict, dev) -> dict:
    """``--archs-only``: the checks of the archs that [lm main] does not
    cover, alone — [flash bwd], the ``"dense"`` and ``"audio"`` goldens,
    [dense main] and [audio main], the ``"train_families"`` goldens of
    nemotron and musicgen, phi-3-vision's and musicgen's bf16 gradients
    and training steps, [train f32 d192] and the float32 backward's and
    forward's timing (`_time_bwd_f32`, `_time_fwd_f32`)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import registry

    fams = {n: golden["train_families"][n] for n in ("nemotron", "musicgen")}
    with ThreadPoolExecutor(len(fams)) as pool:
        trees = {n: pool.submit(_draw_golden_tree, g) for n, g in fams.items()}
        out = {"bwd": check_flash_bwd(dev)}
        _release("flash bwd checks")
        out["families_golden"] = {
            n: check_train_golden(g, dev, trees.pop(n).result(),
                                  f"train families golden {n}")
            for n, g in fams.items()}
    _release("train families golden")
    for name in ("dense", "audio"):
        out[f"{name}_golden"] = check_golden_entries(golden[name], dev,
                                                     f"{name} golden")
    out["dense"] = run_dense_main_path()
    out["audio"] = _serve_full_depth(AUDIO_ARCH, "audio main")
    _release("dense and audio serving")
    archs = ("phi-3-vision-4.2b", AUDIO_ARCH)
    out["families_bf16"] = {}
    for arch in archs:
        cfg = dataclasses.replace(registry.get(arch),
                                  **TRAIN_FAMILY_BF16[arch])
        out["families_bf16"][arch] = check_train_bf16(
            dev, cfg, f"train families bf16 {arch.split('-')[0]}")
        _release(f"train families bf16 {arch}")
    out["families"] = run_train_families(dev, archs)
    out["f32_d192"] = run_train_f32_d192(dev)
    _release("train f32 d192")
    out["timing"] = {}
    for n in ("training", "nemotron"):
        out["timing"][n] = _time_bwd_f32(n, BWD_TIMED_SHAPES[n], dev)
        out["timing"][n]["fwd"] = _time_fwd_f32(n, BWD_TIMED_SHAPES[n], dev)
        _release(f"flash timing, float32 {n}")
    return out


def _lse_shapes() -> list:
    """[flash decode lse]'s shapes, a rank's part of a [serve mesh] job's
    cache: (arch, the rank's positions, the keys a ``model`` rank 1 sees
    at the job's last step); phi-3-vision's at llama's positions."""
    out = []
    for job in SERVE_MESH_JOBS:
        lc = job["prompt"] + job["cross"]
        keys = job["prompt"] + job["steps"] - lc
        if job["arch"] == "llama3.2-3b":
            out.append(("phi-3-vision-4.2b", lc, keys))
        if job["arch"] != "deepseek-v3-671b":          # MLA: no kernel
            out.append((job["arch"], lc, keys))
    return out


def check_flash_decode_lse(dev) -> dict:
    """[flash decode lse] (phase 18, module docstring): the decode route's
    output and log-sum-exp against their plain versions, and the kernel
    timed with and without the lse output."""
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref, work

    gen = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = SERVE_MESH_BATCH // 2
    shapes = _lse_shapes()
    out = {"cases": 0, "max_abs_err": 0.0, "rrms": 0.0, "lse_err": 0.0,
           "shapes": {}}
    for arch, lk, keys in shapes:
        cfg = registry.get(arch)
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = torch.randn((b, 1, h, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        k = torch.randn((b, lk, kvh, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        v = torch.randn((b, lk, kvh, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        chunk, n_chunks = fa.decode_split(b, kvh, h, lk, sms)
        for off in (lk - 1, chunk - 1, chunk, keys - 1, -1):
            before = ops.LAUNCHES["flash_decode"]
            got, lse = ops.flash_attention(q, k, v, causal=True,
                                           kv_offset=off, return_lse=True)
            torch.cuda.synchronize()
            what = f"flash decode lse {arch} kv_offset {off}"
            if off < 0:
                _check(ops.LAUNCHES["flash_decode"] == before
                       and bool((got == 0).all())
                       and bool((lse == float("-inf")).all()),
                       f"{what}: not (out 0, lse -inf, no launch)")
                continue
            _check(ops.LAUNCHES["flash_decode"] == before + 1,
                   f"{what}: the decode kernel did not launch")
            worst, rrms = _flash_close(got, ref.flash_attention_ref(
                q, k, v, causal=True, kv_offset=off), torch.bfloat16, what)
            lse_err = float((lse - ref.flash_attention_lse_ref(
                q, k, causal=True, kv_offset=off)).abs().max())
            _check(lse_err <= LSE_TOL, f"{what}: lse max abs err "
                   f"{lse_err} > {LSE_TOL}")
            out["cases"] += 1
            out["max_abs_err"] = max(out["max_abs_err"], worst)
            out["rrms"] = max(out["rrms"], rrms)
            out["lse_err"] = max(out["lse_err"], lse_err)
        scale = d ** -0.5
        buf = torch.empty((b, h, 1), dtype=torch.float32, device=dev)

        def plain():
            return (ref.flash_attention_ref(q, k, v, kv_offset=lk - 1),
                    ref.flash_attention_lse_ref(q, k, kv_offset=lk - 1))

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ops_n, nbytes = work.flash_forward(q, k, True, lk - 1, True)
        ops_ms = 1e3 * ops_n / BF16_FLOPS_PER_S
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        out["shapes"][arch] = dict(
            shape=(b, lk, h, kvh, d), chunk=chunk, splits=n_chunks,
            ms=_kernel_ms(lambda: fa.flash_decode_cuda(
                q, k, v, causal=True, scale=scale, kv_offset=lk - 1)),
            lse_ms=_kernel_ms(lambda: fa.flash_decode_cuda(
                q, k, v, causal=True, scale=scale, kv_offset=lk - 1,
                lse=buf)),
            plain_ms=_time_ms(plain, 3),
            library_ms=_kernel_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True)),
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    _check(out["cases"] == 4 * len(shapes),
           f"flash decode lse: {out['cases']} cases")
    print(f"[flash decode lse] {out['cases']} cases (every key, one split, "
          f"a key past it, the keys a model rank 1 sees at the job's last "
          f"step; B {b}, each job's positions a rank: "
          + ", ".join(f"{a.split('-')[0]} {lk} ({keys} on rank 1)"
                      for a, lk, keys in shapes)
          + f") and {len(shapes)} with no key visible (no launch): output "
          f"max abs err {out['max_abs_err']:.3e}, bf16 relative RMS "
          f"{out['rrms']:.3e} (limits atol = rtol = {BF16_TOL}, "
          f"{BF16_RMS_TOL}); lse max abs err {out['lse_err']:.3e} (limit "
          f"{LSE_TOL}); kernel ms without / with lse (CUDA graph of 10), "
          f"plain, SDPA (output alone), bound: "
          + "; ".join(f"{a} {r['shape']} {r['ms']:.4f} / {r['lse_ms']:.4f}"
                      f", {r['plain_ms']:.4f}, {r['library_ms']:.4f}, "
                      f"{r['bound_ms']:.6f} ({r['bound_by']})"
                      for a, r in out["shapes"].items()))
    return out


def _serve_mesh_jobs() -> list:
    """`mesh_smoke.rank_serve_mesh`'s jobs of SERVE_MESH_JOBS on the 2x2
    mesh (full configs, the seeded weights)."""
    return [dict(arch=j["arch"], smoke=False, cut=j["cut"], seed=0,
                 batch=SERVE_MESH_BATCH, prompt=j["prompt"],
                 steps=j["steps"], max_len=2 * (j["prompt"] + j["cross"]),
                 shape=(2, 2), axes=("data", "model"), timeout_s=900,
                 fault_from=j["cross"] if j["faults"] else None)
            for j in SERVE_MESH_JOBS]


def _rrms(got, want) -> float:
    return float(np.sqrt(((got - want) ** 2).mean())
                 / np.sqrt((want ** 2).mean()))


def _serve_routes(job: dict, cfg, got: list, want: list) -> dict:
    """A MoE job's expert picks on the mesh (rank 0's routes, one device's
    token order) against one device's, call by call (module docstring at
    SERVE_MESH_JOBS): equal wherever the router's margin exceeds twice the
    router-logit difference; per step, the rows whose own token's pick
    differs (step 0: the prompt's last position)."""
    from repro_torch.models import model

    k, b = cfg.top_k, job["batch"]
    moe = sum(kind == "moe" for kind in model.layer_kinds(cfg))
    _check(len(got) == len(want) == moe * (1 + job["steps"]),
           f"serve mesh {job['arch']}: {len(got)} MoE calls on the mesh, "
           f"{len(want)} on one device, not {moe * (1 + job['steps'])}")
    out = dict(calls=len(got), picks=0, differ=0, margin=math.inf,
               logit_diff=0.0, flipped=[0] * (1 + job["steps"]))
    flipped = [np.zeros(b, bool) for _ in range(1 + job["steps"])]
    for c, ((im, lm), (io, lo)) in enumerate(zip(got, want)):
        s = -np.sort(-lo, -1)
        gap = (s[:, :k] - s[:, 1:k + 1]).min(-1)
        diff = np.abs(lm - lo).max(-1)
        bad = (im != io).any(-1)
        unsure = bad & (gap > 2 * diff)
        _check(not unsure.any(), f"serve mesh {job['arch']}: MoE call {c} "
               f"picks other experts than one device's at tokens "
               f"{np.flatnonzero(unsure)[:8].tolist()}, where the router's "
               f"margin exceeds twice the logits' difference")
        out["picks"] += im.size
        out["differ"] += int((im != io).sum())
        out["margin"] = min(out["margin"], float((s[:, k - 1] - s[:, k])
                                                 .min()))
        out["logit_diff"] = max(out["logit_diff"], float(diff.max()))
        flipped[c // moe] |= bad.reshape(b, -1)[:, -1]
    out["flipped"] = [int(f.sum()) for f in flipped]
    out["flipped_rows"] = flipped
    return out


def run_serve_mesh(dev, worlds: dict) -> dict:
    """[serve mesh] (phase 18, module docstring): each job on the 2x2 mesh
    (the mesh world's ``serve`` job, fed one device's tokens) against its
    one-device run (`run_worlds`); returns per arch the one-device and
    per-rank results and the checks' numbers, and for the jobs with
    ``faults`` the planted faults' and the split check's (checked by
    `check_serve_mesh_faults`)."""
    from repro_torch.launch import mesh_smoke
    from repro_torch.models import model

    jobs, ones = worlds["serve_jobs"], worlds["one"]
    ranks = worlds["ranks"]["serve"]
    out = {}
    for j, job in enumerate(jobs):
        cfg = mesh_smoke.serve_cfg(job)
        want, got = ones[j], ranks[0][j]
        routes = _serve_routes(job, cfg, got["routes"], want["routes"]) \
            if cfg.num_experts else None
        rrms, gaps = [], []
        for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            keep = np.ones(job["batch"], bool) if routes is None \
                else ~routes["flipped_rows"][step]
            _check(keep.any(), f"serve mesh {job['arch']}: every row's pick "
                   f"differs at step {step}")
            rrms.append(_rrms(g[keep], w[keep]))
            top2 = np.sort(w[:, -1].reshape(w.shape[0], -1), -1)[:, -2:]
            gaps.append(top2[:, 1] - top2[:, 0])
            if step < len(got["tokens"]):
                diff = np.abs(g - w).reshape(g.shape[0], -1).max(-1)
                sure = (gaps[-1] > 2 * diff) & keep
                rows = np.concatenate([r[j]["tokens"][step] for r in
                                       ranks[::2]])[:, 0]
                mine = np.asarray(want["tokens"][step])[:, 0]
                _check(bool((rows[sure] == mine[sure]).all()),
                       f"serve mesh {job['arch']}: step {step}'s greedy "
                       f"tokens {rows} differ from one device's {mine} "
                       f"where its top-2 gap {gaps[-1]} is sure")
        control = float(np.sqrt(((want["logits"][1] - want["logits"][0])
                                 ** 2).mean())
                        / np.sqrt((want["logits"][0] ** 2).mean()))
        _check(max(rrms) <= SERVE_MESH_RRMS, f"serve mesh {job['arch']}: "
               f"logits' relative RMS per step {rrms} > {SERVE_MESH_RRMS}")
        attn = 0 if cfg.attention == "mla" else sum(
            k != "mamba" for k in model.layer_kinds(cfg))
        lc = job["max_len"] // 2
        for r in ranks:
            m = r[j]["rank"] % 2
            steps_seen = sum(job["prompt"] + i >= m * lc
                             for i in range(job["steps"]))
            want_l = {"flash_wgmma": attn, "flash_decode": attn * steps_seen,
                      "flash_simt": 0}
            have = {k: r[j]["launches"][k] for k in want_l}
            _check(have == want_l, f"serve mesh {job['arch']} rank "
                   f"{r[j]['rank']}: launches {have}, not {want_l}")
        print(f"[serve mesh] {cfg.name}, {cfg.num_layers} layers at full "
              f"width (d {cfg.d_model}"
              + (f", {cfg.num_experts} experts, top-{cfg.top_k}, capacity "
                 f"factor {cfg.capacity_factor:g}" if cfg.num_experts
                 else "")
              + f"), {cfg.dtype}, batch {job['batch']}, prompt "
              f"{job['prompt']}, {job['steps']} greedy steps on a 2x2 gloo "
              f"mesh of 4 ranks sharing the card, caches of 2 x {lc} "
              f"positions: logits' bf16 relative RMS per step "
              + ", ".join(f"{x:.2e}" for x in rrms)
              + f" (limit {SERVE_MESH_RRMS}; control, one device's step 1 "
              f"against its step 0: {control:.3f})"
              + (f"; expert picks of {routes['calls']} MoE calls "
                 f"({routes['picks']} picks): {routes['differ']} differ from "
                 f"one device's, each where the router's margin is within "
                 f"twice the two runs' router-logit difference (largest "
                 f"{routes['logit_diff']:.3e}); the smallest k-th/(k+1)-th "
                 f"margin {routes['margin']:.3e}; rows left out of each "
                 f"step's logits for a differing pick of their own token "
                 f"{routes['flipped']}" if routes else "")
              + f"; one device prefill {want['prefill_s']:.3f}s, decode "
              f"{want['decode_ms']:.2f} ms a step, peak "
              f"{want['peak_gib']:.2f} GiB; per rank: "
              + "; ".join(
                  f"rank {r[j]['rank']} prefill {r[j]['prefill_s']:.3f}s, "
                  f"decode {r[j]['decode_ms']:.2f} ms a step, launches "
                  f"wgmma {r[j]['launches']['flash_wgmma']} / decode "
                  f"{r[j]['launches']['flash_decode']}, "
                  + ", ".join(f"{a} {v['calls']} calls / "
                              f"{v['bytes'] / 2 ** 20:.1f} MiB"
                              for a, v in r[j]["mesh_stats"].items())
                  + f", staged {r[j]['staged_bytes'] / 2 ** 30:.3f} GiB, "
                  f"peak {r[j]['peak_gib']:.2f} GiB" for r in ranks))
        out[job["arch"]] = dict(one=want, ranks=[r[j] for r in ranks],
                                rrms=rrms, control=control, job=job)
        if routes is not None:
            del routes["flipped_rows"]
            out[job["arch"]]["routes"] = routes
        if job["fault_from"] is not None:
            out[job["arch"]]["faults"] = _serve_mesh_faults(job, want, got,
                                                            rrms)
    out["seconds"] = worlds["jobs_s"]["serve"]
    return out


def _serve_mesh_faults(job: dict, want: dict, got: dict, rrms: list
                       ) -> dict:
    """The planted faults' logits against one device's, and the split
    check's readings (`mesh_smoke._fault_steps`, `_split_check`), one
    line."""
    first = job["fault_from"]
    steps = range(first, job["steps"])
    fault = {f: [_rrms(g, want["logits"][1 + i]) for i, g in zip(steps, xs)]
             for f, xs in got["fault_logits"].items()}
    sound = rrms[1 + first:]
    print(f"[serve mesh] {job['arch']} planted faults, steps {first}-"
          f"{job['steps'] - 1} decoded again on the run's caches: logits' "
          f"relative RMS per step, sound "
          + ", ".join(f"{x:.2e}" for x in sound)
          + "; model rank 1 lost " + ", ".join(f"{x:.2e}" for x in
                                                fault["lost"])
          + "; lse ignored " + ", ".join(f"{x:.2e}" for x in fault["lse"])
          + f" (limit {SERVE_MESH_RRMS}); split check (a decode step's "
          f"attention alone, seeded, against one device's), relative RMS "
          f"sound / lost / lse ignored: "
          + "; ".join(f"model rank 1 seeing {keys} keys "
                      + " / ".join(f"{r[m]:.3e}" for m in ("sound", "lost",
                                                           "lse"))
                      for keys, r in got["split"].items())
          + f" (limit {SERVE_MESH_SPLIT_RRMS})")
    return dict(sound=sound, logits=fault, split=got["split"])


def check_serve_mesh_faults(serve: dict) -> None:
    """The planted faults must fail the checks a sound run passes: a merge
    that ignores the lse fails the logits' limit; the split check's limit
    passes the sound merge and fails both faults (GQA's and MLA's)."""
    for arch, res in serve.items():
        if not isinstance(res, dict) or "faults" not in res:
            continue
        f = res["faults"]
        _check(min(f["logits"]["lse"]) > SERVE_MESH_RRMS, f"serve mesh "
               f"{arch}: a merge ignoring the lse gives logits within "
               f"{SERVE_MESH_RRMS} ({f['logits']['lse']}): the check cannot "
               f"see it")
        for keys, r in f["split"].items():
            _check(r["sound"] <= SERVE_MESH_SPLIT_RRMS, f"serve mesh {arch} "
                   f"split check, rank 1 seeing {keys} keys: sound merge "
                   f"{r['sound']} > {SERVE_MESH_SPLIT_RRMS}")
            _check(min(r["lost"], r["lse"]) > SERVE_MESH_SPLIT_RRMS,
                   f"serve mesh {arch} split check, rank 1 seeing {keys} "
                   f"keys: a planted fault within the limit ({r})")


def run_dryrun_check(train_main: dict, serve: dict) -> dict:
    """[dryrun check] (phase 18, module docstring): the dry-run's traces
    of [train mesh main]'s step and [serve mesh]'s llama run against
    their measured collectives and peaks on rank 0."""
    from repro_torch.configs import registry
    from repro_torch.distributed.comm import ShapeMesh
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    def mesh():
        return ShapeMesh((2, 2), ("data", "model"))

    def line(tag, rec, measured_peak):
        r = rec["roofline"]
        rel = abs(rec["peak_bytes"] - measured_peak) / measured_peak
        print(f"[dryrun check] {tag}: FLOPs {rec['flops_per_device']:.4e}, "
              f"bytes {rec['bytes_per_device']:.4e}, collective "
              f"{rec['collective']['per_device_bytes']:.4e} a device; "
              f"roofline compute {r['compute_s']:.4e} s, memory "
              f"{r['memory_s']:.4e} s, collective {r['collective_s']:.4e} "
              f"s ({r['dominant']}); traced in {rec['trace_s']:.2f}s")
        return rel

    out = {}
    argv = TRAIN_MESH_MAIN_ARGV
    cut = int(argv[argv.index("--num-layers") + 1])
    batch = int(argv[argv.index("--batch") + 1])
    seq = int(argv[argv.index("--seq-len") + 1])
    cfg = dataclasses.replace(registry.get("llama3.2-3b"), num_layers=cut)
    rec = dryrun.lower_cell("llama3.2-3b", "train_mesh", multi_pod=False,
                            cfg=cfg, mesh=mesh(),
                            shape=ShapeConfig("train_mesh", "train", seq,
                                              batch))
    _check(rec["status"] == "ok", f"dryrun check train: {rec}")
    want = train_main["stats_per_step"]
    got = rec["collective"]["by_axis"]
    _check(got == want, f"dryrun check train: dry stats {got}, measured "
           f"{want} a step")
    peak = train_main["peak_gib"][0] * 2 ** 30
    rel = line("train mesh main", rec, peak)
    _check(rel <= DRYRUN_PEAK_RTOL, f"dryrun check train: dry peak "
           f"{rec['peak_bytes'] / 2 ** 30:.3f} GiB against the measured "
           f"{peak / 2 ** 30:.3f} GiB ({rel:.1%})")
    print(f"[dryrun check] train mesh main: collectives by axis {got} equal "
          f"the measured ones a step; peak {rec['peak_bytes'] / 2 ** 30:.3f}"
          f" GiB against the measured {peak / 2 ** 30:.3f} on rank 0 "
          f"({rel:.1%}, limit {DRYRUN_PEAK_RTOL:.0%})")
    out["train"] = dict(rec=rec, peak_rel=rel)
    job = SERVE_MESH_JOBS[0]
    arch, steps = job["arch"], job["steps"]
    cfg = dataclasses.replace(registry.get(arch), num_patches=0,
                              **job["cut"])
    pre = dryrun.lower_cell(arch, "serve_prefill", multi_pod=False, cfg=cfg,
                            mesh=mesh(), shape=ShapeConfig(
                                "serve_prefill", "prefill",
                                job["prompt"], SERVE_MESH_BATCH))
    dec = dryrun.lower_cell(arch, "serve_decode", multi_pod=False, cfg=cfg,
                            mesh=mesh(), shape=ShapeConfig(
                                "serve_decode", "decode",
                                2 * (job["prompt"] + job["cross"]),
                                SERVE_MESH_BATCH))
    _check(pre["status"] == dec["status"] == "ok",
           f"dryrun check serve: {pre.get('error')} {dec.get('error')}")
    got = {a: {k: pre["collective"]["by_axis"][a][k] + steps
               * dec["collective"]["by_axis"][a][k] for k in ("calls",
                                                              "bytes")}
           for a in pre["collective"]["by_axis"]}
    rank0 = serve[arch]["ranks"][0]
    _check(got == rank0["mesh_stats"], f"dryrun check serve: dry stats "
           f"{got} (prefill + {steps} decode steps), measured "
           f"{rank0['mesh_stats']}")
    peak = rank0["peak_gib"] * 2 ** 30
    dry_peak = max(pre["peak_bytes"], dec["peak_bytes"])
    line("serve mesh prefill", pre, peak)
    line("serve mesh decode", dec, peak)
    rel = abs(dry_peak - peak) / peak
    _check(rel <= DRYRUN_PEAK_RTOL, f"dryrun check serve: dry peak "
           f"{dry_peak / 2 ** 30:.3f} GiB against the measured "
           f"{peak / 2 ** 30:.3f} GiB ({rel:.1%})")
    print(f"[dryrun check] serve mesh {arch}: collectives by axis {got} "
          f"equal the measured ones (prefill + {steps} decode "
          f"steps); peak {dry_peak / 2 ** 30:.3f} GiB (prefill "
          f"{pre['peak_bytes'] / 2 ** 30:.3f}, a decode step "
          f"{dec['peak_bytes'] / 2 ** 30:.3f}) against the measured "
          f"{peak / 2 ** 30:.3f} on rank 0 ({rel:.1%}, limit "
          f"{DRYRUN_PEAK_RTOL:.0%})")
    out["serve"] = dict(prefill=pre, decode=dec, peak_rel=rel)
    return out


def _dryrun_sweep_cells() -> dict:
    """[dryrun sweep]'s traces (host work alone, module docstring): the
    three BPT cells and ``DRYRUN_SWEEP_CELLS`` on 16x16, and their
    seconds."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    recs = [dryrun.lower_bpt_cell(w, multi_pod=False)
            for w in ("sample", "graph", "graph_q")]
    recs += [dryrun.lower_cell(arch, shape, multi_pod=False)
             for arch, shape in DRYRUN_SWEEP_CELLS]
    return dict(recs=recs, seconds=time.perf_counter() - t0)


def check_dryrun_sweep(sweep: dict) -> dict:
    """[dryrun sweep] (phase 18, module docstring): one line a cell of
    `_dryrun_sweep_cells`'s, none in error, within the budget."""
    from repro_torch.launch import dryrun

    recs, secs = sweep["recs"], sweep["seconds"]
    for rec in recs:
        print(f"[dryrun sweep] {rec['arch']:28s} {rec['shape']:12s} "
              f"{rec['mesh']} {dryrun.summary(rec)}")
    count = {s: sum(r["status"] == s for r in recs)
             for s in ("ok", "skipped", "unsupported", "error")}
    _check(count["error"] == 0, "dryrun sweep: cells in error: " + ", ".join(
        f"{r['arch']} {r['shape']}: {r.get('error')}" for r in recs
        if r["status"] == "error"))
    _check(secs <= DRYRUN_SWEEP_BUDGET_S, f"dryrun sweep: {secs:.1f}s > "
           f"{DRYRUN_SWEEP_BUDGET_S}s")
    print(f"[dryrun sweep] 16x16: " + ", ".join(
        f"{n} {s}" for s, n in count.items()) + f" of {len(recs)} cells "
        f"in {secs:.1f}s "
        f"(budget {DRYRUN_SWEEP_BUDGET_S:.0f}s)")
    return dict(count=count, seconds=secs,
                fits=sum(bool(r.get("fits")) for r in recs))


def _serve_mesh_result(sm: dict) -> None:
    """Phase 18's numbers on one result line (the end of the output)."""
    lse = sm["lse"]["shapes"]
    print("[result serve mesh] decode kernel without / with lse "
          + ", ".join(f"{a} {r['ms']:.4f} / {r['lse_ms']:.4f} ms"
                      for a, r in lse.items())
          + "; " + "; ".join(
              f"{a} on 2x2: prefill {r['ranks'][0]['prefill_s']:.3f}s, "
              f"decode {r['ranks'][0]['decode_ms']:.1f} ms a step (one "
              f"device {r['one']['prefill_s']:.3f}s, "
              f"{r['one']['decode_ms']:.2f} ms), "
              f"{r['ranks'][0]['staged_bytes'] / 2 ** 30:.3f} GiB staged a "
              f"rank, logits within {max(r['rrms']):.2e}"
              + (f", {r['routes']['differ']} of {r['routes']['picks']} "
                 f"expert picks differ (margin {r['routes']['margin']:.2e})"
                 if "routes" in r else "")
              for a, r in sm["serve"].items() if a != "seconds")
          + f"; dry-run peaks within {sm['check']['train']['peak_rel']:.1%}"
          f" (train) and {sm['check']['serve']['peak_rel']:.1%} (serve); "
          f"sweep {sm['sweep']['count']} in {sm['sweep']['seconds']:.1f}s; "
          f"the phases {sm['seconds']:.1f}s")


def run_serve_mesh_phases(dev, train_main: dict, worlds: dict) -> dict:
    """Phase 18 (module docstring); ``train_main`` is [train mesh
    main]'s line (`_mesh_step_line`), ``worlds`` `run_worlds`' results
    (the serving job, and the sweep traced beside the world, or traced
    here when it was not)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    lse = check_flash_decode_lse(dev)
    print(f"[flash decode lse] peak device memory {_peak_gib():.2f} GiB")
    _release("flash decode lse")
    serve = run_serve_mesh(dev, worlds)
    sweep = check_dryrun_sweep(worlds.get("sweep") or _dryrun_sweep_cells())
    check = run_dryrun_check(train_main, serve)
    check_serve_mesh_faults(serve)
    secs = time.perf_counter() - t0 + serve["seconds"]
    print(f"[serve mesh] the phases took {secs:.1f}s (serving "
          f"{serve['seconds']:.1f}s of it, a job of the mesh world; the "
          f"sweep {sweep['seconds']:.1f}s "
          + ("beside the world, not counted)" if "sweep" in worlds
             else "here)"))
    return dict(lse=lse, serve=serve, check=check, sweep=sweep,
                seconds=secs)


def _time_line(t_all: float) -> None:
    """[time]: each phase's seconds (from one release to the next; the
    mesh world's jobs apart), the whole run's, and the limit."""
    total = time.time() - t_all
    print("[time] seconds by phase: " + ", ".join(
        f"{what} {sec:.1f}" for what, sec in _PHASE_S)
          + "; the mesh world's jobs: " + ", ".join(
              f"{what} {sec:.1f}" for what, sec in _WORLD_JOBS_S.items())
          + f"; the whole run {total:.1f}s of the {TIME_LIMIT_S:.0f}s "
          f"limit")


def main(argv=None) -> int:
    import argparse
    from concurrent.futures import ThreadPoolExecutor

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-mesh-only", action="store_true",
                    help="build, then run phase 16g (sharded training) "
                         "alone; no kernels line")
    ap.add_argument("--serve-mesh-only", action="store_true",
                    help="build, then run [train mesh main] (one step) "
                         "and phase 18 alone; no kernels line")
    ap.add_argument("--archs-only", action="store_true",
                    help="build, then run [flash bwd], the dense and audio "
                         "goldens and main paths, nemotron's and "
                         "musicgen's train-family goldens, phi-3-vision's "
                         "and musicgen's training, [train f32 d192] and "
                         "the float32 backward's and forward's timing alone "
                         "(`run_archs_phases`); no kernels line")
    ap.add_argument("--worlds-only", action="store_true",
                    help="build, then run the mesh world of 9d with every "
                         "job and check phases 9d (without its one-device "
                         "builds), 16c, 16g and 18 alone; no kernels line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    t_all = time.time()
    gpu = _gpu_line()
    dev = torch.device("cuda")
    print(f"[env] {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f} "
          f"GiB of device memory")
    with open(GOLDEN) as f:
        golden = json.load(f)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} in {build_s:.2f}s")
    for name in _build.SOURCES:
        log = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        print(f"[build] {name}: {len(regs)} kernel(s), registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
              f"(stores + loads) {sum(spills)}" if regs
              else f"[build] {name}: no ptxas report")
    # cover_counts_kernel<W, Q, 16-byte loads>: registers per instantiation.
    cover = re.findall(r"cover_counts_kernelILi(\d)ELi(\d)ELb(\d)E.*?Used "
                       r"(\d+) registers", _build.build_log("coverage"),
                       re.S)
    print("[build] coverage registers (W, Q, 16-byte loads): "
          + ", ".join(f"({w}, {q}, {v == '1'}) {r}" for w, q, v, r in cover))
    # flash_bwd_dq_kernel<T, NT> and flash_bwd_dkdv_kernel<T, NT, part>
    # (part 1 dv alone, 2 dk alone at D 192): registers and spill bytes.
    bwd = re.findall(r"(flash_bwd_\w+?_kernel)I(\w+?)Li(\d+)E(?:Li(\d)E)?"
                     r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                     r".*?Used (\d+) registers", _build.build_log(
                         "flash_attention_bwd"), re.S)
    bwd_simt = {f"{({'1': 'dv', '2': 'dk'}.get(part, k[10:-7]))} "
                f"{'bf16' if 'bfloat' in t else 'f32'} {nt}": {
                    "registers": int(r), "spill_bytes": int(a) + int(b)}
                for k, t, nt, part, a, b, r in bwd}
    print("[build] flash_attention_bwd registers (spill bytes) per kernel, "
          "dtype and D/16 bucket: "
          + ", ".join(f"{n} {v['registers']} ({v['spill_bytes']})"
                      for n, v in bwd_simt.items()))
    # flash_bwd_dq_kernel<D> and flash_bwd_dkdv_kernel<D, part> (the wgmma
    # route; part 1 dv alone, 2 dk alone at D 192): registers at launch
    # (ptxas's figure for 384 threads; setmaxnreg then moves the producer
    # warpgroup to 24 and the consumers to 240) and spill bytes.
    bwd_wgmma = {f"{({'1': 'dv', '2': 'dk'}.get(part, k))} D {d}": {
        "registers": int(r), "spill_bytes": int(a) + int(b)}
        for k, d, part, a, b, r in re.findall(
            r"flash_bwd_(dq|dkdv)_kernelILi(\d+)E(?:Li(\d)E)?.*?(\d+) "
            r"bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) "
            r"registers", _build.build_log("flash_bwd_wgmma"), re.S)}
    print("[build] flash_bwd_wgmma registers (spill bytes) per launch and "
          "head dim: " + ", ".join(f"{n} {v['registers']} "
                                  f"({v['spill_bytes']})"
                                  for n, v in sorted(bwd_wgmma.items())))
    # flash_prefill_kernel<D>: registers and spill bytes per head dim.
    wgmma = re.findall(r"flash_prefill_kernelILi(\d+)E.*?(\d+) bytes spill "
                       r"stores, (\d+) bytes spill loads.*?Used (\d+) "
                       r"registers", _build.build_log("flash_prefill_wgmma"),
                       re.S)
    print("[build] flash_prefill_wgmma registers (spill bytes) per head dim: "
          + ", ".join(f"D {d} {r} ({int(a) + int(b)})"
                      for d, a, b, r in wgmma))
    # flash_prefill_tf32x3_kernel<D>, flash_bwd_tf32x3_dq_kernel<D> and
    # flash_bwd_tf32x3_dkdv_kernel<D, part> (part 1 dv alone, 2 dk alone at
    # D 192): registers and spill bytes.
    tf32x3 = {
        f"{({'1': 'dv', '2': 'dk'}.get(part, k or 'prefill'))} D {d}": {
        "registers": int(r), "spill_bytes": int(a) + int(b)}
        for k, d, part, a, b, r in re.findall(
            r"flash_(?:prefill|bwd)_tf32x3_(?:(dq|dkdv)_)?kernelILi(\d+)E"
            r"(?:Li(\d)E)?.*?(\d+) bytes spill stores, (\d+) bytes spill "
            r"loads.*?Used (\d+) registers",
            _build.build_log("flash_prefill_tf32x3")
            + _build.build_log("flash_bwd_tf32x3"), re.S)}
    print("[build] tf32x3 registers (spill bytes) per launch and head dim: "
          + ", ".join(f"{n} {v['registers']} ({v['spill_bytes']})"
                      for n, v in sorted(tf32x3.items())))
    if args.archs_only:
        run_archs_phases(golden, dev)
        _time_line(t_all)
        print(f"[result] the archs' phases alone, {time.time() - t_all:.1f}s "
              f"with the build")
        print(_gpu_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.serve_mesh_only or args.train_mesh_only or args.worlds_only:
        if args.serve_mesh_only:
            worlds = run_worlds(golden, mesh=False, a2a=False, train=False,
                                train_main_argv=TRAIN_MESH_MAIN_ARGV[:-1]
                                + ["1"], beside=False)
            res = worlds["ranks"]["train_main"][0]
            main_line = dict(stats_per_step={
                a: {k: v / len(res["losses"]) for k, v in st.items()}
                for a, st in res["mesh_stats"].items()},
                peak_gib=res["rank_peak_gib"])
            _serve_mesh_result(run_serve_mesh_phases(dev, main_line, worlds))
            what = "[train mesh main] and phase 18"
        elif args.train_mesh_only:
            worlds = run_worlds(golden, mesh=False, a2a=False, serve=False,
                                beside=False)
            _train_mesh_result(run_train_mesh_phases(golden, worlds))
            what = "the train mesh phases"
        else:
            worlds = run_worlds(golden, beside=False)
            check_mesh_phase(worlds, {"a": math.nan, "b": math.nan})
            run_moe_a2a_phase(golden, worlds)
            train_mesh = run_train_mesh_phases(golden, worlds)
            _serve_mesh_result(run_serve_mesh_phases(
                dev, train_mesh["main"], worlds))
            _train_mesh_result(train_mesh)
            what = "the mesh world's phases"
        _time_line(t_all)
        print(f"[result] {what} alone, {time.time() - t_all:.1f}s with the "
              f"build")
        print(_gpu_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    torch.cuda.reset_peak_memory_stats()
    err = check_kernels(dev)
    print(f"[kernels] peak device memory {_peak_gib():.2f} GiB")

    out, launches = run_main_path(golden, "ic")
    check_outputs(out, golden)
    torch.cuda.reset_peak_memory_stats()
    fe = time_tile_kernel(out["store"], "ic")
    cc = time_cover_counts(out["store"])
    print(f"[timing ic] peak device memory {_peak_gib():.2f} GiB")
    ic = dict(build_s=out["build_s"], flush_s=out["flush_s"],
              reflush_s=out["reflush_s"],
              **{k: out[k] for k in ("snapshot_mib", "save_s", "restore_s")})
    # The LT stacks (prob, cb) take another 24.2 GiB at this size: release
    # the IC graph, its 24.2 GiB of tiles and the pools first, so that each
    # phase's peak device memory is its own.
    del out
    _release("IC phase")

    tier = run_tier_phase(golden)
    _release("tier phase")
    stream_ic = run_stream_phase(golden, "ic")
    _release("IC stream phase")

    out_lt, launches_lt = run_main_path(golden, "lt")
    check_outputs_lt(out_lt, golden)
    torch.cuda.reset_peak_memory_stats()
    lse = time_tile_kernel(out_lt["store"], "lt")
    print(f"[timing lt] peak device memory {_peak_gib():.2f} GiB")
    lt = dict(build_s=out_lt["build_s"], reflush_s=out_lt["reflush_s"],
              **{k: out_lt[k] for k in ("snapshot_mib", "save_s",
                                        "restore_s")})
    # The LM phases hold up to ~10 GiB: release the LT graph, its 24.2 GiB
    # of tiles and the pools first, as the IC phase's are above.
    del out_lt
    _release("LT phase")
    stream_lt = run_stream_phase(golden, "lt")
    _release("LT stream phase")
    unfused = run_unfused_phase(golden)
    _release("unfused phase")
    grid = run_table1_grid()
    _release("Table-1 grid")
    worlds = run_worlds(golden)
    # The "dense" and "audio" golden weights, drawn on the host (niced)
    # while phases 10-15 run on the card: beside the world's ranks they
    # passed the machine's 96 GiB.
    late = ThreadPoolExecutor(3)
    _predraw_entries(late, golden, ("dense", "audio"))
    late.shutdown(wait=False)
    mesh = check_mesh_phase(worlds, {"a": ic["build_s"], "b": lt["build_s"]})
    _release("mesh phase")

    q = run_q_phases(golden, dev)
    _release("quantised phases")

    torch.cuda.reset_peak_memory_stats()
    flash_err = check_flash(dev)
    print(f"[flash] peak device memory {_peak_gib():.2f} GiB")
    lm_gold = check_lm_golden(golden, dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_gold = check_golden_entries(golden["moe"], dev, "moe golden")
    ssm_gold = check_golden_entries(golden["ssm"], dev, "ssm golden")
    vlm_gold = check_golden_entries(golden["vlm"], dev, "vlm golden")
    dense_gold = check_golden_entries(golden["dense"], dev, "dense golden")
    audio_gold = check_golden_entries(golden["audio"], dev, "audio golden")
    lm_bf16 = check_lm_bf16(dev)
    ssm_bf16 = check_lm_bf16(dev, "zamba2-2.7b",
                             golden["ssm"]["zamba2"]["num_layers"],
                             "ssm bf16")
    vlm_bf16 = check_lm_bf16(dev, VLM_ARCH,
                             golden["vlm"]["phi3v"]["num_layers"],
                             "vlm bf16", patches=True)
    gc.collect()
    torch.cuda.empty_cache()
    lm = run_lm_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    moe = run_moe_main_path()
    a2a = run_moe_a2a_phase(golden, worlds)
    _release("MoE phases")
    ssm = run_ssm_main_path()
    _release("SSD phases")
    vlm = run_vlm_main_path(dev)
    _release("VLM phases")
    nemo = run_nemotron_serving()
    _release("nemotron serving")
    dense = run_dense_main_path()
    audio = _serve_full_depth(AUDIO_ARCH, "audio main")
    _release("dense and audio serving")
    train = run_train_phases(golden, dev)
    _release("training phases")
    train_mesh = run_train_mesh_phases(golden, worlds)
    _release("train mesh phases")
    served = run_serve_mesh_phases(dev, train_mesh["main"], worlds)
    _release("serve mesh phases")
    del worlds
    fam = train["families"]
    torch.cuda.reset_peak_memory_stats()
    fl = time_flash(dev)
    fb = time_flash_bwd(dev)
    print(f"[timing flash] peak device memory {_peak_gib():.2f} GiB")
    # The share of each (b) prefill that its attention launches take.
    share = {name: r["launches"]["flash_wgmma"] * fl[shape]["ms"]
             / (1e3 * r["prefill_s"])
             for name, r, shape in (("zamba2", ssm["zamba2-2.7b"]["b"],
                                     "zamba2_prefill"),
                                    ("phi", vlm["b"], "phi_prefill"))}

    print(f"[result] build {build_s:.2f}s; IC pool build {ic['build_s']:.3f}s "
          f"for 64 batches ({64 / ic['build_s']:.2f} batches/s), mixed flush "
          f"{ic['flush_s'] * 1e3:.2f} ms (first in the process), "
          f"{ic['reflush_s'] * 1e3:.2f} ms (after the refresh); LT pool build "
          f"{lt['build_s']:.3f}s ({64 / lt['build_s']:.2f} "
          f"batches/s), mixed flush {lt['reflush_s'] * 1e3:.2f} ms after "
          f"the refresh; LM llama3.2-3b (b) prefill "
          f"{lm['b']['prefill_tok_s']:.0f} tokens/s, decode "
          f"{lm['b']['decode_ms']:.3f} ms/step; "
          + "; ".join(f"{arch} (b) prefill {r['b']['prefill_tok_s']:.0f} "
                      f"tokens/s, decode {r['b']['decode_ms']:.3f} ms/step "
                      f"(experts' bound {r['b']['expert_bound_ms']:.3f})"
                      for arch, r in moe.items())
          + "; " + "; ".join(
              f"{arch} (b) prefill {r['b']['prefill_tok_s']:.0f} tokens/s, "
              f"decode {r['b']['decode_ms']:.3f} ms/step (bytes' bound "
              f"{r['b']['bound_ms']:.3f})" for arch, r in ssm.items())
          + f" (zamba2's 9 wgmma launches at {fl['zamba2_prefill']['ms']:.4f}"
          f" ms each, simt {fl['zamba2_prefill']['simt_ms']:.4f}: "
          f"{share['zamba2']:.1%} of its (b) prefill); {VLM_ARCH} (b) "
          f"prefill {vlm['b']['prefill_tok_s']:.0f} tokens/s, decode "
          f"{vlm['b']['decode_ms']:.3f} ms/step (bytes' bound "
          f"{vlm['b']['bound_ms']:.3f}; 32 wgmma launches at "
          f"{fl['phi_prefill']['ms']:.4f} ms each, simt "
          f"{fl['phi_prefill']['simt_ms']:.4f}: {share['phi']:.1%} of the "
          f"prefill), patched prefill {vlm['c']['prefill_s']:.4f}s"
          + f"; MoE a2a within {a2a['max_abs_err']:.3e} of the reference; "
          f"flash_attention prefill "
          f"{fl['prefill']['ms']:.4f} ms (wgmma; simt "
          f"{fl['prefill']['simt_ms']:.4f}), decode "
          f"{fl['decode']['ms']:.4f} ms (split-K; simt "
          f"{fl['decode']['simt_ms']:.4f}); fused_expand mean per level "
          f"{fe['dense_ms']:.4f} ms "
          f"(compacted {fe['compact_ms']:.4f}); lt_select_expand "
          f"{lse['compact_ms']:.4f} ms compacted ({lse['dense_ms']:.4f} "
          f"dense grid); batch 0 end to end IC {fe['batch_dense_ms']:.2f} / "
          f"{fe['batch_compact_ms']:.2f} ms, LT {lse['batch_dense_ms']:.2f} / "
          f"{lse['batch_compact_ms']:.2f} ms (dense / compacted grid); "
          f"cover_counts {cc['ms']:.4f} ms cold, {cc['warm_ms']:.4f} warm, "
          f"Q 8 {cc['multi']['ms']:.4f} cold; training llama3.2-3b "
          f"{train['main']['step_s']:.3f}s a step of "
          f"{train['main']['batch'] * train['main']['seq_len']} tokens "
          f"({train['main']['tokens_per_s']:.0f} tokens/s, "
          f"{train['main']['mfu']:.1%} of the bf16 peak, peak memory "
          f"{train['main']['peak_gib']:.2f} GiB); "
          + "; ".join(f"training {arch} {r['step_s']:.3f}s a step "
                      f"({r['tokens_per_s']:.0f} tokens/s, {r['mfu']:.1%} of "
                      f"the bf16 peak, peak {r['peak_gib']:.2f} GiB)"
                      for arch, r in fam.items())
          + f"; flash backward "
          f"{fb['ms']:.4f} ms on wgmma, float32 on tf32x3 "
          f"{fb['f32']['training']['ms']:.4f} (simt "
          f"{fb['f32']['training']['simt_ms']:.4f}; bound "
          f"{fb['bound_ms']:.4f}, SDPA's {fb['library_ms']:.4f} from a graph, "
          f"{fb['library_eager_ms']:.4f} eager), at D 192 "
          f"{fb['shapes']['nemotron']['ms']:.4f} ms (bound "
          f"{fb['shapes']['nemotron']['bound_ms']:.4f}, SDPA's "
          f"{fb['shapes']['nemotron']['library_ms']:.4f}), in float32 on "
          f"tf32x3 {fb['f32']['nemotron']['ms']:.4f} ms (simt "
          f"{fb['f32']['nemotron']['simt_ms']:.4f}; bound "
          f"{fb['f32']['nemotron']['bound_ms']:.4f}, SDPA's "
          f"{fb['f32']['nemotron']['library_ms']:.4f}), the float32 forward "
          f"there {fb['f32']['nemotron']['fwd']['ms']:.4f} ms (simt "
          f"{fb['f32']['nemotron']['fwd']['simt_ms']:.4f}); training the "
          f"nemotron cut in float32 "
          f"{train['f32_d192']['step_seconds'][0]:.3f}s a step (peak "
          f"{train['f32_d192']['peak_gib']:.2f} GiB); flash forward at D "
          f"192 {fl['nemotron_prefill']['ms']:.4f} ms (bound "
          f"{fl['nemotron_prefill']['bound_ms']:.4f}, SDPA's "
          f"{fl['nemotron_prefill']['library_ms']:.4f}); fused_expand_q at n {Q_N} "
          f"({q['num_tiles']} tiles, {q['q8_gib']:.2f} GiB) {q['dense_ms']:.4f} "
          f"ms dense / {q['compact_ms']:.4f} ms compacted per level, batch "
          f"{q['batch_dense_ms']:.2f} / {q['batch_compact_ms']:.2f} ms end to "
          f"end; total {time.time() - t_all:.1f}s")
    drv = stream_ic["driver"]
    print(f"[result lifecycle] snapshot of the 64-batch pool: IC "
          f"{ic['snapshot_mib']:.2f} MiB saved {ic['save_s']:.3f}s / "
          f"restored {ic['restore_s']:.3f}s, LT {lt['snapshot_mib']:.2f} MiB "
          f"{lt['save_s']:.3f}s / {lt['restore_s']:.3f}s; tier p50 "
          f"{tier['p50_ms']:.3f} ms, p99 {tier['p99_ms']:.3f} ms over "
          f"{tier['queries']} queries (peak {tier['peak_gib']:.2f} GiB); "
          + "; ".join(
              f"{name} stream: {r['dirty_slots']}/{r['total_slots']} dirty, "
              f"{r['touched_row_blocks']} row blocks, rebind "
              f"{r['rebind_s']:.3f}s + resample {r['resample_s']:.3f}s "
              f"(apply_plan {r['refresh_s']:.3f}s), cold {r['cold_s']:.3f}s, "
              f"peak {r['peak_gib']:.2f} GiB"
              for name, r in (("IC", stream_ic), ("LT", stream_lt)))
          + f"; driver 16 batches {drv['seconds']:.3f}s")
    print(f"[result mesh] 9d on one card: 64-batch pool IC 2x2 "
          f"{mesh['a']['build_dense_s']:.3f}s dense leg / "
          f"{mesh['a']['build_sparse_s']:.3f}s sparse leg (one device "
          f"{ic['build_s']:.3f}s), LT 2x2 {mesh['b']['build_dense_s']:.3f}s "
          f"/ {mesh['b']['build_sparse_s']:.3f}s (one device "
          f"{lt['build_s']:.3f}s); one level's exchange on 2x2: all-gather "
          f"{mesh['exchange']['dense_ms']:.3f} ms, butterfly "
          f"{mesh['exchange']['butterfly_ms']:.3f} ms, pmax "
          f"{mesh['exchange']['pmax_ms']:.3f} ms; words IC "
          f"{mesh['a']['words_dense']} dense / {mesh['a']['words_sparse']} "
          f"sparse; peak {mesh['a']['peak_gib']:.3f} GiB a rank (a); async "
          f"front end on 2x2, flush ms (mesh / one device) "
          + ", ".join(f"{op} {mesh['f']['mesh_ms'][op]:.3f} / "
                      f"{mesh['f']['one_ms'][op]:.3f}"
                      for op in ("sigma", "marginal", "top_k"))
          + f", whole-mesh broadcast {mesh['f']['broadcast_ms']:.3f} ms; "
          f"worlds "
          f"{mesh['seconds']['world_2x2']:.1f}s, "
          f"{mesh['seconds']['world_1x3']:.1f}s, "
          f"{mesh['seconds']['world_1x1']:.1f}s")
    _train_mesh_result(train_mesh)
    _serve_mesh_result(served)
    _time_line(t_all)
    kernels = [
        dict(name="fused_expand", route="cuda",
             source="src/repro_torch/csrc/fused_expand.cu",
             replaces="src/repro/kernels/fused_expand.py:99",
             launches=launches["fused_expand"],
             launches_by_path={
                 "ic_main": launches["fused_expand"],
                 "stream_ic": stream_ic["launches"]["fused_expand"],
                 "driver": drv["launches"]["fused_expand"],
                 "mesh_gp_ic_2x2": mesh["a"]["launches"]["fused_expand"],
                 "mesh_async_2x2": mesh["f"]["launches"]["fused_expand"],
                 "mesh_gp_ic_1x1_nccl": mesh["d"]["launches"][
                     "fused_expand"]},
             max_abs_err=max(err["fused_expand"], fe["max_abs_err"],
                             mesh["a"]["max_abs_err"]),
             ms=fe["dense_ms"], plain_ms=fe["plain_ms"],
             bound_ms=fe["dense_bound_ms"], bound_by=fe["dense_bound_by"],
             library_ms=None,
             compacted={"ms": fe["compact_ms"],
                        "bound_ms": fe["compact_bound_ms"],
                        "bound_by": fe["compact_bound_by"],
                        "compaction_ms": fe["compaction_ms"]},
             slot_list={k: fe[f"slot_{k}"] for k in (
                 "entries", "bytes", "build_ms")}),
        dict(name="cover_counts", route="cuda",
             source="src/repro_torch/csrc/coverage.cu",
             replaces="src/repro/kernels/coverage.py:41",
             launches=launches["cover_counts"],
             launches_by_path={
                 "ic_main": launches["cover_counts"],
                 "lt_main": launches_lt["cover_counts"],
                 "tier": tier["launches"]["cover_counts"],
                 "stream_ic": stream_ic["launches"]["cover_counts"],
                 "stream_lt": stream_lt["launches"]["cover_counts"],
                 "mesh_gp_ic_2x2": mesh["a"]["launches"]["cover_counts"],
                 "mesh_gp_lt_2x2": mesh["b"]["launches"]["cover_counts"],
                 "mesh_dp_4x1": mesh["c"]["launches"]["cover_counts"],
                 "mesh_async_2x2": mesh["f"]["launches"]["cover_counts"],
                 "mesh_gp_ic_1x1_nccl": mesh["d"]["launches"][
                     "cover_counts"]},
             max_abs_err=max(err["cover_counts"], cc["max_abs_err"],
                             *(mesh[t]["cover_max_abs_err"]
                               for t in "abcd")),
             ms=cc["ms"], plain_ms=cc["plain_ms"], bound_ms=cc["bound_ms"],
             bound_by=cc["bound_by"], library_ms=None,
             **{k: cc[k] for k in ("warm_ms", "eager_cold_ms",
                                   "clean_cold_ms")},
             multi=dict(cc["multi"], launches=launches["cover_counts_multi"],
                        launches_lt=launches_lt["cover_counts_multi"],
                        launches_mesh_async_2x2=mesh["f"]["launches"][
                            "cover_counts_multi"])),
        dict(name="lt_select_expand", route="cuda",
             source="src/repro_torch/csrc/lt_select_expand.cu",
             replaces="src/repro/kernels/lt_select_expand.py:101",
             launches=launches_lt["lt_select_expand"],
             launches_by_path={
                 "lt_main": launches_lt["lt_select_expand"],
                 "stream_lt": stream_lt["launches"]["lt_select_expand"],
                 "mesh_gp_lt_2x2": mesh["b"]["launches"][
                     "lt_select_expand"]},
             max_abs_err=max(err["lt_select_expand"], lse["max_abs_err"],
                             mesh["b"]["max_abs_err"]),
             ms=lse["compact_ms"], plain_ms=lse["plain_ms"],
             bound_ms=lse["compact_bound_ms"],
             bound_by=lse["compact_bound_by"],
             library_ms=None,
             dense={"ms": lse["dense_ms"], "bound_ms": lse["dense_bound_ms"],
                    "bound_by": lse["dense_bound_by"]},
             compaction_ms=lse["compaction_ms"],
             slot_list=True,
             slot_list_stats={k: lse[f"slot_{k}"] for k in (
                 "entries", "bytes", "build_ms")}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_prefill_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:83",
             launches=lm["launches"]["flash_attention"],
             max_abs_err=max(flash_err["f32"], flash_err["bf16"],
                             fl["prefill"]["max_abs_err"],
                             fl["decode"]["max_abs_err"]),
             max_abs_err_f32=flash_err["f32"],
             max_abs_err_bf16=flash_err["bf16"],
             lm_golden_max_abs_err=lm_gold["max_abs_err"],
             moe_golden_max_abs_err={k: v["max_abs_err"]
                                     for k, v in moe_gold.items()},
             lm_bf16_max_abs_err=lm_bf16["max_abs_err"],
             ssm_golden_max_abs_err={k: v["max_abs_err"]
                                     for k, v in ssm_gold.items()},
             ssm_bf16_max_abs_err=ssm_bf16["max_abs_err"],
             vlm_golden_max_abs_err={k: v["max_abs_err"]
                                     for k, v in vlm_gold.items()},
             vlm_bf16_max_abs_err=vlm_bf16["max_abs_err"],
             dense_golden_max_abs_err={k: v["max_abs_err"]
                                       for k, v in dense_gold.items()},
             audio_golden_max_abs_err={k: v["max_abs_err"]
                                       for k, v in audio_gold.items()},
             launches_by_path={
                 "lm_llama3.2-3b": lm["launches"]["flash_attention"],
                 **{f"ssm_{arch.split('-')[0]}_{mix}": ssm[arch][mix][
                     "launches"]["flash_attention"]
                    for arch in SSM_MAIN for mix in LM_MIXES},
                 **{f"vlm_phi_{mix}": vlm[mix]["launches"]["flash_attention"]
                    for mix in (*LM_MIXES, "c")},
                 "nemotron_cut_b": nemo["launches"]["flash_attention"],
                 **{f"dense_{arch.split('-')[0]}_{mix}": dense[arch][mix][
                     "launches"]["flash_attention"]
                    for arch in DENSE_MAIN for mix in LM_MIXES},
                 **{f"audio_musicgen_{mix}": audio[mix]["launches"][
                     "flash_attention"] for mix in LM_MIXES},
                 **{f"moe_maverick_{mix}": moe[
                     "llama4-maverick-400b-a17b"][mix]["launches"][
                     "flash_attention"] for mix in LM_MIXES},
                 **{f"moe_deepseek_{mix}": moe["deepseek-v3-671b"][mix][
                     "launches"]["flash_attention"] for mix in LM_MIXES},
                 # Phase 18: summed over the 2x2 mesh's four ranks.
                 **{f"serve_mesh_{job['arch'].split('-')[0]}": sum(
                     r["launches"]["flash_attention"]
                     for r in served["serve"][job["arch"]]["ranks"])
                    for job in SERVE_MESH_JOBS}},
             ms=fl["prefill"]["ms"], plain_ms=fl["prefill"]["plain_ms"],
             bound_ms=fl["prefill"]["bound_ms"],
             bound_by=fl["prefill"]["bound_by"],
             library_ms=fl["prefill"]["library_ms"],
             routes={
                 "wgmma": dict(
                     source="src/repro_torch/csrc/flash_prefill_wgmma.cu",
                     shape="prefill",
                     launches=lm["launches"]["flash_wgmma"],
                     launches_zamba2={mix: ssm["zamba2-2.7b"][mix][
                         "launches"]["flash_wgmma"] for mix in LM_MIXES},
                     launches_phi={mix: vlm[mix]["launches"]["flash_wgmma"]
                                   for mix in (*LM_MIXES, "c")},
                     launches_nemotron_cut_b=nemo["launches"]["flash_wgmma"],
                     launches_dense_and_audio={
                         **{f"{arch}_{mix}": dense[arch][mix]["launches"][
                             "flash_wgmma"]
                            for arch in DENSE_MAIN for mix in LM_MIXES},
                         **{f"{AUDIO_ARCH}_{mix}": audio[mix]["launches"][
                             "flash_wgmma"] for mix in LM_MIXES}},
                     cases=flash_err["cases"]["wgmma"],
                     bf16_rrms=flash_err["bf16_rrms"]["wgmma"],
                     **{k: fl["prefill"][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "library_eager_ms")},
                     # zamba2's (D 80) and phi-3-vision's (D 96) prefill,
                     # beside the earlier design's (simt) time there.
                     **{f"d{d}": dict(
                         {k: fl[shape][k] for k in (
                             "ms", "simt_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "library_eager_ms",
                             "max_abs_err", "simt_max_abs_err")},
                         prefill_share=share[name])
                        for d, shape, name in (
                            (80, "zamba2_prefill", "zamba2"),
                            (96, "phi_prefill", "phi"))},
                     # nemotron's (D 192, B 1, L 4096, 96 over 8 heads).
                     d192=dict({k: fl["nemotron_prefill"][k] for k in (
                         "ms", "simt_ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "library_eager_ms", "max_abs_err",
                         "simt_max_abs_err")},
                         launches_training_per_step=fam["nemotron-4-340b"][
                             "per_step"]["flash_wgmma"]),
                     launches_training_per_step={
                         arch: r["per_step"]["flash_wgmma"]
                         for arch, r in fam.items()},
                     # sharded training: each rank's launches a step.
                     launches_train_mesh_per_step_and_rank={
                         p: [x["flash_wgmma"] for x in train_mesh[p][
                             "per_rank"]] for p in ("main", "moe")}),
                 "decode": dict(
                     source="src/repro_torch/csrc/flash_decode.cu",
                     shape="decode",
                     launches=lm["launches"]["flash_decode"],
                     # The log-sum-exp output (phase 18): its checks, the
                     # kernel with and without it, and the
                     # sequence-parallel decode's launches per rank.
                     lse=dict(
                         cases=served["lse"]["cases"],
                         max_abs_err=served["lse"]["max_abs_err"],
                         lse_max_abs_err=served["lse"]["lse_err"],
                         shapes=served["lse"]["shapes"],
                         launches_serve_mesh_per_rank={
                             job["arch"]: [
                                 r["launches"]["flash_decode"] for r in
                                 served["serve"][job["arch"]]["ranks"]]
                             for job in SERVE_MESH_JOBS}),
                     cases=flash_err["cases"]["decode"],
                     bf16_rrms=flash_err["bf16_rrms"]["decode"],
                     **{k: fl["decode"][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "library_eager_ms")},
                     **{f"d{d}": dict(
                         {k: fl[shape][k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "library_eager_ms",
                             "max_abs_err")},
                         launches=launches)
                        for d, shape, launches in (
                            (80, "zamba2_decode",
                             {mix: ssm["zamba2-2.7b"][mix]["launches"][
                                 "flash_decode"] for mix in LM_MIXES}),
                            (96, "phi_decode",
                             {mix: vlm[mix]["launches"]["flash_decode"]
                              for mix in (*LM_MIXES, "c")}))}),
                 "simt": dict(
                     source="src/repro_torch/csrc/flash_attention.cu",
                     launches=lm["launches"]["flash_simt"],
                     launches_train_mesh_golden={
                         n: [x["flash_simt"] for x in v["launches"]]
                         for n, v in train_mesh["golden"]["models"].items()},
                     launches_zamba2={mix: ssm["zamba2-2.7b"][mix][
                         "launches"]["flash_simt"] for mix in LM_MIXES},
                     launches_phi={mix: vlm[mix]["launches"]["flash_simt"]
                                   for mix in (*LM_MIXES, "c")},
                     cases=flash_err["cases"]["simt"],
                     bf16_rrms=flash_err["bf16_rrms"]["simt"],
                     ms={shape: fl[shape]["simt_ms"] for shape in (
                         "prefill", "decode", "zamba2_prefill",
                         "phi_prefill")},
                     bound_ms={shape: fl[shape]["bound_ms"] for shape in (
                         "prefill", "decode", "zamba2_prefill",
                         "phi_prefill")})}),
        dict(name="fused_expand_q", route="cuda",
             source="src/repro_torch/csrc/fused_expand_q.cu",
             replaces="src/repro/kernels/fused_expand_q.py:110",
             also_replaces="src/repro/kernels/fused_expand_q.py:179",
             launches=q["launches"],
             max_abs_err=max(err["fused_expand_q"], q["max_abs_err"]),
             ms=q["dense_ms"], plain_ms=q["plain_ms"],
             bound_ms=q["dense_bound_ms"], bound_by=q["dense_bound_by"],
             library_ms=None,
             compacted={"ms": q["compact_ms"],
                        "bound_ms": q["compact_bound_ms"],
                        "bound_by": q["compact_bound_by"],
                        "compaction_ms": q["compaction_ms"]},
             slot_list=dict({k: q[f"slot_{k}"] for k in (
                 "entries", "bytes", "build_ms")},
                 cell_collisions=q["cell_collisions"])),
        dict(name="flash_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
             replaces="src/repro/models/attention.py:70",
             replaces_note="no pallas_call: the reference differentiates "
                           "its jnp blocked scan (attention.py:70-134); "
                           "the gradient of row 6's kernel",
             launches=train["main"]["launches"]["flash_bwd_wgmma"],
             launches_per_step=train["main"]["per_step"]["flash_bwd_wgmma"],
             max_abs_err=max(train["bwd"]["bf16"], fb["max_abs_err"]),
             bf16_rrms=train["bwd"]["bf16_rrms"],
             lse_max_abs_err=train["bwd"]["lse"],
             cases=train["bwd"]["cases_by_route"],
             train_golden_max_rel_err=train["golden"]["max_rel_err"],
             train_bf16_max_rel_err=train["bf16"]["max_rel_err"],
             train_families_golden_max_rel_err={
                 k: v["max_rel_err"]
                 for k, v in train["families_golden"].items()},
             train_families_bf16_max_rel_err={
                 k: v["max_rel_err"]
                 for k, v in train["families_bf16"].items()},
             train_restart_max_abs_err=train["restart"]["max_abs_err"],
             **{k: fb[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_eager_ms")},
             routes={
                 "wgmma": dict(
                     source="src/repro_torch/csrc/flash_bwd_wgmma.cu",
                     build=bwd_wgmma,
                     launches_by_path=dict(
                         {p: train[p]["launches"]["flash_bwd_wgmma"]
                          for p in ("main", "golden", "bf16")},
                         **{f"families_{arch}": r["launches"][
                             "flash_bwd_wgmma"] for arch, r in fam.items()},
                         **{f"families_bf16_{arch}": r["launches"][
                             "flash_bwd_wgmma"]
                            for arch, r in train["families_bf16"].items()}),
                     launches_per_step_families={
                         arch: r["per_step"]["flash_bwd_wgmma"]
                         for arch, r in fam.items()},
                     launches_train_mesh_per_step_and_rank={
                         p: [x["flash_bwd_wgmma"] for x in train_mesh[p][
                             "per_rank"]] for p in ("main", "moe")},
                     train_mesh_golden_max_rel_err=train_mesh["golden"][
                         "max_rel_err"],
                     **{k: fb[k] for k in (
                         "ms", "dq_ms", "dkdv_ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "max_abs_err")},
                     # nemotron's D 192 (dq, dv, dk), zamba2's D 80 and
                     # phi-3-vision's D 96, each at train_4k's 4,096 tokens.
                     **{f"d{BWD_TIMED_SHAPES[n][4]}": {k: fb["shapes"][n][k]
                                                      for k in (
                         "ms", "part_ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "library_eager_ms", "max_abs_err",
                         "launches")}
                        for n in ("nemotron", "zamba2", "phi")}),
                 "simt": dict(
                     source="src/repro_torch/csrc/flash_attention_bwd.cu",
                     build=bwd_simt,
                     launches_by_path={
                         p: train[p]["launches"]["flash_bwd_simt"]
                         for p in ("main", "golden", "bf16")} | {
                         f"families_golden_{n}": r["launches"][
                             "flash_bwd_simt"]
                         for n, r in train["families_golden"].items()} | {
                         f"train_mesh_golden_{n}": [
                             x["flash_bwd_simt"] for x in v["launches"]]
                         for n, v in train_mesh["golden"]["models"].items()}
                     | {"train_f32_d192": train["f32_d192"]["launches"][
                         "flash_bwd_simt"]},
                     # The earlier design in float32 at the training
                     # shape (the top-level keys) and at nemotron's (D 192:
                     # dq, dv, dk), timed beside the tf32x3 route, against
                     # the float32 peak of the CUDA cores.
                     ms=fb["f32"]["training"]["simt_ms"],
                     max_abs_err=fb["f32"]["training"]["simt_max_abs_err"],
                     bound_ms=fb["f32"]["training"]["bound_f32_ms"],
                     f32={n: dict(
                         ms=t["simt_ms"], part_ms=t["simt_part_ms"],
                         bound_ms=t["bound_f32_ms"],
                         max_abs_err=t["simt_max_abs_err"],
                         max_rel_err=t["simt_max_rel_err"])
                         for n, t in fb["f32"].items()})}),
        # The float32 routes on the tensor cores (3xTF32): their launches
        # on [train f32 d192] (the float32 training path), the goldens'
        # too; times at nemotron's shape (the top-level keys) and llama's.
        dict(name="flash_attention_tf32x3", route="cuda",
             source="src/repro_torch/csrc/flash_prefill_tf32x3.cu",
             replaces="src/repro/kernels/flash_attention.py:83",
             launches=train["f32_d192"]["launches"]["flash_tf32x3"],
             launches_by_path=dict(
                 train_f32_d192=train["f32_d192"]["launches"][
                     "flash_tf32x3"],
                 train_golden=train["golden"]["launches"]["flash_tf32x3"],
                 **{f"train_families_golden_{n}": r["launches"][
                     "flash_tf32x3"]
                    for n, r in train["families_golden"].items()}),
             cases=flash_err["cases"]["tf32x3"],
             max_abs_err=max(flash_err["f32"], *(
                 t["fwd"]["max_abs_err"] for t in fb["f32"].values())),
             lse_max_abs_err=train["bwd"]["lse"],
             build={n: v for n, v in tf32x3.items()
                    if n.startswith("prefill")},
             **{k: fb["f32"]["nemotron"]["fwd"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library_backend", "library_efficient_ms", "simt_ms",
                 "bound_tf32x3_ms", "bound_f32_ms")},
             d128={k: fb["f32"]["training"]["fwd"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library_backend", "library_efficient_ms", "simt_ms",
                 "bound_f32_ms", "max_abs_err")}),
        dict(name="flash_bwd_tf32x3", route="cuda",
             source="src/repro_torch/csrc/flash_bwd_tf32x3.cu",
             replaces="src/repro/models/attention.py:70",
             replaces_note="no pallas_call: the reference differentiates "
                           "its jnp blocked scan (attention.py:70-134); "
                           "the gradient of row 6's kernel in float32",
             launches=train["f32_d192"]["launches"]["flash_bwd_tf32x3"],
             launches_by_path=dict(
                 train_f32_d192=train["f32_d192"]["launches"][
                     "flash_bwd_tf32x3"],
                 train_golden=train["golden"]["launches"][
                     "flash_bwd_tf32x3"],
                 **{f"train_families_golden_{n}": r["launches"][
                     "flash_bwd_tf32x3"]
                    for n, r in train["families_golden"].items()}),
             cases=train["bwd"]["cases_by_route"]["tf32x3"],
             max_abs_err=max(train["bwd"]["f32"], *(
                 t["max_abs_err"] for t in fb["f32"].values())),
             max_rel_err_d192=max(train["bwd"]["f32_d192_rel"],
                                  fb["f32"]["nemotron"]["max_rel_err"]),
             build={n: v for n, v in tf32x3.items()
                    if not n.startswith("prefill")},
             **{k: fb["f32"]["nemotron"][k] for k in (
                 "ms", "part_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "library_eager_ms", "library_backend",
                 "library_efficient_ms", "simt_ms", "simt_part_ms",
                 "bound_tf32x3_ms", "bound_f32_ms")},
             d128={k: fb["f32"]["training"][k] for k in (
                 "ms", "part_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "library_backend", "library_efficient_ms",
                 "simt_ms", "simt_part_ms", "bound_f32_ms", "max_abs_err")},
             train_f32_d192=dict(
                 step_seconds=train["f32_d192"]["step_seconds"],
                 split=train["f32_d192"]["split"])),
    ]
    print(json.dumps({"kernels": kernels}))
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
