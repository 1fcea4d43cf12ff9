"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card, checks that the card serves
and trains as the CPU does, then drives the port's main paths at the full
widths of ``dlrm-recmg`` (emb_dim 128, multi_hot 20, 856 tables, bf16 MLPs),
of ``smollm-135m`` and ``granite-moe-1b-a400m`` (LM serving with the vocab
on tiered memory, and training through the launcher), of
``internvl2-26b`` (served with a frontend, its depth cut), of
``falcon-mamba-7b`` and ``hymba-1.5b`` (served, and trained through the
launcher with their depth cut) and of ``whisper-large-v3`` (served and
trained at full depth):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: nvcc for sm_90a, one process per source, with the build seconds
   and the registers and spills of the attention backward's and the
   scan's forward and backward kernels;
3. kernels vs plain on the card at the serve and forward shapes, fp32 and
   bf16, D in {16, 128}: the row gathers bit-exact, the pooled gather
   within fp32 rtol 1e-5; each timed beside its byte bound;
3'. the quantized tier's kernels vs plain, int8 and fp8, D in {16, 20,
   128}, at the full-width serve shape (one batch's admit into and read
   from the 720,100-row quantized buffer, with and without overflow rows,
   and the batch's pooled read, idx (32 * 856, 20)), and the admit at the
   per-table facade's shape (one sub-store's 264 first-batch rows into its
   841-row buffer, beside the timer's floor): codes bit-exact, scales
   within one ulp, the row reads bit-exact, the pooled read within fp32
   rtol/atol 1e-6; each timed beside its byte bound;
4. serve parity: the golden-trace fixture through ``serve_trace`` on the
   CPU and on the card, ``lru`` and ``recmg`` (frequency model), with fp32,
   int8 and fp8 rows and through the per-table facade: counters
   identical, logits within fp32 rtol/atol 1e-4 (the two devices sum in
   different orders);
5. full-width serve: ``rows_per_table`` cut to 4096 (a 72,704-row host
   table is 31.9 GB of fp32, drawn as 64 GB of float64 first), the first
   6 of 8 batches of 32 queries (547,840 ids each; all 8 before the script
   needed the time), capacity 0.2 of the 8 batches' unique ids (185,651
   fp32 rows); fp32 ``lru`` and ``recmg``, then the same bytes
   re-spent as 720,100 quantized rows: int8 ``lru`` and ``recmg``, fp8
   ``lru``, and int8 ``lru`` through the per-table facade (856 stores);
6. full-width ``dlrm_forward`` with the 856 full-size tables (72,704 rows,
   15.9 GB of bf16) in device memory and B=256 (cut from the 6,144 of
   ``infer_6k``: the (B, 857, 857) fp32 interaction alone is 18 GB there),
   against the plain lookup on the card; then the same forward with the
   tables quantized to int8 (8 GB), which pools through
   ``gather_pool_dequant``;
6'. distributed serve: the same tables row-sharded over the ranks of a
   ``torch.distributed`` mesh, served through
   ``build(run=RunConfig(dlrm_sharded_lookup=True)).prefill``: first world
   1 over NCCL in this process on phase 6's tables and batch, bit-equal
   to phase 6's logits; then four ``gloo`` ranks on the one card
   (``torch.multiprocessing.spawn``, a ``file://`` store), a (2, 2) mesh,
   each drawing its half of every table's rows (7.97 GB) and serving its
   quarter of a B=256 batch whose ids run over [-2, R + 2): the gathered
   logits within 2e-2 (bf16) of the unsharded forward with phase 6's
   tables, an id no shard owns dropped (the shard window's plain twin
   over the whole tables); each rank's shard window of ``gather_pool``
   within fp32 rtol/atol 1e-5 of its twin, timed (one rank at a time)
   beside its bound and ``embedding_bag`` with per-sample weights, and
   the all-reduce of its pooled partials timed beside the unpooled
   exchange's bytes (gloo through host memory, not an NCCL figure);
6''. distributed training: world 1 over NCCL in this process, DLRM with
   ``rows_per_table`` cut to 4,096 through ``make_train_step`` on a (1, 1)
   mesh (ids in range): the loss bit-equal to the unsharded step's, the
   table gradient within one bf16 ulp, the others bit-equal, and
   ``compress_tree``/``psum_int8`` over the one rank equal to
   ``dequant(quant(g))``; then, in the four gloo ranks after they serve:
   DLRM on the (2, 2) mesh (bf16, B=256 in 2 microbatches, ids over [-2,
   R + 2), 2 steps) against one rank's step on the whole tables (losses
   within 2e-2, first-step gradients within 2e-2 of each leaf's largest
   magnitude), the window's forward and its masked and unmasked
   backwards timed beside their bounds, the fp32 gradient all-reduce
   over ``data`` timed; granite-moe-1b-a400m cut to 2 layers through the
   launcher on (4, 1) (S=2,048, global batch 8 in 2 microbatches) in
   fp32 against one rank (losses and gradients within 1e-4, the global
   top-K equal), then bf16 with ``--grad-compression int8_ef`` (its int32
   wire's bytes and all-reduce time); DLRM's arm runs twice, its
   tables' rows over ``model`` (``emb_rows="model"``) and over both axes
   (``emb_rows="all"``, JAX's default layout: a quarter of every table a
   rank, the ids all-gathered over ``data``, the pooled partials
   reduce-scattered over it), the second's losses against the first's
   and one rank's, its step time, peak and collective bytes, its
   all-reduces short of the first's by the table gradient;
6'''. the LMs' parameters and AdamW state sharded by JAX's partition
   rules (phase ``sharded_train``): world 1 over NCCL in this process,
   qwen2.5-3b at full width cut to 2 layers through ``build(...,
   mesh=)`` on a (1, 1) ``fsdp_tp`` mesh (every gather, reduce-scatter
   and tensor-parallel collective runs over the one rank): loss, grad
   norm and parameters bit-equal to the step without a mesh, and that
   step against ``launch/accounting.py``'s trace of it on the meta
   device: the predicted peak of the step's own allocations within
   ``ACC_PEAK_RATIO`` of ``max_memory_allocated`` above what the step
   found, its collectives equal, its ``dot_flops`` over a second step's
   seconds printed; rows 8 and
   8b at qwen's per-rank layout on (2, 2) ((2, 2048, 8/1, 128) bf16)
   against their plain versions, timed beside their bounds and SDPA; then,
   in the four gloo ranks after their distributed training: qwen's cut on
   (2, 2) in bf16 (S = 2,048, a global batch of 8 in 2 microbatches,
   remat full, logits in chunks of 1,024, 2 steps, no warmup), each
   rank's bytes of parameters and moments equal to ``shard_bytes`` and a
   quarter of the dp layout's, its peak memory, step times and collective
   bytes (the two steps' calls and result bytes of each kind equal to the
   accountant's trace of that rank, times two), layer 0's gathers and
   reduce-scatters timed, the losses and
   gradient norms against one rank's (``ST_TOL_LOSS``, ``ST_TOL_NORM``);
   smollm-135m on (1, 4) (its heads split: the attention gathered) and
   granite-moe on (2, 2) (tensor-parallel experts, the vocab whole) at
   full width cut to 2 layers in fp32 (S = 512): first-step gradients
   within 1e-4 of each leaf's largest magnitude, the parameters after
   the second step within 5e-2 of the update (L2 norms over each shard)
   and both losses within 1e-4 of one rank's; then the arms whose
   layers compute tensor parallel (``scripts/sharded_layers_ab.py``'s
   ``lm_arm``): falcon-mamba-7b (channel-parallel mamba blocks, the
   in_proj exchange) at 2 of 64 layers, S = 2,048, and whisper-large-v3
   (tensor-parallel attention, cross-attention and MLP) at 2 + 2 layers,
   448 tokens over 8 clips of seeded frames, bf16 on (2, 2): each
   rank's bytes of parameters and moments equal to ``shard_bytes``, peak,
   step times and collective bytes by kind (all-gathers, reduce-scatters,
   all-reduces, exchanges), and their fp32 parity against one rank
   (falcon on (1, 4) at S = 512, whisper on (2, 2)): losses within 1e-6
   of their magnitude, first-step gradients within 2e-5, the parameters
   after step 2 within 5e-2 of the update; the sequence split under a
   gradient: qwen's cut trained under fsdp_seq inside
   ``activation_sharding(mesh, "fsdp_seq")`` on (2, 2) (each rank its 2
   rows a microbatch x 1,024 positions at offset 0 or 1,024, K/V
   gathered over ``model`` with a reduce-scatter backward, the loss the
   mean over every rank's tokens), its losses and grad norms against the
   same one-rank reference, its bytes, peak, step times, collective
   bytes and launches, and granite-moe's fp32 parity under the split
   (S = 512, the fp32 parity's bounds); and, in this process, the scan
   and its backward at the ranks' channels (falcon's 4,096, hymba's
   1,600 and 800), the attention kernels at qwen's and whisper's ranks'
   heads (whisper's encoder unmasked, its decoder causal, (2, 1500 or
   448, 10/10, 64)), and row 8b at an offset: the split's costlier rank,
   q (2, 1,024, 16, 128) at offset 1,024 against k/v (2, 2,048, 2, 128),
   against its plain version (bf16 2e-2), the two ranks' dk/dv summed and
   dq rows stacked against the whole call's (dq bit for bit), timed
   beside its bound, the plain version and SDPA's backward with the
   offset's mask.  The launches counted are the (1, 1) step's and the
   four ranks' sharded runs';
6''''. the LMs served over the mesh (phase ``lm_sharded_serve``): the
   forward kernel's query-offset mode (row 8''''') at qwen2.5-3b's rank
   shapes of a four-way sequence split, q (8, 512, 16, 128) at offsets
   0, 512, 1,024 and 1,536 against k/v (8, 2,048, 2, 128), causal, the
   last also windowed and the first unmasked, bf16 and fp32, against
   ``ref.kv_stream_attention_ref`` (fp32 1e-5, bf16 1e-2), each shard's
   rows bit-equal to the whole attention's and offset 0 to the old call,
   the costliest shard timed beside its bound and SDPA with the explicit
   offset mask; world 1 over NCCL in this process (qwen's cut, 2 of 36
   layers, through ``build(..., mesh=)`` on (1, 1): the fsdp_seq prefill
   and tp decode against the whole model's logits); then, in the four
   gloo ranks after their sharded training: qwen's cut in bf16 on (2, 2),
   an fsdp_seq prefill of 8 x 2,048 tokens (each rank 1,024 positions at
   its offset) and 16 tp decode steps, the cache's slots over model
   (``shard_kv_seq``) and then its KV heads, each within 2e-2 of the
   whole model's largest logit; in fp32 on (1, 4) at S = 512 within
   1e-5; and falcon-mamba-7b at 2 of 64 layers in bf16 on (2, 2), S =
   512 (its mamba blocks gather the sequence, decode channel parallel on
   the conv and SSM states' channels over model) within 2e-2; each
   rank's collective calls and bytes (each run's equal to the
   accountant's trace of that rank's prefill plus its decode steps),
   cache bytes and host ms.  The
   launches counted are the (1, 1) run's and the ranks' served runs';
7. the learned models' kernels vs plain on the card: ``lstm_cell`` at the
   inference (B=4096) and training (B=256) shapes of every LSTM layer of
   the path (K = 57, 67, 80, 88, 120 at H = 32 or 40), within fp32 abs
   1e-5 on h', c' and the gates; ``chamfer`` at the training shape (B=256, P=5, W=15, F=25)
   and at B=65,536, the loss within rtol 1e-5 and the argmins equal; each
   timed beside its bound, the timer's floor and, for ``lstm_cell``,
   ``torch.lstm_cell``;
   then the gradients through both autograd Functions against autograd
   through the plain versions (max abs error within 1e-6 + 1e-4 times the
   gradient's largest entry); each ``lstm_cell`` record carries its
   achieved TFLOP/s, its share of the bound, whether it beat
   ``torch.lstm_cell``, the kernel's design and the timer's floor (what it
   reads for an empty kernel);
8. learned parity on the golden fixture: the caching, prefetch and Voyager
   models trained on the card (1 epoch), their outputs computed on the card
   and, from the same parameters, on the CPU: decisions equal except where
   a logit or a nearest-candidate margin is under 1e-4 (flips counted);
   the card's outputs served on the CPU and on the card with identical
   counters and logits within rtol/atol 1e-4;
9. the CLI's default path at full width (``--model learned``, the widths
   of ``src/repro/launch/serve.py:569-572``): both models trained on the
   card on the first quarter of the first of the 6 serve batches (1
   epoch; the first 2 batches before the SSM phases needed the time, half
   of one before the distributed serve did) at the fp32 capacity, their
   outputs over the whole trace, served fp32 (185,651 rows) and int8
   (720,100 rows; the int8 arm computes the outputs of
   the fp32 arm's model, which it retrained at its own capacity before the
   distributed serve needed the time); the Voyager arm trained on the
   same accesses (the first batch before) and served fp32 on an LRU
   store;
9'. runtime parity at the serve width: the pipelined runtime
   (``async_prefetch``) through the inline scheduler at depths 1 and 2,
   fp32 ``recmg`` (frequency) and int8 ``lru``: counters equal those of
   phase ``serve``'s synchronous runs, the stall equals the demand fetch at
   depth 1 and is strictly less at depth 2; then int8 ``recmg`` through
   the thread scheduler: the accounting identities hold and the engine's
   worker thread launched ``quantize_scatter``;
9''. runtime serve at the serve width: ``overload=2.0`` on the int8 store
   (stale degraded rows read on the card by ``gather_rows_dequant_expand``
   inside ``lookup_resident_device``), ``adapt`` with the frequency model
   and with phase 9's fp32 learned model (its fine-tunes launch
   ``lstm_cell``) on 3 batches of 8 queries of the diurnal regime (a
   hot-set switch a batch; drift windows of one batch, so 2 refreshes),
   and the CLI's ``main`` with ``--workload zipf_hot --async-prefetch``
   (its reduced config);
9'''. sharded parity: the golden fixture through the sharded store on the
   CPU and on the card, 2 and 4 shards, the four placements, fp32 ``lru``
   and ``recmg`` (frequency model) and int8 ``lru``: counters and shard
   telemetry identical, logits within rtol/atol 1e-4, the CPU's 2-shard
   ``table`` counters equal to ``tests/golden/serve_lru_sharded_table2.
   json``; then ``replay_chaos`` under each of ``chaos_sweep``'s five fault
   plans on both devices: the same fates, 0 wrong rows on the card;
9''''. sharded serve at the serve width (the same trace and host table as
   phase 5): 4 shards, ``placement=freq``, fp32 and int8 ``lru``; fp32
   ``lru`` with ``--fault-plan kill:1@mid,recover:1@75%`` and the hottest
   5% of the vectors replicated; the inline pipelined runtime at depth 2
   over the fp32 sharded store, with the synchronous run's counters; then
   ``transfetch``: the transformer prefetch backbone trained on the card
   as phase 9 trains the LSTM one (``lstm_cell`` in its decoder,
   ``chamfer`` in its loss; 1 epoch on the first serve batch), its points on the card and on the CPU from the
   same parameters within fp32 abs 1e-5;
10. ``flash_attention`` vs plain on the card: at the LM serve prefill shape
    q (8, 2048, 9, 64), k/v (8, 2048, 3, 64) bf16, at qwen2.5-3b's head
    layout (1, 8192, 16/2, 128) bf16, at fp32 (2, 1024, 8/2, 64) and at a
    ragged S=1,000 in both dtypes: fp32 within rtol/atol 1e-5, bf16 within
    1e-2; each timed beside its bound and beside
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``, with
    its achieved TFLOP/s, share of the bound, design (bf16: tensor cores;
    fp32: FMAs) and, at bf16, its largest error in bf16 ulps; at each shape
    the output written beside the log-sum-exp (the training forward) has
    the serve path's bits, and the log-sum-exp is within rtol/atol 1e-5 of
    ``torch.logsumexp`` of the plain scores;
10'. ``flash_attention_bwd`` vs plain on the card at the LM training cut
    (4, 4096, 9/3, 64), qwen2.5-3b's heads (1, 4096, 16/2, 128), a ragged
    S=1,000 and head dims 16 and 32, both dtypes, and at granite-moe's
    training cut (4, 4096, 16/8, 64) and internvl2's heads (1, 2048, 48/8,
    128) in bf16: each gradient within 1e-5
    (fp32) or 2e-2 (bf16) of its largest magnitude; each timed beside its
    bound (five causal products) and beside SDPA's backward, bf16 also with
    the dK/dV grid at every split of the G query heads (``ms_by_splits``);
    the build's registers and spill bytes of its kernels are a line of
    their own (``build_flash_attention_bwd``); then the bf16 backward in
    hymba-1.5b's 1,024-token window at its training microbatch (4, 4096,
    25/5, 64): within 2e-2 of the plain windowed backward (batch row 0),
    beside the same shape causal and SDPA's backward with a boolean band
    mask, and a window of S giving the causal backward's bits;
11. LM parity: full-width smollm-135m (30 layers, d_model 576, 9/3 heads,
    vocab 49,152) from the same seeded parameters on the CPU and on the
    card, a B=2, S=256 prefill and 8 teacher-forced decode steps: logits
    within rtol/atol 1e-4 for an fp32 copy of the config and 5e-2 at bf16;
12. LM serve: ``serve_lm_tiered`` at full width, bf16, B=8 streams, a
    2,048-token prompt (cut from ``prefill_32k``'s B=32, S=32,768) and 64
    greedy steps with the vocab on the tiered store (capacity 0.1 = 4,915
    rows, ``lru``); its first step's logits must equal those of the token
    path (``decode_step``) bit for bit; then one prefill and 8 tiered
    decode steps under ``torch.profiler`` (device busy time and idle
    share, the largest kernels);
13. DLRM training (before phase 6, while the serve trace exists):
    ``dlrm-recmg`` at bf16 with ``rows_per_table`` cut to 16,384 (the
    full tables, their gradient and the fp32 AdamW moments would take 95.6
    GB) and B=256 (cut from ``train_6k``'s 6,144): the serve trace's one
    batch of 256 x 856 x 20 ids through ``query_batches``, 4 steps of
    ``make_train_step`` (``gather_pool`` forward, scatter-add backward);
14. train parity: one ``make_train_step`` on the CPU and on the card from
    the same parameters and batch (fp32 reduced smollm-135m, B=2, S=128, 2
    microbatches; fp32 reduced dlrm-recmg, B=64): loss within rtol 1e-5,
    every parameter within 1e-5; the same for reduced falcon-mamba-7b and
    hymba-1.5b (fp32, window 8, B=2, S=24, 2 microbatches), whose card
    step launches ``selective_scan_bwd`` (and, for hymba, the windowed
    ``flash_attention_bwd``) once a layer and microbatch; then full-width
    bf16 gradients with the backward kernels and with their plain
    versions, both on the card: smollm-135m (B=1, S=1024), one
    falcon-mamba-7b layer (S=1024) and one hymba-1.5b layer (S=2,048): each
    leaf within 5e-2 of its largest magnitude;
15. LM training: full-width bf16 smollm-135m through ``launch/train.main``
    at ``train_4k``'s S=4,096, the global batch cut from 256 to 8 (2
    microbatches, ``--remat full``): run A 6 steps with checkpoints every
    3, run B from A's step-3 checkpoint alone to step 6 (losses equal
    A's bit for bit), the kernels' launches (forward 2 and backward 1 a
    layer and microbatch), tokens/s, peak memory and one step under
    ``torch.profiler`` (which must show the bf16 backward's tensor-core
    kernels, ``backward_kernels_ms``);
16. MoE parity: full-width granite-moe-1b-a400m (4 of its 24 layers, d_model 1024,
    16/8 heads, 32 experts top-8, expert width 512, vocab 49,155) from the
    same seeded parameters on the CPU and on the card, a B=2, S=256
    prefill and 8 teacher-forced decode steps, fp32 then bf16, every
    layer's routing recorded: at fp32 the top-K sets equal wherever the
    CPU's K-th and (K+1)-th probabilities differ by more than 1e-5 (in
    rows no earlier flip has changed), keep masks equal while no
    selection has flipped, and the logits of the rows whose routing never
    flipped within rtol/atol 1e-4; at bf16 the flips counted, and the
    logits within 5e-2 of a CPU run given the card's expert choices; the
    dropped share of assignments at cf 1.25;
17. MoE serve: phase 12 at granite's full width (B=8, a 2,048-token
    prompt, 64 greedy steps, capacity 0.1 = 4,915 rows): the prefill's
    capacity dispatch, dense routing on each decode step;
18. MoE training: phase 15 at granite's full width, its depth cut from 24
    to 4 layers and run A to 4 steps (``cuts``), the resumed run's losses
    bit-equal to run A's;
    then 2 steps of ``make_train_step`` at each AdamW setting (fp32 moments, bf16 moments, bf16 moments and an
    fp32 master copy) with each one's peak memory;
19. VLM serve: internvl2-26b at full width (d_model 6,144, 48/8 heads, hd
    128, d_ff 16,384, vocab 92,553), its depth cut from 48 to 8 layers
    (4.3 B parameters): a seeded bf16 frontend (1, 256, 6144) spliced into
    a 2,048-token prompt, prefill and 16 greedy decode steps through
    ``build(cfg).prefill``/``.decode``, and the same prompt without the
    frontend (the logits must differ); the reduced fp32 config with a
    frontend on the card against the CPU within rtol/atol 1e-4;
20. ``selective_scan`` vs plain on the card (phase ``ssm_kernels``, run
    after phase 10'): at falcon-mamba-7b's and hymba-1.5b's prefill layers
    (B=8, S=2,048, Di 8,192 / 3,200, N=16), bf16 and fp32: y within 1e-5
    (fp32) or 1e-2 (bf16) of its largest magnitude, h_last within 1e-5 of
    its; each timed beside its byte bound, its SFU floor (N + 2 SFU
    operations a (b, t, d) at 16 a clock an SM, at the SM's top clock)
    and its first design's time (``earlier_ms``, a constant of this
    script), with its launch geometry, registers and spills (no PyTorch
    call computes the scan);
    then the windowed ``flash_attention`` at hymba's prefill (8, 2048,
    25/5, 64), window 1,024, within 1e-2 of the plain windowed version,
    beside the same shape without a window, SDPA with a boolean band mask
    and its bound; a window of S or more gives the causal kernel's bits
    there and at the LM serve prefill's shape;
20'. ``selective_scan_bwd`` vs plain on the card (phase
    ``scan_bwd_kernels``) at falcon-mamba-7b's and hymba-1.5b's training
    microbatch (B=4, S=4,096, Di 8,192 / 3,200, N=16), bf16 and fp32, from
    an h0 and a dh_last with dt = 0 every seventh step: every gradient
    within 1e-4 of its largest magnitude (bf16 dx, dz 1e-2), two calls
    bit-equal, the forward's bits unchanged by saving its states; each
    timed beside its byte bound, its SFU floors (the function's N + 2 and
    the kernel's 2 N + 2 a (b, t, d)), its design bytes (the saved states
    and the per-block partials) and the plain version, with its launch
    geometry, registers and spills;
21. scan share (run after phase 20): one falcon-mamba-7b prefill layer
    (B=8 x 2,048, bf16) with the plain scan and with the kernel, and the
    kernel alone on the same inputs, under ``torch.profiler`` and between
    CUDA events: the scan's share of the layer's device busy time and of
    its device timeline;
22. SSM parity: reduced falcon-mamba-7b and hymba-1.5b (window cut to 8)
    from the same seeded parameters on the CPU and on the card, a B=2,
    S=24 prefill into a 16-slot cache (hymba's key ring holds 8) and 8
    teacher-forced decode steps: logits within rtol/atol 1e-4 (fp32) and
    5e-2 (bf16), as phase 11 holds them;
23. SSM and hybrid serve: phase 12 at falcon-mamba-7b's full width and
    depth (64 layers, d_model 4,096, Di 8,192, 7.27 B parameters) and at
    hymba-1.5b's (32 layers, d_model 1,600, 25/5 heads, window 1,024,
    1.66 B parameters): the 2,048-token prompt exceeds the window, so
    hymba's key cache is a 1,024-slot ring that the decode wraps;
24. SSM and hybrid training: phase 15 at falcon-mamba-7b's full width cut
    to 2 of 64 layers and at hymba-1.5b's cut to 2 of 32 (``cuts``; S =
    4,096 exceeds hymba's window), run A 2 steps with a checkpoint at step
    1 and run B from it (losses equal A's bit for bit), ``selective_scan``
    twice and ``selective_scan_bwd`` once a layer and microbatch (and
    hymba's windowed attention forward twice and backward once), step ms,
    tokens/s, peak memory and one step under the profiler;
25. the unmasked ``flash_attention`` (``causal=False``, whisper's encoder;
    phase ``encdec_kernels``, after phase 24) at whisper's serve shape (8,
    1500, 20/20, 64) in bf16 and fp32 and at its training microbatch (4,
    1500, 20/20, 64) in bf16, and its backward at the training microbatch
    in both dtypes, then both at S = 1, 17 and 1,500 (B = 2) in both
    dtypes: the forward within 1e-5 (fp32) or 1e-2 (bf16) of the plain
    unmasked version with the log-sum-exp's output bits, the backward
    within 1e-5 / 2e-2 of max(1, each gradient's largest magnitude) and
    bit-equal over two calls; each timed beside its bound (4 B H S^2 hd
    operations forward, 2.5 times that backward), the plain version and
    SDPA without a mask (and its backward);
26. encoder-decoder parity: reduced fp32 whisper-large-v3 from the same
    parameters on the CPU and on the card, the loss and every gradient
    under ``remat="full"``, then a prefill into a 20-slot cache and 3
    decode steps: logits, caches, loss and gradients within 1e-5 of each
    tensor's largest magnitude;
27. encoder-decoder serve: whisper-large-v3 at full width and depth (32 +
    32 layers, d_model 1,280, 20/20 heads, vocab 51,866, 1.60 B
    parameters, bf16) through ``build(cfg).prefill``/``.decode``: 8 clips
    of seeded frames (8, 1500, 1280), a 4-token prompt, 64 greedy steps
    into a 448-slot cache (the published ``max_target_positions``);
    ``flash_attention`` 64 launches, all in the prefill (32 unmasked, 32
    causal); prefill ms, decode p50, tok/s, peak memory and a profile;
28. encoder-decoder training: whisper-large-v3 at full width and depth,
    3 steps of ``make_train_step`` (global batch 8 in 2 microbatches, 448
    decoder tokens and 1,500 frames, ``remat="full"``, AdamW with fp32
    moments): finite losses and gradient norms, ``flash_attention`` twice
    and ``flash_attention_bwd`` once a layer and microbatch, step ms,
    tokens/s, peak memory and one step under the profiler.

Each phase prints one JSON line; any failure exits nonzero.  The line
before the last lists every kernel of the main path with its launches,
error, times and bound, and for the six kernels in their second design
that design (``quantize_scatter`` also with its launches from the single
quantized stores and from the per-table facade of phase ``serve``); the
kernels that the runtime phases drive add those phases' launches and show
them as ``launches_runtime``, the sharded serve as ``launches_sharded``
the transformer backbone's training as ``launches_transfetch``,
training (phases 13 and 15) as ``launches_train``, the LM serve as
``launches_lm_serve``, the MoE's serve and training (17, 18) as
``launches_moe``, the VLM's serve as ``launches_vlm`` and the SSM and
hybrid serves (23) as ``launches_ssm``, their training (24) as
``launches_ssm_train`` and whisper's serve and training (27, 28) as
``launches_encdec``; ``gather_pool_shard``, ``gather_pool``'s shard
window, counts the distributed serve's and training's launches (6',
6'') and carries them by run as ``launches_distributed``, with the
all-reduce's time and bytes, and the training's launches of it and of
the attention kernels show as ``launches_distributed_train``, the
sharded LMs' (6''') as ``launches_sharded_train`` beside the kernels'
``sharded_layout`` records, and the served LMs' (6'''') as
``launches_lm_sharded_serve`` (``flash_attention``'s beside its
``offset`` record; ``selective_scan``'s); ``flash_attention_bwd``'s
``offset`` record is row 8b at the offset with the launches of the
fsdp_seq arms (every one at an offset);
``selective_scan`` and ``selective_scan_bwd`` have no TPU kernel
(``replaces`` null, a ``note`` says why) and carry their SFU floors, and
``flash_attention`` and ``flash_attention_bwd`` carry their ``windowed``
and ``noncausal`` records; the ``done`` line gives each phase's seconds;
the last line is the result.  Imports nothing of JAX and nothing of the
JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import prefetch_model as PM  # noqa: E402
from repro_torch.core.model_runtime import (  # noqa: E402
    LearnedRecMGModel, train_voyager_arm, voyager_arm_outputs)
from repro_torch.core.recmg import RecMGOutputs, frequency_outputs  # noqa: E402
from repro_torch.core.serving import MultiTableTieredStore  # noqa: E402
from repro_torch.core.tiered import (TieredEmbeddingStore,  # noqa: E402
                                     fast_row_bytes)
from repro_torch.core.trace import TraceGenConfig, generate_trace  # noqa: E402
from repro_torch.data.dlrm_data import (DLRMDataConfig,  # noqa: E402
                                        query_batches)
from repro_torch.data.lm_data import LMDataConfig, batch_at  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import chamfer_kernel as ck  # noqa: E402
from repro_torch.kernels import embedding_gather as eg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lstm_cell as lc  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import work as W  # noqa: E402
from repro_torch.launch.serve import (_dense_forward,  # noqa: E402
                                      cli_learned_config, host_table,
                                      serve_trace)
from repro_torch.launch import accounting as A  # noqa: E402
from repro_torch.launch.serve import main as cli_main  # noqa: E402
from repro_torch.launch.serve_lm import serve_lm_tiered  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compress_tree, dequantize_int8, init_error, make_compressed_dp_grads,
    psum_int8, quantize_int8)
from repro_torch.launch.steps import (make_grads_fn,  # noqa: E402
                                      make_train_step)
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import mesh as M  # noqa: E402
from repro_torch.models.dlrm import (_flat_shard_ids, dlrm_forward,  # noqa: E402
                                     init_dlrm, quantize_tables, shard_params,
                                     shard_rows, torch_dtype)
from repro_torch.models.model_api import build  # noqa: E402
from repro_torch.models.transformer import (decode_step,  # noqa: E402
                                            init_lm, lm_loss, prefill)
from repro_torch.optim.adamw import OptConfig, init_opt  # noqa: E402
from repro_torch.runtime import DriftConfig  # noqa: E402
from repro_torch.sharding import partition as SP  # noqa: E402
from repro_torch.tree import jax_stacks, named_leaves  # noqa: E402
from repro_torch.tree import leaves as tree_leaves  # noqa: E402
from repro_torch.workloads import (CHAOS_KEYS, chaos_sweep,  # noqa: E402
                                   make_spec, make_trace, scenario)
from sharded_layers_ab import ARMS, arm_batch, arm_cfg, lm_arm  # noqa: E402

# H100 SXM peaks (NVIDIA's data sheet): device-memory rate, fp32 rate
# outside the tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
CU_SOURCE = "src/repro_torch/kernels/csrc/embedding_gather.cu"
CU_QUANT_SOURCE = "src/repro_torch/kernels/csrc/embedding_quant.cu"
TPU_GATHER_ROWS = "src/repro/kernels/embedding_gather.py:87"
TPU_GATHER_POOL = "src/repro/kernels/embedding_gather.py:113"
TPU_GATHER_ROWS_DEQUANT = "src/repro/kernels/embedding_gather.py:153"
TPU_GATHER_POOL_DEQUANT = "src/repro/kernels/embedding_gather.py:192"
TPU_QUANTIZE_ROWS = "src/repro/kernels/embedding_gather.py:229"
CU_LSTM_SOURCE = "src/repro_torch/kernels/csrc/lstm_cell.cu"
CU_CHAMFER_SOURCE = "src/repro_torch/kernels/csrc/chamfer.cu"
TPU_LSTM_CELL = "src/repro/kernels/lstm_cell.py:54"
TPU_CHAMFER = "src/repro/kernels/chamfer_kernel.py:42"
CU_FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
TPU_FLASH_ATTENTION = "src/repro/kernels/flash_attention.py:80"
# flash_attention shapes (name, B, S, H, K, hd, dtype); the first is the
# LM serve prefill's, which the kernels line reports.
FLASH_SHAPES = (("serve_prefill", 8, 2048, 9, 3, 64, "bf16"),
                ("qwen2.5-3b_heads", 1, 8192, 16, 2, 128, "bf16"),
                ("granite_serve", 8, 2048, 16, 8, 64, "bf16"),
                ("granite_train", 4, 4096, 16, 8, 64, "bf16"),
                ("internvl2_heads", 1, 2048, 48, 8, 128, "bf16"),
                ("fp32", 2, 1024, 8, 2, 64, "fp32"),
                ("ragged", 4, 1000, 9, 3, 64, "fp32"),
                ("ragged", 4, 1000, 9, 3, 64, "bf16"))
CU_FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
# flash_attention_bwd shapes (name, B, S, H, K, hd, dtype): the LM training
# cut (smollm-135m at train_4k's S, a microbatch of 4), qwen2.5-3b's heads,
# a ragged S and the two small head dims in both dtypes; granite's training
# cut and internvl2's heads (G = 6) in bf16, the dtype they train in; the
# first bf16 one is the kernels line's.
FLASH_BWD_SHAPES = tuple(
    (name, b, s, h, n_kv, hd, dt)
    for name, b, s, h, n_kv, hd in (
        ("train_cut", 4, 4096, 9, 3, 64),
        ("qwen2.5-3b_heads", 1, 4096, 16, 2, 128),
        ("ragged", 2, 1000, 9, 3, 64),
        ("hd16", 2, 1024, 4, 2, 16),
        ("hd32", 2, 1024, 8, 2, 32))
    for dt in ("bf16", "fp32")) + (
        ("granite_train", 4, 4096, 16, 8, 64, "bf16"),
        ("internvl2_heads", 1, 2048, 48, 8, 128, "bf16"))
# flash_attention_bwd's designs by dtype (bf16 redesigned on the tensor
# cores; fp32 keeps the first port's kernels).
FLASH_BWD_DESIGN = {
    "bf16": "mma.sync m16n8k16 bf16 -> fp32, FA2's backward without "
            "atomics: a delta pass; a block per (batch, KV head, 64-key "
            "tile, split of the G heads), 4 warps of 16 keys computing "
            "S^T = k q^T and dP^T = v dO^T, P^T and dS^T packed from the C "
            "fragments as the A operands of dV += P^T dO and dK += dS^T q "
            "(ldmatrix.trans), dK and dV in fp32 registers (split: fp32 "
            "partials summed in order), query steps of 64 (32 at hd 128); a "
            "block per (batch, head, 64-query tile) for dQ, key steps of "
            "32; bf16 tiles double-buffered by 16-byte cp.async; 3 blocks an "
            "SM at hd <= 64, no spills",
    "fp32": "fp32 FMAs from shared memory; a delta pass, then a block per "
            "(batch, KV head, 64-key tile) keeping dK, dV in registers over "
            "the G heads and the query tiles, and a block per (batch, head, "
            "64-query tile) for dQ; p and dS recomputed from the forward's "
            "log-sum-exp, no atomics (the first port's kernels)"}
# The designs of the two kernels redesigned after their first port, as
# their records name them (flash_attention by dtype: fp32 keeps the first
# port's kernel).
FLASH_DESIGN = {
    "bf16": "mma.sync m16n8k16 bf16 -> fp32 on the tensor cores, both "
            "products; 128-query blocks of 8 warps, 64-key tiles "
            "double-buffered by cp.async, ldmatrix (.trans for v), p kept "
            "in registers as bf16",
    "fp32": "fp32 FMAs from shared memory, 64-query x 32-key tiles, p "
            "through shared memory (the first port's kernel)"}
CU_SCAN_SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
# JAX computes the scan in XLA: no TPU kernel stands behind this one.
SCAN_REPLACES_NOTE = ("no TPU kernel: JAX computes the mamba-1 scan in XLA, "
                      "src/repro/models/layers.py:612 (selective_scan)")
# selective_scan shapes (name, B, S, Di, N, dtype): falcon-mamba-7b's and
# hymba-1.5b's prefill layers at the LM serve cut (B=8 x 2,048 tokens); the
# first is the kernels line's.
SCAN_SHAPES = tuple((name, 8, 2048, di, 16, dt)
                    for name, di in (("falcon_prefill", 8192),
                                     ("hymba_prefill", 3200))
                    for dt in ("bf16", "fp32"))
SCAN_DESIGN = ("exps on the SFU: ex2.approx on A scaled by log2(e) once, "
               "silu by ex2 and rcp.approx; a channel's N states split "
               "across N/4 lanes, 4 a lane, 2 adjacent channels a lane (one "
               "B/C load for both), sums by a shuffle reduce-scatter over "
               "N/4 steps so each gate runs once; 64-thread blocks of 32 "
               "channels (N=16), at most 80 registers; 16-step tiles of x, "
               "z, dt, Bm and Cm staged by 16-byte cp.async, "
               "double-buffered, y written out through shared memory in "
               "16-byte stores; sequential over S")
# The scan's first design (one thread per (batch, channel), accurate
# expf) at SCAN_SHAPES: constants, not readings of the run, its ms in an
# earlier run of this script on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md, row 9, in brackets).
SCAN_FIRST_DESIGN_MS = {("falcon_prefill", "bf16"): 1.6021,
                   ("hymba_prefill", "bf16"): 1.0073,
                   ("falcon_prefill", "fp32"): 1.5272,
                   ("hymba_prefill", "fp32"): 0.8188}
# The SFU's 2^x and 1/x on one SM, a clock (NVIDIA's CUDA guide, compute
# capability 9.0).
SFU_OPS_PER_SM_CLOCK = 16
# The windowed attention at hymba-1.5b's prefill: (B, S, H, K, hd, window).
WINDOW_SHAPE = (8, 2048, 25, 5, 64, 1024)
# The windowed attention's backward at hymba-1.5b's training microbatch
# (S = 4,096 at train_4k, a microbatch of 4): (B, S, H, K, hd, window).
WINDOW_BWD_SHAPE = (4, 4096, 25, 5, 64, 1024)
CU_SCAN_BWD_SOURCE = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
SCAN_BWD_NOTE = ("no TPU kernel: JAX differentiates its XLA scan, "
                 "src/repro/models/layers.py:612 (selective_scan), in XLA")
# selective_scan_bwd shapes (name, B, S, Di, N, dtype): falcon-mamba-7b's
# and hymba-1.5b's training microbatch (S = 4,096, 4 rows); the first is
# the kernels line's.
SCAN_BWD_SHAPES = tuple((name, 4, 4096, di, 16, dt)
                        for name, di in (("falcon_train", 8192),
                                         ("hymba_train", 3200))
                        for dt in ("bf16", "fp32"))
SCAN_BWD_DESIGN = ("a channel's N states over N / 4 lanes, 4 a lane; "
                   "64-channel blocks of 64 N / 4 threads (8 warps at "
                   "N = 16), at most 128 registers, 2 blocks an SM; the "
                   "forward saves the state entering every 16 steps, the "
                   "backward walks those tiles in reverse, recomputing a "
                   "tile's 16 states into registers (both passes unrolled) "
                   "with the forward's ex2.approx arithmetic; sums over n "
                   "by a group reduce-scatter over 4 (2) steps, the gate, "
                   "dz, dx, ddt once per (b, t, d); dB, dC by a 7-shuffle "
                   "reduce-scatter over a warp's channels and the block's "
                   "warps in order into per-block partials, da, dD per "
                   "batch row, summed by torch.sum: no atomics; x, z, dy, "
                   "dt, B, C and the states staged by 16-byte cp.async, "
                   "double-buffered, dx, dz, ddt out through shared "
                   "memory; 2 N + 2 SFU operations a (b, t, d)")

LSTM_DESIGN = ("fp32 FMAs; blocks tile (16-64 rows) x (8 units, 4 gates "
               "each); rows and the block's W slice staged by 16-byte "
               "cp.async; a thread holds 4 rows x 4 gates, 3.2 FMAs a "
               "shared load")
QUANT_DESIGN = ("a lane group per row (a warp at D=128) taking 2 rows at "
                "once (1 when the admit would give the card fewer than 4 "
                "blocks an SM), their streaming loads and slots issued "
                "before the absmax shuffles; rows kept in registers to the "
                "codes (D <= 512); IEEE divisions; one short block per 16 "
                "rows, no grid cap")
CHAMFER_DESIGN = ("a row is a group of 16 lanes (2 a warp, __syncwarp only); "
                  "each lane one w point against all P points of po in one "
                  "pass; rows staged by 16-byte cp.async with one wait; "
                  "minima on 64-bit (value, index) keys, backward in "
                  "registers, forward by shuffle trees; 1 row a block at "
                  "B=256, 8 at B=65,536")
# Kernel -> its design, for the kernels redesigned after their first port.
REDESIGNED = {"flash_attention": FLASH_DESIGN["bf16"],
              "flash_attention_bwd": FLASH_BWD_DESIGN["bf16"],
              "lstm_cell": LSTM_DESIGN,
              "quantize_scatter": QUANT_DESIGN,
              "chamfer": CHAMFER_DESIGN,
              "selective_scan": SCAN_DESIGN,
              "selective_scan_bwd": SCAN_BWD_DESIGN}
# Why no single PyTorch call stands beside a quantized kernel.
NO_LIBRARY = {
    "quantize_scatter": "no PyTorch call quantizes rows per row and "
                        "scatters codes and scales",
    "gather_rows_dequant_expand": "no PyTorch call gathers int8/fp8 rows "
                                  "with per-row scales",
    "gather_rows_dequant": "no PyTorch call gathers int8/fp8 rows with "
                           "per-row scales",
    "gather_pool_dequant": "embedding_bag takes no int8/fp8 table with "
                           "per-row scales",
    "chamfer": "no PyTorch call computes the bidirectional Chamfer",
}
# Every LSTM layer's (input width, hidden) on the learned path: hidden 40
# for the caching model and the prefetch model (caching encoder and
# prefetch enc1 27 -> K=67, both decoders of stack 1 80 -> K=120, prefetch
# enc2 40 -> K=80, prefetch dec2 48 -> K=88) and the Voyager arm's encoder
# (25 -> K=57 at hidden 32).
LSTM_LAYERS = {"encoder": (27, 40), "decoder": (80, 40),
               "prefetch_enc2": (40, 40), "prefetch_dec2": (48, 40),
               "voyager_encoder": (25, 32)}
CHAMFER_SHAPE = (5, 15, 25)  # P = out_len, W = window, F = rep_dim
SERVE_KEYS = ("batches", "lookups", "hits", "misses", "prefetch_hits",
              "on_demand_rows", "evictions", "on_demand_stall_ms",
              "modeled_fetch_ms_per_batch")
SERVE_REPORT = ("batches", "lookups", "hits", "misses", "hit_rate",
                "on_demand_rows", "evictions", "prefetch_hits",
                "p50_batch_ms", "p99_batch_ms", "mean_batch_ms", "gather_s",
                "fetch_s", "model_s", "compute_ms")
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# Depth cuts that keep the whole script inside its 1,200 s (each named in
# its phase's record): the full-width DLRM serves read the first 6 of the
# trace's 8 batches (the buffers still 0.2 of the 8 batches' unique ids);
# the learned arms train on a quarter of the first
# batch, the transformer backbone on the first batch; granite's parity runs
# 4 of its 24 layers (8 until the sequence split's arms came); the launcher
# trains granite 4 of 24 layers, falcon 2 of 64 and hymba 2 of 32 (4
# before), the last two 2 steps (1 resumed); the distributed granite
# trains at S 2,048 of train_4k's 4,096.
SERVE_BATCHES = 6
MOE_PARITY_LAYERS = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


class Timer:
    """Median device time of ``fn`` over ``reps`` launches, timed with CUDA
    events, with the 50 MB L2 cache flushed before each one (the serving
    path finds its tables cold).  A spin kernel after the flush keeps the
    device busy while the host enqueues ``fn``, so the host's launch
    overhead is not counted as device time."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock

    def __init__(self, reps: int = 20):
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self._floor_ms = None

    def floor_ms(self) -> float:
        """What the timer reads for a kernel that does nothing: the floor
        under every time of a kernel this small (read once)."""
        if self._floor_ms is None:
            self._floor_ms = self(lambda: torch.cuda._sleep(1))
        return self._floor_ms

    def __call__(self, fn) -> float:
        for _ in range(2):
            fn()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_bytes: float, n_ops: float = 0.0,
             ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def work_bound(w: W.Work):
    """A kernel's bound from its work (``repro_torch.kernels.work``, the
    function its meta path charges): ``(ms, "bytes" or "operations")``."""
    return bound_ms(w.bytes, w.ops, BF16_OPS_PER_S if w.dtype == "bf16"
                    else FP32_OPS_PER_S)


def achieved(rec, n_ops):
    """Adds the achieved TFLOP/s and the share of the bound a timed record
    reaches (``bound_ms / ms``)."""
    rec["tflops"] = n_ops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 ulps of max(|want|, 1): 2^(e - 8)
    for a magnitude in [2^(e-1), 2^e), and 2^-7 below 1.  An output near 0
    sums terms of magnitude ~1 and rounds them, so its own ulp would
    measure nothing; the floor counts it at the ulp of 1."""
    mag = want.float().abs().clamp_min(1.0)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    return float(((got.float() - want.float()).abs() / ulp).max())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})


def ptxas_kernels(report: str) -> dict:
    """``{kernel<template ints>: {"registers", "spill_store_bytes",
    "spill_load_bytes"}}`` from nvcc's ``-Xptxas -v`` report of a
    source."""
    out, name = {}, None
    for ln in report.splitlines():
        # '_ZN55_GLOBAL__N__<file hash>17attn_bwd_dkdv_mmaILi64EEEv...':
        # the anonymous namespace and the name, each length-prefixed, then
        # the template arguments.
        m = re.search(r"Compiling entry function '_ZN(\d+)(\w+)'", ln)
        if m:
            rest = m.group(2)[int(m.group(1)):]
            n = re.match(r"\d+", rest)
            if n is None:
                continue
            rest = rest[n.end():]
            n = int(n.group())
            targs = rest[n:].split("Ev", 1)[0]
            args = (["bf16"] if targs.startswith("I13__nv_bfloat16") else
                    ["float"] if targs.startswith("If") else []) \
                + re.findall(r"L[ib](\d+)E", targs)
            name = rest[:n] + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                out[name]["spill_store_bytes"] = int(m.group(1))
                out[name]["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


def phase_build():
    """Builds every kernel; returns the scan's forward and backward
    kernels' registers and spills."""
    res = _build.build_all()
    ptxas = [ln.strip() for rep in res["ptxas"].values()
             for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(res["seconds"], 3),
          "built": res["built"], "ptxas": ptxas})
    # flash_attention_bwd's kernels: registers a thread and spill bytes
    # (the hd-128 tiles are sized to stay under 255 registers unspilled).
    bwd = ptxas_kernels(_build.ptxas_report("flash_attention_bwd"))
    require(any(k.startswith("attn_bwd_dkdv_mma") for k in bwd),
            f"no attn_bwd_dkdv_mma in the backward's build report: {bwd}")
    emit({"phase": "build_flash_attention_bwd", "kernels": bwd})
    # selective_scan's kernels (by dtype and N): at most 80 registers a
    # thread.
    scan = ptxas_kernels(_build.ptxas_report("selective_scan"))
    require(any(k.startswith("selective_scan_kernel") for k in scan),
            f"no selective_scan_kernel in the scan's build report: {scan}")
    emit({"phase": "build_selective_scan", "kernels": scan})
    scan_bwd = ptxas_kernels(_build.ptxas_report("selective_scan_bwd"))
    require(any(k.startswith("selective_scan_bwd_kernel") for k in scan_bwd),
            f"no selective_scan_bwd_kernel in its build report: {scan_bwd}")
    emit({"phase": "build_selective_scan_bwd", "kernels": scan_bwd})
    # gather_pool's instantiations unmasked (<..,0>) and in the shard
    # window (<..,1>): the flag must leave the unmasked ones as they were.
    pool = {k: v for k, v in ptxas_kernels(
        _build.ptxas_report("embedding_gather")).items()
        if k.startswith("gather_pool_kernel")}
    require(any(k.endswith(",1>") for k in pool)
            and any(k.endswith(",0>") for k in pool),
            f"gather_pool's two modes are not in its build report: {pool}")
    emit({"phase": "build_embedding_gather", "kernels": pool})
    eg._lib()
    eg._qlib()
    lc._lib()
    ck._lib()
    fa._lib()
    ss._lib()
    ss._bwd_lib()
    return {**scan, **scan_bwd}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at the main path's shapes.
# ---------------------------------------------------------------------------

def serve_gather_inputs(uniq_n, inv, capacity, d, dtype, with_ov, seed=0):
    """Inputs of the store's read at the full-width serve shape: the
    buffer (capacity, d), the batch's unique slots and inverse, and, with
    ``with_ov``, the share of unique rows the buffer cannot hold as
    overflow rows staged from the host."""
    rng = np.random.default_rng(seed)
    table = torch.randn((capacity, d), generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda").to(dtype)
    slots = torch.from_numpy(rng.integers(0, capacity, uniq_n)
                             .astype(np.int32)).cuda()
    inv_t = torch.from_numpy(inv.astype(np.int32)).cuda()
    ov = hr = None
    if with_ov:
        ov = torch.from_numpy(
            rng.random(uniq_n) < max(0.0, 1.0 - capacity / uniq_n)).cuda()
        hr = torch.from_numpy(rng.normal(size=(uniq_n, d))
                              .astype(np.float32)).cuda().to(dtype)
    return table, slots, inv_t, ov, hr


def phase_kernels(timer, first_batch, capacity, fwd_table_rows, fwd_b, cfg):
    """Every kernel at the serve and forward shapes, fp32 and bf16,
    D in {16, 128}.  Returns the entry of the main path's configuration
    of each kernel (serve: fp32 D=128; forward: bf16 D=128)."""
    uniq, inv = np.unique(first_batch, return_inverse=True)
    u = uniq.size
    overflow = u > capacity
    rng = np.random.default_rng(1)
    main = {}
    for dt_name, dt in DTYPES.items():
        for d in (16, 128):
            # gather_rows (the TPU kernel's contract) and the store's
            # fused gather_rows_expand, with and without overflow rows.
            for with_ov in (False, True):
                table, slots, inv_t, ov, hr = serve_gather_inputs(
                    u, inv, capacity, d, dt, with_ov)
                got = eg.gather_rows_expand(table, slots, inv_t, ov, hr)
                want = ref.gather_rows_expand_ref(table, slots, inv_t, ov, hr)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"gather_rows_expand {dt_name} D={d} ov={with_ov} "
                        "is not bit-exact")
                rec = {"phase": "kernel", "name": "gather_rows_expand",
                       "dtype": dt_name, "D": d, "M": int(inv.size),
                       "U": int(u), "N": capacity, "overflow": with_ov,
                       "max_abs_err": 0.0,
                       "ms": timer(lambda: eg.gather_rows_expand(
                           table, slots, inv_t, ov, hr)),
                       "plain_ms": timer(lambda: ref.gather_rows_expand_ref(
                           table, slots, inv_t, ov, hr)),
                       "library_ms": None}
                rec["bound_ms"], rec["bound_by"] = work_bound(
                    W.gather_rows_expand(table, slots, inv_t, ov))
                emit(rec)
                if dt_name == "fp32" and d == 128 and with_ov == overflow:
                    main["gather_rows_expand"] = rec
            idx = torch.from_numpy(rng.integers(0, capacity, inv.size)
                                   .astype(np.int32)).cuda()
            got = eg.gather_rows(table, idx)
            require(torch.equal(got, ref.gather_rows_ref(table, idx)),
                    f"gather_rows {dt_name} D={d} is not bit-exact")
            rec = {"phase": "kernel", "name": "gather_rows", "dtype": dt_name,
                   "D": d, "M": int(idx.numel()), "N": capacity,
                   "max_abs_err": 0.0,
                   "ms": timer(lambda: eg.gather_rows(table, idx)),
                   "plain_ms": timer(lambda: ref.gather_rows_ref(table, idx)),
                   "library_ms": timer(lambda: table.index_select(0, idx))}
            rec["bound_ms"], rec["bound_by"] = work_bound(
                W.gather_rows(table, idx))
            emit(rec)
            del table, slots, inv_t, ov, hr, idx
            # gather_pool at the forward shape (B*T rows of P ids).
            table = torch.randn((fwd_table_rows, d), device="cuda").to(dt)
            pidx = torch.from_numpy(rng.integers(
                0, fwd_table_rows, (fwd_b * cfg.n_tables, cfg.multi_hot))
                .astype(np.int32)).cuda()
            got = eg.gather_pool(table, pidx)
            want = ref.gather_pool_ref(table, pidx)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"gather_pool {dt_name} D={d}: max abs err {err}")
            rec = {"phase": "kernel", "name": "gather_pool",
                   "dtype": dt_name, "D": d, "B": int(pidx.shape[0]),
                   "P": cfg.multi_hot, "N": fwd_table_rows,
                   "max_abs_err": err,
                   "ms": timer(lambda: eg.gather_pool(table, pidx)),
                   "plain_ms": timer(lambda: ref.gather_pool_ref(table, pidx)),
                   "library_ms": timer(lambda: torch.nn.functional
                                       .embedding_bag(pidx, table,
                                                      mode="sum"))}
            rec["bound_ms"], rec["bound_by"] = work_bound(
                W.gather_pool(table, pidx))
            emit(rec)
            del table, pidx, got, want
            torch.cuda.empty_cache()
    return main


def quantized_buffer(capacity, d, row_format, seed):
    """A full (capacity, d) quantized buffer of normal rows, quantized by
    the plain version on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return ref.quantize_rows_ref(
        torch.randn((capacity, d), generator=g, device="cuda"), row_format)


def scale_ulps(a, b) -> int:
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def quantize_rec(timer, fmt, d, rows, slots, buf, sc, **kw):
    """``quantize_scatter`` of ``rows`` into ``buf``/``sc`` at ``slots``
    against the plain version on a copy: codes bit-equal, scales within
    one ulp; then both timed.  Returns the record and the kernel's buffer
    and scales."""
    m = rows.shape[0]
    bufs, scs = [buf, buf.clone()], [sc, sc.clone()]
    eg.quantize_scatter(bufs[0], scs[0], slots, rows, fmt)
    ref.quantize_scatter_ref(bufs[1], scs[1], slots, rows, fmt)
    torch.cuda.synchronize()
    what = f"quantize_scatter {fmt} D={d} M={m}"
    require(torch.equal(bufs[0].view(torch.uint8), bufs[1].view(torch.uint8)),
            f"{what}: codes differ")
    ulps = scale_ulps(scs[0], scs[1])
    require(ulps <= 1, f"{what}: scales {ulps} ulps apart")
    rec = {"phase": "kernel", "name": "quantize_scatter", "row_format": fmt,
           "D": d, "N": buf.shape[0], "M": m, **kw,
           "max_abs_err": float((scs[0] - scs[1]).abs().max()),
           "scale_ulps": ulps, "codes_equal": True,
           "ms": timer(lambda: eg.quantize_scatter(bufs[0], scs[0], slots,
                                                   rows, fmt)),
           "plain_ms": timer(lambda: ref.quantize_scatter_ref(
               bufs[1], scs[1], slots, rows, fmt)),
           "library_ms": None, "library_note": NO_LIBRARY["quantize_scatter"]}
    rec["bound_ms"], rec["bound_by"] = work_bound(W.quantize_scatter(m, d))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["design"] = QUANT_DESIGN
    return rec, bufs[0], scs[0]


def per_table_admit(trace, first_batch, qcapacity):
    """The admit of one sub-store of the int8 per-table facade (the
    ``int8-multi_table`` serve arm, built the same way): the table whose
    count of the first batch's unique ids is nearest their mean, that
    count and its sub-store's capacity.  The host rows are never read
    here, so one zero row stands in for the table."""
    d = 128
    host = np.broadcast_to(np.zeros((1, d), np.float32),
                           (int(trace.rows_per_table.sum()), d))
    store = MultiTableTieredStore.from_global_table(
        host, trace.rows_per_table, capacity=qcapacity, policy="lru",
        quantize=True, row_format="int8", device="cuda")
    table = np.searchsorted(store.offsets, np.unique(first_batch),
                            side="right") - 1
    counts = np.bincount(table, minlength=len(store.stores))
    t = int(np.argmin(np.abs(counts - counts.mean())))
    caps = [s.capacity for s in store.stores]
    del store
    torch.cuda.empty_cache()
    return {"table": t, "tables": len(caps), "M": int(counts[t]),
            "N": caps[t], "N_range": [min(caps), max(caps)],
            "M_mean": float(counts.mean()),
            "M_median": float(np.median(counts)),
            "M_range": [int(counts.min()), int(counts.max())]}


def phase_quant_kernels(timer, trace, first_batch, qcapacity, cfg):
    """The quantized tier's kernels at the full-width serve shape, int8
    and fp8, D in {16, 20, 128}: batch 0 misses on every unique id, so its
    admit writes U rows into the 720,100-row buffer, and its read expands
    U slots to the batch's M ids.  Then ``quantize_scatter`` at the
    per-table facade's admit shape (D=128: one sub-store's first-batch
    rows into slots 0.. of its buffer, as its first admit writes them),
    beside the timer's floor.  Returns the entry of the main path's
    configuration of each kernel (int8, D=128)."""
    uniq, inv = np.unique(first_batch, return_inverse=True)
    u = uniq.size
    overflow = u > qcapacity
    inv_t = torch.from_numpy(inv.astype(np.int32)).cuda()
    rng = np.random.default_rng(3)
    main = {}

    def kernel_rec(name, fmt, d, **kw):
        rec = {"phase": "kernel", "name": name, "row_format": fmt, "D": d,
               "N": qcapacity, **kw}
        if "library_ms" not in rec:
            rec["library_ms"] = None
            rec["library_note"] = NO_LIBRARY[name]
        return rec

    sub = per_table_admit(trace, first_batch, qcapacity)
    for fmt in ("int8", "fp8"):
        g = torch.Generator(device="cuda").manual_seed(7)
        rows = torch.randn((sub["M"], 128), generator=g, device="cuda")
        slots = torch.arange(sub["M"], dtype=torch.int32, device="cuda")
        buf, sc = quantized_buffer(sub["N"], 128, fmt, seed=7)
        rec, _, _ = quantize_rec(timer, fmt, 128, rows, slots, buf, sc,
                                 shape="per_table_admit", **sub)
        rec["timer_floor_ms"] = timer.floor_ms()
        emit(rec)
    for fmt in ("int8", "fp8"):
        for d in (16, 20, 128):
            is_main = fmt == "int8" and d == 128
            # The admit: quantize U fp32 rows into U distinct slots.
            g = torch.Generator(device="cuda").manual_seed(d)
            rows = torch.randn((u, d), generator=g, device="cuda")
            slots = torch.from_numpy(rng.permutation(qcapacity)[:u]
                                     .astype(np.int32)).cuda()
            buf, sc = quantized_buffer(qcapacity, d, fmt, seed=d)
            rec, table, scales = quantize_rec(timer, fmt, d, rows, slots,
                                              buf, sc, shape="full_batch")
            emit(rec)
            if is_main:
                main["quantize_scatter"] = rec
            del rows, buf, sc
            # The read: U slots expanded to the batch's M ids, with and
            # without overflow rows (10% of the unique ids) from the host.
            slots_r = torch.from_numpy(rng.integers(0, qcapacity, u)
                                       .astype(np.int32)).cuda()
            for with_ov in (False, True):
                ov = hr = None
                if with_ov:
                    ov = torch.from_numpy(rng.random(u) < 0.1).cuda()
                    hr = torch.randn((u, d), generator=g, device="cuda")
                got = eg.gather_rows_dequant_expand(table, scales, slots_r,
                                                    inv_t, ov, hr)
                want = ref.gather_rows_dequant_expand_ref(
                    table, scales, slots_r, inv_t, ov, hr)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"gather_rows_dequant_expand {fmt} D={d} "
                        f"ov={with_ov} is not bit-exact")
                rec = kernel_rec(
                    "gather_rows_dequant_expand", fmt, d, M=int(inv.size),
                    U=int(u), overflow=with_ov, max_abs_err=0.0,
                    ms=timer(lambda: eg.gather_rows_dequant_expand(
                        table, scales, slots_r, inv_t, ov, hr)),
                    plain_ms=timer(lambda: ref.gather_rows_dequant_expand_ref(
                        table, scales, slots_r, inv_t, ov, hr)))
                rec["bound_ms"], rec["bound_by"] = work_bound(
                    W.gather_rows_expand(table, slots_r, inv_t, ov,
                                         quantized=True))
                emit(rec)
                if is_main and with_ov == overflow:
                    main["gather_rows_dequant_expand"] = rec
                del got, want, ov, hr
            # The TPU kernel's own contract: M random slots, no expansion.
            idx = torch.from_numpy(rng.integers(0, qcapacity, inv.size)
                                   .astype(np.int32)).cuda()
            require(torch.equal(eg.gather_rows_dequant(table, scales, idx),
                                ref.gather_rows_dequant_ref(table, scales,
                                                            idx)),
                    f"gather_rows_dequant {fmt} D={d} is not bit-exact")
            rec = kernel_rec(
                "gather_rows_dequant", fmt, d, M=int(idx.numel()),
                max_abs_err=0.0,
                ms=timer(lambda: eg.gather_rows_dequant(table, scales, idx)),
                plain_ms=timer(lambda: ref.gather_rows_dequant_ref(
                    table, scales, idx)))
            rec["bound_ms"], rec["bound_by"] = work_bound(
                W.gather_rows_dequant(table, scales, idx))
            emit(rec)
            # The batch's pooled read: each query's P ids of each table.
            pidx = slots_r[inv_t.long()].reshape(-1, cfg.multi_hot)
            got = eg.gather_pool_dequant(table, scales, pidx)
            want = ref.gather_pool_dequant_ref(table, scales, pidx)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
                    f"gather_pool_dequant {fmt} D={d}: max abs err {err}")
            rec = kernel_rec(
                "gather_pool_dequant", fmt, d, B=int(pidx.shape[0]),
                P=cfg.multi_hot, max_abs_err=err,
                ms=timer(lambda: eg.gather_pool_dequant(table, scales, pidx)),
                plain_ms=timer(lambda: ref.gather_pool_dequant_ref(
                    table, scales, pidx)))
            rec["bound_ms"], rec["bound_by"] = work_bound(
                W.gather_pool(table, pidx, quantized=True))
            emit(rec)
            del table, scales, slots_r, idx, pidx, got, want
            torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# Phase 4: the same small serve on the CPU and on the card.
# ---------------------------------------------------------------------------

def to_device(params, dev):
    return {"emb": params["emb"].to(dev),
            **{k: {"w": [w.to(dev) for w in params[k]["w"]],
                   "b": [b.to(dev) for b in params[k]["b"]]}
               for k in ("bottom", "top")}}


def phase_parity():
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    cap = int(0.15 * trace.unique_count())
    params = init_dlrm(cfg, seed=0, device="cpu")
    for rows, kw in (("fp32", {}),
                     ("int8", dict(quantize=True, row_format="int8")),
                     ("fp8", dict(quantize=True, row_format="fp8")),
                     ("fp32-multi_table", dict(multi_table=True))):
        for policy in ("lru", "recmg"):
            outputs = (frequency_outputs(trace, cap) if policy == "recmg"
                       else None)
            res = {dev: serve_trace(cfg, to_device(params, dev), trace, cap,
                                    policy, outputs, batch_queries=8,
                                    device=dev, collect_logits=True, **kw)
                   for dev in ("cpu", "cuda")}
            cpu, card = res["cpu"], res["cuda"]
            diff = {k: (cpu[k], card[k]) for k in SERVE_KEYS
                    if cpu[k] != card[k]}
            require(not diff, f"serve counters differ CPU vs card ({rows}, "
                              f"{policy}): {diff}")
            err = float(np.abs(cpu["logits"] - card["logits"]).max())
            require(np.allclose(card["logits"], cpu["logits"], rtol=1e-4,
                                atol=1e-4),
                    f"serve logits differ CPU vs card ({rows}, {policy}): "
                    f"{err}")
            emit({"phase": "serve_parity", "rows": rows, "policy": policy,
                  "counters_equal": True,
                  **{k: card[k] for k in SERVE_KEYS},
                  "logits_max_abs_err": err})


# ---------------------------------------------------------------------------
# Phases 5 and 6: the main path at full width.
# ---------------------------------------------------------------------------

def phase_serve(cfg, trace, host, runs, batch_queries):
    """Each run ``(rows, policy, capacity, serve_trace kwargs)`` serves the
    trace with the counts set to 0 just before and read just after; every
    kernel of the run's path must have launched.  Returns each kernel's
    launches summed over the runs of its path, the results, and
    ``quantize_scatter``'s launches by kind of store: ``full_batch`` (one
    quantized store: a warm-up and one admit of the batch's misses per
    batch) and ``per_table`` (the facade: a warm-up and one admit per
    sub-store and batch)."""
    launches, results = {}, {}
    by_store = {"full_batch": 0, "per_table": 0}
    params = init_dlrm(cfg, seed=0, device="cuda")
    for rows, policy, capacity, kw in runs:
        outputs = (frequency_outputs(trace, capacity)
                   if policy == "recmg" else None)
        path = (("quantize_scatter", "gather_rows_dequant_expand")
                if kw.get("quantize") else ("gather_rows_expand",))
        eg.reset_launches()
        res = serve_trace(cfg, params, trace, capacity, policy, outputs,
                          batch_queries=batch_queries, device="cuda",
                          collect_logits=True, host=host, **kw)
        n = {name: getattr(eg, name).launches for name in path}
        for name, k in n.items():
            require(k > 0, f"serve ({rows}, {policy}) launched {name} 0 "
                           "times")
            launches[name] = launches.get(name, 0) + k
        if kw.get("quantize"):
            kind = "per_table" if kw.get("multi_table") else "full_batch"
            by_store[kind] += n["quantize_scatter"]
        require(res["hits"] + res["misses"] == res["lookups"],
                f"serve ({rows}, {policy}): hits + misses != lookups")
        lg = res["logits"]
        require(lg.shape == (res["batches"], batch_queries)
                and np.isfinite(lg).all(),
                f"serve ({rows}, {policy}): logits {lg.shape} not finite")
        results[(rows, policy)] = res
        emit({"phase": "serve", "rows": rows, "policy": policy,
              "batch_queries": batch_queries,
              "ids_per_batch": batch_queries * cfg.n_tables * cfg.multi_hot,
              "capacity": capacity, "launches": n,
              **{k: res[k] for k in SERVE_REPORT}})
    del params
    torch.cuda.empty_cache()
    return launches, results, by_store


def phase_forward(timer, cfg, b):
    params = init_dlrm(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(2)
    dense = torch.from_numpy(rng.normal(size=(b, cfg.dense_features))
                             .astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(
        0, cfg.rows_per_table, (b, cfg.n_tables, cfg.multi_hot))
        .astype(np.int32)).cuda()
    torch.cuda.synchronize()
    eg.reset_launches()
    logits = dlrm_forward(params, cfg, dense, idx)
    torch.cuda.synchronize()
    launches = eg.gather_pool.launches
    require(launches > 0, "dlrm_forward launched gather_pool 0 times")
    require(logits.shape == (b,) and bool(torch.isfinite(logits).all()),
            "dlrm_forward logits not finite")
    # The plain path on the card: the same lookup through the plain version.
    t, r, d = params["emb"].shape
    flat_table = params["emb"].reshape(t * r, d)
    off = torch.arange(t, device="cuda", dtype=torch.int32) * r
    flat_idx = (idx + off[None, :, None]).reshape(b * t, -1).contiguous()
    pooled = eg.gather_pool(flat_table, flat_idx)
    pooled_plain = ref.gather_pool_ref(flat_table, flat_idx)
    err = float((pooled - pooled_plain).abs().max())
    require(torch.allclose(pooled, pooled_plain, rtol=1e-5, atol=1e-5),
            f"gather_pool at the forward shape: max abs err {err}")
    plain_logits = _dense_forward(
        params, cfg, dense, pooled_plain.reshape(b, t, d).to(torch.bfloat16)
    ).float()
    lerr = float((logits - plain_logits).abs().max())
    # bf16 tolerance: the fp32 pooled sums round to bf16 at other points.
    require(torch.allclose(logits, plain_logits, rtol=2e-2, atol=2e-2),
            f"dlrm_forward vs plain lookup: max abs err {lerr}")
    rec = {"name": "gather_pool", "dtype": "bf16", "D": d, "B": b * t,
           "P": cfg.multi_hot, "N": t * r, "max_abs_err": err,
           "ms": timer(lambda: eg.gather_pool(flat_table, flat_idx)),
           "plain_ms": timer(lambda: ref.gather_pool_ref(flat_table,
                                                         flat_idx)),
           "library_ms": timer(lambda: torch.nn.functional.embedding_bag(
               flat_idx, flat_table, mode="sum"))}
    rec["bound_ms"], rec["bound_by"] = work_bound(
        W.gather_pool(flat_table, flat_idx))
    fwd_ms = timer(lambda: dlrm_forward(params, cfg, dense, idx))
    emit({"phase": "forward", "B": b, "tables": t, "rows_per_table": r,
          "emb_gb": params["emb"].numel() * params["emb"].element_size()
          / 1e9, "launches": {"gather_pool": launches},
          "logits_vs_plain_max_abs_err": lerr, "forward_ms": fwd_ms,
          "kernel": rec})
    del flat_table, pooled, pooled_plain
    return rec, launches, dict(params=params, dense=dense, idx=idx,
                               logits=logits)


def forward_quantized(timer, cfg, params, dense, idx, bf16_logits):
    """The same forward with the tables quantized to int8 on the card (one
    ``quantize_scatter`` per table, set-up), which pools through
    ``gather_pool_dequant``, against the plain pooled read."""
    b = dense.shape[0]
    qparams = quantize_tables(params, "int8")
    del params["emb"]
    torch.cuda.synchronize()
    eg.reset_launches()
    logits = dlrm_forward(qparams, cfg, dense, idx)
    torch.cuda.synchronize()
    launches = eg.gather_pool_dequant.launches
    require(launches > 0, "int8 dlrm_forward launched gather_pool_dequant "
                          "0 times")
    require(logits.shape == (b,) and bool(torch.isfinite(logits).all()),
            "int8 dlrm_forward logits not finite")
    t, r, d = qparams["emb"].shape
    codes = qparams["emb"].reshape(t * r, d)
    scales = qparams["emb_scales"].reshape(t * r)
    off = torch.arange(t, device="cuda", dtype=torch.int32) * r
    flat_idx = (idx + off[None, :, None]).reshape(b * t, -1).contiguous()
    pooled = eg.gather_pool_dequant(codes, scales, flat_idx)
    pooled_plain = ref.gather_pool_dequant_ref(codes, scales, flat_idx)
    err = float((pooled - pooled_plain).abs().max())
    require(torch.allclose(pooled, pooled_plain, rtol=1e-6, atol=1e-6),
            f"gather_pool_dequant at the forward shape: max abs err {err}")
    plain_logits = _dense_forward(qparams, cfg, dense,
                                  pooled_plain.reshape(b, t, d)).float()
    lerr = float((logits - plain_logits).abs().max())
    require(torch.allclose(logits, plain_logits, rtol=2e-2, atol=2e-2),
            f"int8 dlrm_forward vs plain lookup: max abs err {lerr}")
    rec = {"name": "gather_pool_dequant", "row_format": "int8", "D": d,
           "B": b * t, "P": cfg.multi_hot, "N": t * r, "max_abs_err": err,
           "ms": timer(lambda: eg.gather_pool_dequant(codes, scales,
                                                      flat_idx)),
           "plain_ms": timer(lambda: ref.gather_pool_dequant_ref(
               codes, scales, flat_idx)),
           "library_ms": None,
           "library_note": NO_LIBRARY["gather_pool_dequant"]}
    rec["bound_ms"], rec["bound_by"] = work_bound(
        W.gather_pool(codes, flat_idx, quantized=True))
    fwd_ms = timer(lambda: dlrm_forward(qparams, cfg, dense, idx))
    emit({"phase": "forward_quantized", "row_format": "int8", "B": b,
          "emb_gb": (codes.numel() + 4 * scales.numel()) / 1e9,
          "launches": {"gather_pool_dequant": launches},
          "logits_vs_plain_max_abs_err": lerr,
          "logits_vs_bf16_tables_max_abs_err":
              float((logits - bf16_logits).abs().max()),
          "forward_ms": fwd_ms, "kernel": rec})
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 6': DLRM served with its tables row-sharded over a mesh of ranks.
# ---------------------------------------------------------------------------

# (data, model): four gloo ranks on the one card, each with half the rows of
# every table and half the batch.
DIST_MESH = (2, 2)
DIST_SEED = 11
GLOO_NOTE = ("gloo on one card: the partials go through host memory; no "
             "NCCL or NVLink figure")


def distributed_batch(cfg, b):
    """The distributed serve's queries on the host: dense features and ids
    drawn over [-2, R + 2), so that some ids are owned by no shard."""
    rng = np.random.default_rng(DIST_SEED)
    dense = rng.normal(size=(b, cfg.dense_features)).astype(np.float32)
    idx = rng.integers(-2, cfg.rows_per_table + 2,
                       (b, cfg.n_tables, cfg.multi_hot)).astype(np.int32)
    return torch.from_numpy(dense), torch.from_numpy(idx)


def phase_distributed_nccl(cfg, fwd, b):
    """World 1 over NCCL in this process, on a (1, 1) mesh: the sharded
    forward through ``build(run=RunConfig(dlrm_sharded_lookup=True))``
    equals phase ``forward``'s logits bit for bit (its all-reduce and
    gather run through NCCL).  Then the reference of the four-rank run from
    the same whole tables: its batch pooled by the shard window's plain
    twin (an id outside [0, R) adds nothing), the same MLPs.  Returns the
    reference logits on the host and the window's launches."""
    params = fwd["params"]
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        M.init_distributed("nccl", f"file://{store}/store", 0, 1,
                           device="cuda:0", timeout=60)
        mesh = M.make_host_mesh()
        shard = shard_params(params, mesh)
        require(shard["emb"].data_ptr() == params["emb"].data_ptr(),
                "the (1, 1) mesh's shard copied the tables")
        bundle = build(cfg, device="cuda",
                       run=RunConfig(dlrm_sharded_lookup=True))
        torch.cuda.synchronize()
        ops.reset_launches()
        with M.activation_sharding(mesh):
            logits = bundle.prefill(shard, {"dense": fwd["dense"],
                                            "sparse": fwd["idx"]})
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                    if fn.launches}
        logits = M.gather_batch(logits, mesh)
        torch.cuda.synchronize()
    finally:
        M.close_distributed()
        shutil.rmtree(store, ignore_errors=True)
    require(launches == {"gather_pool_shard": 1},
            f"the sharded forward launched {launches}")
    require(torch.equal(logits, fwd["logits"]),
            "world 1 over nccl: the sharded forward differs from the "
            "unsharded one by "
            f"{float((logits - fwd['logits']).abs().max())}")
    emit({"phase": "distributed_serve", "world": 1, "backend": "nccl",
          "mesh": mesh.shape, "B": int(logits.shape[0]),
          "launches": launches, "logits_bit_equal_unsharded": True})
    dense, idx = (x.cuda() for x in distributed_batch(cfg, b))
    t, r, d = params["emb"].shape
    pooled = ref.gather_pool_shard_ref(params["emb"].reshape(t * r, d),
                                       _flat_shard_ids(idx, t, r, 0))
    want = _dense_forward(params, cfg, dense,
                          pooled.reshape(b, t, d).to(params["emb"].dtype))
    return want.float().cpu(), launches["gather_pool_shard"]


def distributed_rank(rank, world, work, b, train_ref):
    """One gloo rank of the (2, 2) mesh on the card, in a process of its
    own: draws its rows of the full-width tables, serves its quarter of
    the batch through ``build(...).prefill``, gathers the logits over
    ``data``, then holds the shard window against its plain twin, times
    it (one rank at a time) and times the all-reduce of the pooled
    partials over ``model``; then trains (:func:`distributed_train_rank`).
    Writes ``rank<r>.json`` (and rank 0 the logits) into ``work``; any
    failure raises and fails the spawn."""
    t0 = time.perf_counter()
    # Four ranks' training share the card: segments that grow in place
    # keep each rank's freed blocks usable by its next, larger tensors.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = M.init_distributed("gloo", f"file://{work}/store", rank, world,
                             device="cuda:0", timeout=120)
    cfg = get_config("dlrm-recmg")
    mesh = M.make_mesh(*DIST_MESH)
    lo, hi = shard_rows(cfg.rows_per_table, mesh)
    params = init_dlrm(cfg, seed=0, device=dev, rows=(lo, hi))
    dense, idx = (M.batch_shard(x, mesh).to(dev)
                  for x in distributed_batch(cfg, b))
    bundle = build(cfg, device=dev, run=RunConfig(dlrm_sharded_lookup=True))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dist.barrier()
    ops.reset_launches()
    t0 = time.perf_counter()
    with M.activation_sharding(mesh):
        logits = bundle.prefill(params, {"dense": dense, "sparse": idx})
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    logits = M.gather_batch(logits, mesh)
    t, rs, d = params["emb"].shape
    table = params["emb"].reshape(t * rs, d)
    ids = _flat_shard_ids(idx, t, rs, lo)
    got = eg.gather_pool_shard(table, ids)
    want = ref.gather_pool_shard_ref(table, ids)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
            f"gather_pool_shard on rank {rank}: max abs err {err}")
    rec = {"rank": rank, "coords": [mesh.data_rank, mesh.model_rank],
           "rows": [lo, hi], "shard_gb": params["emb"].numel()
           * params["emb"].element_size() / 1e9, "launches": launches,
           "B": int(ids.shape[0]), "P": cfg.multi_hot, "N": t * rs, "D": d,
           "owned_share": float((ids >= 0).float().mean()),
           "max_abs_err": err, "setup_s": setup_s,
           "forward_ms_host": forward_ms}
    del want
    # The kernel, its twin and embedding_bag, one rank at a time: the
    # others wait in a gloo barrier, off the card.
    for r in range(world):
        dist.barrier()
        if r == rank:
            timer = Timer()
            weights = (ids >= 0).to(table.dtype)
            clamped = ids.clamp_min(0)
            rec.update(
                ms=timer(lambda: eg.gather_pool_shard(table, ids)),
                plain_ms=timer(lambda: ref.gather_pool_shard_ref(table, ids)),
                library_ms=timer(lambda: torch.nn.functional.embedding_bag(
                    clamped, table, mode="sum", per_sample_weights=weights)))
            rec["bound_ms"], rec["bound_by"] = work_bound(
                W.gather_pool_shard(table, ids))
            del timer, weights, clamped
    # The all-reduce of the (B_local * T, D) fp32 partials over model.
    times = []
    for _ in range(5):
        buf = got.clone()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.model_group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec.update(allreduce_ms=float(np.median(times)),
               allreduce_bytes=got.numel() * 4,
               unpooled_exchange_bytes=got.numel() * 4 * cfg.multi_hot)
    if rank == 0:
        torch.save(logits.cpu(), Path(work, "logits.pt"))
    del params, got, table, logits
    torch.cuda.empty_cache()
    rec["train"] = distributed_train_rank(rank, world, work, dev, mesh,
                                          train_ref)
    rec["sharded"] = sharded_train_rank(rank, work, dev, train_ref["sharded"])
    rec["lm_serve"] = lm_sharded_serve_rank(rank, work, dev)
    Path(work, f"rank{rank}.json").write_text(json.dumps(rec))
    M.close_distributed()


def phase_distributed_serve(b, want, train_ref, work, st_nccl_launches,
                            ss_nccl_launches):
    """Four gloo ranks on the one card, a (2, 2) mesh, the full-width
    tables row-sharded over model (7.97 GB a rank): the gathered logits
    within 2e-2 (bf16) of ``want``, each rank's shard window within fp32
    1e-5 of its plain twin; then, in the same ranks, phase
    ``distributed_train`` against ``train_ref`` (its references' files in
    ``work``, which this removes), and phase ``sharded_train``'s four
    ranks (:func:`report_sharded_train`, with the world-1 run's launches
    ``st_nccl_launches``), then phase ``lm_sharded_serve``'s
    (:func:`report_lm_sharded_serve`, with ``ss_nccl_launches``).  Returns
    rank 0's kernel record (errors the largest over the ranks), the
    window's serve launches over the ranks, the training's launches over
    the ranks, the sharded training's launches of ``ST_KERNELS`` and the
    served LM's offset-kernel launches."""
    world = DIST_MESH[0] * DIST_MESH[1]
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(distributed_rank,
                                    args=(world, work, b, train_ref),
                                    nprocs=world, join=True)
        spawn_s = time.perf_counter() - t0
        recs = [json.loads(Path(work, f"rank{r}.json").read_text())
                for r in range(world)]
        got = torch.load(Path(work, "logits.pt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"distributed serve: logits {tuple(got.shape)} not finite")
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=2e-2, atol=2e-2),
            f"distributed serve vs the unsharded forward: max abs err {err}")
    for r in recs:
        require(r["launches"] == {"gather_pool_shard": 1},
                f"rank {r['rank']} launched {r['launches']}")
    launches = sum(r["launches"]["gather_pool_shard"] for r in recs)
    emit({"phase": "distributed_serve", "world": world, "backend": "gloo",
          "ranks_on_one_card": world,
          "mesh": dict(zip(("data", "model"), DIST_MESH)), "B": b,
          "logits_vs_unsharded_max_abs_err": err, "spawn_s": spawn_s,
          "allreduce_note": GLOO_NOTE,
          "ranks": [{k: r[k] for k in (
              "rank", "coords", "rows", "shard_gb", "launches",
              "owned_share", "max_abs_err", "ms", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "allreduce_ms", "allreduce_bytes",
              "unpooled_exchange_bytes", "setup_s", "forward_ms_host")}
              for r in recs]})
    rec = {k: recs[0][k] for k in ("B", "P", "N", "D", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "allreduce_ms", "allreduce_bytes",
                                   "unpooled_exchange_bytes")}
    rec.update(name="gather_pool_shard", dtype="bf16",
               max_abs_err=max(r["max_abs_err"] for r in recs),
               library="embedding_bag(mode='sum', per_sample_weights=owned)")
    return (rec, launches, report_distributed_train(recs, spawn_s),
            report_sharded_train(recs, st_nccl_launches),
            report_lm_sharded_serve(recs, ss_nccl_launches))


# ---------------------------------------------------------------------------
# Phase 6'': training across the ranks of a mesh.
# ---------------------------------------------------------------------------

# DLRM: rows_per_table cut to the full-width serve's 4,096 (2,048 a model
# rank), B = 256 in 2 microbatches, 2 steps.  granite-moe: its depth cut
# to 2 layers, train_4k's S of 4,096 cut to 2,048 (for the script's time,
# when the sequence split's arms were added) and the global batch cut to
# 8 in 2 microbatches (1 row a data rank and microbatch on (4, 1)), 2
# steps.
DT_ROWS = 4096
DT_B, DT_MB, DT_STEPS = 256, 2, 2
DT_LR = 1e-3
MOE_DT = dict(n_layers=2, seq=1024, batch=8, mb=2, steps=2)
DT_TOL_BF16, DT_TOL_FP32 = 2e-2, 1e-4


def dt_dlrm_cfg():
    return dataclasses.replace(get_config("dlrm-recmg"),
                               rows_per_table=DT_ROWS)


def dt_granite_cfg(dtype):
    full = get_config("granite-moe-1b-a400m")
    return dataclasses.replace(full, n_layers=MOE_DT["n_layers"],
                               param_dtype=dtype, compute_dtype=dtype)


def dt_batches(cfg, lo=-2, extra=2):
    """The DLRM training's batches on the host, one a step: ids over [lo,
    R + extra) (by default some that no shard owns, which the row-sharded
    lookup drops)."""
    rng = np.random.default_rng(DIST_SEED + 1)
    out = []
    for _ in range(DT_STEPS):
        out.append({
            "dense": torch.from_numpy(rng.normal(
                size=(DT_B, cfg.dense_features)).astype(np.float32)),
            "sparse": torch.from_numpy(rng.integers(
                lo, cfg.rows_per_table + extra,
                (DT_B, cfg.n_tables, cfg.multi_hot)).astype(np.int32)),
            "label": torch.from_numpy(
                (rng.random(DT_B) < 0.5).astype(np.float32))})
    return out


def dt_lm_argv(steps, extra=()):
    return ["--arch", "granite-moe-1b-a400m", "--steps", str(steps),
            "--seq-len", str(MOE_DT["seq"]), "--batch", str(MOE_DT["batch"]),
            "--microbatches", str(MOE_DT["mb"]), "--lr", str(DT_LR),
            "--log-every", "1", *extra]


class RouteLog:
    """Records each call of the MoE's router (``layers._route``): its
    top-K experts and the margin between the K-th and (K+1)-th
    probabilities, one record a layer and microbatch."""

    def __enter__(self):
        self.top_e, self.margin = [], []
        self._route = L._route

        def route(p, cfg, xf):
            probs, top_p, top_e = self._route(p, cfg, xf)
            srt = torch.sort(probs.detach(), dim=-1, descending=True).values
            self.top_e.append(top_e.detach().clone())
            self.margin.append(srt[:, cfg.top_k - 1] - srt[:, cfg.top_k])
            return probs, top_p, top_e

        L._route = route
        return self

    def __exit__(self, *exc):
        L._route = self._route
        return False


def leaf_errors(got, want, rows=None):
    """{leaf: max |got - want| over max |want|}; ``rows`` cuts a table's
    rows of ``want`` to a rank's shard."""
    out = {}
    for (name, g), w in zip(got, want):
        if rows is not None and name == "emb":
            w = w[:, rows[0]:rows[1]]
        w = w.to(g.device).float()
        out[name] = float((g.float() - w).abs().max()
                          / w.abs().max().clamp_min(1e-30))
    return out


def pool_bwd_bound(idx, n_rows, d, elt):
    """Bound of a sum-pool's backward: the pooled gradient (fp32) and the
    ids read once, the table's gradient written once in its dtype; one add
    per owned id and element."""
    b, _ = idx.shape
    owned = int((idx >= 0).sum())
    return bound_ms(b * d * 4 + idx.numel() * 4 + n_rows * d * elt,
                    owned * d)


def phase_distributed_train_nccl(work):
    """World 1 over NCCL in this process, a (1, 1) mesh with its groups:
    the DLRM step through the row-sharded lookup (ids in range, one
    microbatch) gives the unsharded step's loss bit for bit, its table
    gradient within one bf16 ulp (the scatter-add's atomics) and every
    other gradient bit for bit; ``compress_tree`` and ``psum_int8`` over
    the one NCCL rank give ``dequant(quant(g))`` bit for bit, and the
    compressed step runs.  Then, outside any process group, the references
    of the four ranks on a (1, 1) mesh: the DLRM sharded step (bf16) on the
    whole tables over the global batches (the first step's gradients saved
    to ``work``) and granite's fp32 step over the launcher's batches (its
    first step's gradients and every router call's top-K saved)."""
    cfg = dt_dlrm_cfg()
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_train_")
    try:
        M.init_distributed("nccl", f"file://{store}/store", 0, 1,
                           device="cuda:0", timeout=120)
        mesh = M.make_host_mesh()
        params = init_dlrm(cfg, seed=0, device="cuda")
        batch = dt_batches(cfg, lo=0, extra=0)[0]
        sharded = build(cfg, device="cuda", run=RunConfig(
            remat="none", dlrm_sharded_lookup=True))
        dense = build(cfg, device="cuda", run=RunConfig(remat="none"))
        ops.reset_launches()
        loss_s, grads_s = make_grads_fn(sharded, 1, mesh)(params, batch)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                    if fn.launches}
        loss_d, grads_d = make_grads_fn(dense, 1)(params, batch)
        names = [n for n, _ in named_leaves(params)]
        require(torch.equal(loss_s, loss_d),
                f"nccl world 1: sharded loss {float(loss_s)} vs "
                f"{float(loss_d)}")
        ulps = {}
        for n, a, b in zip(names, grads_s, grads_d):
            if n == "emb":
                ulps[n] = bf16_ulps(a, b.float())
            else:
                require(torch.equal(a, b.float()),
                        f"nccl world 1: gradient {n} differs")
        require(ulps["emb"] <= 1.0, f"nccl world 1: table gradient "
                                    f"{ulps['emb']} bf16 ulps off")
        stacks = jax_stacks(params)
        q, sc, _ = compress_tree(grads_d, init_error(params), stacks)
        summed = psum_int8(q, sc, mesh.data_group, 1)
        for n, g, got in zip(names, grads_d, summed):
            require(torch.equal(got, dequantize_int8(*quantize_int8(g))),
                    f"nccl world 1: psum_int8 of {n} is not "
                    "dequant(quant(g))")
        loss_c, grads_c, _ = make_compressed_dp_grads(dense.loss, mesh)(
            params, init_error(params), batch)
        require(torch.equal(loss_c, loss_d) and all(
            bool(torch.isfinite(g).all()) for g in grads_c),
            "nccl world 1: the compressed step")
        torch.cuda.synchronize()
    finally:
        M.close_distributed()
        shutil.rmtree(store, ignore_errors=True)
    del params, grads_s, grads_d, grads_c, q, summed
    rec = {"phase": "distributed_train", "world": 1, "backend": "nccl",
           "mesh": mesh.shape, "B": DT_B, "rows_per_table": DT_ROWS,
           "launches": launches, "loss_bit_equal_unsharded": True,
           "table_grad_bf16_ulps": ulps["emb"],
           "other_grads_bit_equal": True,
           "int8_ef_is_dequant_of_quant": True,
           "seconds": round(time.perf_counter() - t0, 1)}
    require(launches.get("gather_pool_shard") == 1,
            f"nccl world 1 train: launches {launches}")

    # The four ranks' references, one rank owning every row.
    t0 = time.perf_counter()
    mesh = M.make_host_mesh()
    params = init_dlrm(cfg, seed=0, device="cuda")
    bundle = build(cfg, device="cuda", run=RunConfig(
        remat="none", dlrm_sharded_lookup=True))
    batches = dt_batches(cfg)
    # The gradients of the same rows in the same 64-row pieces that the two
    # data ranks' microbatches hold (DT_MB x 2 microbatches here): the bf16
    # gradients of another cut of the batch (DT_MB here) differ by up to
    # 27% of a leaf's largest magnitude (the rows' terms cancel), which the
    # record shows as ``dlrm_grad_split_noise``.
    _, grads = make_grads_fn(bundle, DT_MB * DIST_MESH[0], mesh)(
        params, batches[0])
    torch.save([g.to(torch.bfloat16).cpu() for g in grads],
               Path(work, "dlrm_ref.pt"))
    _, other = make_grads_fn(bundle, DT_MB, mesh)(params, batches[0])
    rec["dlrm_grad_split_noise"] = leaf_errors(
        zip([n for n, _ in named_leaves(params)], other), grads)
    del grads, other
    # The first loss under each lookup's ids (the fsdp arm's reference):
    # the dense lookup wraps and clamps the ids the sharded one drops.
    with torch.no_grad():
        fsdp_losses = {"dense": float(build(cfg, device="cuda", run=RunConfig(
            remat="none")).loss(params, batches[0]))}
    opt = init_opt(OptConfig(lr=DT_LR), tree_leaves(params))
    step = make_train_step(bundle, DT_MB, mesh)
    dlrm_losses = [float(step(params, opt, b)["loss"]) for b in batches]
    fsdp_losses["sharded"] = dlrm_losses[0]
    del params, opt
    torch.cuda.empty_cache()
    lm = dt_granite_cfg("float32")
    bundle = build(lm, device="cuda", run=RunConfig(remat="none"))
    model = bundle.init(seed=0)
    data = LMDataConfig(vocab=lm.vocab, seq_len=MOE_DT["seq"],
                        global_batch=MOE_DT["batch"])
    with RouteLog() as log:
        _, grads = make_grads_fn(bundle, MOE_DT["mb"])(model, batch_at(data,
                                                                       0))
    torch.save({"grads": [g.cpu() for g in grads],
                "top_e": [t.cpu() for t in log.top_e],
                "margin": [m.cpu() for m in log.margin]},
               Path(work, "granite_ref.pt"))
    del grads, log
    opt = init_opt(OptConfig(lr=DT_LR, total_steps=MOE_DT["steps"]),
                   list(model.parameters()))
    step = make_train_step(bundle, MOE_DT["mb"])
    granite_losses = [float(step(model, opt, batch_at(data, s))["loss"])
                      for s in range(MOE_DT["steps"])]
    del model, opt
    torch.cuda.empty_cache()
    rec["reference_s"] = round(time.perf_counter() - t0, 1)
    emit(rec)
    return ({"dlrm_losses": dlrm_losses, "granite_losses": granite_losses,
             "dlrm_fsdp_losses": fsdp_losses},
            launches["gather_pool_shard"])


def dt_steps(step, params, opt, batches):
    """Every batch's step, the ranks aligned by a barrier before each:
    ``(losses, step ms by the host clock, the steps' collective
    traffic)``."""
    C.reset_traffic()
    losses, step_ms = [], []
    for b in batches:
        dist.barrier()
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, b)["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, copy.deepcopy(C.TRAFFIC)


def distributed_train_rank(rank, world, work, dev, mesh, train_ref):
    """The gloo rank's training, after its serve: (a) DLRM through the
    row-sharded lookup on the (2, 2) mesh with its tables' rows over
    ``model`` (``emb_rows="model"``), its first step's gradients and
    every step's loss against the one-rank reference, the window's forward
    and the masked and unmasked backwards timed (one rank at a time) and
    the gradient all-reduce over ``data`` timed; (a') the same with the
    rows over both axes (``emb_rows="all"``, JAX's default layout): its
    losses against (a)'s and the reference's, its step time, peak and
    collective traffic, whose all-reduces lack (a)'s table gradient;
    (a'') one step with the batch over both axes too (``sharding="fsdp"``)
    through each lookup, its loss against the reference's first; (b)
    granite-moe through
    the launcher on (4, 1), fp32 on the global dispatch against the
    reference (rank 0 compares the gradients and the top-K), then bf16
    with ``--grad-compression int8_ef``.  Returns the rank's record."""
    t_start = time.perf_counter()
    rec = {}
    cfg = dt_dlrm_cfg()
    lo, hi = shard_rows(cfg.rows_per_table, mesh)
    bundle = build(cfg, device=dev, run=RunConfig(
        remat="none", dlrm_sharded_lookup=True, emb_rows="model"), mesh=mesh)
    params = bundle.init(seed=0)
    batches = dt_batches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, grads = make_grads_fn(bundle, DT_MB, mesh)(params, batches[0])
    want = torch.load(Path(work, "dlrm_ref.pt"), mmap=True)
    errs = leaf_errors(zip([n for n, _ in named_leaves(params)], grads),
                       want, (lo, hi))
    del want
    # The gradient all-reduce over data: the dense shard gradient and the
    # MLPs', fp32, leaf by leaf, as the step runs it.
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for g in grads:
        dist.all_reduce(g, group=mesh.data_group)
    torch.cuda.synchronize()
    allreduce = {"allreduce_bytes": sum(g.numel() * 4 for g in grads),
                 "allreduce_ms": (time.perf_counter() - t0) * 1e3}
    del grads
    opt = init_opt(OptConfig(lr=DT_LR), tree_leaves(params))
    step = make_train_step(bundle, DT_MB, mesh)
    ops.reset_launches()
    losses, step_ms, traffic = dt_steps(step, params, opt, batches)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    rec["dlrm"] = {
        "emb_rows": "model", "rows": [lo, hi],
        "spec": params["emb"].placement.spec, "losses": losses,
        "ref_losses": train_ref["dlrm_losses"], "grad_err_share": errs,
        "launches": launches, "step_ms": step_ms, **allreduce,
        "traffic_steps": traffic,
        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    del opt
    # The window's forward and both backwards at the rank's step shape (its
    # 128 rows of the step's 256 queries), one rank at a time.
    t, rs, d = params["emb"].shape
    table = params["emb"].detach().reshape(t * rs, d)
    ids = _flat_shard_ids(M.batch_shard(batches[0]["sparse"].to(dev), mesh),
                          t, rs, lo)
    gen = torch.Generator(device=dev).manual_seed(rank)
    ids_in = torch.where(ids < 0, torch.randint(
        0, t * rs, ids.shape, generator=gen, device=dev,
        dtype=ids.dtype), ids)
    dout = torch.randn((ids.shape[0], d), generator=gen, device=dev)
    for r in range(world):
        dist.barrier()
        if r == rank:
            timer = Timer()
            fwd = eg.gather_pool_shard(table, ids)
            require(torch.allclose(fwd, ref.gather_pool_shard_ref(table, ids),
                                   rtol=1e-5, atol=1e-5),
                    f"rank {rank}: the window against its twin")
            del fwd
            w = {"B": int(ids.shape[0]), "P": int(ids.shape[1]),
                 "N": t * rs, "D": d,
                 "owned_share": float((ids >= 0).float().mean()),
                 "fwd_ms": timer(lambda: eg.gather_pool_shard(table, ids)),
                 "masked_bwd_ms": timer(lambda: ops._pool_backward(
                     ids, dout, table.shape, table.dtype, True)),
                 "unmasked_bwd_ms": timer(lambda: ops._pool_backward(
                     ids_in, dout, table.shape, table.dtype, False))}
            w["fwd_bound_ms"], _ = work_bound(W.gather_pool_shard(table, ids))
            w["masked_bwd_bound_ms"], w["bwd_bound_by"] = pool_bwd_bound(
                ids, t * rs, d, table.element_size())
            w["unmasked_bwd_bound_ms"], _ = pool_bwd_bound(
                ids_in, t * rs, d, table.element_size())
            rec["window"] = w
            del timer
    del ids, ids_in, dout, params, table
    torch.cuda.empty_cache()

    # (a') The rows over both axes: part d * 2 + m of every table.
    bundle = build(cfg, device=dev, run=RunConfig(
        remat="none", dlrm_sharded_lookup=True, emb_rows="all"), mesh=mesh)
    params = bundle.init(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    opt = init_opt(OptConfig(lr=DT_LR), tree_leaves(params))
    step = make_train_step(bundle, DT_MB, mesh)
    ops.reset_launches()
    losses, step_ms, traffic = dt_steps(step, params, opt, batches)
    emb = params["emb"]
    rec["dlrm_all"] = {
        "emb_rows": "all", "spec": emb.placement.spec,
        "part_of_parts": list(SP.part_index(emb.placement.spec[1], mesh)),
        "table_bytes": emb.numel() * emb.element_size(),
        "model_arm_table_bytes": t * rs * d * emb.element_size(),
        "losses": losses, "model_arm_losses": rec["dlrm"]["losses"],
        "ref_losses": train_ref["dlrm_losses"],
        "launches": {fn.__name__: fn.launches for fn in ops.KERNELS
                     if fn.launches},
        "step_ms": step_ms, "traffic_steps": traffic,
        "model_arm_table_grad_fp32_bytes": t * rs * d * 4,
        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    del params, opt, step, bundle, emb
    torch.cuda.empty_cache()

    # (a'') The batch over both axes (sharding="fsdp"): the tables' rows
    # over both axes, the ids gathered over the world and the partials
    # reduce-scattered over it; one step, each lookup.
    for lookup in ("sharded", "dense"):
        bundle = build(cfg, device=dev, run=RunConfig(
            remat="none", sharding="fsdp",
            dlrm_sharded_lookup=lookup == "sharded"), mesh=mesh)
        params = bundle.init(seed=0)
        opt = init_opt(OptConfig(lr=DT_LR), tree_leaves(params))
        step = make_train_step(bundle, DT_MB, mesh)
        ops.reset_launches()
        losses, step_ms, traffic = dt_steps(step, params, opt, batches[:1])
        rec[f"dlrm_fsdp_{lookup}"] = {
            "sharding": "fsdp", "spec": params["emb"].placement.spec,
            "rows_per_rank": DT_B // DT_MB // world, "losses": losses,
            "ref_loss": train_ref["dlrm_fsdp_losses"][lookup],
            "launches": {fn.__name__: fn.launches for fn in ops.KERNELS
                         if fn.launches},
            "step_ms": step_ms, "traffic_steps": traffic}
        del params, opt, step, bundle
        torch.cuda.empty_cache()

    # (b) granite-moe on (4, 1): fp32, global dispatch, then int8_ef.
    lm = dt_granite_cfg("float32")
    mesh41 = M.make_mesh(world, 1)
    bundle = build(lm, device=dev, run=RunConfig(remat="none"))
    model = bundle.init(seed=0)
    data = LMDataConfig(vocab=lm.vocab, seq_len=MOE_DT["seq"],
                        global_batch=MOE_DT["batch"])
    with RouteLog() as log:
        _, grads = make_grads_fn(bundle, MOE_DT["mb"], mesh41)(
            model, batch_at(data, 0))
    top_e = [M.gather_batch(e, mesh41) for e in log.top_e]
    moe = {}
    if rank == 0:
        want = torch.load(Path(work, "granite_ref.pt"), mmap=True)
        moe["grad_err_share"] = leaf_errors(
            zip([n for n, _ in named_leaves(model)], grads), want["grads"])
        diff = [(a.cpu() != b).any(dim=1) for a, b in zip(top_e,
                                                          want["top_e"])]
        moe["top_e_rows_differing"] = [int(x.sum()) for x in diff]
        moe["top_e_equal"] = not any(x.any() for x in diff)
        moe["differing_rows_max_margin"] = max(
            [float(m[x].max()) for m, x in zip(want["margin"], diff)
             if x.any()], default=0.0)
        moe["top_e_calls"] = len(top_e)
        del want
    del model, grads, log, top_e
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    moe["losses"], moe["step_ms"], _ = _train_cli(
        dt_lm_argv(MOE_DT["steps"]), lm)
    moe["launcher_s"] = time.perf_counter() - t0
    moe["launches"] = {fn.__name__: fn.launches for fn in ops.KERNELS
                       if fn.launches}
    moe["ref_losses"] = train_ref["granite_losses"]
    bf16 = dt_granite_cfg("bfloat16")
    ops.reset_launches()
    t0 = time.perf_counter()
    moe["int8_losses"], moe["int8_step_ms"], lines = _train_cli(
        dt_lm_argv(MOE_DT["steps"], ("--grad-compression", "int8_ef")),
        bf16)
    moe["int8_launcher_s"] = time.perf_counter() - t0
    moe["int8_launches"] = {fn.__name__: fn.launches for fn in ops.KERNELS
                            if fn.launches}
    moe["int8_lines"] = [ln for ln in lines if "microbatches" in ln
                         or ln.startswith("mesh:")]
    # The int8 wire: the int32 codes of every parameter and a scale a leaf.
    shapes = [p.shape for p in bundle.init(seed=0).parameters()]
    codes = [torch.zeros(s, dtype=torch.int8, device=dev) for s in shapes]
    scales = [torch.ones((), device=dev) for _ in shapes]
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    psum_int8(codes, scales, mesh41.data_group, mesh41.data)
    torch.cuda.synchronize()
    moe.update(int8_wire_bytes=sum(c.numel() * 4 + 4 for c in codes),
               int8_allreduce_ms=(time.perf_counter() - t0) * 1e3)
    del codes, scales
    torch.cuda.empty_cache()
    rec["moe"] = moe
    rec["train_s"] = time.perf_counter() - t_start
    return rec


def report_distributed_train(recs, spawn_s):
    """Holds the gloo ranks' training against the references and emits
    the phase's line; returns the launches over the ranks."""
    emit({"phase": "distributed_train", "world": len(recs),
          "backend": "gloo", "ranks_on_one_card": len(recs),
          "allreduce_note": GLOO_NOTE, "spawn_s_serve_and_train": spawn_s,
          "dlrm": {"mesh": dict(zip(("data", "model"), DIST_MESH)),
                   "rows_per_table": DT_ROWS, "B": DT_B,
                   "microbatches": DT_MB, "steps": DT_STEPS,
                   "ids": "[-2, R + 2)",
                   "arms": {"dlrm": "emb_rows=model",
                            "dlrm_all": "emb_rows=all",
                            "dlrm_fsdp_sharded": "sharding=fsdp, 1 step",
                            "dlrm_fsdp_dense": "sharding=fsdp, the dense "
                                               "lookup's ids, 1 step"}},
          "granite": {"mesh": {"data": len(recs), "model": 1},
                      "cuts": {"n_layers": [24, MOE_DT["n_layers"]],
                               "from": "train_4k S=4096 global_batch=256",
                               "S": [4096, MOE_DT["seq"]],
                               "global_batch": MOE_DT["batch"],
                               "microbatches": MOE_DT["mb"]},
                      "dtype": "fp32 (plain), bf16 (int8_ef)"},
          "ranks": [{"rank": r["rank"], "coords": r["coords"],
                     **r["train"]} for r in recs]})
    launches = {}
    for r in recs:
        t = r["train"]
        a, b = t["dlrm"], t["moe"]
        require(np.allclose(a["losses"], a["ref_losses"], rtol=DT_TOL_BF16,
                            atol=DT_TOL_BF16),
                f"rank {r['rank']} DLRM losses {a['losses']} vs "
                f"{a['ref_losses']}")
        worst = max(a["grad_err_share"].values())
        require(worst <= DT_TOL_BF16, f"rank {r['rank']} DLRM gradients: "
                f"{a['grad_err_share']}")
        require(a["launches"].get("gather_pool_shard") == DT_STEPS * DT_MB,
                f"rank {r['rank']} DLRM launches {a['launches']}")
        c = t["dlrm_all"]
        require(np.allclose(c["losses"], c["ref_losses"], rtol=DT_TOL_BF16,
                            atol=DT_TOL_BF16)
                and np.allclose(c["losses"], a["losses"], rtol=DT_TOL_BF16,
                                atol=DT_TOL_BF16),
                f"rank {r['rank']} DLRM emb_rows=all losses {c['losses']} "
                f"vs {c['ref_losses']} and {a['losses']}")
        require(c["launches"].get("gather_pool_shard") == DT_STEPS * DT_MB
                and 2 * c["table_bytes"] == c["model_arm_table_bytes"],
                f"rank {r['rank']} DLRM emb_rows=all: launches "
                f"{c['launches']}, {c['table_bytes']} table bytes")
        # The step's all-reduces: (a)'s hold the table gradient (fp32)
        # each step, (a')'s none of it; the rest (the loss, the MLPs, the
        # pooled partials over model) are the same bytes.
        require(a["traffic_steps"]["all_reduce"]["bytes"]
                - c["traffic_steps"]["all_reduce"]["bytes"]
                == DT_STEPS * c["model_arm_table_grad_fp32_bytes"],
                f"rank {r['rank']} DLRM all-reduce bytes "
                f"{a['traffic_steps']['all_reduce']} (model) vs "
                f"{c['traffic_steps']['all_reduce']} (all)")
        for lookup in ("sharded", "dense"):
            f = t[f"dlrm_fsdp_{lookup}"]
            require(np.allclose(f["losses"][0], f["ref_loss"],
                                rtol=DT_TOL_BF16, atol=DT_TOL_BF16)
                    and f["launches"].get("gather_pool_shard") == DT_MB
                    and f["spec"] == [None, ["data", "model"]],
                    f"rank {r['rank']} DLRM fsdp {lookup}: {f}")
            for k, v in f["launches"].items():
                launches[k] = launches.get(k, 0) + v
        require(np.allclose(b["losses"], b["ref_losses"], rtol=DT_TOL_FP32,
                            atol=DT_TOL_FP32),
                f"rank {r['rank']} granite losses {b['losses']} vs "
                f"{b['ref_losses']}")
        require(len(b["int8_losses"]) == MOE_DT["steps"]
                and all(np.isfinite(b["int8_losses"])),
                f"rank {r['rank']} int8_ef losses {b['int8_losses']}")
        n_fwd = MOE_DT["steps"] * MOE_DT["mb"] * MOE_DT["n_layers"]
        for key in ("launches", "int8_launches"):
            per = n_fwd if key == "launches" else n_fwd // MOE_DT["mb"]
            require(b[key].get("flash_attention") == per
                    and b[key].get("flash_attention_bwd") == per,
                    f"rank {r['rank']} granite {key} {b[key]}")
        for src in (a["launches"], c["launches"], b["launches"],
                    b["int8_launches"]):
            for k, v in src.items():
                launches[k] = launches.get(k, 0) + v
    b0 = recs[0]["train"]["moe"]
    require(max(b0["grad_err_share"].values()) <= DT_TOL_FP32,
            f"granite gradients over 4 ranks: {b0['grad_err_share']}")
    require(b0["top_e_equal"] or b0["differing_rows_max_margin"] <= 1e-5,
            f"granite's global top-K differs where the margin is "
            f"{b0['differing_rows_max_margin']}")
    require(any("does not apply" in ln for ln in b0["int8_lines"]),
            f"int8_ef: {b0['int8_lines']}")
    return launches


# ---------------------------------------------------------------------------
# Phase 6''': the LMs' parameters and AdamW state sharded over the mesh.
# ---------------------------------------------------------------------------

# qwen2.5-3b at full width (d 2,048, 16/2 heads of 128, ff 11,008, vocab
# 151,936, bf16, qkv bias), its depth cut from 36 to 2 layers: fsdp_tp on
# (2, 2), S = 2,048, a global batch of 8 in 2 microbatches (2 rows a data
# rank and microbatch), remat full, logits in chunks of 1,024, 2 steps.
ST = dict(arch="qwen2.5-3b", n_layers=2, seq=2048, batch=8, mb=2, steps=2,
          chunk=1024, mesh=(2, 2))
# fp32 parity at full width, 2 layers, S = 512, ST_PARITY_BATCH, the same
# steps:
# smollm-135m on (1, 4) (9 heads: each rank holds part of a head, so the
# attention is gathered; the tied head vocab parallel), granite-moe on
# (2, 2) (tensor-parallel experts; its 49,155-row vocab stays whole).
ST_PARITY = (("smollm-135m", (1, 4)), ("granite-moe-1b-a400m", (2, 2)))
ST_PARITY_SEQ = 512
# The parity runs' global batch (2 microbatches): 4, one row a data rank
# and microbatch on (2, 2) (cut from 8 to pay for ST_FIT_PARITY's arms).
ST_PARITY_BATCH = 4
# No warmup: both updates take the schedule's full rate, so the second
# step's loss and the parity runs' parameters after it see the update.
ST_LR = 1e-3
# qwen in bf16 against one rank: each step's loss within ST_TOL_LOSS
# (absolute; 5.8e-4 read after a step that moved it by 6.0) and its grad
# norm within ST_TOL_NORM of the reference's largest (4.8e-5 read).  The
# fp32 parity runs: losses and first-step gradients within ST_TOL_FP32
# (a gradient leaf's largest error as a share of its largest magnitude);
# the parameters after the last step within ST_TOL_UPDATE as the L2 norm
# of a shard's error over that of the reference's update there (a shard
# left without its update reads 1).  Their largest element error is
# reported, not held: Adam's first update is about lr * sign(g) an
# element, so an element whose gradient lies within the sum's rounding
# takes either sign, up to 1.3e-3 of granite's embed's largest magnitude.
ST_TOL_LOSS, ST_TOL_NORM, ST_TOL_FP32, ST_TOL_UPDATE = 2e-3, 5e-4, 1e-4, 5e-2
# World 1 over NCCL: qwen's cut at 2 sequences of 512 in 2 microbatches.
ST_NCCL_BATCH, ST_NCCL_SEQ = 2, 512
# The layers this script's arms compute tensor parallel beside qwen's
# (scripts/sharded_layers_ab.py's ARMS, run through its lm_arm): bf16 on
# (2, 2), falcon-mamba-7b at 2 of 64 layers (S 1,024 here, cut from the
# script's 2,048: ST_ARMS) and
# whisper-large-v3 at 2 + 2 of 32 + 32 (448 tokens over 8 clips of
# (1500, 1280) seeded frames).  Their fp32 parity against one rank, held
# tighter than ST_PARITY's: falcon on (1, 4) at S = 512 (the in_proj
# exchange over four ranks), whisper on (2, 2); losses within
# ST_TP_TOL_LOSS of their magnitude (falcon's second, after an update
# whose sign noise ST_TOL_UPDATE's note describes, read 3.2e-7 of it:
# 2.9e-6 absolute), first-step gradients within ST_TP_TOL_GRAD of each
# leaf's largest magnitude (whisper's vocab-parallel lm_head read
# 1.02e-5, granite's 8.7e-6 in the same code), the parameters by
# ST_TOL_UPDATE.
ST_ARMS = tuple((a, n, e, 1024 if a == "falcon-mamba-7b" else s)
                for a, n, e, s in ARMS)
ST_TP_PARITY = (("falcon-mamba-7b", (1, 4), ST_PARITY_SEQ),
                ("whisper-large-v3", (2, 2), 448))
ST_TP_TOL_LOSS, ST_TP_TOL_GRAD = 1e-6, 2e-5
ST_ALL_PARITY = tuple((a, m, ST_PARITY_SEQ) for a, m in ST_PARITY) \
    + ST_TP_PARITY
ST_KERNELS = ("flash_attention", "flash_attention_bwd", "selective_scan",
              "selective_scan_bwd")
# The sequence split under a gradient: qwen's cut (ST) trained under
# fsdp_seq inside activation_sharding(mesh, "fsdp_seq") on (2, 2), each
# rank its 2 rows a microbatch x 1,024 positions at offset 0 or 1,024
# (every leaf FSDP over both axes, whole in the compute), against the
# same one-rank reference as the fsdp_tp arm; and granite-moe's fp32
# parity (ST_PARITY's reference, S 512) under the split.  Row 8b at the
# split's costlier rank: no leaf is tensor parallel under fsdp_seq, so a
# rank holds every head: bf16 q (2, 1,024, 16, 128) at offset 1,024
# against k/v (2, 2,048, 2, 128) (B, Sq, Sk, H, K, hd, offset).
ST_SEQ_PARITY = ("granite-moe-1b-a400m", (2, 2), ST_PARITY_SEQ)
# The bf16 split's losses and grad norms are held as the fsdp_tp arm's
# (ST_TOL_LOSS, ST_TOL_NORM): its norms read 1.55e-5 and 1.24e-4 of one
# rank's since the embedding's gradient sums in fp32 (1.8% when the
# lookup's scatter-add summed a microbatch's repeated ids in bf16, whose
# sum over a rank's 2,048 tokens stagnated less than the reference's over
# 8,192).
# Shapes an axis does not divide, granite-moe in fp32 on (2, 2) under
# fsdp_seq inside its scope against one rank, at ST_PARITY's tolerances:
# (key, S, global batch, moe_local_dispatch).  "fit": S 511, which model
# 2 does not divide (the step is not split), and 2 rows in 2 microbatches
# (a microbatch of one row, replicated over data).  "local":
# moe_local_dispatch under the split, 4 rows in 2 microbatches (one row a
# data rank and microbatch): two dispatch shards, each a data rank's row
# gathered over model; the one-rank reference dispatches the same two
# shards in a scope on a (2, 1) stand-in mesh without groups.
ST_FIT_PARITY = (("fit", 511, 2, False), ("local", 512, 4, True))
ST_OFFSET_BWD = (2, 1024, 2048, 16, 2, 128, 1024)
ST_OFFSET_LAYOUT = "qwen_rank_2x2_fsdp_seq_offset_1024"
# The scan's and the attention's kernels at the ranks' layouts: a rank's
# microbatch of 2 rows; falcon's Di 8,192 over model 2 at S 2,048 (the
# script's arm's S);
# hymba-1.5b's 3,200 over 2 and 4 (800 channels: not a whole number of
# the kernels' 64-channel blocks), S cut to 512 (these two check the
# channel counts; the plain versions' seconds grow with S); whisper's
# 20/20 heads over 2, its encoder (unmasked) and decoder (causal).
ST_SCAN_SHAPES = (("falcon_rank_model2", 2, 2048, 4096, 16, "bf16"),
                  ("hymba_rank_model2", 2, 512, 1600, 16, "bf16"),
                  ("hymba_rank_model4", 2, 512, 800, 16, "bf16"))
ST_WHISPER_ENC = (2, 1500, 10, 10, 64)
ST_WHISPER_DEC = (2, 448, 10, 10, 64)


def accounted(cfg, kind, seq, batch, run, mesh, microbatches=1, **kw):
    """``(the accountant's collectives of this rank's step of ``kind``
    on the meta device over a virtual mesh of ``mesh``'s shape (the cuts'
    2 layers and 2 microbatches traced whole), its seconds)``
    (``repro_torch.launch.accounting``)."""
    t0 = time.perf_counter()
    acc = A.account(cfg, ShapeConfig("smoke", kind, seq, batch), run,
                    mesh.shape, microbatches, rank=mesh.rank, **kw)
    return acc["collectives"], time.perf_counter() - t0


def collectives_check(recorded, parts, seconds):
    """The step's recorded collectives against the sum of the
    accountant's ``parts`` (``(collectives, times)`` pairs): equal, key by
    key (calls and result bytes of each kind)."""
    want = {k: sum(p[k] * n for p, n in parts) for k in recorded}
    return {"equal": recorded == want, "recorded": recorded,
            "accountant": want, "accountant_s": round(seconds, 2)}


def st_cfg(arch, dtype=None):
    cfg = dataclasses.replace(get_config(arch), n_layers=ST["n_layers"])
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    return cfg


def st_trainer(cfg, seq, mesh=None, dev="cuda", batch=None,
               sharding="fsdp_tp", **run_kw):
    """``(bundle, model, opt, step, batch(s))``: ``cfg`` from seed 0
    through ``build(..., mesh=)`` (this rank's shards of ``sharding``'s
    layout on a mesh with groups), AdamW over its leaves, the step of
    ``ST["mb"]`` microbatches, step s's global batch (``arm_batch``:
    whisper's with seeded frames)."""
    run = RunConfig(remat="full", logits_chunk=ST["chunk"],
                    sharding=sharding, **run_kw)
    bundle = build(cfg, device=dev, run=run, mesh=mesh)
    model = bundle.init(seed=0)
    opt = init_opt(OptConfig(lr=ST_LR, warmup_steps=0,
                             total_steps=ST["steps"]),
                   list(model.parameters()))
    return (bundle, model, opt, make_train_step(bundle, ST["mb"], mesh),
            lambda s: arm_batch(cfg, seq, batch or ST["batch"], s, dev))


def st_attention_kernels(timer, shape=(2, ST["seq"], 8, 1, 128),
                         layout="qwen2.5-3b per rank on (2, 2): 8/1 of "
                                "16/2 heads"):
    """Rows 8 and 8b (causal) at a rank's layout, by default
    qwen2.5-3b's on (2, 2): each rank's 2 sequences of 2,048 a
    microbatch, its 8 query heads and 1 kv head of 128, bf16; each
    against its plain version, timed beside its bound and SDPA's forward
    or backward."""
    b, s, h, n_kv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(30)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (h, n_kv, n_kv, h))
    got = fa.flash_attention(q, k, v)
    want = ref.causal_attention_ref(q, k, v)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse)
    wants = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    fwd_err = float((got.float() - want.float()).abs().max())
    require(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
            f"flash_attention at the sharded layout: max abs err {fwd_err}")
    shares = {n: float((a.float() - w.float()).abs().max()
                       / w.float().abs().max())
              for n, a, w in zip(("dq", "dk", "dv"), grads, wants)}
    require(max(shares.values()) <= 2e-2,
            f"flash_attention_bwd at the sharded layout: {shares}")
    del got, want, grads, wants
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    shape = {"B": b, "S": s, "H": h, "K": n_kv, "hd": hd, "dtype": "bf16",
             "causal": True, "layout": layout}
    fwd = {**shape, "max_abs_err": fwd_err,
           "ms": timer(lambda: fa.flash_attention(q, k, v)),
           "plain_ms": timer(lambda: ref.causal_attention_ref(q, k, v)),
           "library_ms": timer(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt.detach(), kt.detach(), vt.detach(), is_causal=True,
                   enable_gqa=True))}
    work = W.flash_attention(b, s, s, h, n_kv, hd, q.element_size())
    fwd["bound_ms"], fwd["bound_by"] = work_bound(work)
    achieved(fwd, work.ops)
    bwd = {**shape, "max_abs_err_share_of_largest_grad": shares,
           "ms": timer(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse)),
           "plain_ms": timer(lambda: ref.flash_attention_bwd_ref(
               q, k, v, o, do, lse)),
           "library_ms": timer(lambda: torch.autograd.grad(
               out, (qt, kt, vt), dot, retain_graph=True))}
    work = W.flash_attention_bwd(b, s, s, h, n_kv, hd, q.element_size())
    bwd["bound_ms"], bwd["bound_by"] = work_bound(work)
    achieved(bwd, work.ops)
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    return fwd, bwd


def st_offset_bwd(timer):
    """Row 8b at a query offset (``ST_OFFSET_BWD``: the fsdp_seq arm's
    costlier model rank, bf16): against its plain version at the offset,
    timed beside its bound (the five products over the visible (query,
    key) pairs), the plain version and SDPA's backward with the offset's
    causal mask (its kv heads expanded to H before the timed call: the
    mask takes the memory-efficient backend, which takes no GQA); and
    the split's two ranks' dk/dv summed and dq rows stacked against the
    whole call's."""
    b, sq, sk, h, n_kv, hd, off = ST_OFFSET_BWD
    g = torch.Generator(device="cuda").manual_seed(33)
    q, k, v, do = (torch.randn((b, n_s, n, hd), generator=g, device="cuda")
                   .to(torch.bfloat16)
                   for n_s, n in ((sq, h), (sk, n_kv), (sk, n_kv), (sq, h)))
    o, lse = fa.flash_attention(q, k, v, with_lse=True, q_offset=off)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse, q_offset=off)
    wants = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, 0, True, off)
    torch.cuda.synchronize()
    errs = [float((a.float() - w.float()).abs().max())
            for a, w in zip(grads, wants)]
    shares = {n: e / float(w.float().abs().max())
              for n, e, w in zip(("dq", "dk", "dv"), errs, wants)}
    require(max(shares.values()) <= 2e-2,
            f"flash_attention_bwd at offset {off}: {shares}")
    keys_unseen = max(float(t[:, off + sq:].float().abs().max())
                      if off + sq < sk else 0.0 for t in grads[1:])
    del wants
    # The split of the whole sequence (queries 0 .. sk - 1) over 2 ranks:
    # rank 1's call above and rank 0's at offset 0, against one call.
    q0, do0 = (torch.randn((b, off, h, hd), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(2))
    qw, dow = torch.cat([q0, q], 1), torch.cat([do0, do], 1)
    ow, lsew = fa.flash_attention(qw, k, v, with_lse=True)
    whole = fa.flash_attention_bwd(qw, k, v, ow, dow, lsew)
    part0 = fa.flash_attention_bwd(
        q0, k, v, ow[:, :off].contiguous(), do0, lsew[:, :, :off]
        .contiguous(), q_offset=0)
    part1 = fa.flash_attention_bwd(
        q, k, v, ow[:, off:].contiguous(), do, lsew[:, :, off:]
        .contiguous(), q_offset=off)
    split = (torch.cat([part0[0], part1[0]], 1),
             part0[1].float() + part1[1].float(),
             part0[2].float() + part1[2].float())
    split_shares = {n: float((a.float() - w.float()).abs().max()
                             / w.float().abs().max())
                    for n, a, w in zip(("dq", "dk", "dv"), split, whole)}
    require(max(split_shares.values()) <= 2e-2
            and torch.equal(split[0], whole[0]),
            f"flash_attention_bwd's split over 2 ranks vs the whole call: "
            f"{split_shares}")
    del qw, dow, ow, lsew, whole, part0, part1, split, q0, do0
    rep_h = h // n_kv
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.repeat_interleave(rep_h, dim=2).transpose(1, 2)
              .contiguous().requires_grad_() for t in (k, v))
    mask = (torch.arange(sk, device="cuda")[None, :]
            <= torch.arange(off, off + sq, device="cuda")[:, None])
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2).contiguous()
    pairs = W.visible_pairs(sq, sk, q_offset=off)  # (query, key) pairs
    work = W.flash_attention_bwd(b, sq, sk, h, n_kv, hd, q.element_size(),
                                 q_offset=off)
    rec = {"B": b, "Sq": sq, "Sk": sk, "q_offset": off, "H": h, "K": n_kv,
           "hd": hd, "dtype": "bf16", "causal": True,
           "layout": "qwen2.5-3b's model rank 1 of (2, 2) under fsdp_seq: "
                     "all 16/2 heads, positions 1,024 .. 2,047",
           "visible_pairs_per_head": pairs,
           "max_abs_err": max(errs),
           "max_abs_err_share_of_largest_grad": shares,
           "unseen_keys_max_abs_grad": keys_unseen,
           "split_vs_whole_share_of_largest_grad": split_shares,
           "split_dq_bit_equal": True,
           "ms": timer(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                      q_offset=off)),
           "plain_ms": timer(lambda: ref.flash_attention_bwd_ref(
               q, k, v, o, do, lse, 0, True, off)),
           "library_ms": timer(lambda: torch.autograd.grad(
               out, (qt, kt, vt), dot, retain_graph=True)),
           "library": "scaled_dot_product_attention backward, bool "
                      "attn_mask of the offset, kv heads expanded"}
    rec["bound_ms"], rec["bound_by"] = work_bound(work)
    achieved(rec, work.ops)
    del q, k, v, do, o, lse, grads, qt, kt, vt, out, dot, mask
    torch.cuda.empty_cache()
    return rec


def tp_cfg(arch, dtype=None):
    """``arch`` at the depth this phase trains it: qwen's and the parity
    runs' ``ST["n_layers"]``, whisper's 2 + 2."""
    for a, n_layers, n_enc, _ in ARMS:
        if a == arch:
            return arm_cfg(a, n_layers, n_enc, dtype or "bfloat16")
    return st_cfg(arch, dtype)


def st_layer_kernels(timer, ptxas):
    """The kernels of the sharded arms at their ranks' layouts:
    ``ST_SCAN_SHAPES`` through ``selective_scan`` and its backward,
    whisper's heads through the unmasked and the causal attention and
    their backwards, qwen's through the causal ones.  Returns ``{kernel:
    {layout: record}}``."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_max_mhz()
    plain_timer = Timer(reps=2)
    out = {k: {} for k in ST_KERNELS}
    for name, b, s, di, n, dt_name in ST_SCAN_SHAPES:
        out["selective_scan"][name] = scan_rec(
            timer, plain_timer, name, b, s, di, n, dt_name, ptxas, n_sm, mhz)
        out["selective_scan_bwd"][name] = scan_bwd_rec(
            timer, name, b, s, di, n, dt_name, ptxas, n_sm, mhz)
    for name, shape, layout in (
            ("qwen_rank_2x2", (2, ST["seq"], 8, 1, 128),
             "qwen2.5-3b per rank on (2, 2): 8/1 of 16/2 heads"),
            ("whisper_decoder_rank_2x2", ST_WHISPER_DEC,
             "whisper-large-v3's decoder per rank on (2, 2): 10/10 of "
             "20/20 heads")):
        fwd, bwd = st_attention_kernels(timer, shape, layout)
        out["flash_attention"][name] = fwd
        out["flash_attention_bwd"][name] = bwd
    out["flash_attention"]["whisper_encoder_rank_2x2"] = _noncausal_fwd(
        timer, ST_WHISPER_ENC, "bf16", "whisper_encoder_rank_2x2")
    out["flash_attention_bwd"]["whisper_encoder_rank_2x2"] = _noncausal_bwd(
        timer, ST_WHISPER_ENC, "bf16", "whisper_encoder_rank_2x2")
    out["flash_attention_bwd"][ST_OFFSET_LAYOUT] = st_offset_bwd(timer)
    return out


# The accountant's peak of the (1, 1) step's own allocations over the
# card's (max_memory_allocated above what the step found allocated).
ACC_PEAK_RATIO = (0.8, 1.25)


def nccl_step_vs_accountant(cfg, run, mesh, peak_bytes, step_s, warm_s,
                            recorded):
    """The (1, 1) step on the card against the accountant's trace of it on
    the meta device (``repro_torch.launch.accounting``): its predicted
    peak of the step's own allocations over the card's, its collectives
    against the recorded ones, and its ``dot_flops`` over the host
    seconds of the bundle's second step (``warm_step_s``: achieved
    TFLOP/s; ``step_s``, the first step's, includes first-call costs)."""
    t0 = time.perf_counter()
    acc = A.account(cfg, ShapeConfig("nccl", "train", ST_NCCL_SEQ,
                                     ST_NCCL_BATCH), run, mesh.shape,
                    ST["mb"], rank=mesh.rank)
    predicted = acc["memory_analysis"]["peak_new_bytes"]
    return {"predicted_peak_new_bytes": predicted,
            "measured_peak_new_bytes": int(peak_bytes),
            "ratio": predicted / max(peak_bytes, 1),
            "ratio_bounds": list(ACC_PEAK_RATIO),
            "collectives_equal": acc["collectives"] == recorded,
            "dot_flops": acc["cost"]["dot_flops"], "step_s": step_s,
            "warm_step_s": warm_s,
            "achieved_tflops": acc["cost"]["dot_flops"] / warm_s / 1e12,
            "accountant_s": round(time.perf_counter() - t0, 2)}


def phase_sharded_train_nccl(work, timer, ptxas):
    """World 1 over NCCL in this process: qwen2.5-3b's cut through
    ``build(..., mesh=)`` on a (1, 1) mesh under ``fsdp_tp`` (its
    gathers, reduce-scatters, tensor-parallel and vocab-parallel
    collectives all run, over one rank) gives the step without a mesh
    bit for bit: loss, grad norm and every parameter after it.  Then,
    outside any process group, the references of the four ranks: qwen's
    bf16 losses and gradient norms on one rank, and the fp32 losses,
    first-step gradients and last parameters of smollm-135m, granite-moe,
    falcon-mamba-7b and whisper-large-v3 (saved to ``work``); then the
    attention's and the scan's kernels at the ranks' layouts
    (:func:`st_layer_kernels`; ``ptxas`` the build's report).  Returns
    ``(the references, the kernels' records by layout, the launches of
    ``ST_KERNELS`` in the (1, 1) step)``."""
    t0 = time.perf_counter()
    cfg = st_cfg(ST["arch"])
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_sharded_")
    launches = {}
    try:
        M.init_distributed("nccl", f"file://{store}/store", 0, 1,
                           device="cuda:0", timeout=120)
        mesh = M.make_host_mesh()
        out = []
        for m in (mesh, None):
            bundle, model, opt, step, data = st_trainer(
                cfg, ST_NCCL_SEQ, m, batch=ST_NCCL_BATCH)
            batch = data(0)
            C.reset_traffic()
            C.reset_record()
            ops.reset_launches()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t_step = time.perf_counter()
            metrics = step(model, opt, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t_step
            traffic = copy.deepcopy(C.TRAFFIC)
            params = [p.detach().clone() for p in model.parameters()]
            if m is not None:
                launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
                peak, recorded = (torch.cuda.max_memory_allocated() - base,
                                  C.collective_stats())
                t_step = time.perf_counter()
                step(model, opt, data(1))
                torch.cuda.synchronize()
                memory = nccl_step_vs_accountant(
                    cfg, bundle.run, mesh, peak, step_s,
                    time.perf_counter() - t_step, recorded)
            out.append((metrics, params, traffic,
                        sum(M.placement(p) is not None
                            for p in model.parameters())))
            del model, opt, step
            torch.cuda.empty_cache()
    finally:
        M.close_distributed()
        shutil.rmtree(store, ignore_errors=True)
    (m1, p1, traffic, tagged), (m0, p0, _, _) = out
    require(tagged == len(p1) and traffic["all_gather"]["calls"] > 0
            and traffic["reduce_scatter"]["calls"] > 0,
            f"nccl world 1 sharded: {tagged} placements, traffic {traffic}")
    require(torch.equal(m1["loss"], m0["loss"])
            and torch.equal(m1["grad_norm"], m0["grad_norm"]),
            f"nccl world 1 sharded: loss {float(m1['loss'])} vs "
            f"{float(m0['loss'])}, norm {float(m1['grad_norm'])} vs "
            f"{float(m0['grad_norm'])}")
    differ = sum(not torch.equal(a, b) for a, b in zip(p1, p0))
    require(differ == 0, f"nccl world 1 sharded: {differ} parameters differ")
    require(ACC_PEAK_RATIO[0] <= memory["ratio"] <= ACC_PEAK_RATIO[1]
            and memory["collectives_equal"],
            f"nccl world 1 sharded: the accountant's step against the "
            f"card's: {memory}")
    del out, p0, p1
    torch.cuda.empty_cache()
    emit({"phase": "sharded_train", "world": 1, "backend": "nccl",
          "mesh": mesh.shape, "sharding": "fsdp_tp", "arch": ST["arch"],
          "n_layers": ST["n_layers"], "S": ST_NCCL_SEQ, "B": ST_NCCL_BATCH,
          "loss_bit_equal_without_mesh": True,
          "grad_norm_bit_equal_without_mesh": True,
          "params_bit_equal_without_mesh": True, "traffic": traffic,
          "accountant": memory,
          "launches": {k: v for k, v in launches.items() if v},
          "seconds": round(time.perf_counter() - t0, 1)})

    # The references, one rank holding every leaf.
    t0 = time.perf_counter()
    ref_rec = {}
    _, model, opt, step, data = st_trainer(cfg, ST["seq"])
    ref_rec["qwen_losses"], ref_rec["qwen_grad_norms"] = [], []
    for s in range(ST["steps"]):
        metrics = step(model, opt, data(s))
        ref_rec["qwen_losses"].append(float(metrics["loss"]))
        ref_rec["qwen_grad_norms"].append(float(metrics["grad_norm"]))
    del model, opt, step
    torch.cuda.empty_cache()
    for arch, _, seq in ST_ALL_PARITY:
        pcfg = tp_cfg(arch, "float32")
        bundle, model, opt, step, data = st_trainer(pcfg, seq,
                                                    batch=ST_PARITY_BATCH)
        ref_rec[arch] = st_parity_steps(bundle, model, opt, step, data, None,
                                        Path(work, f"sharded_{arch}"))
        del model, opt, step, bundle
        torch.cuda.empty_cache()
    arch = ST_SEQ_PARITY[0]
    for key, seq, batch, local in ST_FIT_PARITY:
        bundle, model, opt, step, data = st_trainer(
            tp_cfg(arch, "float32"), seq, batch=batch,
            moe_local_dispatch=local)
        # The local dispatch's two shards on one rank: a scope on a (2, 1)
        # stand-in mesh (no groups) whose rows lie on no axis.
        with (M.activation_sharding(M.Mesh(2, 1, 0), "fsdp_seq", rows=())
              if local else contextlib.nullcontext()):
            ref_rec[f"{arch}_{key}"] = st_parity_steps(
                bundle, model, opt, step, data, None,
                Path(work, f"sharded_{arch}_{key}"))
        del model, opt, step, bundle
        torch.cuda.empty_cache()
    ref_rec["reference_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    layouts = st_layer_kernels(timer, ptxas)
    ref_rec["kernels_s"] = round(time.perf_counter() - t0, 1)
    return ref_rec, layouts, {k: launches.get(k, 0) for k in ST_KERNELS}


def _leaf_errors(tensors, named, path, mesh, start=None):
    """Each leaf's error against the whole leaves saved at ``path`` (this
    rank's shard of each): its largest as a share of the saved leaf's
    largest magnitude, and with ``start`` (the shards before the steps)
    also its L2 norm as a share of that of the saved leaf's update over
    the shard.  Returns ``{name: share}`` (and ``{name: update share}``
    with ``start``)."""
    want = torch.load(path, mmap=True)
    errs, upd = {}, {}
    for i, ((n, p), t) in enumerate(zip(named, tensors)):
        w = SP.shard_of(want[n], M.placement(p).spec, mesh).to(t.device)
        errs[n] = float((t - w).abs().max()
                        / want[n].abs().max().clamp_min(1e-30))
        if start is not None:
            upd[n] = float(torch.linalg.vector_norm(t - w)
                           / torch.linalg.vector_norm(w - start[i])
                           .clamp_min(1e-30))
    return errs if start is None else (errs, upd)


def st_parity_steps(bundle, model, opt, step, data, mesh, path):
    """The parity runs' two steps, the first as ``make_train_step`` runs
    it (``make_grads_fn``, then AdamW) with its gradients kept.  The
    reference (``mesh`` None) saves the first step's gradients and the
    parameters after the last step to ``path`` + ``_grads.pt`` /
    ``_params.pt``; a rank measures its shards against them
    (:func:`_leaf_errors`, the parameters also against the update from
    its shards at the start).  Returns the losses, and on a rank
    ``(losses, gradient errors, parameter errors, parameter errors over
    the update)``."""
    named = list(named_leaves(model))
    start = None if mesh is None else [p.detach().clone() for _, p in named]
    loss, grads = make_grads_fn(bundle, ST["mb"], mesh)(model, data(0))
    if mesh is None:
        torch.save({n: g.cpu() for (n, _), g in zip(named, grads)},
                   f"{path}_grads.pt")
    else:
        grad_errs = _leaf_errors(grads, named, f"{path}_grads.pt", mesh)
    opt.apply(grads)
    del grads
    losses = [float(loss)] + [float(step(model, opt, data(s))["loss"])
                              for s in range(1, ST["steps"])]
    params = [p.detach() for _, p in named]
    if mesh is None:
        torch.save({n: p.cpu() for (n, _), p in zip(named, params)},
                   f"{path}_params.pt")
        return losses
    return (losses, grad_errs) + _leaf_errors(
        params, named, f"{path}_params.pt", mesh, start)


def _state_bytes(model, opt) -> int:
    """This rank's bytes of parameters and AdamW moments."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    for st in opt.state.values():
        n += sum(t.numel() * t.element_size() for t in st.values())
    return n


def _layer_collectives(model, mesh):
    """Layer 0's gathers over data (its leaves as the forward gathers
    them) and the reduce-scatters of their gradients, timed on their
    own: ``(all-gather bytes, ms, reduce-scatter bytes, ms)``."""
    blk = model.blocks[0]
    keep = {"attn": True, "mlp": True}
    leaves = [(p, keep.get(n.split(".")[0], False))
              for n, p in blk.named_parameters()]
    with torch.no_grad():
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        full = [C.gather_leaf(p, k) for p, k in leaves]
        torch.cuda.synchronize()
        ag_ms = (time.perf_counter() - t0) * 1e3
        dims = [M.placement(p).spec.index("data")
                if "data" in M.placement(p).spec else None for p, _ in leaves]
        dist.barrier()
        t0 = time.perf_counter()
        for f, d in zip(full, dims):
            if d is not None:
                C.reduce_scatter(f, mesh.data_group, d, mesh.data)
        torch.cuda.synchronize()
        rs_ms = (time.perf_counter() - t0) * 1e3
    nbytes = [f.numel() * f.element_size() for f in full]
    return (sum(nbytes), ag_ms,
            sum(b for b, d in zip(nbytes, dims) if d is not None), rs_ms)


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in ops.KERNELS if fn.launches}


def st_seq_arm(cfg, mesh, dev, ref_rec):
    """qwen's cut trained under fsdp_seq inside its scope
    (``activation_sharding(mesh, "fsdp_seq")``): each rank its 1,024
    positions at offset ``1,024 m`` of its data rank's rows, K/V gathered
    over ``model`` each layer.  Its bytes of parameters and moments, peak
    memory, step times, the steps' collective traffic and launches, and
    the losses and grad norms against the one-rank reference."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle, model, opt, step, data = st_trainer(cfg, ST["seq"], mesh, dev,
                                                sharding="fsdp_seq")
    held = _state_bytes(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.reset_traffic()
    ops.reset_launches()
    losses, norms, step_ms = [], [], []
    with M.activation_sharding(mesh, "fsdp_seq"):
        for s in range(ST["steps"]):
            dist.barrier()
            t1 = time.perf_counter()
            metrics = step(model, opt, data(s))
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            norms.append(float(metrics["grad_norm"]))
    out = {"coords": [mesh.data_rank, mesh.model_rank],
           "positions": [mesh.model_rank * ST["seq"] // mesh.model,
                         (mesh.model_rank + 1) * ST["seq"] // mesh.model],
           "param_and_adamw_bytes": held,
           "peak_gb_steps": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "losses": losses, "ref_losses": ref_rec["qwen_losses"],
           "grad_norms": norms, "ref_grad_norms": ref_rec["qwen_grad_norms"],
           "step_ms": step_ms, "traffic_two_steps": copy.deepcopy(C.TRAFFIC),
           "launches": _launches(), "seconds": time.perf_counter() - t0}
    del model, opt, step, bundle
    torch.cuda.empty_cache()
    return out


def st_seq_parity(work, dev, ref_rec, key=None, seq=ST_SEQ_PARITY[2],
                  batch=ST_PARITY_BATCH, local=False):
    """``ST_SEQ_PARITY``'s arch in fp32 under fsdp_seq inside its scope,
    against ``ST_PARITY``'s one-rank reference of it (saved in ``work``),
    or with ``key`` against ``ST_FIT_PARITY``'s at its S, global batch
    and dispatch: the first step's gradient shards, the parameter shards
    after the second and both losses."""
    arch, shape, _ = ST_SEQ_PARITY
    ref = arch if key is None else f"{arch}_{key}"
    mesh = M.make_mesh(*shape)
    t0 = time.perf_counter()
    bundle, model, opt, step, data = st_trainer(
        tp_cfg(arch, "float32"), seq, mesh, dev, batch=batch,
        sharding="fsdp_seq", moe_local_dispatch=local)
    ops.reset_launches()
    with M.activation_sharding(mesh, "fsdp_seq"):
        losses, errs, perrs, uerrs = st_parity_steps(
            bundle, model, opt, step, data, mesh,
            Path(work, f"sharded_{ref}"))
    worst, pworst = max(errs, key=errs.get), max(perrs, key=perrs.get)
    uworst = max(uerrs, key=uerrs.get)
    out = {"mesh": dict(zip(("data", "model"), shape)), "S": seq,
           "global_batch": batch,
           "moe_local_dispatch": local, "split": seq % shape[1] == 0,
           "sharding": "fsdp_seq", "losses": losses,
           "ref_losses": ref_rec[ref], "grad_err_share_max": errs[worst],
           "grad_err_worst_leaf": worst,
           "param_err_share_max": perrs[pworst],
           "param_err_worst_leaf": pworst,
           "param_err_of_update_max": uerrs[uworst],
           "param_err_of_update_worst_leaf": uworst,
           "launches": _launches(), "seconds": time.perf_counter() - t0}
    del model, opt, step, bundle
    torch.cuda.empty_cache()
    return out


def sharded_train_rank(rank, work, dev, ref_rec):
    """The gloo rank's sharded training, after its distributed training:
    qwen2.5-3b's cut on (2, 2) under fsdp_tp in bf16 (its bytes of
    parameters and moments against ``shard_bytes`` and the dp layout's,
    its peak memory, step times, the steps' collective traffic and layer
    0's gathers and reduce-scatters timed, the losses and gradient norms
    against one rank's), then smollm-135m on (1, 4) and granite-moe on
    (2, 2) in fp32 (the first step's gradient shards, the parameter shards
    after the second and both losses against one rank's); then the arms
    whose layers compute tensor parallel, falcon-mamba-7b and
    whisper-large-v3 in bf16 on (2, 2) (``lm_arm``), and their fp32 parity
    (``ST_TP_PARITY``); qwen's cut under fsdp_seq with the sequence split
    (:func:`st_seq_arm`) after its fsdp_tp run, and granite's fp32 parity
    under the split (:func:`st_seq_parity`) last.  Returns the rank's
    record."""
    t_start = time.perf_counter()
    rec = {}
    cfg = st_cfg(ST["arch"])
    mesh = M.make_mesh(*ST["mesh"])
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle, model, opt, step, data = st_trainer(cfg, ST["seq"], mesh, dev)
    struct = bundle.param_struct()
    specs = SP.param_specs(struct, mesh)
    dp_specs = SP.param_specs(struct, mesh, "dp")
    held = _state_bytes(model, opt)
    rule = SP.shard_bytes(struct, specs, mesh) \
        + 2 * SP.shard_bytes(struct, specs, mesh, itemsize=4)
    dp = SP.shard_bytes(struct, dp_specs, mesh) \
        + 2 * SP.shard_bytes(struct, dp_specs, mesh, itemsize=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.reset_traffic()
    C.reset_record()
    ops.reset_launches()
    losses, norms, step_ms = [], [], []
    for s in range(ST["steps"]):
        dist.barrier()
        t0 = time.perf_counter()
        metrics = step(model, opt, data(s))
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    traffic = copy.deepcopy(C.TRAFFIC)
    recorded = C.collective_stats()
    want, acc_s = accounted(cfg, "train", ST["seq"], ST["batch"],
                            bundle.run, mesh, ST["mb"])
    accountant = collectives_check(recorded, [(want, ST["steps"])], acc_s)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    ag_bytes, ag_ms, rs_bytes, rs_ms = _layer_collectives(model, mesh)
    rec["qwen"] = {
        "coords": [mesh.data_rank, mesh.model_rank],
        "param_and_adamw_bytes": held, "shard_bytes_rule": rule,
        "dp_layout_bytes": dp, "share_of_dp": held / dp,
        "peak_gb_steps": (torch.cuda.max_memory_allocated() - base) / 1e9,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "ref_losses": ref_rec["qwen_losses"],
        "grad_norms": norms, "ref_grad_norms": ref_rec["qwen_grad_norms"],
        "step_ms": step_ms, "traffic_two_steps": traffic,
        "layer0_allgather_bytes": ag_bytes, "layer0_allgather_ms": ag_ms,
        "layer0_reduce_scatter_bytes": rs_bytes,
        "layer0_reduce_scatter_ms": rs_ms, "launches": launches,
        "collectives_vs_accountant": accountant,
        "seconds": time.perf_counter() - t_start}
    del model, opt, step, bundle
    torch.cuda.empty_cache()
    rec["qwen_fsdp_seq"] = st_seq_arm(cfg, mesh, dev, ref_rec)
    # The SSM's and whisper's layers tensor parallel, bf16 on (2, 2).
    for arch, n_layers, n_enc, seq in ST_ARMS:
        ops.reset_launches()
        rec[arch] = lm_arm(arm_cfg(arch, n_layers, n_enc), mesh, dev, seq)
        rec[arch]["launches"] = {fn.__name__: fn.launches
                                 for fn in ops.KERNELS if fn.launches}
    for arch, shape, seq in ST_ALL_PARITY:
        pcfg = tp_cfg(arch, "float32")
        mesh = M.make_mesh(*shape)
        t0 = time.perf_counter()
        bundle, model, opt, step, data = st_trainer(
            pcfg, seq, mesh, dev, batch=ST_PARITY_BATCH)
        ops.reset_launches()
        losses, errs, perrs, uerrs = st_parity_steps(
            bundle, model, opt, step, data, mesh, Path(work, f"sharded_{arch}"))
        worst, pworst = max(errs, key=errs.get), max(perrs, key=perrs.get)
        uworst = max(uerrs, key=uerrs.get)
        rec[f"{arch}_fp32"] = {
            "mesh": dict(zip(("data", "model"), shape)), "S": seq,
            "losses": losses, "ref_losses": ref_rec[arch],
            "grad_err_share_max": errs[worst], "grad_err_worst_leaf": worst,
            "param_err_share_max": perrs[pworst],
            "param_err_worst_leaf": pworst,
            "param_err_of_update_max": uerrs[uworst],
            "param_err_of_update_worst_leaf": uworst,
            "attention": ("none" if not pcfg.n_heads else "tensor parallel"
                          if pcfg.n_heads % shape[1] == 0
                          and pcfg.kv_heads % shape[1] == 0 else "gathered"),
            "mamba": ("none" if not pcfg.ssm_state else "channel parallel"
                      if pcfg.inner % shape[1] == 0 else "gathered"),
            "vocab_parallel": pcfg.vocab % shape[1] == 0,
            "launches": {fn.__name__: fn.launches for fn in ops.KERNELS
                         if fn.launches},
            "seconds": time.perf_counter() - t0}
        del model, opt, step, bundle
        torch.cuda.empty_cache()
    rec[f"{ST_SEQ_PARITY[0]}_fsdp_seq_fp32"] = st_seq_parity(work, dev,
                                                            ref_rec)
    for key, seq, batch, local in ST_FIT_PARITY:
        rec[f"{ST_SEQ_PARITY[0]}_{key}_fp32"] = st_seq_parity(
            work, dev, ref_rec, key, seq, batch, local)
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def report_sharded_train(recs, nccl_launches):
    """Holds the gloo ranks' sharded training against the references and
    emits the phase's line; returns the launches of ``ST_KERNELS`` over
    the ranks and the world-1 run."""
    ranks = [r["sharded"] for r in recs]
    emit({"phase": "sharded_train", "world": len(recs), "backend": "gloo",
          "ranks_on_one_card": len(recs), "collective_note": GLOO_NOTE,
          "qwen": {"arch": ST["arch"], "mesh": dict(zip(
              ("data", "model"), ST["mesh"])), "sharding": "fsdp_tp",
              "cuts": {"n_layers": [36, ST["n_layers"]]},
              "S": ST["seq"], "global_batch": ST["batch"],
              "microbatches": ST["mb"], "steps": ST["steps"],
              "remat": "full", "logits_chunk": ST["chunk"],
              "dtype": "bf16"},
          "tp_arms": {"archs": [{"arch": a, "n_layers": n, "n_enc_layers": e,
                                 "S": s} for a, n, e, s in ST_ARMS],
                      "mesh": dict(zip(("data", "model"), ST["mesh"])),
                      "sharding": "fsdp_tp", "global_batch": ST["batch"],
                      "microbatches": ST["mb"], "steps": ST["steps"],
                      "remat": "full", "dtype": "bf16"},
          "parity": {"S": ST_PARITY_SEQ, "global_batch": ST_PARITY_BATCH,
                     "dtype": "fp32",
                     "n_layers": ST["n_layers"], "tol": ST_TOL_FP32,
                     "tp_runs": [list(p) for p in ST_TP_PARITY],
                     "tp_tol": {"loss_share": ST_TP_TOL_LOSS,
                                "grad": ST_TP_TOL_GRAD}},
          "tol": {"loss": ST_TOL_LOSS, "grad_norm_share": ST_TOL_NORM,
                  "param_err_of_update": ST_TOL_UPDATE},
          "fsdp_seq": {"arch": ST["arch"], "mesh": dict(zip(
              ("data", "model"), ST["mesh"])), "sharding": "fsdp_seq",
              "scope": "activation_sharding(mesh, 'fsdp_seq')",
              "positions_per_rank": ST["seq"] // ST["mesh"][1],
              "parity": {"arch": ST_SEQ_PARITY[0], "mesh": dict(zip(
                  ("data", "model"), ST_SEQ_PARITY[1])),
                  "S": ST_SEQ_PARITY[2], "dtype": "fp32"},
              "fitted": [{"key": k, "S": s, "global_batch": b,
                          "moe_local_dispatch": loc}
                         for k, s, b, loc in ST_FIT_PARITY]},
          "lr": ST_LR, "warmup_steps": 0,
          "seconds_ranks": max(r["seconds"] for r in ranks),
          "ranks": [{"rank": r["rank"], **r["sharded"]} for r in recs]})
    launches = dict(nccl_launches)
    for r, rk in zip(recs, ranks):
        q = rk["qwen"]
        require(0.24 <= q["share_of_dp"] <= 0.26
                and q["param_and_adamw_bytes"] == q["shard_bytes_rule"],
                f"rank {r['rank']}: {q['param_and_adamw_bytes']} bytes of "
                f"parameters and moments, rule {q['shard_bytes_rule']}, dp "
                f"{q['dp_layout_bytes']}")
        require(max_abs_diff(q["losses"], q["ref_losses"]) <= ST_TOL_LOSS
                and max_abs_diff(q["grad_norms"], q["ref_grad_norms"])
                <= ST_TOL_NORM * max(q["ref_grad_norms"]),
                f"rank {r['rank']} qwen losses {q['losses']} vs "
                f"{q['ref_losses']}, grad norms {q['grad_norms']} vs "
                f"{q['ref_grad_norms']}")
        acc = q["collectives_vs_accountant"]
        require(acc["equal"], f"rank {r['rank']} qwen's steps recorded "
                f"{acc['recorded']}, the accountant {acc['accountant']}")
        for arch, shape, _ in ST_ALL_PARITY:
            p = rk[f"{arch}_fp32"]
            if (arch, shape) in ST_PARITY:
                tol_grad = ST_TOL_FP32
                losses_ok = max_abs_diff(p["losses"], p["ref_losses"]) \
                    <= ST_TOL_FP32
            else:
                tol_grad = ST_TP_TOL_GRAD
                losses_ok = np.allclose(p["losses"], p["ref_losses"],
                                        rtol=ST_TP_TOL_LOSS, atol=0)
            require(p["grad_err_share_max"] <= tol_grad
                    and p["param_err_of_update_max"] <= ST_TOL_UPDATE
                    and losses_ok, f"rank {r['rank']} {arch} fp32: {p}")
        for arch, _, _, _ in ARMS:
            a = rk[arch]
            require(a["param_and_adamw_bytes"] == a["shard_bytes_rule"]
                    and all(np.isfinite(a["losses"])),
                    f"rank {r['rank']} {arch}: {a['param_and_adamw_bytes']} "
                    f"bytes (rule {a['shard_bytes_rule']}), losses "
                    f"{a['losses']}")
            require(a["traffic_two_steps"]["all_reduce"]["calls"] > 0,
                    f"rank {r['rank']} {arch}: no tensor-parallel sum "
                    f"{a['traffic_two_steps']}")
        falcon = rk[ARMS[0][0]]
        require(falcon["traffic_two_steps"]["exchange"]["calls"] > 0
                and falcon["launches"].get("selective_scan", 0) > 0
                and falcon["launches"].get("selective_scan_bwd", 0) > 0,
                f"rank {r['rank']} falcon: {falcon['traffic_two_steps']}, "
                f"launches {falcon['launches']}")
        whisper = rk[ARMS[1][0]]["launches"]
        require(whisper.get("flash_attention", 0) > 0
                and whisper.get("flash_attention_bwd", 0) > 0,
                f"rank {r['rank']} whisper launched {whisper}")
        for src in [q["launches"]] + [rk[a]["launches"] for a, *_ in ARMS] \
                + [rk[f"{a}_fp32"]["launches"] for a, *_ in ST_ALL_PARITY]:
            for k in ST_KERNELS:
                launches[k] = launches.get(k, 0) + src.get(k, 0)
        require(q["launches"].get("flash_attention", 0) > 0
                and q["launches"].get("flash_attention_bwd", 0) > 0,
                f"rank {r['rank']} qwen launched {q['launches']}")
        sq = rk["qwen_fsdp_seq"]
        require(max_abs_diff(sq["losses"], sq["ref_losses"]) <= ST_TOL_LOSS
                and max_abs_diff(sq["grad_norms"], sq["ref_grad_norms"])
                <= ST_TOL_NORM * max(sq["ref_grad_norms"])
                and sq["launches"].get("flash_attention", 0) > 0
                and sq["launches"].get("flash_attention_bwd", 0) > 0
                and sq["traffic_two_steps"]["all_gather"]["calls"] > 0,
                f"rank {r['rank']} qwen fsdp_seq: losses {sq['losses']} vs "
                f"{sq['ref_losses']}, grad norms {sq['grad_norms']} vs "
                f"{sq['ref_grad_norms']}, launches {sq['launches']}")
        seq_arms = [rk[f"{ST_SEQ_PARITY[0]}_{key}_fp32"] for key in
                    ["fsdp_seq"] + [f[0] for f in ST_FIT_PARITY]]
        for p in seq_arms:
            require(p["grad_err_share_max"] <= ST_TOL_FP32
                    and p["param_err_of_update_max"] <= ST_TOL_UPDATE
                    and max_abs_diff(p["losses"], p["ref_losses"])
                    <= ST_TOL_FP32
                    and p["launches"].get("flash_attention_bwd", 0) > 0,
                    f"rank {r['rank']} {ST_SEQ_PARITY[0]} fsdp_seq fp32 "
                    f"(S {p['S']}, batch {p['global_batch']}): {p}")
        for src in [sq["launches"]] + [p["launches"] for p in seq_arms]:
            for k in ST_KERNELS:
                launches[k] = launches.get(k, 0) + src.get(k, 0)
        # Every attention backward of a split runs at an offset.
        launches["flash_attention_bwd_offset"] = launches.get(
            "flash_attention_bwd_offset", 0) + sum(
            src["launches"].get("flash_attention_bwd", 0)
            for src in [sq] + [p for p in seq_arms if p["split"]])
    return launches


# ---------------------------------------------------------------------------
# Phase 6'''': the LMs served over the mesh (each rank's shards, JAX's batch
# and cache layouts, fsdp_seq's sequence split through the offset kernel).
# ---------------------------------------------------------------------------

# qwen2.5-3b at full width (16/2 heads of 128, bf16), its depth cut from 36
# to 2 layers: an fsdp_seq prefill of 8 x 2,048 tokens on (2, 2) (a rank's
# 4 rows x 1,024 positions, the queries at offset 0 or 1,024), then 8
# decode steps (cut from 16) under tp, once with the cache's slots over model
# (shard_kv_seq) and once with its 2 KV heads over model; each against the
# same parameters served whole on the card within SS_TOL_BF16 of the
# largest logit magnitude.  fp32 parity at S = 512 on (1, 4) (128 positions
# a rank; 2 KV heads do not split over 4: the attention gathered, the
# cache's slots over model) within SS_TOL_FP32.
SS = dict(arch="qwen2.5-3b", n_layers=2, seq=2048, batch=8, steps=8,
          mesh=(2, 2), parity_seq=512, parity_mesh=(1, 4))
SS_TOL_BF16, SS_TOL_FP32 = 2e-2, 1e-5
# The served runs of the ranks: (name, arch, dtype, mesh, S, shard_kv_seq
# values, global batch, decode steps).  falcon-mamba-7b at 2 of 64 layers,
# bf16 on (2, 2), S = 512: the mamba blocks gather the sequence under
# fsdp_seq, and decode channel parallel under tp on the conv and SSM
# states' channels over model.  "bf16_b1": one prompt of 2,048, which
# data 2 does not divide, so JAX's fit_spec replicates its row over data:
# every rank prefills its 1,024 positions of it and decodes it, in both
# cache layouts.
SS_RUNS = (("bf16", SS["arch"], "bfloat16", SS["mesh"], SS["seq"],
            (True, False), SS["batch"], SS["steps"]),
           ("fp32", SS["arch"], "float32", SS["parity_mesh"],
            SS["parity_seq"], (True,), SS["batch"], SS["steps"]),
           ("falcon_bf16", "falcon-mamba-7b", "bfloat16", SS["mesh"], 512,
            (True,), SS["batch"], SS["steps"]),
           ("bf16_b1", SS["arch"], "bfloat16", SS["mesh"], SS["seq"],
            (True, False), 1, 8))
# The offset kernel at the rank shapes of a four-way split of qwen's 2,048
# positions: q shards (8, 512, 16, 128) at these offsets against k/v
# (8, 2,048, 2, 128), causal; the last shard also in a window and the
# first unmasked.  Its plain version is ref.kv_stream_attention_ref (fp32
# within 1e-5, bf16 within 1e-2); each shard's rows equal the whole
# attention's rows bit for bit, and offset 0 at Sq = Sk is the old call.
SS_OFFSETS = (0, 512, 1024, 1536)
SS_Q, SS_SK, SS_KV_HEADS, SS_WINDOW = (8, 512, 16, 128), 2048, 2, 700
# World 1 over NCCL: the cut's served path on a (1, 1) mesh, 2 x 512.
SS_NCCL_BATCH, SS_NCCL_SEQ, SS_NCCL_STEPS = 2, 512, 4


def ss_cfg(dtype, arch=SS["arch"]):
    return dataclasses.replace(get_config(arch), n_layers=SS["n_layers"],
                               param_dtype=dtype, compute_dtype=dtype)


def ss_batch(cfg, b, seq, steps):
    """The prompt (b, seq) and ``steps`` decode tokens (b, 1), seeded."""
    rng = np.random.default_rng(seq + b)
    return (torch.from_numpy(rng.integers(0, cfg.vocab, (b, seq))),
            [torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)))
             for _ in range(steps)])


def ss_serve(cfg, model, tokens, steps, mesh=None, kv_seq=True, dev="cuda"):
    """The prefill (whole, or on ``mesh`` under fsdp_seq) and the decode
    steps (on ``mesh`` under tp): ``(the logits stacked (1 + steps, B_r,
    V) on the host, the cache, prefill ms, decode ms a step)``.  ``model``
    is one whole model, or a mesh's fsdp_seq and tp models."""
    cap = tokens.shape[1] + len(steps)
    pre = build(cfg, device=dev, run=RunConfig(
        sharding="fsdp_seq", shard_kv_seq=kv_seq), mesh=mesh)
    dec = build(cfg, device=dev, run=RunConfig(
        sharding="tp", shard_kv_seq=kv_seq), mesh=mesh)
    first, second = model if mesh is not None else (model, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre.prefill(first, {"tokens": tokens}, cap)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = [logits.float().cpu()]
    t0 = time.perf_counter()
    for tok in steps:
        logits, cache = dec.decode(second, tok, cache)
        out.append(logits.float().cpu())
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(len(steps), 1)
    return torch.stack(out), cache, prefill_ms, decode_ms


def _share_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def ss_offset_kernels(timer):
    """Row 8''''': the forward kernel's offset mode at ``SS_Q`` against
    its plain version in both dtypes, the shards' rows against the whole
    attention's bits, offset 0 against the old call; the costliest shard
    (offset 1,536, bf16) timed beside its bound (its visible keys'
    products and its bytes) and SDPA with the same explicit mask."""
    b, sq, h, hd = SS_Q
    sk, n_kv = SS_SK, SS_KV_HEADS
    g = torch.Generator(device="cuda").manual_seed(32)
    rec = {"B": b, "Sq": sq, "Sk": sk, "H": h, "K": n_kv, "hd": hd,
           "offsets": list(SS_OFFSETS), "window": SS_WINDOW,
           "layout": "qwen2.5-3b's queries split four ways over model",
           "errors": {}, "rows_bit_equal_whole": True,
           "offset0_bit_equal_old_call": True}
    for dt_name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        tol = 1e-2 if dt_name == "bf16" else 1e-5
        qf = torch.randn((b, sk, h, hd), generator=g, device="cuda").to(dt)
        k, v = (torch.randn((b, sk, n_kv, hd), generator=g, device="cuda")
                .to(dt) for _ in range(2))
        cases = [(off, 0, True) for off in SS_OFFSETS] + [
            (SS_OFFSETS[-1], SS_WINDOW, True), (0, 0, False)]
        for off, w, causal in cases:
            q = qf[:, off:off + sq].contiguous()
            got = fa.flash_attention(q, k, v, window=w, causal=causal,
                                     q_offset=off)
            want = ref.kv_stream_attention_ref(q, k, v, w, 512, off, causal)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            key = f"{dt_name}_{'causal' if causal else 'unmasked'}_{off}" \
                + (f"_window{w}" if w else "")
            rec["errors"][key] = err
            require(err <= tol, f"flash_attention offset {key}: max abs err "
                    f"{err}")
            if causal:
                whole = fa.flash_attention(qf, k, v, window=w)
                require(torch.equal(got, whole[:, off:off + sq]),
                        f"flash_attention offset {key}: the rows differ "
                        "from the whole attention's")
                del whole
            del got, want
        require(torch.equal(fa.flash_attention(qf, k, v),
                            fa.flash_attention(qf, k, v, q_offset=0)),
                f"flash_attention {dt_name}: offset 0 differs from the old "
                "call")
        if dt_name == "bf16":
            off = SS_OFFSETS[-1]
            q = qf[:, off:off + sq].contiguous()
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = (torch.arange(sk, device="cuda")[None, :]
                    <= off + torch.arange(sq, device="cuda")[:, None])
            rec.update(
                dtype="bf16", timed_offset=off,
                ms=timer(lambda: fa.flash_attention(q, k, v, q_offset=off)),
                plain_ms=timer(lambda: ref.kv_stream_attention_ref(
                    q, k, v, 0, 512, off)),
                library_ms=timer(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)),
                library="scaled_dot_product_attention(attn_mask=offset "
                        "mask, enable_gqa=True)")
            work = W.flash_attention(b, sq, sk, h, n_kv, hd,
                                     q.element_size(), q_offset=off)
            rec["bound_ms"], rec["bound_by"] = work_bound(work)
            achieved(rec, work.ops)
            del qt, kt, vt, mask
        del qf, k, v
    torch.cuda.empty_cache()
    rec["max_abs_err"] = max(v for k, v in rec["errors"].items()
                             if k.startswith("bf16"))
    return rec


def phase_lm_sharded_serve_nccl(work, timer):
    """Row 8''''' (:func:`ss_offset_kernels`); then world 1 over NCCL in
    this process: the cut's fsdp_seq prefill and tp decode through
    ``build(..., mesh=)`` on a (1, 1) mesh (its gathers, the sequence
    split and the cache's exchange run over the one rank) against the
    same parameters served whole; then the four ranks' references, the
    cut served whole in bf16 (S 2,048) and fp32 (S 512), saved to
    ``work``.  Returns ``(the kernel record, the (1, 1) run's
    flash_attention launches)``."""
    t0 = time.perf_counter()
    rec = ss_offset_kernels(timer)
    cfg = ss_cfg("bfloat16")
    tokens, steps = ss_batch(cfg, SS_NCCL_BATCH, SS_NCCL_SEQ, SS_NCCL_STEPS)
    whole = build(cfg, device="cuda").init(seed=0)
    want = ss_serve(cfg, whole, tokens, steps)[0]
    del whole
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_serve_")
    try:
        M.init_distributed("nccl", f"file://{store}/store", 0, 1,
                           device="cuda:0", timeout=120)
        mesh = M.make_host_mesh()
        models = tuple(build(cfg, device="cuda", run=RunConfig(sharding=s),
                             mesh=mesh).init(seed=0)
                       for s in ("fsdp_seq", "tp"))
        C.reset_traffic()
        ops.reset_launches()
        got = ss_serve(cfg, models, tokens, steps, mesh)[0]
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        traffic = copy.deepcopy(C.TRAFFIC)
        del models
    finally:
        M.close_distributed()
        shutil.rmtree(store, ignore_errors=True)
    err = _share_err(got, want)
    require(err <= SS_TOL_BF16 and launches == cfg.n_layers
            and traffic["all_gather"]["calls"] > 0,
            f"nccl world 1 served: logits err {err}, flash_attention "
            f"{launches}, traffic {traffic}")
    emit({"phase": "lm_sharded_serve", "world": 1, "backend": "nccl",
          "mesh": mesh.shape, "arch": SS["arch"], "n_layers": SS["n_layers"],
          "prefill": "fsdp_seq", "decode": "tp", "B": SS_NCCL_BATCH,
          "S": SS_NCCL_SEQ, "steps": SS_NCCL_STEPS,
          "logits_err_share_vs_whole": err,
          "logits_bit_equal_whole": bool(torch.equal(got, want)),
          "flash_attention_launches": launches, "traffic": traffic,
          "seconds": round(time.perf_counter() - t0, 1)})
    torch.cuda.empty_cache()
    # The references: the cut served whole, one process holding it.
    for dt_name, arch, dtype, _, seq, _, batch, n_steps in SS_RUNS:
        cfg = ss_cfg(dtype, arch)
        tokens, steps = ss_batch(cfg, batch, seq, n_steps)
        model = build(cfg, device="cuda").init(seed=0)
        logits, _, pre_ms, dec_ms = ss_serve(cfg, model, tokens, steps)
        torch.save({"logits": logits, "prefill_ms": pre_ms,
                    "decode_ms": dec_ms}, Path(work, f"ss_ref_{dt_name}.pt"))
        del model
        torch.cuda.empty_cache()
    return rec, launches


def lm_sharded_serve_rank(rank, work, dev):
    """The gloo rank's served LMs, after its sharded training (``SS_RUNS``):
    qwen's cut in bf16 on (2, 2) (the fsdp_seq prefill, then the tp
    decode, for both cache layouts; then a batch of one row, replicated
    over data), in fp32 on (1, 4) (the slots over model) and
    falcon-mamba-7b's in bf16 on (2, 2), each against the whole
    model's logits saved in ``work``: the rank's rows' errors as a share of
    their largest magnitude, the collectives' calls and bytes, its bytes
    of cache, the prefill's and a decode step's host ms, and the kernels'
    launches.  Returns the rank's record."""
    t_start = time.perf_counter()
    rec = {}
    for dt_name, arch, dtype, shape, seq, kv_seqs, batch, n_steps \
            in SS_RUNS:
        cfg = ss_cfg(dtype, arch)
        mesh = M.make_mesh(*shape)
        want = torch.load(Path(work, f"ss_ref_{dt_name}.pt"))
        tokens, steps = ss_batch(cfg, batch, seq, n_steps)
        rows = SP.shard_of(torch.arange(batch), SP.batch_spec(
            (batch, seq), mesh, "fsdp_seq")[:1], mesh)
        models = tuple(build(cfg, device=dev, run=RunConfig(sharding=s),
                             mesh=mesh).init(seed=0)
                       for s in ("fsdp_seq", "tp"))
        for kv_seq in kv_seqs:
            dist.barrier()
            C.reset_traffic()
            C.reset_record()
            ops.reset_launches()
            got, cache, pre_ms, dec_ms = ss_serve(cfg, models, tokens, steps,
                                                  mesh, kv_seq, dev)
            torch.cuda.synchronize()
            recorded = C.collective_stats()
            cap = seq + n_steps
            pre, pre_s = accounted(cfg, "prefill", seq, batch, RunConfig(
                sharding="fsdp_seq", shard_kv_seq=kv_seq), mesh,
                cache_len=cap)
            dec, dec_s = accounted(cfg, "decode", cap, batch, RunConfig(
                sharding="tp", shard_kv_seq=kv_seq), mesh, pos=seq)
            rec[f"{dt_name}_kv_seq_{int(kv_seq)}"] = {
                "arch": arch, "mesh": dict(zip(("data", "model"), shape)),
                "S": seq, "global_batch": batch, "steps": n_steps,
                "rows": rows.tolist(),
                "logits_err_share": _share_err(got, want["logits"][:, rows]),
                "cache_bytes": sum(t.numel() * t.element_size()
                                   for t in cache.values()
                                   if isinstance(t, torch.Tensor)),
                "cache_shapes": {n: list(t.shape) for n, t in cache.items()
                                 if isinstance(t, torch.Tensor)},
                "traffic": copy.deepcopy(C.TRAFFIC),
                "collectives_vs_accountant": collectives_check(
                    recorded, [(pre, 1), (dec, n_steps)], pre_s + dec_s),
                "launches": {fn.__name__: fn.launches for fn in ops.KERNELS
                             if fn.launches},
                "prefill_ms_host": pre_ms, "decode_ms_host_per_step": dec_ms,
                "whole_prefill_ms_host": want["prefill_ms"],
                "whole_decode_ms_host_per_step": want["decode_ms"]}
            del cache
        del models
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def report_lm_sharded_serve(recs, nccl_launches):
    """Holds the gloo ranks' served LMs against the whole models and emits
    the phase's line; returns ``{kernel: launches}`` over the ranks and
    the world-1 run (``flash_attention``'s offset mode, falcon's
    ``selective_scan``)."""
    ranks = [r["lm_serve"] for r in recs]
    launches = {"flash_attention": nccl_launches}
    for r, rk in zip(recs, ranks):
        for key, run in rk.items():
            if key == "seconds":
                continue
            tol = SS_TOL_FP32 if key.startswith("fp32") else SS_TOL_BF16
            kernel = ("selective_scan" if run["arch"] == "falcon-mamba-7b"
                      else "flash_attention")
            n = run["launches"].get(kernel, 0)
            require(run["logits_err_share"] <= tol and n == SS["n_layers"]
                    and run["traffic"]["all_gather"]["calls"] > 0,
                    f"rank {r['rank']} {key}: logits err "
                    f"{run['logits_err_share']}, {kernel} {n}, "
                    f"traffic {run['traffic']}")
            acc = run["collectives_vs_accountant"]
            require(acc["equal"], f"rank {r['rank']} {key}: the prefill and "
                    f"decode steps recorded {acc['recorded']}, the "
                    f"accountant {acc['accountant']}")
            launches[kernel] = launches.get(kernel, 0) + n
    emit({"phase": "lm_sharded_serve", "world": len(recs), "backend": "gloo",
          "ranks_on_one_card": len(recs), "collective_note": GLOO_NOTE,
          "arch": SS["arch"], "cuts": {"n_layers": [36, SS["n_layers"]],
                                       "falcon-mamba-7b": [64,
                                                           SS["n_layers"]]},
          "prefill": "fsdp_seq (the sequence over model)",
          "decode": "tp", "global_batch": SS["batch"], "steps": SS["steps"],
          "tol": {"bf16": SS_TOL_BF16, "fp32": SS_TOL_FP32},
          "seconds_ranks": max(rk["seconds"] for rk in ranks),
          "ranks": [{"rank": r["rank"], **r["lm_serve"]} for r in recs]})
    return launches


# ---------------------------------------------------------------------------
# Phases 7-9: the learned models' kernels, parity and full-width path.
# ---------------------------------------------------------------------------

def cuda_normal(shape, rng, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).cuda()


def lstm_inputs(b, in_dim, hid, seed):
    """x, h, c, W, b of one LSTM step, W scaled like ``lstm_init``."""
    rng = np.random.default_rng(seed)
    k = in_dim + hid
    return (cuda_normal((b, in_dim), rng), cuda_normal((b, hid), rng),
            cuda_normal((b, hid), rng), cuda_normal((k, 4 * hid), rng,
                                                    k ** -0.5),
            cuda_normal((4 * hid,), rng, 0.5))


def phase_learned_kernels(timer):
    """``lstm_cell`` and ``chamfer`` against their plain versions at the
    learned path's shapes.  Returns the records the kernels line takes:
    ``lstm_cell`` at the inference shape of the decoder (B=4096, K=120, no
    gates saved) and ``chamfer`` at the training shape (B=256)."""
    main = {}
    floor_ms = timer.floor_ms()
    for b in (4096, 256):
        train = b == 256  # training saves the gates for the backward
        for layer, (in_dim, hid) in LSTM_LAYERS.items():
            k = in_dim + hid
            x, h, c, w, bias = lstm_inputs(b, in_dim, hid, b + k)
            got = lc.lstm_cell(x, h, c, w, bias)
            want = ref.lstm_cell_ref(x, h, c, w, bias)
            w_ih, w_hh = w[:in_dim].t().contiguous(), w[in_dim:].t().contiguous()
            b_hh = torch.zeros_like(bias)
            lib = torch.lstm_cell(x, (h, c), w_ih, w_hh, bias, b_hh)
            torch.cuda.synchronize()
            errs = {n: float((g - r).abs().max())
                    for n, g, r in zip(("h", "c", "gates"), got, want)}
            err = max(errs.values())
            require(err <= 1e-5, f"lstm_cell B={b} K={k}: max abs err "
                                 f"{errs} > 1e-5")
            rec = {"phase": "kernel", "name": "lstm_cell", "layer": layer,
                   "B": b, "K": k, "H": hid, "saves_gates": train,
                   "max_abs_err": err, "max_abs_err_by_output": errs,
                   "library_max_abs_err": max(
                       float((lib[0] - want[0]).abs().max()),
                       float((lib[1] - want[1]).abs().max())),
                   "ms": timer(lambda: lc.lstm_cell(x, h, c, w, bias,
                                                    save_gates=train)),
                   "plain_ms": timer(lambda: ref.lstm_cell_ref(x, h, c, w,
                                                               bias)),
                   "library_ms": timer(lambda: torch.lstm_cell(
                       x, (h, c), w_ih, w_hh, bias, b_hh))}
            work = W.lstm_cell(b, in_dim, hid, train)
            rec["bound_ms"], rec["bound_by"] = work_bound(work)
            achieved(rec, work.ops)
            rec["beats_library"] = rec["ms"] <= rec["library_ms"]
            rec["timer_floor_ms"] = floor_ms
            rec["design"] = LSTM_DESIGN
            emit(rec)
            if b == 4096 and layer == "decoder":
                main["lstm_cell"] = rec
    n_p, n_w, n_f = CHAMFER_SHAPE
    for b in (256, 65536):
        rng = np.random.default_rng(b)
        po = cuda_normal((b, n_p, n_f), rng)
        w = cuda_normal((b, n_w, n_f), rng)
        loss, af, ab = ck.chamfer(po, w, 0.7)
        rl, raf, rab = ref.chamfer_ref(po, w, 0.7)
        torch.cuda.synchronize()
        rel = float(((loss - rl).abs() / rl.abs()).max())
        args_equal = bool(torch.equal(af, raf) and torch.equal(ab, rab))
        require(rel <= 1e-5, f"chamfer B={b}: max rel err {rel} > 1e-5")
        require(args_equal, f"chamfer B={b}: argmins differ from plain")
        rec = {"phase": "kernel", "name": "chamfer", "B": b, "P": n_p,
               "W": n_w, "F": n_f, "max_abs_err": float((loss - rl).abs()
                                                        .max()),
               "max_rel_err": rel, "argmins_equal": args_equal,
               "ms": timer(lambda: ck.chamfer(po, w, 0.7)),
               "plain_ms": timer(lambda: ref.chamfer_ref(po, w, 0.7)),
               "library_ms": None, "library_note": NO_LIBRARY["chamfer"]}
        rec["bound_ms"], rec["bound_by"] = work_bound(
            W.chamfer(b, n_p, n_w, n_f))
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["timer_floor_ms"] = floor_ms
        rec["design"] = CHAMFER_DESIGN
        emit(rec)
        if b == 256:
            main["chamfer"] = rec
    return main


def grads_close(got, want, what, rtol=1e-4, atol=1e-6) -> dict:
    """Max abs difference of two gradients, required to be within ``atol +
    rtol * max|want|``: the tolerance is scaled by the gradient's size, not
    by each entry's, since an entry that sums 256 rows' products can
    cancel to near zero while keeping the rounding of its terms.  Returns
    the error, the scale it was held to, and how many entries the
    elementwise ``atol + rtol * |want|`` would have refused."""
    diff = (got - want).abs()
    err = float(diff.max())
    scale = float(want.abs().max())
    require(err <= atol + rtol * scale,
            f"{what}: max abs err {err} > {atol} + {rtol} * {scale}")
    over = int((diff > atol + rtol * want.abs()).sum())
    return {"max_abs_err": err, "scale": scale, "elementwise_over": over,
            "entries": want.numel()}


def phase_learned_grads():
    """Gradients through the two autograd Functions (kernel forward,
    PyTorch backward) against autograd through the plain versions, at the
    training shapes, on the same inputs."""
    rng = np.random.default_rng(5)
    out = {}
    for layer, (in_dim, hid) in LSTM_LAYERS.items():
        ins = [t.requires_grad_() for t in lstm_inputs(256, in_dim, hid, 7)]
        gh = cuda_normal((256, hid), rng)
        gc = cuda_normal((256, hid), rng)
        h2, c2 = ops.lstm_cell(*ins)
        ((h2 * gh).sum() + (c2 * gc).sum()).backward()
        plain = [t.detach().clone().requires_grad_() for t in ins]
        ph, pc, _ = ref.lstm_cell_ref(*plain)
        ((ph * gh).sum() + (pc * gc).sum()).backward()
        for name, t, p in zip(("x", "h", "c", "w", "b"), ins, plain):
            out[f"lstm_cell_{layer}_{name}"] = grads_close(
                t.grad, p.grad, f"lstm_cell {layer} grad {name}")
    n_p, n_w, n_f = CHAMFER_SHAPE
    po = cuda_normal((256, n_p, n_f), rng).requires_grad_()
    w = cuda_normal((256, n_w, n_f), rng)
    g = cuda_normal((256,), rng)
    (ops.chamfer(po, w, 0.7) * g).sum().backward()
    pp = po.detach().clone().requires_grad_()
    (ref.chamfer_ref(pp, w, 0.7)[0] * g).sum().backward()
    out["chamfer_po"] = grads_close(po.grad, pp.grad, "chamfer grad po")
    emit({"phase": "learned_grads", "rtol": 1e-4, "atol": 1e-6,
          "tolerance": "max abs err <= atol + rtol * max |plain grad|",
          "grads": out})


def decision_flips(card, cpu, card_margin, cpu_margin, what):
    """Decisions of the two devices must agree wherever both margins are
    at least 1e-4; returns the number of flips (all of them near a tie)."""
    flips = card != cpu
    near = (np.broadcast_to(card_margin, flips.shape) < 1e-4) | \
        (np.broadcast_to(cpu_margin, flips.shape) < 1e-4)
    require(not (flips & ~near).any(),
            f"{what}: {int((flips & ~near).sum())} decisions differ CPU vs "
            "card with a margin of at least 1e-4")
    return int(flips.sum())


def phase_learned_parity():
    """The learned models trained on the card on the golden fixture; their
    outputs on the card and, from the same parameters, on the CPU; the
    card's outputs served on both devices."""
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    cap = int(0.15 * trace.unique_count())
    lcfg = dataclasses.replace(cli_learned_config(1), train_stride=2)
    card = LearnedRecMGModel.train_from_trace(trace, cap, lcfg,
                                              device="cuda")
    cpu = card.to("cpu")
    data, starts = card.serving_windows(trace)
    got = {}
    for dev, m in (("cuda", card), ("cpu", cpu)):
        logits = m.predict_logits(data)
        pts = m.predict_points(data)
        ids, gaps = m.decode_points(pts, return_margins=True)
        got[dev] = (logits, pts, ids, gaps)
    (cl, cp, ci, cg), (pl, pp, pi, pg) = got["cuda"], got["cpu"]
    logit_diff = float(np.abs(cl - pl).max())
    point_diff = float(np.abs(cp - pp).max())
    require(logit_diff <= 1e-5 and point_diff <= 1e-5,
            f"card vs CPU model outputs: logits {logit_diff}, points "
            f"{point_diff} (max abs, allowed 1e-5)")
    bit_flips = decision_flips(cl > 0, pl > 0, np.abs(cl), np.abs(pl),
                               "keep bits")
    id_flips = decision_flips(ci, pi, cg, pg, "prefetch ids")
    vmodel, cand, vlosses = train_voyager_arm(trace, cap, epochs=1,
                                              device="cuda")
    vcard, vgap = voyager_arm_outputs(vmodel, cand, trace,
                                      return_margins=True)
    vcpu, vgap_cpu = voyager_arm_outputs(
        copy.deepcopy(vmodel).to("cpu"), cand, trace, return_margins=True)
    v_flips = decision_flips(vcard.prefetch_ids, vcpu.prefetch_ids,
                             vgap[:, None], vgap_cpu[:, None],
                             "voyager prefetch ids")
    params = init_dlrm(cfg, seed=0, device="cpu")
    served = {}
    for arm, policy, outputs in (
            ("learned", "recmg", RecMGOutputs(starts, cl > 0, ci)),
            ("voyager", "lru", vcard)):
        res = {dev: serve_trace(cfg, to_device(params, dev), trace, cap,
                                policy, outputs, batch_queries=8, device=dev,
                                collect_logits=True)
               for dev in ("cpu", "cuda")}
        diff = {k: (res["cpu"][k], res["cuda"][k]) for k in SERVE_KEYS
                if res["cpu"][k] != res["cuda"][k]}
        require(not diff, f"learned serve counters differ CPU vs card "
                          f"({arm}): {diff}")
        err = float(np.abs(res["cpu"]["logits"] - res["cuda"]["logits"])
                    .max())
        require(np.allclose(res["cuda"]["logits"], res["cpu"]["logits"],
                            rtol=1e-4, atol=1e-4),
                f"learned serve logits differ CPU vs card ({arm}): {err}")
        served[arm] = {"counters_equal": True, "logits_max_abs_err": err,
                       **{k: res["cuda"][k] for k in SERVE_KEYS}}
    emit({"phase": "learned_parity", "capacity": cap, "windows": len(data),
          "caching_losses": [card.caching_losses[0], card.caching_losses[-1]],
          "prefetch_losses": [card.prefetch_losses[0],
                              card.prefetch_losses[-1]],
          "voyager_losses": [vlosses[0], vlosses[-1]],
          "logits_max_abs_diff": logit_diff,
          "points_max_abs_diff": point_diff,
          "min_abs_logit": float(min(np.abs(cl).min(), np.abs(pl).min())),
          "min_decode_margin": float(min(cg.min(), pg.min())),
          "flips": {"keep_bits": bit_flips, "prefetch_ids": id_flips,
                    "voyager_ids": v_flips},
          "serve": served})


def phase_learned_serve(cfg, trace, host, capacity, qcapacity, per_batch,
                        batch_queries, baseline):
    """The CLI's default path at full width: ``--model learned`` trained on
    the first quarter of the first of the 6 batches (1 epoch) at the fp32
    capacity and served fp32, then the same model's outputs served int8
    (the int8 arm trained a model of its own at the int8 capacity until
    the distributed serve needed the script's time), and the Voyager arm
    trained on the same accesses and served fp32 on LRU.  Counts are set
    to 0 just before the fp32 arm's training, before the int8 arm's
    outputs and before the Voyager arm's training, and read just after
    each serve.  Returns each kernel's launches summed over the arms, and
    the learned model."""
    params = init_dlrm(cfg, seed=0, device="cuda")
    lcfg = cli_learned_config(1)
    # The accesses the arms train on: a quarter of a serve batch (the first
    # 2 batches before the SSM phases needed the script's time, half of one
    # before the distributed serve did).
    train_upto = per_batch // 4
    launches = {"lstm_cell": 0, "chamfer": 0}
    summary = {}
    int8 = dict(quantize=True, row_format="int8")
    ops.reset_launches()
    t0 = time.perf_counter()
    model = LearnedRecMGModel.train_from_trace(
        trace, capacity, lcfg, profile_upto=train_upto, device="cuda")
    train_s = time.perf_counter() - t0
    for rows, cap, kw in (("fp32", capacity, {}), ("int8", qcapacity, int8)):
        if rows == "int8":
            ops.reset_launches()
        t0 = time.perf_counter()
        outputs = model.outputs_for(trace)
        outputs_s = time.perf_counter() - t0
        res = serve_trace(cfg, params, trace, cap, "recmg", outputs,
                          batch_queries=batch_queries, device="cuda",
                          collect_logits=True, host=host, **kw)
        # chamfer runs in the prefetch model's training loss only.
        path = (("lstm_cell", "quantize_scatter",
                 "gather_rows_dequant_expand") if kw else
                ("lstm_cell", "chamfer", "gather_rows_expand"))
        n = {fn.__name__: fn.launches for fn in ops.KERNELS
             if fn.__name__ in path}
        for name in path:
            require(n[name] > 0, f"learned serve ({rows}) launched {name} "
                                 "0 times")
        launches["lstm_cell"] += n["lstm_cell"]
        launches["chamfer"] += n.get("chamfer", 0)
        lg = res["logits"]
        require(lg.shape == (res["batches"], batch_queries)
                and np.isfinite(lg).all()
                and res["hits"] + res["misses"] == res["lookups"],
                f"learned serve ({rows}): bad result")
        require(np.isfinite(model.caching_losses).all()
                and np.isfinite(model.prefetch_losses).all(),
                f"learned serve ({rows}): non-finite training loss")
        summary[(rows, "recmg-learned")] = res
        trained = rows == "fp32"
        emit({"phase": "learned_serve", "rows": rows, "model": "learned",
              "capacity": cap, "launches": n, "trained_here": trained,
              "trained_at_capacity": capacity,
              "cuts": {"profile_upto": train_upto,
                       "train_batches": "first quarter of 1 of 6",
                       "epochs": 1},
              "train_windows_stride": lcfg.train_stride,
              "stage_s": {**({k: round(v, 3) for k, v in
                              model.timings.items()} if trained else {}),
                          "train_total_s": round(train_s, 3) if trained
                          else 0.0,
                          "outputs_for_s": round(outputs_s, 3)},
              "chunks": int(len(outputs.chunk_starts)),
              "caching_steps": len(model.caching_losses),
              "prefetch_steps": len(model.prefetch_losses),
              "caching_loss_first_last": [model.caching_losses[0],
                                          model.caching_losses[-1]],
              "prefetch_loss_first_last": [model.prefetch_losses[0],
                                           model.prefetch_losses[-1]],
              "keep_bit_share": float(outputs.caching_bits.mean()),
              **{k: res[k] for k in SERVE_REPORT}})
        del outputs, res
    ops.reset_launches()
    t0 = time.perf_counter()
    vmodel, cand, vlosses = train_voyager_arm(trace, capacity, epochs=1,
                                              profile_upto=train_upto,
                                              device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outputs = voyager_arm_outputs(vmodel, cand, trace)
    outputs_s = time.perf_counter() - t0
    res = serve_trace(cfg, params, trace, capacity, "lru", outputs,
                      batch_queries=batch_queries, device="cuda",
                      collect_logits=True, host=host)
    n = {fn.__name__: fn.launches for fn in ops.KERNELS
         if fn.__name__ in ("lstm_cell", "gather_rows_expand")}
    for name, k in n.items():
        require(k > 0, f"voyager serve launched {name} 0 times")
    require(np.isfinite(res["logits"]).all() and np.isfinite(vlosses).all(),
            "voyager serve: non-finite logits or losses")
    launches["lstm_cell"] += n["lstm_cell"]
    summary[("fp32", "voyager")] = res
    emit({"phase": "learned_serve", "rows": "fp32", "model": "voyager",
          "capacity": capacity, "launches": n,
          "cuts": {"profile_upto": train_upto,
                   "train_batches": "first quarter of 1 of 6", "epochs": 1},
          "stage_s": {"train_s": round(train_s, 3),
                      "outputs_s": round(outputs_s, 3)},
          "steps": len(vlosses), "loss_first_last": [vlosses[0], vlosses[-1]],
          **{k: res[k] for k in SERVE_REPORT}})
    del params
    torch.cuda.empty_cache()
    arms = {**{(r, p): baseline[(r, p)] for r, p in
               (("fp32", "lru"), ("fp32", "recmg"), ("int8", "lru"),
                ("int8", "recmg"))}, **summary}
    emit({"phase": "learned_vs_frequency", "arms": {
        f"{r} {'recmg-frequency' if p == 'recmg' else p}": {
            k: arms[(r, p)][k] for k in ("hit_rate", "on_demand_rows",
                                         "prefetch_hits", "p50_batch_ms",
                                         "model_s")}
        for r, p in arms}})
    return launches, model  # phase runtime_serve adapts it online



# ---------------------------------------------------------------------------
# Phases 9' and 9'': the pipelined runtime, admission and drift adaptation.
# ---------------------------------------------------------------------------

RUNTIME_COUNTERS = ("batches", "lookups", "hits", "prefetch_hits",
                    "on_demand_rows", "evictions")
RUNTIME_PATH = ("gather_rows_expand", "gather_rows_dequant_expand",
                "quantize_scatter", "lstm_cell")


class ThreadLaunches:
    """Splits ``quantize_scatter``'s launches by the thread that made them,
    so a run can show that the prefetch engine's worker launched the
    kernel.  It wraps the store's entry point ``ops.quantize_scatter``; the
    kernel's own ``launches`` count still counts every launch."""

    def __init__(self):
        self.by_thread = {}

    def __enter__(self):
        orig = self._orig = ops.quantize_scatter

        def counted(*a, **kw):
            n0 = eg.quantize_scatter.launches
            out = orig(*a, **kw)
            name = threading.current_thread().name
            self.by_thread[name] = (self.by_thread.get(name, 0)
                                    + eg.quantize_scatter.launches - n0)
            return out

        ops.quantize_scatter = counted
        return self

    def __exit__(self, *exc):
        ops.quantize_scatter = self._orig


class DegradedLaunches:
    """Counts the gather launches made inside the store's degraded read
    (``lookup_resident_device``), apart from the lookups' own."""

    def __init__(self):
        self.launches = 0

    def __enter__(self):
        self._orig = TieredEmbeddingStore.lookup_resident_device
        orig, tally = self._orig, self

        def counted(store, ids):
            n0 = eg.gather_rows_expand.launches \
                + eg.gather_rows_dequant_expand.launches
            out = orig(store, ids)
            tally.launches += eg.gather_rows_expand.launches \
                + eg.gather_rows_dequant_expand.launches - n0
            return out

        TieredEmbeddingStore.lookup_resident_device = counted
        return self

    def __exit__(self, *exc):
        TieredEmbeddingStore.lookup_resident_device = self._orig


def path_launches():
    return {fn.__name__: fn.launches for fn in ops.KERNELS
            if fn.__name__ in RUNTIME_PATH}


def runtime_report(res):
    rt = res["runtime"]
    return {**{k: res[k] for k in RUNTIME_COUNTERS},
            "stall_ms": rt["stall_ms"],
            "demand_fetch_ms": rt["demand_fetch_ms"],
            "p50_batch_ms": res["p50_batch_ms"]}


def phase_runtime_parity(cfg, trace, host, capacity, qcapacity,
                         batch_queries, baseline):
    """The pipelined runtime at full width against the synchronous serve
    of phase ``serve`` (``baseline``): fp32 ``recmg`` (frequency) and int8
    ``lru`` through the inline scheduler at depths 1 and 2 give the same
    counters, the whole demand fetch stalls at depth 1 and strictly less at
    depth 2; then int8 ``recmg`` (frequency) through the thread scheduler,
    whose counters keep the identities and whose worker launched
    ``quantize_scatter``.  Returns the kernels' launches summed over the
    runs."""
    params = init_dlrm(cfg, seed=0, device="cuda")
    int8 = dict(quantize=True, row_format="int8")
    freq = {capacity: frequency_outputs(trace, capacity),
            qcapacity: frequency_outputs(trace, qcapacity)}
    total = {}
    runs = [("fp32", "recmg", capacity, {}, "inline", 1),
            ("fp32", "recmg", capacity, {}, "inline", 2),
            ("int8", "lru", qcapacity, int8, "inline", 1),
            ("int8", "lru", qcapacity, int8, "inline", 2),
            ("int8", "recmg", qcapacity, int8, "thread", 2)]
    for rows, policy, cap, kw, sched, depth in runs:
        sync = baseline[(rows, policy)]
        outputs = freq[cap] if policy == "recmg" else None
        ops.reset_launches()
        with ThreadLaunches() as threads:
            res = serve_trace(cfg, params, trace, cap, policy, outputs,
                              batch_queries=batch_queries, device="cuda",
                              async_prefetch=True, pipeline_depth=depth,
                              scheduler=sched, collect_logits=True,
                              host=host, **kw)
        n = path_launches()
        for name, k in n.items():
            total[name] = total.get(name, 0) + k
        rt = res["runtime"]
        what = f"runtime_parity ({rows}, {policy}, {sched}, depth {depth})"
        require(np.isfinite(res["logits"]).all()
                and res["logits"].shape == (res["batches"], batch_queries),
                f"{what}: logits not finite or of the wrong shape")
        # The demand fetch is the store's modeled fetch (rounded to 0.1 ms
        # in ``modeled_fetch_s``).
        require(abs(rt["demand_fetch_ms"] - res["modeled_fetch_s"] * 1e3)
                <= 0.051, f"{what}: demand fetch {rt['demand_fetch_ms']} ms "
                          f"is not the store's {res['modeled_fetch_s']} s")
        worker = sum(v for t, v in threads.by_thread.items()
                     if t == "prefetch-engine")
        if sched == "inline":
            diff = {k: (sync[k], res[k]) for k in RUNTIME_COUNTERS
                    if sync[k] != res[k]}
            require(not diff, f"{what}: counters differ from the "
                              f"synchronous serve: {diff}")
            if depth == 1:
                require(rt["stall_ms"] == rt["demand_fetch_ms"],
                        f"{what}: stall {rt['stall_ms']} != demand fetch "
                        f"{rt['demand_fetch_ms']}")
            else:
                require(rt["stall_ms"] < rt["demand_fetch_ms"],
                        f"{what}: stall {rt['stall_ms']} not below demand "
                        f"fetch {rt['demand_fetch_ms']}")
        else:
            require(res["hits"] + res["misses"] == res["lookups"]
                    == sync["lookups"] and res["batches"] == sync["batches"]
                    and rt["batches"] == res["batches"]
                    and rt["stall_ms"] < rt["demand_fetch_ms"],
                    f"{what}: accounting identities fail")
            require(worker > 0, f"{what}: the engine's worker launched "
                                "quantize_scatter 0 times")
        emit({"phase": "runtime_parity", "rows": rows, "policy": policy,
              "scheduler": sched, "pipeline_depth": depth,
              "counters_equal_sync": sched == "inline",
              "quantize_scatter_by_worker": worker,
              **runtime_report(res),
              "sync_p50_batch_ms": sync["p50_batch_ms"],
              "pf_issued": rt["pf_issued"], "launches": n})
    del params
    torch.cuda.empty_cache()
    return total


def phase_runtime_serve(cfg, trace, host, per_batch, capacity, qcapacity,
                        batch_queries, model):
    """The runtime's other paths at full width: ``--overload 2`` on the
    int8 store (degraded reads on the card), ``--adapt`` with the
    frequency model and with the learned model of phase ``learned_serve``
    on a drift workload (3 batches of a quarter of the serve's queries in
    the diurnal regime, one hot-set switch a batch), and ``--workload
    zipf_hot`` through the CLI's ``main``.  Returns the kernels' launches
    summed over the runs."""
    params = init_dlrm(cfg, seed=0, device="cuda")
    total = {}

    def count(n):
        for name, k in n.items():
            total[name] = total.get(name, 0) + k

    ops.reset_launches()
    with DegradedLaunches() as deg:
        res = serve_trace(cfg, params, trace, qcapacity, "lru",
                          None, batch_queries=batch_queries, device="cuda",
                          async_prefetch=True, overload=2.0, quantize=True,
                          row_format="int8", collect_logits=True,
                          host=host)
    n = path_launches()
    count(n)
    adm = res["admission"]
    require(adm["degraded_rows_stale"] > 0,
            "runtime_serve (overload): no stale degraded rows")
    require(deg.launches > 0 and n["gather_rows_dequant_expand"] > 0,
            "runtime_serve (overload): the degraded read launched "
            "gather_rows_dequant_expand 0 times")
    require(adm["admitted"] == adm["served"] + adm["shed"]
            + adm["degraded"] and np.isfinite(res["logits"]).all(),
            "runtime_serve (overload): bad result")
    emit({"phase": "runtime_serve", "run": "overload 2.0, int8 lru",
          **runtime_report(res), "admission": adm,
          "goodput_rps": res["goodput_rps"],
          "offered_rps": res["offered_rps"],
          "degraded_read_launches": deg.launches, "launches": n})

    # Seconds of each fine-tune and output recompute of the learned
    # controller's refreshes (instance wrappers, removed after the run).
    refresh_s = {"finetune": [], "outputs_for": []}

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            refresh_s[key].append(round(time.perf_counter() - t, 3))
            return out
        return run

    # Batches of a quarter of the serve's queries (three of them, one
    # hot-set switch a batch): the learned arm's three outputs_for over
    # the drift trace took ~47 s at full batches.
    adapt_queries = batch_queries // 4
    adapt_batch = per_batch // 4
    drift = make_trace(scenario(
        "diurnal", n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=3 * adapt_batch, seed=0, n_phases=3))
    adapt_cfg = DriftConfig(window=adapt_batch, hot_k=256, warmup_windows=1)
    for arm in ("frequency", "learned"):
        ops.reset_launches()
        t0 = time.perf_counter()
        if arm == "learned":
            outputs = model.outputs_for(drift)
        else:
            outputs = frequency_outputs(drift, capacity)
        outputs_s = time.perf_counter() - t0
        n_outputs = path_launches()
        count(n_outputs)
        ops.reset_launches()  # the serve's count: refreshes included
        if arm == "learned":
            model.finetune = timed(model.finetune, "finetune")
            model.outputs_for = timed(model.outputs_for, "outputs_for")
        t0 = time.perf_counter()
        res = serve_trace(cfg, params, drift, capacity, "recmg", outputs,
                          batch_queries=adapt_queries, device="cuda",
                          async_prefetch=True, adapt=True,
                          adapt_cfg=adapt_cfg,
                          model=model if arm == "learned" else None,
                          collect_logits=True)
        serve_s = time.perf_counter() - t0
        if arm == "learned":
            del model.finetune, model.outputs_for
        n = path_launches()
        count(n)
        d = res["drift"]
        require(d["refreshes"] > 0, f"runtime_serve (adapt, {arm}): no "
                                    "refresh")
        if arm == "learned":
            require(d["finetunes"] > 0 and n["lstm_cell"] > 0,
                    "runtime_serve (adapt, learned): no fine-tune or no "
                    "lstm_cell launch")
        require(np.isfinite(res["logits"]).all(),
                f"runtime_serve (adapt, {arm}): logits not finite")
        emit({"phase": "runtime_serve", "run": f"adapt, {arm}, fp32 recmg",
              "workload": "diurnal, n_phases=3, 3 batches of "
                          f"{adapt_queries} queries",
              **runtime_report(res), "drift": d,
              "seconds": {"outputs_before_serve_s": round(outputs_s, 3),
                          "serve_s": round(serve_s, 3),
                          **({"refresh_finetune_s": refresh_s["finetune"],
                              "refresh_outputs_for_s":
                                  refresh_s["outputs_for"]}
                             if arm == "learned" else {})},
              "launches_outputs_before_serve": n_outputs, "launches": n})
    del drift

    ops.reset_launches()
    res = cli_main(["--policy", "recmg", "--model", "frequency",
                    "--workload", "zipf_hot", "--async-prefetch"])
    n = path_launches()
    count(n)
    require(res["hits"] + res["misses"] == res["lookups"] > 0
            and n["gather_rows_expand"] > 0,
            "runtime_serve (--workload zipf_hot): bad result")
    emit({"phase": "runtime_serve", "run": "cli --workload zipf_hot "
          "--async-prefetch (reduced config)", **runtime_report(res),
          "launches": n})
    del params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Phases 9''' and 9'''': the sharded multi-worker store with faults; the
# transformer prefetch backbone.
# ---------------------------------------------------------------------------

SHARD_KEYS = ("n_shards", "placement", "per_shard_rows", "per_shard_capacity",
              "per_shard_lookups", "per_shard_hit_rate",
              "per_shard_evictions", "load_imbalance", "max_batch_imbalance",
              "modeled_fetch_ms_sum", "modeled_fetch_ms_critical")
GOLDEN_SHARDED = (Path(__file__).resolve().parent / "tests" / "golden"
                  / "serve_lru_sharded_table2.json")
SHARDED_PATH = ("gather_rows_expand", "gather_rows_dequant_expand",
                "quantize_scatter")


def shard_report(res):
    sh = res["shard"]
    return {"p50_batch_ms": res["p50_batch_ms"],
            "hit_rate": res["hit_rate"],
            "on_demand_rows": res["on_demand_rows"],
            "load_imbalance": sh["load_imbalance"],
            "max_batch_imbalance": sh["max_batch_imbalance"],
            "modeled_fetch_ms_critical": sh["modeled_fetch_ms_critical"],
            "modeled_fetch_ms_sum": sh["modeled_fetch_ms_sum"],
            "per_shard_lookups": sh["per_shard_lookups"],
            "per_shard_capacity": sh["per_shard_capacity"]}


def phase_sharded_parity():
    """The golden fixture through the sharded store on the CPU and on the
    card: 2 and 4 shards, the four placements, fp32 ``lru`` and ``recmg``
    (frequency model) and int8 ``lru``.  Counters, shard telemetry and
    logits (rtol/atol 1e-4) must agree, and the CPU's 2-shard ``table``
    counters must equal ``tests/golden/serve_lru_sharded_table2.json``.
    Then ``replay_chaos`` under each of ``chaos_sweep``'s five plans on both
    devices: the same fates, and 0 wrong rows on the card."""
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    cap = int(0.15 * trace.unique_count())
    params = init_dlrm(cfg, seed=0, device="cpu")
    freq = frequency_outputs(trace, cap)
    golden = json.loads(GOLDEN_SHARDED.read_text())
    t0 = time.perf_counter()
    n_runs = 0
    for shards in (2, 4):
        for placement in ("table", "row", "hash", "freq"):
            for rows, policy, kw in (("fp32", "lru", {}),
                                     ("fp32", "recmg", {}),
                                     ("int8", "lru",
                                      dict(quantize=True,
                                           row_format="int8"))):
                res = {dev: serve_trace(
                    cfg, to_device(params, dev), trace, cap, policy,
                    freq if policy == "recmg" else None, batch_queries=8,
                    shards=shards, placement=placement, device=dev,
                    collect_logits=True, **kw) for dev in ("cpu", "cuda")}
                n_runs += 2
                cpu, card = res["cpu"], res["cuda"]
                what = f"({shards} shards, {placement}, {rows} {policy})"
                diff = {k: (cpu[k], card[k]) for k in SERVE_KEYS
                        if cpu[k] != card[k]}
                require(not diff, f"sharded counters differ CPU vs card "
                                  f"{what}: {diff}")
                require(cpu["shard"] == card["shard"],
                        f"shard telemetry differs CPU vs card {what}")
                err = float(np.abs(cpu["logits"] - card["logits"]).max())
                require(np.allclose(card["logits"], cpu["logits"],
                                    rtol=1e-4, atol=1e-4),
                        f"sharded logits differ CPU vs card {what}: {err}")
                if (shards, placement, rows, policy) == (2, "table", "fp32",
                                                         "lru"):
                    got = {k: cpu[k] for k in golden if k != "shard"}
                    got["shard"] = {k: cpu["shard"][k] for k in SHARD_KEYS}
                    require(got == golden, "sharded CPU counters differ "
                                           f"from {GOLDEN_SHARDED.name}")
    emit({"phase": "sharded_parity", "serve_runs": n_runs,
          "counters_equal": True, "shard_telemetry_equal": True,
          "golden_equal": True,
          "seconds": round(time.perf_counter() - t0, 1)})
    spec = make_spec("shard_failure", n_accesses=10_240, n_tables=4,
                     rows_per_table=256)
    t0 = time.perf_counter()
    sweeps = {dev: chaos_sweep(spec=spec, batch=128, shards=4, device=dev)
              for dev in ("cpu", "cuda")}
    for plan, card in sweeps["cuda"].items():
        cpu = sweeps["cpu"][plan]
        diff = {k: (cpu[k], card[k]) for k in cpu
                if k != "metrics" and cpu[k] != card[k]}
        require(not diff, f"chaos ({plan or 'clean'}) differs CPU vs card: "
                          f"{diff}")
        require(card["wrong_rows"] == 0,
                f"chaos ({plan or 'clean'}): {card['wrong_rows']} wrong rows")
        emit({"phase": "sharded_parity", "chaos_plan": plan or "clean",
              "fates_equal_cpu": True,
              **{k: card[k] for k in CHAOS_KEYS},
              "zero_default_rows": card["zero_default_rows"],
              "exact_rows": card["exact_rows"]})
    emit({"phase": "sharded_parity", "chaos_seconds":
          round(time.perf_counter() - t0, 1)})


def phase_sharded_serve(cfg, trace, host, capacity, qcapacity,
                        batch_queries, baseline):
    """The sharded store at the serve width: 4 shards, ``placement=freq``,
    fp32 ``lru`` and int8 ``lru``; fp32 ``lru`` with shard 1 killed at mid-
    run and recovered at 75% and the hottest 5% of the vectors replicated;
    then the inline pipelined runtime at depth 2 over the fp32 sharded
    store, whose counters must equal the synchronous run's.  Counts are set
    to 0 just before each run and read just after.  Returns the store
    kernels' launches summed over the runs."""
    params = init_dlrm(cfg, seed=0, device="cuda")
    int8 = dict(quantize=True, row_format="int8")
    rep = int(0.05 * int(trace.rows_per_table.sum()))
    faults = "kill:1@mid,recover:1@75%"
    total = {}
    runs = [("fp32", capacity, {}),
            ("int8", qcapacity, int8),
            ("fp32 faults", capacity,
             dict(fault_plan=faults, replicate_hot=rep)),
            ("fp32 pipelined depth 2", capacity,
             dict(async_prefetch=True, pipeline_depth=2))]
    sync = None
    for arm, cap, kw in runs:
        ops.reset_launches()
        t0 = time.perf_counter()
        res = serve_trace(cfg, params, trace, cap, "lru", None,
                          batch_queries=batch_queries, shards=4,
                          placement="freq", device="cuda",
                          collect_logits=True, host=host, **kw)
        seconds = time.perf_counter() - t0
        n = {fn.__name__: fn.launches for fn in ops.KERNELS
             if fn.__name__ in SHARDED_PATH}
        path = (("quantize_scatter", "gather_rows_dequant_expand")
                if kw.get("quantize") else ("gather_rows_expand",))
        for name in path:
            require(n[name] > 0, f"sharded_serve ({arm}) launched {name} "
                                 "0 times")
        for name, k in n.items():
            total[name] = total.get(name, 0) + k
        lg = res["logits"]
        sh = res["shard"]
        # Ids of a dead shard are routed (and counted in its load) but
        # answered by the failover layer, not looked up in its store.
        routed = res["ft"]["served"] if "fault_plan" in kw \
            else res["lookups"]
        require(lg.shape == (res["batches"], batch_queries)
                and np.isfinite(lg).all()
                and res["hits"] + res["misses"] == res["lookups"]
                and sum(sh["per_shard_lookups"]) == routed,
                f"sharded_serve ({arm}): bad result")
        require(sh["modeled_fetch_ms_critical"]
                <= sh["modeled_fetch_ms_sum"],
                f"sharded_serve ({arm}): critical path above the sum")
        extra = {}
        if arm == "fp32":
            sync = res
            single = baseline[("fp32", "lru")]
            extra["single_store"] = {k: single[k] for k in
                                     ("hit_rate", "on_demand_rows",
                                      "p50_batch_ms")}
        if "fault_plan" in kw:
            ft = res["ft"]
            require(ft["kills"] == 1 and ft["recoveries"] == 1
                    and ft["served"] == ft["primary"]
                    + ft["failover_replica"] + ft["failover_degraded"]
                    and ft["failover_replica"] > 0,
                    f"sharded_serve ({arm}): ft fates {ft}")
            extra.update(ft=ft, replicated_rows=rep, fault_plan=faults)
        if kw.get("async_prefetch"):
            diff = {k: (sync[k], res[k]) for k in RUNTIME_COUNTERS
                    if sync[k] != res[k]}
            require(not diff, f"sharded_serve ({arm}): counters differ "
                              f"from the synchronous run: {diff}")
            rt = res["runtime"]
            require(rt["stall_ms"] < rt["demand_fetch_ms"],
                    f"sharded_serve ({arm}): stall not below demand fetch")
            extra.update(counters_equal_sync=True, stall_ms=rt["stall_ms"],
                         demand_fetch_ms=rt["demand_fetch_ms"])
        emit({"phase": "sharded_serve", "arm": arm, "shards": 4,
              "placement": "freq", "capacity": cap,
              "batch_queries": batch_queries,
              "ids_per_batch": batch_queries * cfg.n_tables * cfg.multi_hot,
              **shard_report(res), **extra,
              "serve_s": round(seconds, 3), "launches": n})
        del res
    del params, sync
    torch.cuda.empty_cache()
    return total


def phase_transfetch(trace, per_batch):
    """The TransFetch-class transformer backbone of the prefetch model,
    trained on the card as phase ``learned_serve`` trains the LSTM one (the
    CLI's widths, 1 epoch on the first of the 6 serve batches): its
    ``dec2`` runs ``lstm_cell`` and its loss ``chamfer``.  Counts are set
    to 0 just before the training and read just after.  Then, from the
    same parameters, the predicted points of the first 4,096 windows on
    the card and on the CPU agree within fp32 abs 1e-5 (TF32 off).
    Returns the two kernels' launches."""
    lcfg = cli_learned_config(1)
    pcfg = PM.PrefetchModelConfig(n_tables=trace.n_tables,
                                  hidden=lcfg.hidden, in_len=lcfg.in_len,
                                  out_len=lcfg.out_len,
                                  backbone="transformer")
    t0 = time.perf_counter()
    pdata = PM.make_prefetch_data(trace.slice(0, per_batch),
                                  in_len=lcfg.in_len,
                                  stride=lcfg.train_stride)
    data_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    model, losses = PM.train_prefetch_model(
        pdata, pcfg, epochs=1, batch_size=lcfg.batch_size, lr=lcfg.lr,
        seed=lcfg.seed, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n = {fn.__name__: fn.launches for fn in ops.KERNELS
         if fn.__name__ in ("lstm_cell", "chamfer")}
    for name, k in n.items():
        require(k > 0, f"transfetch training launched {name} 0 times")
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"transfetch: losses {losses[0]} -> {losses[-1]}")
    windows = pdata.base.batch(np.arange(min(4096, len(pdata))))
    t0 = time.perf_counter()
    card = PM.predict_sequences(model, pcfg, windows, batch_size=4096)
    predict_s = time.perf_counter() - t0
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu = PM.predict_sequences(cpu_model, pcfg, windows, batch_size=4096)
    err = float(np.abs(card - cpu).max())
    require(np.isfinite(card).all() and err <= 1e-5,
            f"transfetch: card vs CPU points differ by {err}")
    emit({"phase": "transfetch", "backbone": "transformer",
          "cuts": {"train_batches": "first 1 of 6 (2 of 8 before)",
                   "epochs": 1,
                   "stride": lcfg.train_stride},
          "windows": len(pdata), "steps": len(losses),
          "loss_first_last": [losses[0], losses[-1]],
          "seconds": {"data_s": round(data_s, 3),
                      "train_s": round(train_s, 3),
                      "predict_4096_s": round(predict_s, 3)},
          "points_max_abs_err_card_vs_cpu": err, "launches": n})
    del model, cpu_model
    torch.cuda.empty_cache()
    return n


# ---------------------------------------------------------------------------
# Phases 10-12: dense-LM serving (flash_attention, tiered vocab rows).
# ---------------------------------------------------------------------------

def phase_flash_kernels(timer):
    """``flash_attention`` against its plain version at ``FLASH_SHAPES``,
    each timed beside its bound and beside SDPA.  Returns the record of
    the serve prefill shape."""
    main = None
    for name, b, s, h, n_kv, hd, dt_name in FLASH_SHAPES:
        dt = DTYPES[dt_name]
        g = torch.Generator(device="cuda").manual_seed(s + hd)
        q, k, v = (torch.randn((b, s, n, hd), generator=g, device="cuda")
                   .to(dt) for n in (h, n_kv, n_kv))
        got = fa.flash_attention(q, k, v)
        want, lse_want = ref.causal_attention_lse_ref(q, k, v)
        # The training forward: the same bits, and each row's log-sum-exp.
        o_lse, lse = fa.flash_attention(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ulps = bf16_ulps(got, want) if dt_name == "bf16" else None
        tol = 1e-5 if dt_name == "fp32" else 1e-2
        require(torch.allclose(got.float(), want.float(), rtol=tol,
                               atol=tol),
                f"flash_attention {name} {dt_name}: max abs err {err}")
        bits_equal = bool(torch.equal(o_lse, got))
        lse_err = float((lse - lse_want).abs().max())
        require(bits_equal, f"flash_attention {name} {dt_name}: the output "
                "changes when the kernel also writes the log-sum-exp")
        require(torch.allclose(lse, lse_want, rtol=1e-5, atol=1e-5),
                f"flash_attention {name} {dt_name}: lse max abs err "
                f"{lse_err}")
        del got, want, o_lse, lse, lse_want
        # SDPA takes (B, H, S, hd): transposed once, outside the timing.
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float()
                         - ref.causal_attention_ref(q, k, v).float())
                        .abs().max())
        rec = {"phase": "kernel", "name": "flash_attention", "shape": name,
               "dtype": dt_name, "B": b, "S": s, "H": h, "K": n_kv, "hd": hd,
               "max_abs_err": err, "tolerance": tol,
               **({"max_err_bf16_ulps": ulps} if ulps is not None else {}),
               "o_bits_equal_without_lse": bits_equal,
               "lse_max_abs_err_vs_logsumexp": lse_err,
               "design": FLASH_DESIGN[dt_name],
               "library_max_abs_err": lib_err,
               "ms": timer(lambda: fa.flash_attention(q, k, v)),
               "plain_ms": timer(lambda: ref.causal_attention_ref(q, k, v)),
               "library_ms": timer(sdpa)}
        # Causal work: 2 products of 2 hd over the S (S + 1) / 2 visible
        # pairs of each (batch, head); q, k, v read once, o written once.
        work = W.flash_attention(b, s, s, h, n_kv, hd, q.element_size())
        rec["bound_ms"], rec["bound_by"] = work_bound(work)
        achieved(rec, work.ops)
        emit(rec)
        if main is None:
            main = rec
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return main


def scan_inputs(b, s, di, n, dt):
    """The scan's inputs at a prefill layer's shape and the model's scales:
    x and z normal in the compute dtype, dt = softplus(normal - 2) (the
    init's dt_bias), a = -(1 .. N) per channel (``-exp(A_log)`` of
    ``init_mamba``), Bm and Cm normal, D ones."""
    g = torch.Generator(device="cuda").manual_seed(di + n + s)
    xc, z = (torch.randn((b, s, di), generator=g, device="cuda").to(dt)
             for _ in range(2))
    dtv = torch.nn.functional.softplus(
        torch.randn((b, s, di), generator=g, device="cuda") - 2.0)
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").repeat(di, 1)
    bm, cm = (torch.randn((b, s, n), generator=g, device="cuda")
              for _ in range(2))
    return xc, z, dtv, a, bm, cm, torch.ones(di, device="cuda")


def scan_bound(b, s, di, n, elt):
    """The scan's bound from its work (:func:`repro_torch.kernels.work.
    selective_scan`)."""
    return work_bound(W.selective_scan(b, s, di, n, elt))


def sm_clock_max_mhz() -> float:
    """The SM clock's maximum, MHz (``nvidia-smi``'s ``clocks.max.sm``)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def scan_errors(dt_name, got, want):
    """(y's and h_last's largest errors and largest magnitudes, whether
    both are within the kernel's tolerances): fp32 y within 1e-5 of its
    largest magnitude, bf16 y within 1e-2 (one bf16 rounding of nearly the
    same fp32 value), h_last (fp32) within 1e-5."""
    (y, h), (wy, wh) = got, want
    tol = 1e-5 if dt_name == "fp32" else 1e-2
    y_err = float((y.float() - wy.float()).abs().max())
    y_scale = float(wy.float().abs().max())
    h_err = float((h - wh).abs().max())
    h_scale = float(wh.abs().max())
    return (y_err, y_scale, h_err, h_scale,
            y_err <= tol * y_scale and h_err <= 1e-5 * h_scale)


def scan_rec(timer, plain_timer, name, b, s, di, n, dt_name, scan_ptxas,
             n_sm, mhz):
    """``selective_scan`` at (b, s, di, n) in ``dt_name`` against its plain
    version, timed beside its byte bound and its SFU floor, with its
    launch geometry and registers; emits and returns the record."""
    dt = DTYPES[dt_name]
    ins = scan_inputs(b, s, di, n, dt)
    wy, wh = ref.selective_scan_ref(*ins)
    y_err, y_scale, h_err, h_scale, ok = scan_errors(
        dt_name, ss.selective_scan(*ins), (wy, wh))
    torch.cuda.synchronize()
    require(ok, f"selective_scan {name} {dt_name}: y err {y_err} (of "
                f"{y_scale}), h err {h_err} (of {h_scale})")
    del wy, wh
    geo = ss.geometry(n, dt)
    blocks = -(-di // geo["channels"]) * b
    ptx = scan_ptxas.get(
        f"selective_scan_kernel<{'bf16' if dt_name == 'bf16' else 'float'}"
        f",{n},0>", {})
    # The SFU's 2^x per state and the gate's 2^x and 1/x, per (b, t, d).
    sfu_ops = (n + 2) * b * s * di
    rec = {"phase": "kernel", "name": "selective_scan", "shape": name,
           "dtype": dt_name, "B": b, "S": s, "Di": di, "N": n,
           "max_abs_err": y_err, "max_abs_y": y_scale,
           "tolerance_share_of_largest": 1e-5 if dt_name == "fp32"
           else 1e-2,
           "h_last_max_abs_err": h_err, "max_abs_h": h_scale,
           "design": SCAN_DESIGN,
           "threads_per_block": geo["threads"],
           "channels_per_block": geo["channels"], "blocks": blocks,
           "blocks_per_sm": blocks / n_sm,
           "max_blocks_per_sm": geo["blocks_per_sm"],
           "waves": blocks / (n_sm * geo["blocks_per_sm"]),
           "warps_per_sm": min(blocks / n_sm, geo["blocks_per_sm"])
           * geo["threads"] / 32,
           "registers": ptx.get("registers"),
           "spill_store_bytes": ptx.get("spill_store_bytes"),
           "spill_load_bytes": ptx.get("spill_load_bytes"),
           "ms": timer(lambda: ss.selective_scan(*ins)),
           "earlier_ms": SCAN_FIRST_DESIGN_MS.get((name, dt_name)),
           "earlier_from": "a constant of this script: the first "
                           "design's ms, not measured in this run",
           "plain_ms": plain_timer(lambda: ref.selective_scan_ref(*ins)),
           "library_ms": None,
           "library": "none: no PyTorch call computes a selective scan",
           "sfu_ops": sfu_ops, "sm_clock_max_mhz": mhz,
           "sfu_floor_ms": sfu_ops / (SFU_OPS_PER_SM_CLOCK * n_sm
                                      * mhz * 1e6) * 1e3}
    rec["bound_ms"], rec["bound_by"] = scan_bound(
        b, s, di, n, torch.empty((), dtype=dt).element_size())
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["sfu_floor_share"] = rec["sfu_floor_ms"] / rec["ms"]
    emit(rec)
    del ins
    torch.cuda.empty_cache()
    return rec


def phase_ssm_kernels(timer, scan_ptxas):
    """``selective_scan`` against its plain version at ``SCAN_SHAPES``, each
    timed beside its byte bound and its SFU floor (no PyTorch call
    computes the scan), its first design's time (``SCAN_FIRST_DESIGN_MS``), its
    launch geometry and registers; then the windowed ``flash_attention`` at hymba-1.5b's
    prefill against its plain version and SDPA with a band mask, beside the
    same shape unwindowed, and a window of S or more against no window at
    the LM serve prefill's shape and at hymba's (bit-equal).  Returns (the
    record of falcon's bf16 layer, the windowed attention's record)."""
    plain_timer = Timer(reps=2)  # the plain scan: ~10 launches a step
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_max_mhz()
    main = None
    for name, b, s, di, n, dt_name in SCAN_SHAPES:
        rec = scan_rec(timer, plain_timer, name, b, s, di, n, dt_name,
                       scan_ptxas, n_sm, mhz)
        if main is None:
            main = rec
    return main, window_attention(timer)


def window_attention(timer):
    b, s, h, n_kv, hd, w = WINDOW_SHAPE
    g = torch.Generator(device="cuda").manual_seed(s + w)
    q, k, v = (torch.randn((b, s, n, hd), generator=g, device="cuda")
               .to(torch.bfloat16) for n in (h, n_kv, n_kv))
    got = fa.flash_attention(q, k, v, window=w)
    want, lse_want = ref.causal_attention_lse_ref(q, k, v, w)
    o_lse, lse = fa.flash_attention(q, k, v, with_lse=True, window=w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    require(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
            f"flash_attention window {w}: max abs err {err}")
    require(torch.equal(o_lse, got), "flash_attention window: the output "
            "changes when the kernel also writes the log-sum-exp")
    lse_err = float((lse - lse_want).abs().max())
    require(torch.allclose(lse, lse_want, rtol=1e-5, atol=1e-5),
            f"flash_attention window: lse max abs err {lse_err}")
    ulps = bf16_ulps(got, want)
    del want, lse_want, o_lse, lse
    # The library: SDPA with an explicit boolean band mask (no call takes a
    # window), the KV heads repeated to H outside the timing.
    g_ = h // n_kv
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(g_, dim=1).contiguous()
              for t in (k, v))
    band = torch.ones((s, s), dtype=torch.bool, device="cuda").tril().triu(
        1 - w)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band)
    lib_err = float((sdpa().transpose(1, 2).float() - got.float())
                    .abs().max())
    rec = {"phase": "kernel", "name": "flash_attention", "shape":
           "hymba_prefill_window", "dtype": "bf16", "B": b, "S": s, "H": h,
           "K": n_kv, "hd": hd, "window": w, "max_abs_err": err,
           "tolerance": 1e-2, "max_err_bf16_ulps": ulps,
           "o_bits_equal_without_lse": True,
           "lse_max_abs_err_vs_logsumexp": lse_err,
           "design": FLASH_DESIGN["bf16"] + "; KV walk from the window's "
           "edge, edge tiles masked",
           "library": "SDPA with an explicit boolean band mask, KV heads "
                      "repeated outside the timing",
           "library_max_abs_err_vs_kernel": lib_err,
           "ms": timer(lambda: fa.flash_attention(q, k, v, window=w)),
           "causal_ms": timer(lambda: fa.flash_attention(q, k, v)),
           "plain_ms": timer(lambda: ref.causal_attention_ref(q, k, v, w)),
           "library_ms": timer(sdpa)}
    del qt, kt, vt, band
    rec["windowed_over_causal"] = rec["ms"] / rec["causal_ms"]
    # Work inside the window: query i sees min(i + 1, w) keys.
    work = W.flash_attention(b, s, s, h, n_kv, hd, 2, window=w)
    rec["bound_ms"], rec["bound_by"] = work_bound(work)
    rec["causal_bound_ms"] = bound_ms(0, W.flash_attention(
        b, s, s, h, n_kv, hd, 2).ops, BF16_OPS_PER_S)[0]
    achieved(rec, work.ops)
    # A window of S or more masks no key: the causal kernel's bits.
    same = {}
    for name, shape in (("hymba_prefill", (b, s, h, n_kv)),
                        ("serve_prefill", (8, 2048, 9, 3))):
        bb, ss_, hh, kk = shape
        if name == "serve_prefill":
            q, k, v = (torch.randn((bb, ss_, n, hd), generator=g,
                                   device="cuda").to(torch.bfloat16)
                       for n in (hh, kk, kk))
        causal = fa.flash_attention(q, k, v)
        same[name] = all(torch.equal(fa.flash_attention(q, k, v, window=x),
                                     causal) for x in (ss_, 10 ** 12))
    require(all(same.values()), f"flash_attention: a window >= S changes "
            f"the causal bits {same}")
    rec["window_at_or_above_s_bit_equal_causal"] = same
    emit(rec)
    del q, k, v, got
    torch.cuda.empty_cache()
    return rec


def scan_bwd_bound(b, s, di, n, elt):
    """The backward's bound from its work (:func:`repro_torch.kernels.work.
    selective_scan_bwd`: the function's own traffic; the states the forward
    saves are this design's checkpoint, which
    :func:`scan_bwd_state_bytes` counts apart)."""
    return work_bound(W.selective_scan_bwd(b, s, di, n, elt))


def scan_bwd_state_bytes(b, s, di, n):
    """The bytes of the states the saving forward writes and the backward
    reads (fp32, one every chunk of steps): the design's, outside the
    bound."""
    return 4 * ss.n_chunks(s) * b * di * n


def scan_bwd_partial_bytes(b, s, di, n, channels):
    """The bytes of the backward's per-block partials, each written by the
    kernel and read by the wrapper's sum (fp32): dB and dC (ceil(Di /
    channels), B, S, 2 N), da (B, Di, N) and dD (B, Di).  The design's,
    outside the bound."""
    return 2 * 4 * (-(-di // channels) * b * s * 2 * n + b * di * n
                    + b * di)


SCAN_BWD_NAMES = ("dx", "dz", "ddt", "da", "dbm", "dcm", "dd", "dh0")


def scan_bwd_rec(timer, name, b, s, di, n, dt_name, ptxas, n_sm, mhz):
    """``selective_scan_bwd`` at (b, s, di, n) in ``dt_name`` against its
    plain version, as :func:`phase_scan_bwd_kernels` holds it; emits and
    returns the record."""
    dt = DTYPES[dt_name]
    xc, z, dtv, a, bm, cm, d_skip = scan_inputs(b, s, di, n, dt)
    dtv[:, ::7] = 0.0  # identity steps
    g = torch.Generator(device="cuda").manual_seed(di + s + 1)
    h0, dh_last = (torch.randn((b, di, n), generator=g, device="cuda")
                   for _ in range(2))
    dy = torch.randn((b, s, di), generator=g, device="cuda").to(dt)
    ins = (xc, z, dtv, a, bm, cm, d_skip)
    y, h_last, states = ss.selective_scan(*ins, h0, save_states=True)
    y_serve, h_serve = ss.selective_scan(*ins, h0)
    require(torch.equal(y, y_serve) and torch.equal(h_last, h_serve),
            f"selective_scan {name} {dt_name}: saving states changes "
            "the forward's bits")
    require(torch.equal(states[:, 0], h0), f"selective_scan {name}: "
            "the first saved state is not h0")
    del y, h_last, y_serve, h_serve
    got = ss.selective_scan_bwd(*ins, states, dy, dh_last)
    again = ss.selective_scan_bwd(*ins, states, dy, dh_last)
    same = all(torch.equal(u, v) for u, v in zip(got, again))
    del again
    torch.cuda.synchronize()
    s_ev, e_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s_ev.record()
    want = ref.selective_scan_bwd_ref(*ins, h0, dy, dh_last)
    e_ev.record()
    torch.cuda.synchronize()
    plain_ms = s_ev.elapsed_time(e_ev)
    require(same, f"selective_scan_bwd {name} {dt_name}: two calls "
            "give different bits")
    errs, shares, tols = {}, {}, {}
    for gname, u, w in zip(SCAN_BWD_NAMES, got, want):
        require(u.dtype == w.dtype and u.shape == w.shape,
                f"selective_scan_bwd {name} {gname}: {u.dtype} "
                f"{tuple(u.shape)} vs {w.dtype} {tuple(w.shape)}")
        errs[gname] = float((u.float() - w.float()).abs().max())
        shares[gname] = errs[gname] / max(float(w.float().abs().max()),
                                          1e-30)
        tols[gname] = 1e-2 if (dt_name == "bf16"
                               and gname in ("dx", "dz")) else 1e-4
    require(all(shares[k] <= tols[k] for k in shares),
            f"selective_scan_bwd {name} {dt_name}: error / largest "
            f"gradient {shares} (tolerances {tols})")
    del got, want
    ptx = ptxas.get(f"selective_scan_bwd_kernel<"
                    f"{'bf16' if dt_name == 'bf16' else 'float'},{n}>",
                    {})
    sfu_ops = (n + 2) * b * s * di
    # The kernel's own: N exponentials to recompute the tile's states,
    # N to walk them back, and the gate's two once per (b, t, d) (the
    # lane that owns the step computes its gate).
    kernel_sfu_ops = (2 * n + 2) * b * s * di
    geo = ss.bwd_geometry(n, dt)
    blocks = -(-di // geo["channels"]) * b
    rec = {"phase": "kernel", "name": "selective_scan_bwd",
           "shape": name, "dtype": dt_name, "B": b, "S": s, "Di": di,
           "N": n, "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs,
           "err_share_of_largest": shares, "tolerance": tols,
           "two_calls_bit_equal": True,
           "forward_bits_equal_with_states": True,
           "dt_zero_every": 7, "h0_and_dh_last_given": True,
           "design": SCAN_BWD_DESIGN,
           "threads_per_block": geo["threads"],
           "channels_per_block": geo["channels"], "blocks": blocks,
           "blocks_per_sm": blocks / n_sm,
           "max_blocks_per_sm": geo["blocks_per_sm"],
           "waves": blocks / (n_sm * geo["blocks_per_sm"]),
           "warps_per_sm": min(blocks / n_sm, geo["blocks_per_sm"])
           * geo["threads"] / 32,
           "registers": ptx.get("registers"),
           "spill_store_bytes": ptx.get("spill_store_bytes"),
           "spill_load_bytes": ptx.get("spill_load_bytes"),
           "ms": timer(lambda: ss.selective_scan_bwd(*ins, states, dy,
                                                     dh_last)),
           "ms_includes": "the kernel and the wrapper's torch.sum of "
                          "the partials",
           "plain_ms": plain_ms,
           "plain_timing": "its one call, between CUDA events",
           "library_ms": None,
           "library": "none: no PyTorch call computes a selective "
                      "scan's backward",
           "sfu_ops": sfu_ops, "kernel_sfu_ops": kernel_sfu_ops,
           "sm_clock_max_mhz": mhz,
           "sfu_floor_ms": sfu_ops / (SFU_OPS_PER_SM_CLOCK * n_sm
                                      * mhz * 1e6) * 1e3,
           "kernel_sfu_floor_ms": kernel_sfu_ops / (
               SFU_OPS_PER_SM_CLOCK * n_sm * mhz * 1e6) * 1e3}
    rec["bound_ms"], rec["bound_by"] = scan_bwd_bound(
        b, s, di, n, torch.empty((), dtype=dt).element_size())
    rec["design_bytes_by"] = {
        "states": scan_bwd_state_bytes(b, s, di, n),
        "partials": scan_bwd_partial_bytes(b, s, di, n,
                                           geo["channels"])}
    rec["design_bytes"] = sum(rec["design_bytes_by"].values())
    rec["design_bytes_are"] = ("the saved states the backward reads "
                               "and its per-block partials, written "
                               "and read back by the wrapper's sum; "
                               "not in bound_ms")
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["sfu_floor_share"] = rec["sfu_floor_ms"] / rec["ms"]
    rec["kernel_sfu_floor_share"] = rec["kernel_sfu_floor_ms"] / rec["ms"]
    emit(rec)
    del ins, xc, z, dtv, states, dy, h0, dh_last
    torch.cuda.empty_cache()
    return rec


def phase_scan_bwd_kernels(timer, ptxas):
    """``selective_scan_bwd`` against its plain version at
    ``SCAN_BWD_SHAPES`` (falcon-mamba-7b's and hymba-1.5b's training
    microbatch, bf16 and fp32), from an h0 and a dh_last, with dt = 0 on
    every seventh step: every gradient within 1e-4 of its largest
    magnitude (dx and dz at bf16 within 1e-2: one bf16 rounding); a second
    call gives the same bits; the forward's y and h_last have the same
    bits with and without saving states.  Each timed beside its byte bound,
    its SFU floor as the forward's is reckoned (N + 2 a (b, t, d); the
    kernel takes N more to recompute the states) and the plain version,
    with its registers and spills (no PyTorch call computes the scan's
    backward), with its launch geometry from the occupancy calculator.  The plain version is timed on its one call (~1.5 s, some
    50,000 launches).  Returns the record of falcon's bf16 shape."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_max_mhz()
    main = None
    for name, b, s, di, n, dt_name in SCAN_BWD_SHAPES:
        rec = scan_bwd_rec(timer, name, b, s, di, n, dt_name, ptxas, n_sm,
                           mhz)
        if main is None:
            main = rec
    return main


def phase_lm_parity():
    """Full-width smollm-135m from the same parameters on both devices: a
    B=2, S=256 prefill and 8 teacher-forced decode steps, fp32 and bf16."""
    full = get_config("smollm-135m")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, full.vocab, (2, 256 + 8)))
    cfg32 = dataclasses.replace(full, param_dtype="float32",
                                compute_dtype="float32")
    base = init_lm(cfg32, seed=0, device="cpu")
    out = {}
    for dt_name, tol in (("fp32", 1e-4), ("bf16", 5e-2)):
        cfg = cfg32 if dt_name == "fp32" else full
        cpu = base if dt_name == "fp32" else copy.deepcopy(base).to(
            torch.bfloat16)
        logits = {}
        for dev, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to(
                "cuda"))):
            ops.reset_launches()
            lg, cache = prefill(model, cfg, tokens[:, :256].to(dev),
                                cache_len=256 + 8)
            steps = [lg]
            for i in range(8):
                lg, cache = decode_step(model, cfg,
                                        tokens[:, 256 + i:257 + i].to(dev),
                                        cache)
                steps.append(lg)
            logits[dev] = torch.stack(steps).cpu()
            if dev == "cuda":
                require(fa.flash_attention.launches == full.n_layers,
                        f"lm_parity {dt_name}: {fa.flash_attention.launches}"
                        f" flash_attention launches, expected "
                        f"{full.n_layers}")
            del model, cache
        diff = (logits["cuda"] - logits["cpu"]).abs()
        out[dt_name] = {"max_abs_err": float(diff.max()), "tolerance": tol,
                        # The largest |diff| / (atol + rtol |cpu|): the
                        # share of its bound the worst logit uses.
                        "worst_share_of_bound": float(
                            (diff / (tol + tol * logits["cpu"].abs()))
                            .max()),
                        "max_abs_logit": float(logits["cpu"].abs().max()),
                        "argmax_equal_share": float(
                            (logits["cuda"].argmax(-1)
                             == logits["cpu"].argmax(-1)).float().mean())}
        require(bool(torch.isfinite(logits["cuda"]).all()),
                f"lm_parity {dt_name}: non-finite logits on the card")
        require(torch.allclose(logits["cuda"], logits["cpu"], rtol=tol,
                               atol=tol),
                f"lm_parity {dt_name}: card vs CPU logits {out[dt_name]}")
    emit({"phase": "lm_parity", "arch": full.name, "B": 2, "S": 256,
          "decode_steps": 8, "teacher_forced": True, **out})
    torch.cuda.empty_cache()


class _RoutingRecorder:
    """Within the block, every MoE routing call records, in call order and
    on the host, its fp32 router probabilities, its top-K experts and, on
    the capacity path, its keep mask (one record a layer of a prefill or
    decode step).  Given ``forced`` (another run's records, in the same
    call order), each call takes that run's experts in place of its own
    top-K, weighted by its own renormalised probabilities: the two runs
    then differ by their arithmetic alone, not by near-tied choices."""

    def __init__(self, forced=None):
        self.forced = forced

    def __enter__(self):
        self.records = []
        self._route, self._slots = L._route, L._capacity_slots

        def route(p, cfg, xf):
            probs, top_p, top_e = self._route(p, cfg, xf)
            if self.forced is not None:
                top_e = self.forced[len(self.records)]["top_e"].to(
                    top_e.device)
                top_p = probs.gather(-1, top_e)
                top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
            self.records.append({"probs": probs.detach().cpu(),
                                 "top_e": top_e.cpu(), "keep": None})
            return probs, top_p, top_e

        def slots(flat_e, n_experts, capacity):
            slot, keep = self._slots(flat_e, n_experts, capacity)
            self.records[-1]["keep"] = keep.cpu()
            return slot, keep

        L._route, L._capacity_slots = route, slots
        return self

    def __exit__(self, *exc):
        L._route, L._capacity_slots = self._route, self._slots


def routing_compare(cpu_recs, card_recs, n_rows, top_k, margin,
                    strict=True):
    """The card's routing against the CPU's, record by record in call
    order.  A token's top-K set is "inside the margin" where the CPU's
    K-th and (K+1)-th probabilities differ by ``margin`` or less.  A row
    (a sequence) turns "dirty" once one of its selections differs, since
    the flip changes that row's later inputs.  Returns the counts and the
    rows still clean at the end.  ``strict``: fails on a flip outside the
    margin in a clean row, and on keep masks that differ while no row is
    dirty."""
    dirty = torch.zeros(n_rows, dtype=torch.bool)
    out = {"token_layers": 0, "inside_margin": 0, "flips": 0,
           "flips_inside_margin": 0, "flips_outside_margin_clean_rows": 0,
           "keep_masks_compared": 0, "keep_masks_equal": 0}
    for i, (cpu, card) in enumerate(zip(cpu_recs, card_recs)):
        t = cpu["top_e"].shape[0]
        rows = torch.arange(t) // (t // n_rows)
        ranked = cpu["probs"].sort(dim=-1, descending=True).values
        inside = (ranked[:, top_k - 1] - ranked[:, top_k]) <= margin
        flip = (cpu["top_e"].sort(-1).values
                != card["top_e"].sort(-1).values).any(-1)
        bad = int((flip & ~inside & ~dirty[rows]).sum())
        require(not strict or bad == 0, f"routing record {i}: {bad} top-K "
                f"sets differ outside the {margin} margin in clean rows")
        if cpu["keep"] is not None and not dirty.any() and not flip.any():
            equal = bool(torch.equal(cpu["keep"], card["keep"]))
            require(not strict or equal,
                    f"routing record {i}: keep masks differ")
            out["keep_masks_compared"] += 1
            out["keep_masks_equal"] += int(equal)
        out["token_layers"] += t
        out["inside_margin"] += int(inside.sum())
        out["flips"] += int(flip.sum())
        out["flips_inside_margin"] += int((flip & inside).sum())
        out["flips_outside_margin_clean_rows"] += bad
        dirty[rows[flip]] = True
    out["clean_rows"] = [int(r) for r in torch.nonzero(~dirty)[:, 0]]
    return out


def _cast_params(model, cfg):
    """The model's parameters in ``cfg.param_dtype``, in place, the MoE
    router kept fp32 (as ``init_lm`` draws it)."""
    dt = torch_dtype(cfg.param_dtype)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if not name.endswith("router"):
                prm.data = prm.data.to(dt)
    return model


def _moe_run(model, cfg, tokens, s, n_dec, dev, forced=None):
    """A prefill of ``tokens[:, :s]`` and ``n_dec`` teacher-forced decode
    steps on ``dev`` with the routing recorded (or forced): ``(logits
    (1 + n_dec, B, V) on the host, routing records, seconds)``."""
    t0 = time.perf_counter()
    with _RoutingRecorder(forced) as rec:
        lg, cache = prefill(model, cfg, tokens[:, :s].to(dev),
                            cache_len=s + n_dec)
        steps = [lg]
        for i in range(n_dec):
            lg, cache = decode_step(model, cfg,
                                    tokens[:, s + i:s + i + 1].to(dev), cache)
            steps.append(lg)
    return torch.stack(steps).cpu(), rec.records, time.perf_counter() - t0


def phase_moe_parity():
    """Full-width granite-moe-1b-a400m, its depth cut to
    ``MOE_PARITY_LAYERS`` of 24, from the same seeded parameters on the CPU
    and on the card: a B=2, S=256 prefill and 8 teacher-forced
    decode steps, fp32 then bf16, every layer's routing recorded.  fp32:
    the top-K sets equal outside a 1e-5 margin, the logits of rows whose
    routing never flipped within 1e-4.  bf16 (an ulp of an activation
    moves a router logit by ~1e-2, so near-tied choices flip): the flips
    counted, then the CPU run again with the card's choices forced, its
    logits within 5e-2 of the card's."""
    full = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                               n_layers=MOE_PARITY_LAYERS)
    b, s, n_dec = 2, 256, 8
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, full.vocab, (b, s + n_dec)))
    cfg32 = dataclasses.replace(full, param_dtype="float32",
                                compute_dtype="float32")
    base = init_lm(cfg32, seed=0, device="cpu")
    out = {}
    for dt_name, tol, margin in (("fp32", 1e-4, 1e-5),
                                 ("bf16", 5e-2, 1e-5)):
        cfg = cfg32 if dt_name == "fp32" else full
        cpu = base if dt_name == "fp32" else _cast_params(base, full)
        card = copy.deepcopy(cpu).to("cuda")
        ops.reset_launches()
        card_lg, card_recs, card_s = _moe_run(card, cfg, tokens, s, n_dec,
                                              "cuda")
        require(fa.flash_attention.launches == full.n_layers,
                f"moe_parity {dt_name}: {fa.flash_attention.launches} "
                f"flash_attention launches, expected {full.n_layers}")
        del card
        cpu_lg, cpu_recs, cpu_s = _moe_run(cpu, cfg, tokens, s, n_dec, "cpu")
        require(len(cpu_recs) == len(card_recs)
                == full.n_layers * (1 + n_dec),
                f"moe_parity {dt_name}: {len(cpu_recs)} routing records")
        routing = routing_compare(cpu_recs, card_recs, b, full.top_k, margin,
                                  strict=dt_name == "fp32")
        prefill_keep = torch.stack([r["keep"] for r in card_recs[
            :full.n_layers]]).float()
        rec = {"tolerance": tol, "margin": margin, "routing": routing,
               "dropped_assignment_share_cf_1.25": float(
                   1.0 - prefill_keep.mean()),
               "max_abs_logit": float(cpu_lg.abs().max()),
               "cpu_s": cpu_s, "card_s": card_s}
        if dt_name == "bf16":
            # The CPU again, the card's expert choices forced.
            forced_lg, _, rec["cpu_forced_s"] = _moe_run(
                cpu, cfg, tokens, s, n_dec, "cpu", forced=card_recs)
            rec["max_abs_err_free_routing"] = float(
                (card_lg - cpu_lg).abs().max())
            cpu_lg, clean = forced_lg, list(range(b))
        else:
            clean = routing["clean_rows"]
        diff = (card_lg - cpu_lg).abs()
        rec.update(max_abs_err=float(diff.max()), compared_rows=clean,
                   worst_share_of_bound=float(
                       (diff / (tol + tol * cpu_lg.abs()))[:, clean].max())
                   if clean else None,
                   argmax_equal_share=float(
                       (card_lg.argmax(-1) == cpu_lg.argmax(-1))
                       .float().mean()))
        out[dt_name] = rec
        require(bool(torch.isfinite(card_lg).all()),
                f"moe_parity {dt_name}: non-finite logits on the card")
        require(bool(clean), f"moe_parity {dt_name}: every row's routing "
                f"flipped {routing}")
        require(torch.allclose(card_lg[:, clean], cpu_lg[:, clean],
                               rtol=tol, atol=tol),
                f"moe_parity {dt_name}: card vs CPU logits {rec}")
        del cpu_recs, card_recs
    del base
    emit({"phase": "moe_parity", "arch": full.name, "B": b, "S": s,
          "cuts": {"n_layers": [get_config(full.name).n_layers,
                                full.n_layers]},
          "decode_steps": n_dec, "teacher_forced": True,
          "capacity_factor": full.capacity_factor, **out})
    torch.cuda.empty_cache()


def phase_vlm_serve():
    """internvl2-26b at full width, its depth cut to 8 of 48 layers: a
    seeded bf16 frontend (1, 256, 6144) spliced into a 2,048-token prompt,
    prefill and 16 greedy decode steps through ``build(cfg).prefill`` and
    ``.decode``, and the same prompt without the frontend; then the reduced
    fp32 config on the card against the CPU.  Counts set to 0 just before
    the serves and read just after."""
    full = get_config("internvl2-26b")
    cfg = dataclasses.replace(full, n_layers=8)
    prompt_len, n_dec = 2048, 16
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab, (1, prompt_len))
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bundle = build(cfg, device="cuda")
    model = bundle.init(seed=0)
    fe = torch.from_numpy(rng.normal(size=(
        1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    ops.reset_launches()
    runs = {}
    for arm, batch in (("frontend", {"tokens": prompt, "frontend": fe}),
                       ("text_only", {"tokens": prompt})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = bundle.prefill(model, batch,
                                   cache_len=prompt_len + n_dec)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, step_ms = [lg], []
        for _ in range(n_dec):
            t0 = time.perf_counter()
            lg, cache = bundle.decode(model, lg.argmax(-1)[:, None], cache)
            steps.append(lg)
            lg.argmax(-1).cpu()  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        runs[arm] = {"logits": torch.stack(steps).cpu(),
                     "prefill_ms": prefill_ms,
                     "decode_ms_p50": float(np.median(step_ms))}
        del cache
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    del model, fe
    torch.cuda.empty_cache()
    a, b_ = runs["frontend"]["logits"], runs["text_only"]["logits"]
    require(bool(torch.isfinite(a).all() and torch.isfinite(b_).all()),
            "vlm_serve: non-finite logits")
    fe_diff = float((a[0] - b_[0]).abs().max())
    require(fe_diff > 1e-3, f"vlm_serve: the frontend changes the first "
            f"logits by {fe_diff}")
    require(launches.get("flash_attention") == 2 * cfg.n_layers,
            f"vlm_serve: flash_attention launched {launches}, expected "
            f"{2 * cfg.n_layers}")
    # The reduced config in fp32, with a frontend, on both devices.
    red = full.reduced()
    rb = {dev: build(red, device=dev) for dev in ("cpu", "cuda")}
    rm = rb["cpu"].init(seed=0)
    rbatch = {"tokens": rng.integers(0, red.vocab, (2, 24)),
              "frontend": rng.normal(size=(2, red.n_frontend_tokens,
                                           red.d_model)).astype(np.float32)}
    reduced = {}
    for dev, model in (("cpu", rm), ("cuda", copy.deepcopy(rm).to("cuda"))):
        lg, cache = rb[dev].prefill(model, rbatch, cache_len=28)
        steps = [lg]
        for i in range(4):
            lg, cache = rb[dev].decode(model, rbatch["tokens"][:, i:i + 1],
                                       cache)
            steps.append(lg)
        reduced[dev] = torch.stack(steps).cpu()
    red_err = float((reduced["cuda"] - reduced["cpu"]).abs().max())
    require(torch.allclose(reduced["cuda"], reduced["cpu"], rtol=1e-4,
                           atol=1e-4),
            f"vlm_serve reduced fp32: card vs CPU max abs err {red_err}")
    emit({"phase": "vlm_serve", "arch": full.name, "dtype": cfg.param_dtype,
          "cuts": {"n_layers": [full.n_layers, cfg.n_layers], "batch": 1,
                   "prompt_len": prompt_len, "decode_steps": n_dec},
          "n_params": build(cfg, device="cuda").n_params(),
          "frontend_shape": [1, cfg.n_frontend_tokens, cfg.d_model],
          "launches": launches, "peak_device_gb": peak_gb,
          "frontend_changes_first_logits_by": fe_diff,
          **{f"{arm}_{k}": v for arm, r in runs.items()
             for k, v in r.items() if k != "logits"},
          "reduced_fp32_card_vs_cpu_max_abs_err": red_err,
          "reduced_tolerance": 1e-4})
    return launches


# ---------------------------------------------------------------------------
# Phases 20-23: the SSM and hybrid LMs (selective_scan, the window).
# ---------------------------------------------------------------------------

def _timeline_ms(fn):
    """Device time from ``fn``'s first kernel to its last (CUDA events):
    its kernels and the idle gaps between them."""
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


def phase_scan_share():
    """One falcon-mamba-7b prefill layer (``rms_norm``, ``mamba_block``) at
    the LM serve cut, B=8 x 2,048 bf16, seed-0 weights, with the plain scan
    in place of the kernel and with the kernel, under ``torch.profiler``
    (device busy time) and between CUDA events (the device timeline, idle
    gaps included; the kernel also alone on the layer's scan inputs).  The
    layer's work besides the scan is the same in both arms, so the plain
    scan's time in the layer is the plain layer's less the kernel layer's
    besides its scan.  The scan's share of the layer is what decides
    whether the scan needs a kernel."""
    cfg = get_config("falcon-mamba-7b")
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    p = L.init_mamba(g, cfg, dt, torch.device("cuda"))
    ln = torch.ones(cfg.d_model, dtype=dt, device="cuda")
    x = torch.randn((8, 2048, cfg.d_model), generator=g,
                    device="cuda").to(dt)
    with torch.inference_mode():
        hn = L.rms_norm(x, ln, cfg.norm_eps)
        xz = hn @ p["in_proj"]
        xc = L._silu(L._causal_conv(xz[..., :cfg.inner], p["conv_w"],
                                    p["conv_b"]))
        dtv, bm, cm = L._ssm_params(p, cfg, xc)
        ins = (xc, xz[..., cfg.inner:].contiguous(), dtv,
               -torch.exp(p["A_log"]), bm.contiguous(), cm.contiguous(),
               p["D_skip"])
        del xz, hn

    def layer():
        with torch.inference_mode():
            return x + L.mamba_block(p, cfg, L.rms_norm(x, ln,
                                                        cfg.norm_eps))[0]

    def scan():
        return ss.selective_scan(*ins)
    kernel_scan = ops.selective_scan
    ops.selective_scan = ref.selective_scan_ref
    try:
        layer()  # warm-up
        plain_tl = _timeline_ms(layer)
        # A profile that records no device time is taken once more.
        plain = _device_profile(layer) or _device_profile(layer)
    finally:
        ops.selective_scan = kernel_scan
    layer()
    kernel_tl, scan_tl = _timeline_ms(layer), _timeline_ms(scan)
    kernel = _device_profile(layer) or _device_profile(layer)
    rec = {"phase": "scan_share", "arch": cfg.name, "dtype": "bf16",
           "shape": {"B": 8, "S": 2048, "D": cfg.d_model, "Di": cfg.inner,
                     "N": cfg.ssm_state},
           "prefill_layers": cfg.n_layers,
           "timeline_ms": {"plain_layer": plain_tl, "kernel_layer": kernel_tl,
                           "kernel_scan": scan_tl},
           "plain_scan_share_of_layer_timeline":
               1.0 - (kernel_tl - scan_tl) / plain_tl,
           "kernel_scan_share_of_layer_timeline": scan_tl / kernel_tl}
    missing = [name for name, prof in (("plain layer", plain),
                                       ("kernel layer", kernel))
               if prof is None]
    if missing:
        rec["busy"] = ("not measured: the profiler recorded no device time "
                       f"for the {', '.join(missing)}")
    else:
        # The kernel's own time in the kernel layer's profile.
        kernel_ms = sum(ms for name, ms in kernel["kernels"].items()
                        if "selective_scan_kernel" in name)
        other = kernel["busy_ms"] - kernel_ms
        for arm, prof, scan_ms in (("plain", plain, plain["busy_ms"] - other),
                                   ("kernel", kernel, kernel_ms)):
            rec[arm] = {"layer_wall_ms": prof["wall_ms"],
                        "layer_busy_ms": prof["busy_ms"],
                        "layer_launches": prof["launches"],
                        "scan_busy_ms": scan_ms,
                        "scan_share_of_layer_busy": scan_ms / prof["busy_ms"],
                        "layer_top_kernels_ms": dict(sorted(
                            prof["kernels"].items(),
                            key=lambda kv: -kv[1])[:6])}
    emit(rec)
    del p, x, ins
    torch.cuda.empty_cache()


def phase_ssm_parity():
    """Reduced falcon-mamba-7b and hymba-1.5b (its window cut to 8) from
    the same seeded parameters on both devices: a B=2, S=24 prefill into a
    16-slot cache (hymba's key ring holds 8, so it wraps) and 8
    teacher-forced decode steps, fp32 then bf16, as ``lm_parity`` holds
    them (fp32 rtol/atol 1e-4, bf16 5e-2)."""
    out = {}
    for arch in ("falcon-mamba-7b", "hymba-1.5b"):
        base = dataclasses.replace(get_config(arch).reduced(), window=8)
        tokens = torch.from_numpy(np.random.default_rng(7).integers(
            0, base.vocab, (2, 24 + 8)))
        for dt_name, tol in (("fp32", 1e-4), ("bf16", 5e-2)):
            kw = {} if dt_name == "fp32" else dict(
                param_dtype="bfloat16", compute_dtype="bfloat16")
            cfg = dataclasses.replace(base, **kw)
            cpu = init_lm(cfg, seed=0, device="cpu")
            logits = {}
            for dev, model in (("cpu", cpu),
                               ("cuda", copy.deepcopy(cpu).to("cuda"))):
                ops.reset_launches()
                lg, cache = prefill(model, cfg, tokens[:, :24].to(dev),
                                    cache_len=16)
                steps = [lg]
                for i in range(8):
                    lg, cache = decode_step(
                        model, cfg, tokens[:, 24 + i:25 + i].to(dev), cache)
                    steps.append(lg)
                logits[dev] = torch.stack(steps).cpu()
                if dev == "cuda":
                    want = {"selective_scan": cfg.n_layers,
                            "flash_attention": cfg.n_layers
                            if cfg.family == "hybrid" else 0}
                    got = {k: getattr(ss if k == "selective_scan" else fa,
                                      k).launches for k in want}
                    require(got == want, f"ssm_parity {arch} {dt_name}: "
                            f"launches {got}, expected {want}")
                    if "k" in cache:
                        require(cache["k"].shape[2] == cfg.window,
                                f"ssm_parity {arch}: key cache of "
                                f"{cache['k'].shape[2]} slots")
                del model, cache
            diff = (logits["cuda"] - logits["cpu"]).abs()
            rec = {"max_abs_err": float(diff.max()), "tolerance": tol,
                   "worst_share_of_bound": float(
                       (diff / (tol + tol * logits["cpu"].abs())).max()),
                   "max_abs_logit": float(logits["cpu"].abs().max()),
                   "argmax_equal_share": float(
                       (logits["cuda"].argmax(-1)
                        == logits["cpu"].argmax(-1)).float().mean())}
            require(bool(torch.isfinite(logits["cuda"]).all()),
                    f"ssm_parity {arch} {dt_name}: non-finite logits")
            require(torch.allclose(logits["cuda"], logits["cpu"], rtol=tol,
                                   atol=tol),
                    f"ssm_parity {arch} {dt_name}: card vs CPU {rec}")
            out[f"{arch}_{dt_name}"] = rec
    emit({"phase": "ssm_parity", "B": 2, "S": 24, "cache_len": 16,
          "window": 8, "decode_steps": 8, "teacher_forced": True, **out})
    torch.cuda.empty_cache()


def phase_lm_serve(arch="smollm-135m", phase="lm_serve"):
    """The LM serving path at full width; counts set to 0 just before the
    serve and read just after: ``flash_attention`` once per attention
    layer, ``selective_scan`` once per mamba layer (SSM and hybrid),
    ``gather_rows_expand`` once per decode step.  Returns the kernels'
    launches."""
    cfg = get_config(arch)
    b, prompt_len, steps = 8, 2048, 64
    # The path's own peak: device bytes above what earlier phases left
    # allocated, from the model's weights through the serve.
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stage_s = {}
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    stage_s["init_s"] = round(time.perf_counter() - t0, 3)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = serve_lm_tiered(cfg, batch=b, prompt_len=prompt_len, steps=steps,
                          capacity_frac=0.1, policy="lru", device="cuda",
                          seed=0, model=model, collect_logits=True)
    stage_s["serve_s"] = round(time.perf_counter() - t0, 3)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    want = {"flash_attention": 0 if cfg.family == "ssm" else cfg.n_layers,
            "selective_scan": cfg.n_layers
            if cfg.family in ("ssm", "hybrid") else 0,
            "gather_rows_expand": steps}
    require(all(launches.get(k, 0) == n for k, n in want.items()),
            f"{phase}: launched {launches}, expected {want} (one per "
            "prefill layer, one per decode step)")
    require(res["hits"] + res["misses"] == res["lookups"] == b * steps,
            f"{phase}: hits + misses != lookups")
    lg, tok = res["logits"], res["tokens"]
    require(lg.shape == (steps, b, cfg.vocab) and np.isfinite(lg).all()
            and tok.shape == (steps, b) and (tok >= 0).all()
            and (tok < cfg.vocab).all(), f"{phase}: bad logits or tokens")
    # The tiered path's first step against the token path on the same
    # prompt: the cast store rows are the token's embedding, so the two
    # agree bit for bit.
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (b, prompt_len))
    pt = torch.from_numpy(prompt).to("cuda")
    _, cache = prefill(model, cfg, pt, prompt_len + steps)
    # A sliding window caps the key ring at the window; the decode wraps it.
    kv_slots = cache["k"].shape[2] if "k" in cache else 0
    if cfg.attn_type == "sliding":
        require(kv_slots == min(cfg.window, prompt_len + steps),
                f"{phase}: {kv_slots} key slots for window {cfg.window}")
    ref_logits, _ = decode_step(model, cfg, pt[:, -1:], cache)
    require(np.array_equal(ref_logits.cpu().numpy(), lg[0]),
            f"{phase}: the tiered first step differs from the token path")
    del cache, pt
    t0 = time.perf_counter()
    profile = lm_profile(cfg, model, b, prompt_len)
    stage_s["profile_s"] = round(time.perf_counter() - t0, 3)
    emit({"phase": phase, "arch": cfg.name, "dtype": cfg.param_dtype,
          "cuts": {"from": "prefill_32k B=32 S=32768", "batch": b,
                   "prompt_len": prompt_len},
          "launches": launches, "peak_device_gb": peak_gb,
          "n_params": build(cfg, device="cuda").n_params(),
          "kv_cache_slots": kv_slots,
          "first_step_equals_token_path": True,
          "profile": profile, "stage_s": stage_s,
          **{k: res[k] for k in ("steps", "capacity", "policy", "batches",
                                 "lookups", "hits", "misses", "hit_rate",
                                 "on_demand_rows", "evictions", "tok_per_s",
                                 "prefill_ms", "decode_ms_p50",
                                 "decode_s")}})
    del model
    torch.cuda.empty_cache()
    return launches


# The seconds spent inside ``_device_profile`` (the profiled call and the
# reading of its events), for the ``done`` line.
PROFILER_SECONDS = {"calls": 0, "seconds": 0.0}


def _device_profile(fn):
    """Run ``fn`` under ``torch.profiler`` (device activity only): its wall
    ms, the device ms of its CUDA kernels and copies (one stream, so they
    do not overlap), their launches, and ``{name: device ms}`` per kernel
    (names cut to 80 characters).  ``None`` when the profiler recorded no
    device time.  The events are read as the profiler's raw records:
    ``key_averages()`` first builds a tree of every recorded event, which
    takes seconds a profile on the host and which the script does not
    use."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()[:80]
        kernels[name] = kernels.get(name, 0.0) + e.duration_ns() / 1e6
        launches += 1
    busy_ms = sum(kernels.values())
    PROFILER_SECONDS["calls"] += 1
    PROFILER_SECONDS["seconds"] += time.perf_counter() - t_all
    if busy_ms <= 0:
        return None
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": launches,
            "kernels": kernels}


def _profile_summary(wall_ms, busy_ms, launches, kernels, n):
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms / n, "device_busy_ms": busy_ms / n,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches": launches / n,
            "top_kernels_ms": {k: v / n for k, v in top}}


def lm_profile(cfg, model, batch, prompt_len, n_steps=8):
    """Where a served LM's time goes, read from the entry point itself:
    ``serve_lm_tiered`` on ``model`` with no decode step (the prefill, then
    the store built over the host copy of the vocab) and with ``n_steps``
    steps, each under ``torch.profiler``.  A decode step is the difference
    of the two over ``n_steps``."""
    def serve(steps):
        return lambda: serve_lm_tiered(
            cfg, batch=batch, prompt_len=prompt_len, steps=steps,
            capacity_frac=0.1, policy="lru", device="cuda", seed=0,
            model=model)
    setup, full = _device_profile(serve(0)), _device_profile(serve(n_steps))
    if setup is None or full is None:
        return "not measured: the profiler recorded no device time"
    diff = {k: full["kernels"][k] - setup["kernels"].get(k, 0.0)
            for k in full["kernels"]}
    return {"prefill_and_store": _profile_summary(
                setup["wall_ms"], setup["busy_ms"], setup["launches"],
                setup["kernels"], 1),
            "decode_per_step": _profile_summary(
                full["wall_ms"] - setup["wall_ms"],
                full["busy_ms"] - setup["busy_ms"],
                full["launches"] - setup["launches"], diff, n_steps)}


# ---------------------------------------------------------------------------
# Phases 13-16: training (the attention backward, parity, LM and DLRM).
# ---------------------------------------------------------------------------

def phase_flash_bwd_kernels(timer):
    """``flash_attention_bwd`` against its plain version at
    ``FLASH_BWD_SHAPES``, each timed beside its bound and beside the
    backward of SDPA, then in a sliding window at ``WINDOW_BWD_SHAPE``
    (:func:`window_attention_bwd`).  Returns (the record of the training
    cut at bf16, the windowed record)."""
    main = None
    for name, b, s, h, n_kv, hd, dt_name in FLASH_BWD_SHAPES:
        dt = DTYPES[dt_name]
        g = torch.Generator(device="cuda").manual_seed(s + hd + 1)
        q, k, v, do = (torch.randn((b, s, n, hd), generator=g,
                                   device="cuda").to(dt)
                       for n in (h, n_kv, n_kv, h))
        o, lse = fa.flash_attention(q, k, v, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse)
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        tol = 1e-5 if dt_name == "fp32" else 2e-2
        errs, shares = {}, {}
        for gname, a, w in zip(("dq", "dk", "dv"), got, want):
            errs[gname] = float((a.float() - w.float()).abs().max())
            shares[gname] = errs[gname] / float(w.float().abs().max())
        require(max(shares.values()) <= tol,
                f"flash_attention_bwd {name} {dt_name}: error / largest "
                f"gradient {shares} (tolerance {tol})")
        del got, want
        # SDPA's backward alone, on (B, H, S, hd) copies made outside the
        # timing: the yardstick, never called by the port.
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        rec = {"phase": "kernel", "name": "flash_attention_bwd",
               "shape": name, "dtype": dt_name, "B": b, "S": s, "H": h,
               "K": n_kv, "hd": hd, "max_abs_err": max(errs.values()),
               "max_abs_err_share_of_largest_grad": shares,
               "tolerance": tol, "design": FLASH_BWD_DESIGN[dt_name],
               "ms": timer(lambda: fa.flash_attention_bwd(q, k, v, o, do,
                                                          lse)),
               "plain_ms": timer(lambda: ref.flash_attention_bwd_ref(
                   q, k, v, o, do, lse)),
               "library_ms": timer(lambda: torch.autograd.grad(
                   out, (qt, kt, vt), dot, retain_graph=True))}
        if dt_name == "bf16":
            # Both dK/dV grids: the G query heads of a KV head in one block
            # or split over blocks (every divisor of G), beside the split
            # the wrapper picks.
            group = h // n_kv
            rec["splits"] = fa.bwd_splits(
                b, s, n_kv, group,
                torch.cuda.get_device_properties(0).multi_processor_count)
            rec["ms_by_splits"] = {
                str(sp): timer(lambda: fa.flash_attention_bwd(
                    q, k, v, o, do, lse, splits=sp))
                for sp in range(1, group + 1) if group % sp == 0}
        # Five products of 2 hd over the causal pairs of each (batch,
        # head); q, k, v, o, dO and lse read once, dq, dk, dv written once.
        work = W.flash_attention_bwd(b, s, s, h, n_kv, hd, q.element_size())
        rec["bound_ms"], rec["bound_by"] = work_bound(work)
        achieved(rec, work.ops)
        emit(rec)
        if name == "train_cut" and dt_name == "bf16":
            main = rec
        del q, k, v, do, o, lse, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
    return main, window_attention_bwd(timer)


def window_attention_bwd(timer):
    """The bf16 backward in hymba-1.5b's 1,024-token window at its training
    microbatch: each gradient within 2e-2 of its largest magnitude of the
    plain windowed backward (run one batch row at a time, every row: the
    plain version holds (H, S, S) fp32 tensors; timed on row 0), beside
    the same shape causal and SDPA's
    backward with a boolean band mask; a window of S or more gives the
    causal backward's bits."""
    b, s, h, n_kv, hd, w = WINDOW_BWD_SHAPE
    g = torch.Generator(device="cuda").manual_seed(s + w + 1)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (h, n_kv, n_kv, h))
    o, lse = fa.flash_attention(q, k, v, with_lse=True, window=w)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, window=w)
    names = ("dq", "dk", "dv")
    errs, peaks = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for r in range(b):
        row = slice(r, r + 1)
        want = ref.flash_attention_bwd_ref(q[row], k[row], v[row], o[row],
                                           do[row], lse[row], w)
        for gname, u, x in zip(names, got, want):
            errs[gname] = max(errs[gname], float(
                (u[row].float() - x.float()).abs().max()))
            peaks[gname] = max(peaks[gname], float(x.float().abs().max()))
        del want
    shares = {gname: errs[gname] / peaks[gname] for gname in names}
    require(max(shares.values()) <= 2e-2,
            f"flash_attention_bwd window {w}: error / largest gradient "
            f"{shares}")
    # A window of S or more: the causal backward's bits.
    co, clse = fa.flash_attention(q, k, v, with_lse=True)
    causal = fa.flash_attention_bwd(q, k, v, co, do, clse)
    wide = fa.flash_attention_bwd(q, k, v, co, do, clse, window=s)
    same = all(torch.equal(x, y) for x, y in zip(causal, wide))
    require(same, "flash_attention_bwd: a window of S changes the causal "
                  "bits")
    # The window bites: the gradients are not the causal ones.
    require(not torch.equal(got[0], causal[0]),
            "flash_attention_bwd: the window changed nothing")
    del causal, wide
    # SDPA with a boolean band mask, the KV heads repeated to H outside the
    # timing; its backward alone is the library's time.
    g_ = h // n_kv
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.transpose(1, 2).repeat_interleave(g_, dim=1).contiguous()
              .requires_grad_() for t in (k, v))
    band = torch.ones((s, s), dtype=torch.bool, device="cuda").tril().triu(
        1 - w)
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band)
    dot = do.transpose(1, 2).contiguous()
    plain = (q[:1], k[:1], v[:1], o[:1], do[:1], lse[:1])
    rec = {"phase": "kernel", "name": "flash_attention_bwd",
           "shape": "hymba_train_window", "dtype": "bf16", "B": b, "S": s,
           "H": h, "K": n_kv, "hd": hd, "window": w,
           "max_abs_err": max(errs.values()),
           "max_abs_err_share_of_largest_grad": shares, "tolerance": 2e-2,
           "compared_rows": "every batch row, the plain version one row "
                            "at a time",
           "window_at_or_above_s_bit_equal_causal": True,
           "design": FLASH_BWD_DESIGN["bf16"] + "; the window's own "
           "instantiation of both kernels (the causal one folds the "
           "window's terms away): query walk to the last key's window, key "
           "walk from the first query's, edge tiles masked",
           "library": "SDPA's backward with an explicit boolean band mask, "
                      "KV heads repeated outside the timing",
           "ms": timer(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                      window=w)),
           "causal_ms": timer(lambda: fa.flash_attention_bwd(
               q, k, v, co, do, clse)),
           "plain_ms": timer(lambda: ref.flash_attention_bwd_ref(*plain, w)),
           "plain_B": 1, "plain_timing": "batch row 0 alone",
           "library_ms": timer(lambda: torch.autograd.grad(
               out, (qt, kt, vt), dot, retain_graph=True))}
    rec["windowed_over_causal"] = rec["ms"] / rec["causal_ms"]
    # Five products over the visible pairs: query i sees min(i + 1, w)
    # keys; q, k, v, o, dO and lse read once, dq, dk, dv written once.
    pairs = W.visible_pairs(s, s, window=w)
    work = W.flash_attention_bwd(b, s, s, h, n_kv, hd, 2, window=w)
    rec["visible_share_of_causal"] = pairs / (s * (s + 1) / 2)
    rec["bound_ms"], rec["bound_by"] = work_bound(work)
    achieved(rec, work.ops)
    emit(rec)
    del q, k, v, do, o, lse, co, clse, got, qt, kt, vt, out, dot, band, plain
    torch.cuda.empty_cache()
    return rec


class _PlainAttentionBackward:
    """Within the block, ``ops.flash_attention``'s backward on the card is
    the plain version (``flash_attention_bwd_ref``) in place of the
    kernel; the forward stays the kernel."""

    def __enter__(self):
        self._kept = fa.flash_attention_bwd
        fa.flash_attention_bwd = ref.flash_attention_bwd_ref
        return self

    def __exit__(self, *exc):
        fa.flash_attention_bwd = self._kept


class _PlainScanBackward:
    """Within the block, ``ops.selective_scan``'s backward on the card is
    the plain version (``selective_scan_bwd_ref``, from the first saved
    state: h0, or zeros) in place of the kernel; the forward stays the
    kernel."""

    def __enter__(self):
        self._kept = ss.selective_scan_bwd

        def plain(xc, z, dt, a, bm, cm, d_skip, states, dy, dh_last=None):
            return ref.selective_scan_bwd_ref(xc, z, dt, a, bm, cm, d_skip,
                                              states[:, 0], dy, dh_last)
        ss.selective_scan_bwd = plain
        return self

    def __exit__(self, *exc):
        ss.selective_scan_bwd = self._kept


def _bf16_grads(cfg, s, rng):
    """``lm_loss`` gradients of ``cfg`` (bf16, seed-0 weights, B=1, S=s,
    ``remat="full"``) on the card, the backward kernels in one arm and
    their plain versions in the other (the forwards stay the kernels):
    each leaf's largest difference over its largest magnitude, and the
    kernel arm's launches."""
    model = init_lm(cfg, seed=0, device="cuda").requires_grad_(True)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, s))).cuda()
    lab = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -1)], dim=1)
    grads = {}
    for arm in ("kernel", "plain"):
        ops.reset_launches()
        with contextlib.ExitStack() as stack:
            if arm == "plain":
                stack.enter_context(_PlainAttentionBackward())
                stack.enter_context(_PlainScanBackward())
            loss = lm_loss(model, cfg, RunConfig(remat="full"), toks, lab)
            grads[arm] = (loss.item(), torch.autograd.grad(
                loss, list(model.parameters())))
        if arm == "kernel":
            launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                        if fn.launches}
    shares = [float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30))
              for a, b in zip(grads["kernel"][1], grads["plain"][1])]
    names = [n for n, _ in model.named_parameters()]
    worst = int(np.argmax(shares))
    losses = {arm: grads[arm][0] for arm in grads}
    del model, grads
    torch.cuda.empty_cache()
    return {"B": 1, "S": s, "n_layers": cfg.n_layers,
            "loss_kernel": losses["kernel"], "loss_plain": losses["plain"],
            "worst_leaf": names[worst],
            "worst_err_share_of_largest": shares[worst],
            "median_err_share": float(np.median(shares)),
            "tolerance": 5e-2, "launches": launches}


def _train_backwards(cfg):
    """The backward kernels an LM's training step launches, once a layer
    and microbatch: the attention's (every family with attention) and the
    scan's (the SSM and the hybrid)."""
    if cfg.family == "dlrm":
        return ()
    return ((() if cfg.family == "ssm" else ("flash_attention_bwd",))
            + (("selective_scan_bwd",) if cfg.family in ("ssm", "hybrid")
               else ()))


def _step_on(dev, bundle_cfg, run, params, batch, microbatches):
    bundle = build(bundle_cfg, device=dev, run=run)
    opt = init_opt(OptConfig(lr=1e-3), tree_leaves(params))
    m = make_train_step(bundle, microbatches)(params, opt, batch)
    return float(m["loss"]), float(m["grad_norm"])


def phase_train_parity():
    """One train step from the same parameters and batch on the CPU and on
    the card (fp32 reduced smollm-135m, B=2, S=128, 2 microbatches; fp32
    reduced dlrm-recmg, B=64; fp32 reduced falcon-mamba-7b and hymba-1.5b,
    its window cut to 8, B=2, S=24, 2 microbatches); then full-width bf16
    gradients through the backward kernels against the same code with
    their plain versions, both on the card: smollm-135m (B=1, S=1024), one
    falcon-mamba-7b layer (S=1024) and one hymba-1.5b layer (S=2048, two
    windows)."""
    out = {}
    lm = get_config("smollm-135m").reduced()
    dl = get_config("dlrm-recmg").reduced()
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, lm.vocab, (2, 128)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    cases = {
        "smollm-135m.reduced": (lm, init_lm(lm, seed=0, device="cpu"),
                                {"tokens": tokens, "labels": labels}, 2),
        "dlrm-recmg.reduced": (dl, init_dlrm(dl, seed=0, device="cpu"), {
            "dense": rng.normal(size=(64, dl.dense_features)).astype(
                np.float32),
            "sparse": rng.integers(0, dl.rows_per_table, (
                64, dl.n_tables, dl.multi_hot)).astype(np.int32),
            "label": (rng.random(64) < 0.5).astype(np.float32)}, 1)}
    for arch in ("falcon-mamba-7b", "hymba-1.5b"):
        scfg = dataclasses.replace(get_config(arch).reduced(), window=8)
        stoks = rng.integers(0, scfg.vocab, (2, 24)).astype(np.int32)
        cases[f"{arch}.reduced"] = (scfg, init_lm(scfg, seed=0, device="cpu"),
                                    {"tokens": stoks, "labels": np.concatenate(
                                        [stoks[:, 1:],
                                         np.full((2, 1), -1, np.int32)],
                                        axis=1)}, 2)
    for name, (cfg, params, batch, mb) in cases.items():
        card = (copy.deepcopy(params).to("cuda")
                if isinstance(params, torch.nn.Module)
                else to_device(params, "cuda"))
        ops.reset_launches()
        res = {dev: _step_on(dev, cfg, RunConfig(remat="full"), p, batch, mb)
               for dev, p in (("cpu", params), ("cuda", card))}
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                    if fn.launches}
        diffs = [float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(tree_leaves(card), tree_leaves(params))]
        rec = {"loss_cpu": res["cpu"][0], "loss_card": res["cuda"][0],
               "grad_norm_cpu": res["cpu"][1],
               "grad_norm_card": res["cuda"][1], "microbatches": mb,
               "params_max_abs_diff": max(diffs), "n_leaves": len(diffs),
               "launches": launches}
        out[name] = rec
        require(abs(rec["loss_card"] - rec["loss_cpu"])
                <= 1e-5 * abs(rec["loss_cpu"]) and max(diffs) <= 1e-5,
                f"train_parity {name}: {rec}")
        want = {k: mb * cfg.n_layers for k in _train_backwards(cfg)}
        require({k: launches.get(k) for k in want} == want,
                f"train_parity {name}: launches {launches}, expected "
                f"{want}")
    # Full-width bf16 gradients through the same code, the backward kernels
    # in one arm and their plain versions in the other.
    for name, cfg, s in (
            ("smollm-135m", get_config("smollm-135m"), 1024),
            ("falcon-mamba-7b", dataclasses.replace(
                get_config("falcon-mamba-7b"), n_layers=1), 1024),
            ("hymba-1.5b", dataclasses.replace(get_config("hymba-1.5b"),
                                               n_layers=1), 2048)):
        rec = _bf16_grads(cfg, s, rng)
        rec["backward_launches_expected"] = {
            k: cfg.n_layers for k in _train_backwards(cfg)}
        out[f"{name}.bf16_grads"] = rec
    emit({"phase": "train_parity", **out})
    for name, rec in out.items():
        if not name.endswith(".bf16_grads"):
            continue
        want = rec["backward_launches_expected"]
        got = {k: rec["launches"].get(k) for k in want}
        require(got == want, f"train_parity {name}: backward launches "
                f"{got}, expected {want}")
        require(rec["worst_err_share_of_largest"] <= 5e-2,
                f"train_parity {name}: {rec['worst_leaf']} "
                f"{rec['worst_err_share_of_largest']}")
    torch.cuda.empty_cache()


STEP_LINE = re.compile(r"step\s+(\d+) loss (\S+) \((\d+) ms")


def _train_cli(argv, cfg):
    """``launch/train.main`` on ``cfg`` (its depth cut here: JAX's launcher
    has no flag for one) with its printed lines captured: ``(losses,
    {step: ms}, lines)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = train_main(argv, cfg=cfg)
    lines = buf.getvalue().splitlines()
    ms = {int(m.group(1)): float(m.group(3))
          for m in map(STEP_LINE.match, lines) if m}
    return losses, ms, lines


def phase_lm_train(arch="smollm-135m", phase="lm_train",
                   opt_settings=False, n_layers=None, steps=6, resume=True):
    """Full-width bf16 ``arch`` (its depth cut to ``n_layers`` when given)
    trained through the launcher: run A (``steps`` steps, checkpoints every
    ``steps // 2``) and run B (A's checkpoint at ``steps // 2`` alone in a
    fresh directory, run to ``steps``), then one step under the profiler
    and, with ``opt_settings``, 2 steps at each AdamW setting.  Without
    ``resume``, run A alone and without checkpoints (their ``np.savez``
    writes were most of falcon-mamba-7b's seconds)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers)
    half = steps // 2
    seq, batch, mb = 4096, 8, 2
    argv = ["--arch", cfg.name, "--steps", str(steps), "--seq-len", str(seq),
            "--batch", str(batch), "--microbatches", str(mb), "--remat",
            "full", "--lr", "3e-4", "--log-every", "1"]
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    a_dir, b_dir = root / "a", root / "b"
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    run_a, ms_a, lines_a = _train_cli(
        argv + (["--ckpt", str(a_dir), "--ckpt-every", str(half)]
                if resume else []), cfg)
    a_s = time.perf_counter() - t0
    launches_a = {fn.__name__: fn.launches for fn in ops.KERNELS
                  if fn.launches}
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    if not resume:
        half, run_b, ms_b, lines_b, b_s, launches_b = steps, [], {}, [], \
            0.0, {}
    else:
        # A's checkpoint at ``half`` alone in B's directory (moved: a
        # checkpoint of granite's parameters and moments is 14 GB).
        b_dir.mkdir(parents=True)
        ck = f"step_{half:08d}"
        shutil.move(a_dir / ck, b_dir / ck)
        shutil.rmtree(a_dir)
        ops.reset_launches()
        t0 = time.perf_counter()
        run_b, ms_b, lines_b = _train_cli(argv + ["--ckpt", str(b_dir)], cfg)
        b_s = time.perf_counter() - t0
        launches_b = {fn.__name__: fn.launches for fn in ops.KERNELS
                      if fn.launches}
    shutil.rmtree(root, ignore_errors=True)
    # The forwards run twice a layer and microbatch under --remat full,
    # the backwards once.
    want = {k: mb * cfg.n_layers for k in _train_backwards(cfg)}
    for k in list(want):
        want[k.replace("_bwd", "")] = 2 * mb * cfg.n_layers
    for run, n, got in (("A", steps, launches_a), ("B", steps - half,
                                                   launches_b)):
        for k, per_step in want.items():
            require(got.get(k, 0) == n * per_step,
                    f"{phase} run {run}: {k} launched {got.get(k)}, "
                    f"expected {n * per_step}")
    require(len(run_a) == steps and all(np.isfinite(run_a))
            and len(run_b) == steps - half,
            f"{phase} losses {run_a} {run_b}")
    require(not resume or (any(f"restored step {half}" in ln
                               for ln in lines_b)
                           and run_b == run_a[half:]),
            f"{phase} resume: B {run_b} vs A {run_a[half:]}")
    steady = [ms_a[i] for i in range(1, steps)]
    cuts = {"from": "train_4k S=4096 global_batch=256",
            "global_batch": batch, "microbatches": mb}
    if cfg.n_layers != full.n_layers:
        cuts["n_layers"] = [full.n_layers, cfg.n_layers]
    rec = {"phase": phase, "arch": cfg.name, "dtype": cfg.param_dtype,
           "cuts": cuts, "n_params": build(cfg).n_params(),
           "argv": argv, "losses_a": run_a, "step_ms_a": ms_a,
           "losses_b": run_b, "step_ms_b": ms_b,
           "resumed_losses_bit_equal": True if resume else None,
           "run_a_s": a_s, "run_b_s": b_s,
           "tokens_per_s_median": batch * seq / (np.median(steady) / 1e3),
           "peak_device_gb": peak_gb, "launches_a": launches_a,
           "launches_b": launches_b, "launches_expected_per_step": want,
           "profile": train_profile(cfg, seq, batch, mb)}
    if opt_settings:
        rec["optimizer_settings"] = optimizer_settings(cfg, seq, batch, mb)
    emit(rec)
    torch.cuda.empty_cache()
    return {k: launches_a.get(k, 0) + launches_b.get(k, 0)
            for k in set(launches_a) | set(launches_b)}


def optimizer_settings(cfg, seq, batch, mb):
    """2 steps of ``make_train_step`` from the same seeded model at each
    AdamW setting: fp32 moments, bf16 moments, bf16 moments with an fp32
    master copy.  Each setting's peak device GB (above what was allocated
    before its model), step ms and losses."""
    out = {}
    data = LMDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    step = make_train_step(build(cfg, device="cuda",
                                 run=RunConfig(remat="full")), mb)
    for name, kw in (("fp32_moments", {}),
                     ("bf16_moments", dict(moment_dtype="bfloat16")),
                     ("bf16_moments_fp32_master",
                      dict(moment_dtype="bfloat16", master_fp32=True))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = init_lm(cfg, seed=0, device="cuda")
        opt = init_opt(OptConfig(lr=3e-4, total_steps=6, **kw),
                       list(model.parameters()))
        losses, ms = [], []
        for i in range(2):
            t0 = time.perf_counter()
            losses.append(float(step(model, opt, batch_at(data, i))["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"peak_device_gb": (torch.cuda.max_memory_allocated()
                                        - base_bytes) / 1e9,
                     "state_gb": sum(t.numel() * t.element_size()
                                     for key, ts in opt.state_dict().items()
                                     if key != "count" for t in ts) / 1e9,
                     "step_ms": ms, "losses": losses}
        require(all(np.isfinite(losses)), f"optimizer setting {name}: "
                f"losses {losses}")
        del model, opt
    torch.cuda.empty_cache()
    return out


def train_profile(cfg, seq, batch, mb):
    """One train step of the launcher's configuration under
    ``torch.profiler``, after one warm step."""
    run = RunConfig(remat="full")
    bundle = build(cfg, device="cuda", run=run)
    model = bundle.init(seed=0)
    opt = init_opt(OptConfig(lr=3e-4, total_steps=6),
                   list(model.parameters()))
    step = make_train_step(bundle, mb)
    data = LMDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    step(model, opt, batch_at(data, 0))
    prof = _device_profile(lambda: step(model, opt, batch_at(data, 1)))
    del model, opt
    if prof is None:
        return "not measured: the profiler recorded no device time"
    # The backwards' kernels by name: the step must have run the bf16
    # tensor-core attention kernels and the scan's backward, as the family
    # has them.
    bwd = {k: ms for k, ms in prof["kernels"].items()
           if "attn_bwd" in k or "selective_scan_bwd" in k}
    need = {"flash_attention_bwd": ("attn_bwd_dkdv_mma", "attn_bwd_dq_mma"),
            "selective_scan_bwd": ("selective_scan_bwd_kernel",)}
    for name in (n for k in _train_backwards(cfg) for n in need[k]):
        require(any(name in k for k in bwd),
                f"lm_train profile: no {name} among {sorted(bwd)}")
    return dict(_profile_summary(prof["wall_ms"], prof["busy_ms"],
                                 prof["launches"], prof["kernels"], 1),
                backward_kernels_ms=bwd)


def phase_dlrm_train(full, trace):
    """dlrm-recmg at bf16 trained 4 steps on the serve trace's one batch of
    256 queries, the tables cut to 16,384 rows; counts set to 0 just
    before the steps and read just after."""
    cfg = dataclasses.replace(full, rows_per_table=16384)
    b = 256
    batch = next(query_batches(DLRMDataConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        multi_hot=cfg.multi_hot, dense_features=cfg.dense_features,
        batch=b, seed=0), trace=trace, n_batches=1))
    require(len(trace.row_id) == b * cfg.n_tables * cfg.multi_hot,
            "dlrm_train: the trace is not one batch of 256 queries")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_dlrm(cfg, seed=0, device="cuda")
    bundle = build(cfg, device="cuda")
    opt = init_opt(OptConfig(), tree_leaves(params))
    step = make_train_step(bundle, 1)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    ops.reset_launches()
    losses, step_ms = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    # The tables' gradient once more, outside the counted steps: its
    # nonzero rows are the rows the batch reads.
    g = torch.autograd.grad(bundle.loss(params, batch), params["emb"])[0]
    nonzero_rows = int((g.reshape(-1, cfg.emb_dim) != 0).any(dim=1).sum())
    flat = (batch["sparse"].long() + torch.arange(
        cfg.n_tables, device="cuda")[None, :, None] * cfg.rows_per_table)
    read_rows = int(torch.unique(flat).numel())
    del g, params, opt
    torch.cuda.empty_cache()
    require(launches.get("gather_pool") == 4,
            f"dlrm_train: gather_pool launched {launches} (expected 4)")
    require(all(np.isfinite(losses)) and nonzero_rows == read_rows,
            f"dlrm_train: losses {losses}, {nonzero_rows} nonzero gradient "
            f"rows, {read_rows} rows read by the batch")
    emit({"phase": "dlrm_train", "arch": full.name, "dtype": cfg.param_dtype,
          "cuts": {"rows_per_table": [full.rows_per_table,
                                      cfg.rows_per_table],
                   "batch": [6144, b]},
          "losses": losses, "step_ms": step_ms, "peak_device_gb": peak_gb,
          "launches": launches, "nonzero_grad_rows": nonzero_rows,
          "rows_read_by_batch": read_rows})
    return launches


# ---------------------------------------------------------------------------
# Phases 25-28: the encoder-decoder LM (whisper-large-v3) and the unmasked
# attention of its encoder.
# ---------------------------------------------------------------------------

# The unmasked attention's shapes (B, S, H, K, hd): whisper's encoder at the
# serve batch (8 clips of 1,500 frames) and at the training microbatch (4);
# the kernels line's records are the serve forward and the training
# backward, both bf16.
ENCDEC_SERVE_ATTN = (8, 1500, 20, 20, 64)
ENCDEC_TRAIN_ATTN = (4, 1500, 20, 20, 64)
# Ragged S at whisper's heads: one frame, one past a 16-row warp tile, and
# the 30-second window (against 64-key tiles and 128-query blocks).
ENCDEC_RAGGED_S = (1, 17, 1500)
# What the kernels line keeps of the unmasked records.
NONCAUSAL_KEYS = ("shape", "dtype", "B", "S", "H", "K", "hd", "max_abs_err",
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library", "design")
NONCAUSAL_DESIGN = ("the causal kernels' designs in an unmasked "
                    "instantiation of their own (template flag): the KV "
                    "walk (forward, dQ) to the end of S and the query walk "
                    "(dK/dV) from tile 0, only the ragged end of S masked")


def _noncausal_fwd(timer, shape, dt_name, name):
    """The unmasked forward at ``shape`` against its plain version (with
    the log-sum-exp), timed beside the plain version, SDPA without a mask
    and its bound (4 B H S^2 hd operations)."""
    b, s, h, n_kv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(s + hd + 7)
    q, k, v = (torch.randn((b, s, n, hd), generator=g, device="cuda")
               .to(DTYPES[dt_name]) for n in (h, n_kv, n_kv))
    got = fa.flash_attention(q, k, v, causal=False)
    o_lse, lse = fa.flash_attention(q, k, v, with_lse=True, causal=False)
    want, lse_want = ref.causal_attention_lse_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-5 if dt_name == "fp32" else 1e-2
    require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
            f"flash_attention causal=False {name} {dt_name}: max abs err "
            f"{err}")
    require(torch.equal(o_lse, got), f"flash_attention causal=False "
            f"{name}: the output changes when it also writes the lse")
    lse_err = float((lse - lse_want).abs().max())
    require(torch.allclose(lse, lse_want, rtol=1e-5, atol=1e-5),
            f"flash_attention causal=False {name}: lse max abs err {lse_err}")
    del got, want, o_lse, lse, lse_want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)
    rec = {"phase": "kernel", "name": "flash_attention", "shape": name,
           "causal": False, "dtype": dt_name, "B": b, "S": s, "H": h,
           "K": n_kv, "hd": hd, "max_abs_err": err, "tolerance": tol,
           "lse_max_abs_err_vs_logsumexp": lse_err,
           "design": NONCAUSAL_DESIGN,
           "ms": timer(lambda: fa.flash_attention(q, k, v, causal=False)),
           "plain_ms": timer(lambda: ref.causal_attention_ref(
               q, k, v, causal=False)),
           "library": "SDPA without a mask", "library_ms": timer(sdpa)}
    work = W.flash_attention(b, s, s, h, n_kv, hd, q.element_size(),
                             causal=False)
    rec["bound_ms"], rec["bound_by"] = work_bound(work)
    achieved(rec, work.ops)
    emit(rec)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


def _noncausal_bwd(timer, shape, dt_name, name):
    """The unmasked backward at ``shape`` against its plain version (each
    gradient within 1e-5 / 2e-2 of max(1, its largest magnitude)), two
    calls bit-equal, timed beside the
    plain version, SDPA's backward without a mask and its bound (five
    products: 10 B H S^2 hd operations)."""
    b, s, h, n_kv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(s + hd + 8)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=g, device="cuda")
                   .to(DTYPES[dt_name]) for n in (h, n_kv, n_kv, h))
    o, lse = fa.flash_attention(q, k, v, with_lse=True, causal=False)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=False)
    torch.cuda.synchronize()
    tol = 1e-5 if dt_name == "fp32" else 2e-2
    # Against max(1, the largest magnitude): at S = 1 a query sees only its
    # own key, p = 1, and dq and dk are 0 up to rounding.
    errs, shares = {}, {}
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        errs[gname] = float((a.float() - w.float()).abs().max())
        shares[gname] = errs[gname] / max(float(w.float().abs().max()), 1.0)
    require(max(shares.values()) <= tol,
            f"flash_attention_bwd causal=False {name} {dt_name}: error / "
            f"largest gradient {shares} (tolerance {tol})")
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            f"flash_attention_bwd causal=False {name}: two calls differ")
    del got, want, again
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    rec = {"phase": "kernel", "name": "flash_attention_bwd", "shape": name,
           "causal": False, "dtype": dt_name, "B": b, "S": s, "H": h,
           "K": n_kv, "hd": hd, "max_abs_err": max(errs.values()),
           "max_abs_err_share_of_largest_grad_or_1": shares,
           "tolerance": tol, "bit_equal_over_two_calls": True,
           "design": NONCAUSAL_DESIGN,
           "ms": timer(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                      causal=False)),
           "plain_ms": timer(lambda: ref.flash_attention_bwd_ref(
               q, k, v, o, do, lse, causal=False)),
           "library": "SDPA's backward without a mask",
           "library_ms": timer(lambda: torch.autograd.grad(
               out, (qt, kt, vt), dot, retain_graph=True))}
    work = W.flash_attention_bwd(b, s, s, h, n_kv, hd, q.element_size(),
                                 causal=False)
    rec["bound_ms"], rec["bound_by"] = work_bound(work)
    achieved(rec, work.ops)
    emit(rec)
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    return rec


def phase_encdec_kernels(timer):
    """The unmasked ``flash_attention`` at whisper's serve shape and its
    backward at the training microbatch, bf16 and fp32, then the forward
    at the training shape (bf16) and both at ragged S in both dtypes, each
    against its plain version and timed.  Returns (the bf16 serve forward's
    record, the bf16 training backward's)."""
    fwd = {dt: _noncausal_fwd(timer, ENCDEC_SERVE_ATTN, dt, "whisper_serve")
           for dt in ("bf16", "fp32")}
    _noncausal_fwd(timer, ENCDEC_TRAIN_ATTN, "bf16", "whisper_train")
    bwd = {dt: _noncausal_bwd(timer, ENCDEC_TRAIN_ATTN, dt, "whisper_train")
           for dt in ("bf16", "fp32")}
    b, _, h, n_kv, hd = ENCDEC_SERVE_ATTN
    for s in ENCDEC_RAGGED_S:
        for dt in ("bf16", "fp32"):
            _noncausal_fwd(timer, (2, s, h, n_kv, hd), dt, f"ragged_{s}")
            _noncausal_bwd(timer, (2, s, h, n_kv, hd), dt, f"ragged_{s}")
    return fwd["bf16"], bwd["bf16"]


def _encdec_batch(cfg, b, s, rng, dev="cuda"):
    """Seeded tokens, labels (the next token, -1 at the end) and audio
    frames (B, enc_len, d_model) in the compute dtype on ``dev``."""
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    frames = torch.from_numpy(rng.normal(size=(
        b, cfg.enc_len, cfg.d_model)).astype(np.float32)).to(
        dev, torch_dtype(cfg.compute_dtype))
    return {"tokens": tokens, "labels": labels, "frontend": frames}


def _share(got, want):
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_encdec_parity():
    """Reduced fp32 whisper-large-v3 from the same parameters on the CPU
    and on the card: ``encdec_loss`` and every gradient (``remat="full"``),
    then a prefill into a 20-slot cache and 3 teacher-forced decode steps;
    each tensor within 1e-5 of its largest magnitude on the CPU."""
    cfg = get_config("whisper-large-v3").reduced()
    rng = np.random.default_rng(23)
    batch = _encdec_batch(cfg, 2, 12, rng, "cpu")
    cpu = build(cfg, device="cpu").init(seed=0).requires_grad_(True)
    res = {}
    for dev, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to("cuda"))):
        bundle = build(cfg, device=dev, run=RunConfig(remat="full"))
        loss = bundle.loss(model, batch)
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, list(model.parameters()))]
        lg, cache = bundle.prefill(model, batch, cache_len=20)
        steps = [lg]
        for i in range(3):
            lg, cache = bundle.decode(model, batch["tokens"][:, i:i + 1],
                                      cache)
            steps.append(lg)
        res[dev] = (loss.detach().cpu(), grads, torch.stack(steps).cpu(),
                    {k: cache[k].cpu() for k in ("k", "v", "xk", "xv")})
    names = [n for n, _ in cpu.named_parameters()]
    shares = {"loss": _share(res["cuda"][0], res["cpu"][0]),
              "logits": _share(res["cuda"][2], res["cpu"][2]),
              **{f"cache_{k}": _share(res["cuda"][3][k], res["cpu"][3][k])
                 for k in res["cpu"][3]}}
    grad_shares = [_share(g, w) for g, w in zip(res["cuda"][1],
                                                res["cpu"][1])]
    worst = int(np.argmax(grad_shares))
    require(max(shares.values()) <= 1e-5 and grad_shares[worst] <= 1e-5,
            f"encdec_parity: card vs CPU {shares}, worst gradient "
            f"{names[worst]} {grad_shares[worst]}")
    emit({"phase": "encdec_parity", "arch": cfg.name, "dtype": "float32",
          "B": 2, "S": 12, "frames": cfg.enc_len, "cache_len": 20,
          "decode_steps": 3, "err_share_of_largest": shares,
          "worst_grad": names[worst],
          "worst_grad_err_share": grad_shares[worst], "tolerance": 1e-5})


def phase_encdec_serve():
    """whisper-large-v3 at full width and depth through
    ``build(cfg).prefill``/``.decode``: 8 clips of seeded bf16 frames
    (8, 1500, 1280), a 4-token start-of-transcript prompt, 64 greedy steps
    into a 448-slot cache; counts set to 0 just before the prefill and
    read after the last step: ``flash_attention`` 32 unmasked (the
    encoder) and 32 causal (the decoder) launches in the prefill, none in
    a decode step (its attention and cross-attention are plain PyTorch, as
    JAX's are XLA).  Then one prefill and 8 steps under the profiler."""
    cfg = get_config("whisper-large-v3")
    b, prompt_len, n_dec, cache_len = 8, 4, 64, 448
    rng = np.random.default_rng(29)
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bundle = build(cfg, device="cuda")
    model = bundle.init(seed=0)
    batch = _encdec_batch(cfg, b, prompt_len, rng)
    del batch["labels"]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = bundle.prefill(model, batch, cache_len=cache_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                        if fn.launches}
    steps, step_ms = [lg], []
    t_dec = time.perf_counter()
    for _ in range(n_dec):
        t0 = time.perf_counter()
        lg, cache = bundle.decode(model, lg.argmax(-1)[:, None], cache)
        steps.append(lg)
        lg.argmax(-1).cpu()  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_s = time.perf_counter() - t_dec
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    logits = torch.stack(steps)
    require(bool(torch.isfinite(logits).all()) and tuple(logits.shape) ==
            (n_dec + 1, b, cfg.vocab), "encdec_serve: bad logits")
    require(cache["pos"] == prompt_len + n_dec and
            tuple(cache["k"].shape) == (cfg.n_layers, b, cache_len,
                                        cfg.kv_heads, cfg.hd) and
            tuple(cache["xk"].shape) == (cfg.n_layers, b, cfg.enc_len,
                                         cfg.kv_heads, cfg.hd),
            f"encdec_serve: cache pos {cache['pos']}")
    want = {"flash_attention": cfg.n_enc_layers + cfg.n_layers}
    require(prefill_launches == want and launches == want,
            f"encdec_serve: launched {prefill_launches} in the prefill and "
            f"{launches} in all, expected {want}")
    del cache, logits, steps

    def serve(k):
        def run():
            lg_, c = bundle.prefill(model, batch, cache_len=cache_len)
            for _ in range(k):
                lg_, c = bundle.decode(model, lg_.argmax(-1)[:, None], c)
        return run
    setup, full = _device_profile(serve(0)), _device_profile(serve(8))
    if setup is None or full is None:
        profile = "not measured: the profiler recorded no device time"
    else:
        diff = {k: full["kernels"][k] - setup["kernels"].get(k, 0.0)
                for k in full["kernels"]}
        profile = {"prefill": _profile_summary(
                       setup["wall_ms"], setup["busy_ms"],
                       setup["launches"], setup["kernels"], 1),
                   "decode_per_step": _profile_summary(
                       full["wall_ms"] - setup["wall_ms"],
                       full["busy_ms"] - setup["busy_ms"],
                       full["launches"] - setup["launches"], diff, 8)}
    emit({"phase": "encdec_serve", "arch": cfg.name,
          "dtype": cfg.param_dtype, "n_params": bundle.n_params(),
          "batch": b, "frames": [b, cfg.enc_len, cfg.d_model],
          "prompt_len": prompt_len, "decode_steps": n_dec,
          "cache_len": cache_len, "cuts": "none (full width and depth)",
          "prefill_ms": prefill_ms,
          "decode_ms_p50": float(np.median(step_ms)),
          "decode_ms_first": step_ms[0], "decode_s": decode_s,
          "tok_per_s": b * n_dec / decode_s, "peak_device_gb": peak_gb,
          "launches_prefill": prefill_launches, "launches": launches,
          "profile": profile})
    del model, batch
    torch.cuda.empty_cache()
    return launches


def phase_encdec_train():
    """whisper-large-v3 at full width and depth, bf16, 3 steps of
    ``make_train_step``: a global batch of 8 clips in 2 microbatches,
    1,500 frames and 448 decoder tokens each, ``remat="full"``, AdamW with
    fp32 moments; counts set to 0 just before the steps and read just
    after: per microbatch ``flash_attention`` twice and
    ``flash_attention_bwd`` once in each of the 64 layers.  Then one step
    under the profiler."""
    cfg = get_config("whisper-large-v3")
    b, s, mb, n_steps = 8, 448, 2, 3
    rng = np.random.default_rng(31)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bundle = build(cfg, device="cuda", run=RunConfig(remat="full"))
    model = bundle.init(seed=0)
    opt = init_opt(OptConfig(lr=3e-4, total_steps=n_steps + 1),
                   list(model.parameters()))
    step = make_train_step(bundle, mb)
    batches = [_encdec_batch(cfg, b, s, rng) for _ in range(n_steps + 1)]
    torch.cuda.synchronize()
    ops.reset_launches()
    losses, norms, step_ms = [], [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        m = step(model, opt, batches[i])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    layers = cfg.n_enc_layers + cfg.n_layers
    want = {"flash_attention": n_steps * mb * 2 * layers,
            "flash_attention_bwd": n_steps * mb * layers}
    require(launches == want, f"encdec_train: launched {launches}, expected "
            f"{want}")
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"encdec_train: losses {losses}, grad norms {norms}")
    prof = _device_profile(lambda: step(model, opt, batches[n_steps]))
    if prof is None:
        profile = "not measured: the profiler recorded no device time"
    else:
        bwd = {k: ms for k, ms in prof["kernels"].items() if "attn_bwd" in k}
        require(any("attn_bwd_dkdv_mma" in k for k in bwd),
                f"encdec_train profile: no attn_bwd_dkdv_mma among {bwd}")
        profile = dict(_profile_summary(prof["wall_ms"], prof["busy_ms"],
                                        prof["launches"], prof["kernels"],
                                        1), backward_kernels_ms=bwd)
    steady = step_ms[1:]
    emit({"phase": "encdec_train", "arch": cfg.name,
          "dtype": cfg.param_dtype, "n_params": bundle.n_params(),
          "global_batch": b, "microbatches": mb, "decoder_seq_len": s,
          "frames": cfg.enc_len, "remat": "full", "optimizer": "AdamW, fp32 "
          "moments", "cuts": "none (full width and depth)",
          "losses": losses, "grad_norms": norms, "step_ms": step_ms,
          "decoder_tokens_per_s": b * s / (np.median(steady) / 1e3),
          "frames_per_s": b * cfg.enc_len / (np.median(steady) / 1e3),
          "peak_device_gb": peak_gb, "launches": launches,
          "launches_expected": want, "profile": profile})
    del model, opt, batches
    torch.cuda.empty_cache()
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # fp32 products stay fp32 on the card: no TF32 in any comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    phase_device()
    scan_ptxas = timed("build", phase_build)
    timer = Timer()

    full = get_config("dlrm-recmg")
    serve_cfg = dataclasses.replace(full, rows_per_table=4096)
    batch_queries = 32
    per_batch = batch_queries * full.n_tables * full.multi_hot
    # 8 batches of 32 queries: DLRM training reads them as one batch of 256
    # queries; the serves read the first SERVE_BATCHES (cut from 8 to keep
    # the script inside its time).
    train_trace = generate_trace(TraceGenConfig(
        n_tables=serve_cfg.n_tables, rows_per_table=serve_cfg.rows_per_table,
        n_accesses=8 * per_batch, seed=0, drift_every=10**9))
    trace = train_trace.slice(0, SERVE_BATCHES * per_batch)
    # The buffer stays 0.2 of the 8 batches' unique ids (the kernels'
    # shapes of the earlier runs): the 6 batches' 775,985 ids overflow the
    # int8 buffer too, so every arm evicts.
    capacity = int(0.2 * train_trace.unique_count())
    # The same fast-tier bytes re-spent as quantized rows (the CLI's
    # --quantize conversion): 185,651 x 512 B / 132 B = 720,100.
    qcapacity = capacity * fast_row_bytes(full.emb_dim, np.float32, False) \
        // fast_row_bytes(full.emb_dim, np.float32, True, "int8")
    # The host-tier table every full-width serve reads (1.8 GB of fp32,
    # drawn once: the draw is most of a full-width serve's seconds).
    host = host_table(serve_cfg, trace)
    fwd_b = 256

    main_recs = timed("kernels", phase_kernels, timer,
                      trace.global_id[:per_batch], capacity,
                      full.n_tables * serve_cfg.rows_per_table, fwd_b, full)
    main_recs.update(timed("quant_kernels", phase_quant_kernels, timer,
                           trace, trace.global_id[:per_batch], qcapacity,
                           full))
    main_recs.update(timed("learned_kernels", phase_learned_kernels, timer))
    main_recs["flash_attention"] = timed("flash_kernels",
                                         phase_flash_kernels, timer)
    main_recs["flash_attention_bwd"], window_bwd_rec = timed(
        "flash_bwd_kernels", phase_flash_bwd_kernels, timer)
    main_recs["selective_scan"], window_rec = timed(
        "ssm_kernels", phase_ssm_kernels, timer, scan_ptxas)
    main_recs["selective_scan_bwd"] = timed(
        "scan_bwd_kernels", phase_scan_bwd_kernels, timer, scan_ptxas)
    timed("scan_share", phase_scan_share)
    timed("learned_grads", phase_learned_grads)
    timed("parity", phase_parity)
    timed("learned_parity", phase_learned_parity)
    int8 = dict(quantize=True, row_format="int8")
    serve_launches, serve_results, qs_by_store = timed(
        "serve", phase_serve, serve_cfg, trace, host, [
            ("fp32", "lru", capacity, {}),
            ("fp32", "recmg", capacity, {}),
            ("int8", "lru", qcapacity, int8),
            ("int8", "recmg", qcapacity, int8),
            ("fp8", "lru", qcapacity, dict(quantize=True, row_format="fp8")),
            ("int8-multi_table", "lru", qcapacity,
             dict(multi_table=True, **int8)),
        ], batch_queries)
    learned_launches, learned_model = timed(
        "learned_serve", phase_learned_serve, serve_cfg, trace, host,
        capacity, qcapacity, per_batch, batch_queries, serve_results)
    runtime_launches = timed("runtime_parity", phase_runtime_parity,
                             serve_cfg, trace, host, capacity, qcapacity,
                             batch_queries, serve_results)
    for name, k in timed("runtime_serve", phase_runtime_serve, serve_cfg,
                         trace, host, per_batch, capacity, qcapacity,
                         batch_queries, learned_model).items():
        runtime_launches[name] = runtime_launches.get(name, 0) + k
    del learned_model
    timed("sharded_parity", phase_sharded_parity)
    sharded_launches = timed("sharded_serve", phase_sharded_serve,
                             serve_cfg, trace, host, capacity, qcapacity,
                             batch_queries, serve_results)
    transfetch_launches = timed("transfetch", phase_transfetch, trace,
                                per_batch)
    del host, serve_results, trace
    train_launches = timed("dlrm_train", phase_dlrm_train, full, train_trace)
    del train_trace
    pool_rec, pool_launches, fwd = timed("forward", phase_forward, timer,
                                         full, fwd_b)
    # The row-sharded serve: world 1 over NCCL here on the forward's
    # tables, the four-rank run's reference from them; then, the tables
    # freed, four gloo ranks on the card.
    shard_want, nccl_launches = timed("distributed_serve_nccl",
                                      phase_distributed_nccl, full, fwd,
                                      fwd_b)
    qpool_rec, qpool_launches = timed(
        "forward_quantized", forward_quantized, timer, full, fwd["params"],
        fwd["dense"], fwd["idx"], fwd["logits"])
    del fwd
    # Training across the ranks: world 1 over NCCL and the references
    # here, then the four gloo ranks train after they serve, in one spawn.
    dist_work = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    train_ref, nccl_train_launches = timed(
        "distributed_train_nccl", phase_distributed_train_nccl, dist_work)
    # The LMs sharded over the mesh: world 1 over NCCL, the references and
    # rows 8 and 8b at the per-rank layout here; the four ranks train after
    # their distributed training, in the same spawn.
    train_ref["sharded"], st_kernels, st_nccl_launches = timed(
        "sharded_train_nccl", phase_sharded_train_nccl, dist_work, timer,
        scan_ptxas)
    # The LMs served over the mesh: the offset kernel, world 1 over NCCL
    # and the whole model's references here; the four ranks serve after
    # their sharded training, in the same spawn.
    ss_rec, ss_nccl_launches = timed(
        "lm_sharded_serve_nccl", phase_lm_sharded_serve_nccl, dist_work,
        timer)
    (shard_rec, gloo_launches, dist_train_launches, st_launches,
     ss_launches) = timed(
        "distributed_serve", phase_distributed_serve, fwd_b, shard_want,
        train_ref, dist_work, st_nccl_launches, ss_nccl_launches)
    dist_train_launches["gather_pool_shard"] += nccl_train_launches
    timed("lm_parity", phase_lm_parity)
    lm_launches = timed("lm_serve", phase_lm_serve)
    timed("train_parity", phase_train_parity)
    for name, k in timed("lm_train", phase_lm_train).items():
        train_launches[name] = train_launches.get(name, 0) + k
    # The MoE and VLM LMs (granite-moe-1b-a400m, internvl2-26b).
    timed("moe_parity", phase_moe_parity)
    moe_launches = timed("moe_serve", phase_lm_serve, "granite-moe-1b-a400m",
                         "moe_serve")
    # granite's depth cut from 24 to 4 layers and 4 steps: the
    # checkpoints' bytes are most of the phase's seconds.
    for name, k in timed("moe_train", phase_lm_train, "granite-moe-1b-a400m",
                         "moe_train", opt_settings=True,
                         n_layers=4, steps=4).items():
        moe_launches[name] = moe_launches.get(name, 0) + k
    vlm_launches = timed("vlm_serve", phase_vlm_serve)
    # The SSM and hybrid LMs (falcon-mamba-7b, hymba-1.5b).
    timed("ssm_parity", phase_ssm_parity)
    ssm_launches = timed("ssm_serve", phase_lm_serve, "falcon-mamba-7b",
                         "ssm_serve")
    for name, k in timed("hybrid_serve", phase_lm_serve, "hymba-1.5b",
                         "hybrid_serve").items():
        ssm_launches[name] = ssm_launches.get(name, 0) + k
    # Their training at full width, the depth cut: falcon 2 of 64 layers,
    # hymba 2 of 32 (4 until the sequence split's arms needed the script's
    # time), 2 steps each (a checkpoint at 1, resumed from it).  falcon's
    # run A alone, without checkpoints (hymba's resumes).
    ssm_train_launches = timed("ssm_train", phase_lm_train,
                               "falcon-mamba-7b", "ssm_train", n_layers=2,
                               steps=2, resume=False)
    for name, k in timed("hybrid_train", phase_lm_train, "hymba-1.5b",
                         "hybrid_train", n_layers=2, steps=2).items():
        ssm_train_launches[name] = ssm_train_launches.get(name, 0) + k
    # The encoder-decoder LM (whisper-large-v3) at full width and depth,
    # and the unmasked attention of its encoder.
    noncausal_rec, noncausal_bwd_rec = timed(
        "encdec_kernels", phase_encdec_kernels, timer)
    timed("encdec_parity", phase_encdec_parity)
    encdec_launches = timed("encdec_serve", phase_encdec_serve)
    for name, k in timed("encdec_train", phase_encdec_train).items():
        encdec_launches[name] = encdec_launches.get(name, 0) + k

    kernels = []
    for name, rec, n, src, replaces in (
            ("gather_rows_expand", main_recs["gather_rows_expand"],
             serve_launches["gather_rows_expand"], CU_SOURCE,
             TPU_GATHER_ROWS),
            ("gather_pool", pool_rec, pool_launches, CU_SOURCE,
             TPU_GATHER_POOL),
            ("gather_pool_shard", shard_rec, gloo_launches + nccl_launches,
             CU_SOURCE, TPU_GATHER_POOL),
            ("quantize_scatter", main_recs["quantize_scatter"],
             serve_launches["quantize_scatter"], CU_QUANT_SOURCE,
             TPU_QUANTIZE_ROWS),
            ("gather_rows_dequant_expand",
             main_recs["gather_rows_dequant_expand"],
             serve_launches["gather_rows_dequant_expand"], CU_QUANT_SOURCE,
             TPU_GATHER_ROWS_DEQUANT),
            ("gather_pool_dequant", qpool_rec, qpool_launches,
             CU_QUANT_SOURCE, TPU_GATHER_POOL_DEQUANT),
            ("lstm_cell", main_recs["lstm_cell"],
             learned_launches["lstm_cell"], CU_LSTM_SOURCE, TPU_LSTM_CELL),
            ("chamfer", main_recs["chamfer"], learned_launches["chamfer"],
             CU_CHAMFER_SOURCE, TPU_CHAMFER),
            ("flash_attention", main_recs["flash_attention"], 0,
             CU_FLASH_SOURCE, TPU_FLASH_ATTENTION),
            ("flash_attention_bwd", main_recs["flash_attention_bwd"], 0,
             CU_FLASH_BWD_SOURCE, None),
            ("selective_scan", main_recs["selective_scan"], 0,
             CU_SCAN_SOURCE, None),
            ("selective_scan_bwd", main_recs["selective_scan_bwd"], 0,
             CU_SCAN_BWD_SOURCE, None)):
        # The runtime phases drive the store's kernels and the learned
        # model's fine-tune through their own paths, the sharded serve the
        # store's kernels in every shard, and the transformer backbone's
        # training lstm_cell (dec2) and chamfer (the loss).
        # Training (phases dlrm_train and lm_train) drives gather_pool,
        # flash_attention and flash_attention_bwd, which runs nowhere else.
        # The LM serves drive flash_attention and gather_rows_expand; the
        # MoE's serve and training and the VLM's serve add theirs; the SSM
        # and hybrid serves drive selective_scan and the hybrid's windowed
        # flash_attention, and their training selective_scan_bwd, which
        # runs nowhere else, and the windowed flash_attention_bwd; whisper's
        # serve and training the unmasked and causal flash_attention and
        # flash_attention_bwd.
        n += runtime_launches.get(name, 0) + sharded_launches.get(name, 0) \
            + transfetch_launches.get(name, 0) + train_launches.get(name, 0) \
            + lm_launches.get(name, 0) + moe_launches.get(name, 0) \
            + vlm_launches.get(name, 0) + ssm_launches.get(name, 0) \
            + ssm_train_launches.get(name, 0) + encdec_launches.get(name, 0) \
            + dist_train_launches.get(name, 0) + st_launches.get(name, 0) \
            + ss_launches.get(name, 0)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if name in REDESIGNED:
            kernels[-1]["design"] = REDESIGNED[name]
        if name in runtime_launches:
            kernels[-1]["launches_runtime"] = runtime_launches[name]
        if name in sharded_launches:
            kernels[-1]["launches_sharded"] = sharded_launches[name]
        if name in transfetch_launches:
            kernels[-1]["launches_transfetch"] = transfetch_launches[name]
        if name in train_launches:
            kernels[-1]["launches_train"] = train_launches[name]
        if name in lm_launches:
            kernels[-1]["launches_lm_serve"] = lm_launches[name]
        if name in moe_launches:
            kernels[-1]["launches_moe"] = moe_launches[name]
        if name in vlm_launches:
            kernels[-1]["launches_vlm"] = vlm_launches[name]
        if name in ssm_launches:
            kernels[-1]["launches_ssm"] = ssm_launches[name]
        if name in ssm_train_launches:
            kernels[-1]["launches_ssm_train"] = ssm_train_launches[name]
        if name in encdec_launches:
            kernels[-1]["launches_encdec"] = encdec_launches[name]
        if name in dist_train_launches:
            kernels[-1]["launches_distributed_train"] = \
                dist_train_launches[name]
        if name in ss_launches:
            kernels[-1]["launches_lm_sharded_serve"] = ss_launches[name]
        if name in st_kernels:
            kernels[-1]["launches_sharded_train"] = st_launches[name]
            kernels[-1]["sharded_layout"] = st_kernels[name]
        if name == "selective_scan":
            kernels[-1].update(note=SCAN_REPLACES_NOTE,
                               sfu_floor_ms=rec["sfu_floor_ms"])
        if name == "selective_scan_bwd":
            kernels[-1].update(
                note=SCAN_BWD_NOTE, sfu_floor_ms=rec["sfu_floor_ms"],
                kernel_sfu_floor_ms=rec["kernel_sfu_floor_ms"],
                design_bytes=rec["design_bytes"],
                geometry={k: rec[k] for k in (
                    "threads_per_block", "channels_per_block",
                    "max_blocks_per_sm", "warps_per_sm", "registers",
                    "spill_store_bytes", "spill_load_bytes")})
        if name == "flash_attention_bwd":
            kernels[-1]["windowed"] = {
                k: window_bwd_rec[k] for k in (
                    "shape", "B", "S", "H", "K", "hd", "window",
                    "max_abs_err", "ms", "causal_ms", "plain_ms", "plain_B",
                    "bound_ms", "bound_by", "library_ms", "library")}
            kernels[-1]["noncausal"] = {
                k: noncausal_bwd_rec[k] for k in NONCAUSAL_KEYS}
            kernels[-1]["offset"] = {
                **st_kernels[name][ST_OFFSET_LAYOUT],
                "launches": st_launches["flash_attention_bwd_offset"],
                "launches_from": "phase sharded_train's fsdp_seq arms, "
                                 "over the four ranks"}
        if name == "flash_attention":
            kernels[-1]["windowed"] = {
                k: window_rec[k] for k in (
                    "shape", "B", "S", "H", "K", "hd", "window",
                    "max_abs_err", "ms", "causal_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "library")}
            kernels[-1]["noncausal"] = {
                k: noncausal_rec[k] for k in NONCAUSAL_KEYS}
            kernels[-1]["offset"] = ss_rec
        if name == "quantize_scatter":
            kernels[-1].update(launches_full_batch=qs_by_store["full_batch"],
                               launches_per_table=qs_by_store["per_table"])
        if name == "gather_pool_shard":
            kernels[-1].update(
                mode="gather_pool's shard window (ids < 0 skipped)",
                launches_distributed={"gloo_world_4": gloo_launches,
                                      "nccl_world_1": nccl_launches,
                                      "train_gloo_world_4":
                                          dist_train_launches[name]
                                          - nccl_train_launches,
                                      "train_nccl_world_1":
                                          nccl_train_launches},
                library=rec["library"], shape={
                    k: rec[k] for k in ("B", "P", "N", "D", "dtype")},
                allreduce={k: rec[k] for k in (
                    "allreduce_ms", "allreduce_bytes",
                    "unpooled_exchange_bytes")}, allreduce_note=GLOO_NOTE)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1),
          "phase_seconds": seconds,
          "profiler": {"calls": PROFILER_SECONDS["calls"],
                       "seconds": round(PROFILER_SECONDS["seconds"], 1)}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
