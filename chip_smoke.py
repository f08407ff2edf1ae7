#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpudist_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # the acceptance run
    python3 chip_smoke.py --profile    # plus a torch.profiler breakdown
    python3 chip_smoke.py --only-tp    # phases 1-3 (flash), 6 and 21
    python3 chip_smoke.py --only-serve-mesh   # phases 1-3 (forward), 4, 22-23
    python3 chip_smoke.py --only-expert   # phases 1-3 (checks), 18a, 24
    python3 chip_smoke.py --only-context  # phases 1-3 (checks), 25
    python3 chip_smoke.py --only-overlap  # phases 1-3 (checks), 26
    python3 chip_smoke.py --only-overlap --only-context --context-drift \
        --only-expert    # the checks once, then 26, 25 + the CP fault, 24
    python3 chip_smoke.py --expert-drift  # phases 1-2; 24b's holds
                                          # against a mesh without the
                                          # expert axis, a planted fault

Phases, each of which fails the script (non-zero exit, no result line):

1. device: the card's name and power limit; TF32 switched off for f32
   matmuls and convolutions, so f32 means f32;
2. build: the three CUDA libraries (flash-attention forward; the dq,
   dk/dv and merged backward kernels; the fused LM-head cross-entropy
   forward and backward) from the sources in the checkout, one ``nvcc``
   for sm_90a each, started together; ptxas's register and spill report;
3. kernels vs plain: the forward kernel against its plain version (o and
   lse within f32 1e-4 / bf16 3e-2, two calls bitwise equal) on 41
   shapes (35 that take its 64-row blocks with split kv tiles, 6 whose
   grids take its 128-row blocks), and the three backward kernels,
   through the autograd Function, against ``flash_attention_bwd_plain``
   (each gradient's max |d| / max |plain| within f32 1e-4 / bf16 5e-2, a
   nonzero lse cotangent, two calls bitwise equal, the predicted route)
   on 55 shapes, 10 of them at the edges of the split pair's tiling, 6
   at the merged kernel's (seq 128 and 256, seq 512 over 256 keys) and
   the slice's three (b8 s2048 f32, b8 s512 f32 and bf16);
   each kernel's time at its main paths' shapes beside its bound (on the
   tensor cores' peak at hd 128), the plain version's and one PyTorch
   library call's (``scaled_dot_product_attention``, forward or
   ``autograd.grad`` through it): the forward at the serving prefill (b1
   s512 f32), the training slice (b8 s2048 f32, RoPE in the kernel) and
   phase 9 (b8 s512 bf16, RoPE in the kernel), where the library call
   takes q/k rotated before it and its time excludes the rotation; the
   dq + dk/dv pair's sum beside that call's whole backward; the merged
   kernel at seq 512 in f32 (phase 6) and bf16 (phase 9), with the split
   pair called on its inputs as a yardstick;
   3c. the fused LM-head kernels (tensor cores, ``mma.sync``: f32 as
   3xTF32, bf16), through their autograd Function, against
   ``fused_xent_fwd_plain`` / ``fused_xent_bwd_plain`` on 11 shapes:
   ``tpudist/selfcheck.py``'s four (d 256 f32), the bench geometry (t
   1024, V 32000, d 2048, bf16), phase 9's (t 4096, bf16), the slice's
   (t 16384, f32) and four at the edges of the kernels' tiling (t, V
   and d off the tiles and off 16-byte rows; d not a multiple of 8 in
   bf16; just over one backward chunk; t 16), two calls bitwise equal;
   their times at the slice's shape (f32) and at phase 9's (bf16)
   beside their bounds on the tensor cores, the plain versions' and
   ``F.cross_entropy(h @ emb.T)``'s in the same dtype (forward, and
   ``autograd.grad`` through it), and the head's peak device memory at
   the slice's shape, fused against that;
4. the serving slice at full width (BASELINE config #5, f32) on the
   graph engine: warmup (each body once eagerly, then the prefill and
   the decode ladder (8, 4, 2) captured as CUDA graphs) and 16 requests
   through ``ServeEngine`` + ``run_serve``, every request completed, the
   program pin (1 prefill, 3 decode graphs), the flash forward launched
   exactly n_layers x prefills (counted through the engine's graph
   accounting: a replay does not move the wrapper's counter), every
   request's tokens and one replayed prefill's first token against the
   engine's bodies called eagerly (a check, not a route), and that
   prefill's logits against the non-cached forward through the plain
   version;
   4b. serve overload on the same engine: a Poisson stream of 64
   requests at twice the requests/s phase 4 completed, a queue cap of 8,
   a TTFT deadline of 4 x phase 4's TTFT p50 and the ladder walked by
   the pressure controller: the exact shed partition, the pin, every
   admitted request completed with the tokens it gets in an unloaded
   run, the flash launches exact; then two runs of one seed on virtual
   time with equal summaries;
5. the train CLI at full width (BASELINE config #5, f32, batch 8,
   ``--lm-head auto``) at seq 2048 for 2 epochs (8 steps): the dq and
   dk/dv kernels in every layer's backward;
6. the same at seq 512 (the JAX package's bench shape) for 1 epoch (4
   steps): the merged backward kernel;
7. one full-width training step at seq 512 and 2048, and at 2048 with
   the fused head: the loss and every param grad through the kernels
   against the plain versions on the card (f32, 1e-4 of each tensor's
   largest element); with the fused head it also reports the head alone
   (lse, dh, dE) against float64, kernels and plain versions;
8. the train CLI at seq 2048 with ``--lm-head fused``, 1 epoch (4 steps):
   the fused head's kernels beside the flash kernels;
9. the train CLI at seq 512 in bf16 with ``--lm-head auto`` and
   ``--adam-nu-dtype bfloat16``, the device memory pinned so that auto
   picks the fused head, 1 epoch (4 steps);
10. data parallelism: (a) the train CLI as one process per visible card
   under the ``TPUDIST_COORDINATOR`` / ``TPUDIST_NUM_PROCESSES`` /
   ``TPUDIST_PROCESS_ID`` contract, NCCL, at seq 512, f32, ``--lm-head
   fused``, global batch 8, 1 epoch (4 steps): the contract on rank 0
   only, every rank's verdict and the final one, and each rank's own
   launch counts; (b) two ranks on the one card: NCCL refused (two ranks
   cannot share a card), then gloo passed explicitly (host copies) for
   two steps of the engine's data-parallel step at local batch 4, against
   one process at the global batch of 8: the losses and the gradients
   each step hands to Adam within f32 1e-4 (of each gradient's largest
   element), the two ranks' params bitwise equal, the params after the 2
   steps within 1e-4 of each param's largest element wherever the first
   gradient's |g| is at least 1 % of that tensor's largest (the elements
   left out are counted), and the step time labelled as gloo through
   host memory;
11. the superstep (k training steps a dispatch, CUDA graphs): (a) phase
   9's configuration with ``--log-every 4`` over 80 samples (10 steps
   an epoch: two full windows of k = 4 and a 2-step tail), 2 epochs,
   per-step and as the superstep under a ``TPUDIST_STAGING_BUDGET_MB``
   that holds two 4-step slabs of the staged token ids (each epoch
   streams in 3 slabs): each epoch's Avg and eval loss bitwise equal
   between the two, the programs pinned at 2, the replays those of the
   windows, both step times, the capture time, the graph pool and the
   staging verdict; (b) the MLP at the reference defaults (31 steps an
   epoch, auto k = 25), per-step and as the superstep in turns
   (per-step, superstep, superstep, per-step), the Avg and eval losses
   bitwise equal, the steps/s of each run; (c) phase 10a's spawn at
   80 samples with ``--log-every 4 --steps-per-dispatch 4``, the NCCL
   all-reduce captured: every rank's verdict, launches, programs and
   replays;
12. the measured-probe autotuner (``--autotune probe``), each trial
   printed (k, staging budget, remat, accumulation, steps/s and spread,
   peak reserved memory, graph pool, reserved memory after it, feasible
   or its error) with the reserved memory before and after the search:
   (a) the MLP at the reference defaults (the k ladder 1, 2, 4, 10, 20,
   25): the search succeeds from a probe within its 12 trials (plus two
   confirmations), the commit measures at least the heuristic start's
   steps/s, the card holds at most one trial's graph pool more after
   the search, every epoch's Avg and eval loss is bitwise an untuned
   run's at the committed point, and a second run on the same cache is
   a hit with 0 trials at the same point; then an OOM raised inside a
   probe's capture comes back as a pruned trial with the capture
   closed, the counters and reserved memory where they were, and the
   same probe then measures; (b) one full-width step (seq 512, f32,
   fused head) with and without ``--remat``, each replayed from a
   graph, the loss and every grad within f32 1e-4; then phase 11a's
   configuration at ``--log-every 8`` over 128 samples (16 steps; the k
   ladder 1, 2, 4, 8), 1 epoch, ``--autotune-trials 8``: the same
   search checks, the remat and accumulation points measured inside
   captured probes or pruned with their error, the timed run's launches
   exact with the probes' shown apart, its losses bitwise an untuned
   run's at the committed point (within f32 1e-4 of the committed
   schedule alone if a math knob moved), and the cached rerun;
13. the observability every default run writes (on in every CLI run
   above): (a) phase 11a's superstep run's directory: both traces with
   the JAX span names and nothing dropped, the beacon at the final
   step, a ``kind=hosts`` record an epoch, the memory ledger (its
   partition summing to the card's memory), ``kind=timing`` with
   ``0 < mfu <= 1.05`` over a flop count equal to its closed form,
   ``hbm_source`` ``memory_stats`` and a watermark at or above the run's
   ``max_memory_allocated``, ``run_id`` on every record; then the same
   configuration with ``--trace off --stall-timeout-s 0 --hbm-sample-s
   0`` and on again: the losses bitwise, the programs, replays and
   launches the same, the step times in turns; (b) phase 4's serving
   configuration through ``python -m tpudist_torch.serve`` (its
   ``run``), traced and with ``--trace off``: one slot track per slot
   that served, the ledger, the tokens equal, the program pin, the
   flash launches exact, tokens/s/chip of each; (c) a CUDA graph
   captured while an ``HbmSampler`` reads every millisecond (the capture
   holds, its replay equals the eager body), then a stall drill: a
   ``FlightRecorder`` with a 2 s window and no progress while that
   graph replays writes ``flightrec.worker0`` with the threads' stacks
   and the card's ``memory_stats``, the replays' output unchanged;
14. the paged serving plane at phase 4's configuration on the graph
   engine (``PagedServeEngine``, 16-token pages; its attention plain
   PyTorch, as the JAX package's is outside any Pallas kernel): (a)
   phase 4's 16 requests on the default pool (512 pages, the dense
   capacity): every request's tokens equal phase 4's dense tokens and
   the eager bodies', the pin (1 prefill, 3 decode, 0 verify graphs),
   the pool drained to 0 pages; (b) a 256-token shared prefix and
   ``speculate_k`` 4 against the dense engine on the same prefixed
   stream: the tokens equal, the pin (1, 3, 1), the registry's 16 pages
   held after the drain, the acceptance (drafted/accepted from the
   ``decode_emit`` instants) and tokens/s/chip and ITL p50 beside 14a's
   (printed, not gated); (c) the JAX package's fixed-memory pair
   (``bench.py``): the dense engine (8 slots, 536,870,912 bytes of
   cache) against 16 paged slots on 480 pages (``spec.bytes`` strictly
   smaller), 32 requests at t=0 with the prefix: equal tokens, a higher
   ``active_slots_peak``, at most 480 pages; (d) the serve CLI with
   ``--kv-page-tokens 16 --shared-prefix 256 --speculate-k 4``: the
   memory-bound line (bound by the graph pools), the ledger exact with
   ``kv_pool`` the pool's bytes, a slot track per serving slot and the
   ``kv_pages`` counter track, verdict ``success``. Tokens that differ
   from the dense run's fail unless the first divergence is a near-tie:
   the full forward's top-two logit gap there within 1e-4 of the
   logits' largest magnitude (printed and counted);
15. the serve tuner, the chaos surface and ``alert_events`` at phase 4's
   configuration: (a) ``python -m tpudist_torch.serve --serve-tune
   probe`` (its ``main``) with phase 4's flags: exit 0, one
   ``kind=serve_tune`` record from a probe (success, at most 8 trials,
   none pruned), the committed tokens/s at least the start's, the pin,
   the probes' launches off the counters, the tokens bitwise a
   ``--serve-tune off`` run's at the committed point; then
   ``cache-only``: a hit with 0 trials; (b) ``autotune_serve`` over the
   whole knob space (16 trials) in-process, each trial printed: none
   pruned, the reserved memory back within one trial's footprint, the
   launch counters untouched; (c) phase 4's stream at ``layout="hs"``
   and ``"st"``: the tokens equal or a near tie (14's rule), each run's
   tokens/s/chip and replayed decode superstep, no alert at the default
   gates (``--profile``: each superstep's busy share and largest
   kernels); (d) on virtual time through the CLI: ``--chaos
   serve_kill@0:3 --requeue-attempt 0`` in a process of its own exits
   137 with a flushed ``kind=chaos`` record and no summary, then
   ``--requeue-attempt 1`` classifies exactly the admitted rids with no
   terminal event as lost (``kind=serve_resume``), every rid in one
   terminal bucket across the attempts; ``serve_slow`` shows in the
   ITL p99 against a clean run; ``request_garbage`` gives six named
   rejections and the clean run's tokens; (e) phase 4b's overload with
   ``TPUDIST_SERVE_SHED_MAX=0.05``: exit 1, verdict ``fail``, each failed
   gate's alert fired mid-run. The phase's wall time is printed;
16. the serve drill (``tpudist_torch.serve.drill``) at BASELINE config
   #5's model (V 32000, L 4, d 2048, h 16, kv 16, d_ff 5504), prompts
   padded to 128 tokens (the flash kernel's least; cache rows of 256),
   with the drill's own slots and traffic: (a) ``run_matrix``
   then ``verify_matrix`` with ``TPUDIST_PLATFORM=cuda``, every attempt
   a ``python -m tpudist_torch.serve`` process on the card (overload
   twice, shed_breach, serve_kill with the policy's requeue,
   request_garbage, serve_slow, adapt): each scenario's verifier ``ok``,
   its facts and its attempts' wall printed, every attempt's
   ``kind=serve_warmup`` naming the card with a graph pool; (b) the
   overload scenario's attempt in-process through the serve CLI: the
   flash launches exact and its canonical summary (``ts``/``mono`` left
   out) equal to (a)'s ``overload0``. The phase's wall time is printed;
17. the train side's elastic and chaos plane at BASELINE config #5's
   width and depth in phase 9's training configuration (bf16, bf16 nu,
   the fused head, seq 512) under the chaos drill's ``BASE_FLAGS`` (8
   steps, sharded saves at steps 3, 6 and 8): the free disk printed
   first against the saves four families hold at once; (a)
   ``tpudist_torch.chaos.drill``'s
   baseline and its seven families (kill, hang, slow, corrupt_shard,
   torn_manifest, fs_error, telemetry_garbage; hang and
   telemetry_garbage with the live bus on: the mid-run ``stall`` alert,
   ``bad_frames`` >= 1 and a final ``status: ok``) with
   ``TPUDIST_PLATFORM=cuda``, every attempt
   a ``python -m tpudist_torch.train`` process on the card, four
   families at a time through ``run_family``, each through
   ``verify_family`` as it ends: each ``ok``, its
   pinned facts (rcs, fired faults, policy, resume step, steps lost,
   fallback, final step, the write counters) the CPU drill's, and its
   final committed crc signature the baseline's, the bitwise-resume pin;
   each verified directory's shard files are deleted as soon as it is
   verified (the verifier reads only json); (b) the baseline's flags
   in-process through the train CLI: the kernel launches exact, the
   final crc signature equal to (a)'s baseline; (c) enqueue and drain
   ms, the bytes a save writes and the writer's GB/s for synchronous and
   asynchronous sharded saves every 2 steps, per-step, and the steps/s
   of each against a run with no mid-epoch save. The phase's wall time
   is printed;
18. the MoE model at ``bench.py``'s MoE row (V 32000, L 4, d 2048, h 16,
   kv 16, d_ff 2752 an expert, 8 experts, top 2, capacity factor 1.25,
   routing groups of 256; 673.8 M params), seq 512: (a) the train CLI
   with ``--model moe`` in bf16 with the bf16 nu, ``--lm-head fused`` and
   ``--lr 1e-3``, batch 8, 32 samples, 2 epochs, per-step and as the
   superstep (auto k = 4: one eager window, one replay): the contract,
   falling losses, verdict ``success``, exact launches, the flop count
   equal to its closed form (the capacity rows and the dispatch/combine
   products) and ``0 < mfu <= 1.05``, each epoch's Avg and eval loss
   bitwise equal between the two, steps/s, tokens/s and peak memory;
   (b) one f32 step, plain and fused head: the loss and every param
   grad (the router's and every expert's) through the kernels against
   the plain versions within f32 1e-4, and how many token-layer
   routings the two runs made differently; (c) phase 4's stream on
   ``ServeEngine`` over the MoE in f32 on CUDA graphs: the pin, exact
   flash launches, tokens equal to the eager bodies', a replayed
   prefill's logits within 1e-3 of the plain forward's; then on
   ``PagedServeEngine`` (16-token pages): tokens equal to the dense
   engine's or a first divergence at a near-tie (14's rule); (d)
   ``python -m tpudist_torch.serve --model moe`` at phase 4's flags:
   exit 0, the verdict and the SLO status ``success``, the pin. The
   phase's wall time is printed;
19. the rest of observability: (a) phase 11a's superstep run with ``--live
   on --live-port P --profile-window 2`` (P a free port): exit 0 and
   ``success``; ``/healthz`` and ``/metrics`` scraped by a thread while
   it runs, an answer with the pod steps/s gauge; ``live_status.json``
   ending ``ok`` with 0 bad frames; the ``kind=devtime`` record
   (``comm_status`` success, window and compute > 0, 2 dispatches, one
   device track named for the card); the capture's device ops naming
   rows 1, 2, 5 and 6's kernels (the profiler sees inside replayed CUDA
   graphs); ``pod_trace.json``'s devtime rows inside the
   ``profile_window`` span; each epoch's Avg and eval bitwise 11a's;
   exact launches; the window's device busy share and its top five
   device ops; (b) one epoch of 11a's configuration with ``--profile-dir``
   (per-step, the tuner off though asked for), its Kineto trace read by
   ``analyze_capture``, exact launches; then ``python -m
   tpudist_torch.bench.profile`` at that configuration, ``--steps 5``:
   exit 0, its ops naming rows 1 and 5's kernels, ``total_us_per_step``
   beside the StepTimer's step; (c) ``python -m tpudist_torch.serve
   --live-port P`` at phase 4's configuration: a scrape with the serve
   gauges while it serves, exit 0, the pin, exact launches, the tokens
   of a run without the port. The phase's wall time is printed.
20. FSDP at phase 9's configuration (config #5, seq 512, bf16, bf16 nu,
   fused head, batch 8): (a) in a spawned process, a one-rank NCCL
   group and its mesh; the replicated step body 4 steps, the sharded
   body (its all-gathers and reduce-scatters issued over the one-rank
   fsdp group) 8 steps and an eval, bitwise the replicated one after 4
   (losses, params, mu, nu), then as a k = 4 superstep over the same 8
   steps (the first window eager with the captures, the second
   replayed) and the eval, bitwise its per-step run with 2 programs and
   one replay; exact launches for both runs; the step's collective rows
   (``reduced_operands``), the step times and the peak memory; (b) with
   two cards or more, the train CLI at one NCCL process a card,
   replicated and with ``--fsdp <cards>``: every verdict ``success``,
   exact launches on every rank, the step losses within rtol 2e-3 /
   atol 2e-4 of each other, each rank's params and optimizer-state
   bytes side by side.
21. tensor parallelism at phase 6's configuration: (a) in a spawned
   process, the tensor path on a one-rank NCCL mesh's tensor group,
   bitwise the replicated body per step and replayed; (b) with two
   cards or more, the train CLI at ``--tensor <cards>`` and ``--fsdp 2
   --tensor 2`` against phase 6's losses, the MoE at ``--tensor
   <cards>`` against its one-card run.
22. serving on several cards: (a) in a spawned process, a one-rank NCCL
   serve mesh; phase 4's engine on it over phase 4's stream and phase
   18c's dense MoE engine (its decode graphs capturing the all-gather of
   the router probabilities over the slot group): every request's
   tokens bitwise phase 4's and 18c's, the pin, exact launches, every
   prefill on the rank, ``n_chips`` 1; (b) with two cards or more, the
   serve CLI at one NCCL process a card at phase 4's flags (8 slots),
   phase 18d's MoE flags and 8 slots a card over 16 requests a card:
   exit 0 and ``success`` on every rank, ``n_chips`` the cards, each
   rank's pin and launches (n_layers x (its prefills + the warm-up's)),
   the prefills over the ranks the requests, every request's tokens
   those of one card (the serve CLI there; phase 4's engine for the
   third) or a near-tie under phase 14's rule; tokens/s/chip, TTFT and
   ITL beside one card's. ``--only-serve-mesh`` runs phase 3's forward
   checks, phase 4, phase 22 (22a without the MoE) and phase 23 alone.
23. the paged plane on a serve mesh: (a) in a spawned process, a
   one-rank NCCL serve mesh; ``PagedServeEngine(mesh=...)`` over phase
   14a's paged stream, 14b's shared prefix with speculation and 18c's
   paged MoE: every request's tokens bitwise those phases', the pins (1,
   3, 0) and (1, 3, 1), exact launches (n_layers x (prefills +
   registrations + the warm-up's)), every prefill on the rank; (b) with
   two cards or more, the serve CLI at one NCCL process a card with
   ``--kv-page-tokens 16`` (the pool replicated), ``--kv-pages 479``
   (its 480 rows split over the cards: each card's pool bytes printed),
   ``--speculate-k 4 --shared-prefix 256``, the MoE paged and
   ``--serve-tune probe``, each against one card's run (tokens equal or
   a near-tie, every rank's pin, prefills and launches, tokens/s/chip,
   TTFT and ITL beside one card's); then ``serve_kill`` at dispatch 3
   and the requeued attempt (rank 0 exits 137, every other rank
   non-zero in bounded time, the lost bucket exact, every rid in one
   terminal bucket) and the serve drill's matrix with each attempt on
   one process a card. In
   ``--only-serve-mesh`` 23a's references are 14a's and 14b's engines
   run on one card there, and 23a runs without the MoE.
24. the MoE's expert axis at phase 18a's configuration: (a) in a
   spawned process, a one-rank NCCL mesh whose expert group the layout
   takes (the routed FFN's entries and exit over it, this rank's
   columns of dispatch and combine), 18a's two epochs per-step and as
   the k = 4 superstep: the step losses at 18a's records and the evals
   bitwise 18a's, the superstep bitwise its per-step run (2 programs,
   one replay), exact launches, the step's all-reduces those of the
   sharded body plus three a layer; (b) under ``--only-expert``, with
   two cards or more, the train CLI at one NCCL process a card:
   ``--expert <cards>`` at 18a's flags beside 18a's run (within 5e-2),
   then in f32 over 4 steps against one card's run of the same flags
   (rtol 2e-3 / atol 2e-4) ``--expert <cards>``, ``--data 2 --expert
   2``, ``--fsdp 2 --expert 2``, ``--tensor 2 --expert 2`` (four cards)
   and at ``--fsdp <cards>`` a routing group spanning ranks and
   ``--grad-accum-steps 2``; every verdict ``success``, exact launches
   a rank, each rank's params and Adam bytes, the step time and
   tokens/s/chip beside one card's, rank 0's exposed comm share from a
   ``--profile-window 1`` capture.
25. context parallelism: (a) on one card, the JAX selfcheck's ring-merge
   check (two disjoint-kv flash calls merged by ``merge_partials``
   against one whole-kv call, forward and grads, at b2 s1024 h4 kv2 in
   bf16 at its tolerances and in f32 at 1e-4), then the zigzag ring with
   flash hops over 4 virtual ranks in one process (the injectable
   rotation) at config #5's attention (b8 s2048 h16 kv16 f32, h16 kv4
   bf16) against one causal flash call over the whole sequence and the
   einsum ring, forward and grads at phase 3's tolerances, exact
   launches (1 + 2 (n - 1) forward calls a virtual rank, each with its
   merged backward), and the hop shapes' times beside their bounds and
   SDPA; (b) under ``--only-context``, with two cards or more, the train
   CLI at one NCCL process a card at config #5's width, seq 2048, f32,
   over 4 steps, each against one card's run of the same flags (the
   transformer within 2e-4 absolute, the MoE at rtol 2e-3 / atol
   2e-4): ``--context <cards>`` with the ring and with
   Ulysses and with the fused head, ``--data 2 --context 2``, ``--fsdp 2
   --context 2``, ``--tensor 2 --context 2`` (four cards), the MoE in
   f32 at capacity 4.0 at ``--data 2 --context 2`` and ``--expert 2
   --context 2``, then ``--context <cards>`` as the k = 2 superstep
   bitwise its per-step run; every verdict ``success``, exact launches
   a rank, step time and tokens/s/chip beside one card's, rank 0's
   exposed comm share. 25a also runs the ring at the MoE's hop shape
   under ``--context 4`` at seq 512 (hops of 64, which the kernel does
   not take): the einsum hops, routed from the shapes and named in one
   line, against one dense causal call, no kernel launched;
   ``--context-drift`` adds 25b's ring run with the context ranks left
   out of the step's mean, against 25b's hold.
26. under ``--only-overlap``, the overlap plane and the collective
   harness: (a) on one card, phase 6's model through the replicated
   data-parallel step on a one-rank NCCL group, ``--grad-overlap off``
   against ``bucketed`` at 4 MB and 1 MB bitwise over 8 steps (losses,
   params, ``mu``, ``nu``), the bucketed k = 4 superstep bitwise its
   per-step run (2 programs, one replay), launches exact; (b) with two
   cards or more, the train CLI at ``--data <cards>`` with phase 6's
   flags in f32 over 4 steps and 2 evals: ``off``, ``bucketed`` 4 MB
   and 64 MB bitwise on every rank, the bucketed k = 2 superstep
   bitwise its per-step run, under ``TPUDIST_SLICE_MAP=2`` ``flat``
   against ``hierarchical`` bitwise with the gradients' cross-slice
   bytes in the ratio 2, ``--autotune probe`` over the bucket axis
   (committed steps/s at least the start's, losses bitwise an untuned
   run's at the point), ``--fsdp 2 --data 2 --grad-overlap bucketed``
   refused on every rank with the JAX message; each run's step time and
   rank 0's exposed comm share; (c) each collective at 1 MB against
   its closed form on the card, then ``python -m
   tpudist_torch.bench.sweep`` over one NCCL process a card, all five
   kinds from 1 MB to 1 GB, its exit code and verdict those of
   ``gate(records)``, ``--peak-gbps`` far below and far above the
   measured bus bandwidth (exit 0 ``success``, exit 1 ``fail``), the
   best bus GB/s per kind beside the card's NVLink peak and topology.

Phases 4, 4b, 5-6, 8-9, 10a, 11a, 11c, 12b, 13a, 13b, 14a-14d, 15a,
15c-15e (15d's requeued, stalled, garbage and clean runs), 16b, 17b,
18a (both runs), 18c (both engines), 18d, 19a-19c (19c's run with the
port), 20a (both sharded runs), 20b (both runs), 21a-b, 22a (both
engines), 22b (its three runs), 23a (its three engines), 23b (its
five CLI runs), 24a (both runs), 24b (its runs and their one-card
references), 25a (the flash-hop ring) and 25b (its runs, their one-card
references and the superstep), 26a (its four runs) and 26b (its runs)
are the main paths:
each
runs with every launch count set to 0 just before and read just after
(10a, 11c, 20a-24b, 25b, 26a-b in each rank's process; 12b's and 15a's timed
runs, not
their probes, which restore the counters), and each
kernel must have launched the
exact number of times its path calls it, counting the launches a CUDA
graph's replays ran (the superstep's record of its captures times its
replays; a replay does not move the wrappers' counters). The training
phases also check the stdout contract, a falling loss and the
``success`` verdict files.
``--profile`` adds torch.profiler breakdowns of the serving windows (8
prefills and one decode superstep, replayed and as eager bodies, with
the flash kernels counted in the replayed prefills; one replayed paged
decode superstep and one verify dispatch, phase 14b's) and of two training
steps at seq 2048 (plain and
fused head), 512 and 512 in bf16 with the fused head (phase 9's
configuration; device time by kernel, busy share), of two MoE steps in
phase 18a's configuration (the expert GEMMs' and the dispatch/combine
products' device time read from ``aten::bmm``'s input shapes), of one
replayed
superstep against as many per-step steps (phase 11's MLP at k = 25 and
seq 512 bf16 at k = 4; wall, kernel time, busy share), and the rates
mma.sync reaches (``tpudist_torch/csrc/mma_peak.cu``).
The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores (the flash backward at hd 256 does f32 FMA), bf16 tensor cores,
# HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the flash forward, the flash backward at hd 128 and the fused LM-head
# kernels run their f32 products on the tensor cores as 3xTF32:
# three TF32 products for each f32 one, so a third of the 495 TFLOP/s
# TF32 peak
TC_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
# backward gradients: max |kernel - plain| / max |plain|
BWD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def build_all(build, fa, fx):
    """Phase 2: build every kernel library of the port's paths from the
    checkout, one nvcc each, all started together; print ptxas's
    register and spill report."""
    from concurrent.futures import ThreadPoolExecutor

    libs = ((fa.LIBRARY, fa.SOURCES), (fa.BWD_LIBRARY, fa.BWD_SOURCES),
            (fx.LIBRARY, fx.SOURCES))
    with ThreadPoolExecutor(len(libs)) as pool:
        results = list(pool.map(lambda lib: build.build(*lib), libs))
    for (name, _), res in zip(libs, results):
        ptxas = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        print(f"build: {name}: {res.path.name} ({res.seconds:.2f} s)")
        for ln in ptxas:
            print(f"build:   {ln}")


def time_ms(torch, fn, *, warmup: int = 3, runs: int = 25,
            inner: int = 10) -> float:
    """Median over ``runs`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events, after ``warmup`` calls. Each run
    first queues a ~10 ms spin on the card, so the host has queued the
    calls before the start event: a call shorter than its own host-side
    cost is timed on the device, not at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # cycles
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_bound(b, s, sk, h, kv, hd, dtype: str, causal: bool,
                    rope: bool = False):
    """(bound_ms, bound_by) of one attention forward: the larger of the
    FLOPs of the two products over the tensor cores' peak for ``dtype``
    (``TC_PEAK_FLOPS``: 3xTF32 for f32) and the bytes
    of q, k, v, o and lse (each once; and the f32 RoPE tables with
    ``rope``) over HBM bandwidth. Causal counts the s(s+1)/2 query-key
    pairs the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * sk
    flops = 4 * b * h * hd * pairs
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * (2 * b * s * h * hd + 2 * b * sk * kv * hd) \
        + 4 * b * h * s + (2 * 4 * s * hd // 2 if rope else 0)
    t_ops = flops / TC_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(torch, fa, F):
    """Phase 3: the flash kernel against its plain version, two calls
    bitwise equal, on every shape; and its times at the main paths'
    shapes. Returns the kernel's record."""
    from tpudist_torch.ops.rope import apply_rope

    shapes = [(1, 512, 16, 16, 128, "float32", True, False),   # serving
              (1, 128, 16, 16, 128, "float32", True, False)]   # drill
    for (b, s, h) in ((4, 512, 8), (1, 2048, 4)):            # selfcheck
        for kv in ((8, 2) if h == 8 else (4, 2)):
            for dt in ("bfloat16", "float32"):
                for causal in (True, False):
                    for rope in (False, True):
                        shapes.append((b, s, h, kv, 128, dt, causal, rope))
    for dt in ("bfloat16", "float32"):                       # hd 256
        shapes.append((1, 512, 4, 2, 256, dt, True, True))
    # grids that fill the card: the kernel's 128-row blocks (the shapes
    # above take its 64-row blocks with split kv tiles)
    for dt in ("bfloat16", "float32"):
        shapes += [(8, 512, 16, 16, 128, dt, True, True),
                   (8, 512, 16, 4, 128, dt, False, dt == "bfloat16"),
                   (8, 512, 16, 8, 256, dt, True, True),
                   # phase 21: config #5's heads on one of 4 tensor ranks
                   (8, 512, 4, 4, 128, dt, True, True)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bad = []
    serving_err = None
    print(f"{'shape':44s} {'o err':>10s} {'lse err':>10s} {'atol':>7s} "
          f"bitwise")
    for (b, s, h, kv, hd, dt, causal, rope) in shapes:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, s, kv, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, s, kv, hd, device="cuda", generator=gen).to(dtype)
        cos = sin = None
        if rope:
            ang = torch.rand(s, hd // 2, device="cuda", generator=gen) * 6.3
            cos, sin = ang.cos(), ang.sin()

        def run():
            if rope:
                o = fa.flash_attention(q, k, v, cos=cos, sin=sin,
                                       causal=causal)
                qr, kr = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
                return o, fa.flash_attention_with_lse(qr, kr, v,
                                                      causal=causal)[1]
            return fa.flash_attention_with_lse(q, k, v, causal=causal)
        with torch.no_grad():
            o, lse = run()
            o2, lse2 = run()
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                                causal=causal)
        o_err = (o.float() - po.float()).abs().max().item()
        l_err = (lse - plse).abs().max().item()
        bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        name = (f"b{b} s{s} h{h} kv{kv} hd{hd} {dt} "
                f"{'causal' if causal else 'full'}"
                f"{' rope' if rope else ''}")
        ok = max(o_err, l_err) <= ATOL[dt] and bitwise and bool(
            torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        print(f"{name:44s} {o_err:10.3e} {l_err:10.3e} {ATOL[dt]:7.0e} "
              f"{bitwise}{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
        if serving_err is None:
            serving_err = max(o_err, l_err)
    if bad:
        fail(f"flash kernel disagrees with its plain version (or is not "
             f"deterministic) on {len(bad)} shape(s): {bad}")

    # the main paths' shapes: serving prefill (b1 s512, no RoPE), the
    # drill's prefill (phase 16: b1 s128, no RoPE), the training slice
    # (b8 s2048, RoPE in the kernel), phase 9 (b8 s512 bf16, RoPE in
    # the kernel) and phase 21's tensor rank of 4 (b8 s512 h4 f32)
    rows = []
    few = dict(warmup=1, runs=5, inner=2)
    for (b, s, h, kv, hd, dt, rope) in (
            (1, 512, 16, 16, 128, "float32", False),
            (1, 128, 16, 16, 128, "float32", False),
            (8, 2048, 16, 16, 128, "float32", True),
            (8, 512, 16, 16, 128, "bfloat16", True),
            (8, 512, 4, 4, 128, "float32", True)):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, s, n, hd, device="cuda",
                               generator=gen).to(dtype)
                   for n in (h, kv, kv))
        cos = sin = None
        if rope:
            ang = torch.rand(s, hd // 2, device="cuda", generator=gen) * 6.3
            cos, sin = ang.cos(), ang.sin()
        big = b * s > 4096   # the plain version's scores take seconds
        with torch.no_grad():
            kernel_ms = time_ms(torch, lambda: fa.flash_attention(
                q, k, v, cos=cos, sin=sin))
            plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, cos=cos, sin=sin), **(few if big else {}))
            # the library call takes q/k rotated up front: its time
            # excludes the rotation
            qr, kr = ((apply_rope(q, cos, sin), apply_rope(k, cos, sin))
                      if rope else (q, k))
            qt, kt, vt = (x.transpose(1, 2) for x in (qr, kr, v))
            library_ms = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
        bound_ms, bound_by = attention_bound(b, s, s, h, kv, hd, dt, True,
                                             rope)
        shape = (f"b{b} s{s} h{h} kv{kv} hd{hd} {dt} causal"
                 f"{' rope' if rope else ''}")
        note = " (on q/k rotated before it, not timed)" if rope else ""
        print(f"flash_attention_fwd at {shape}: kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
              f"{library_ms:.4f} ms{note}, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        rows.append({"shape": shape, "ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        del q, k, v, qr, kr, qt, kt, vt
        torch.cuda.empty_cache()
    serving = rows[0]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "tpudist_torch/csrc/flash_attention_fwd.cu",
            "replaces": "tpudist/ops/pallas/flash_attention.py:149",
            "launches": None, "max_abs_err": serving_err,
            "ms": serving["ms"], "plain_ms": serving["plain_ms"],
            "bound_ms": serving["bound_ms"],
            "bound_by": serving["bound_by"],
            "library_ms": serving["library_ms"], "shape": serving["shape"],
            "timings": rows}


def backward_peak(hd: int):
    """The peak a flash backward kernel's operations are bounded by: every
    backward kernel runs on the tensor cores at hd 128 (``TC_PEAK_FLOPS``)
    and does f32 FMA on the CUDA cores at hd 256 (``PEAK_FLOPS``)."""
    return TC_PEAK_FLOPS if hd == 128 else PEAK_FLOPS


def backward_bound(b, s, h, kv, hd, dtype: str, causal: bool,
                   products: int, outputs: str, peak, rope: bool = True):
    """(bound_ms, bound_by) of one flash backward kernel: ``products``
    matrix products over the kept query-key pairs (dq 3, dk/dv 4, merged
    5) over ``peak[dtype]`` (:func:`backward_peak`), against the bytes of
    q, k, v, do, lse, delta and (``rope``) the RoPE tables read once and
    of ``outputs`` (a string of q/k/v: which gradients it writes)
    written once. The merged kernel's workspace is its own traffic, not
    the function's."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = products * 2 * b * h * hd * pairs
    elt = 4 if dtype == "float32" else 2
    qsz, ksz = b * s * h * hd, b * s * kv * hd
    nbytes = (elt * (2 * qsz + 2 * ksz) + 2 * 4 * b * h * s
              + (2 * 4 * s * hd // 2 if rope else 0)
              + elt * sum(qsz if o == "q" else ksz for o in outputs))
    t_ops = flops / peak[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bwd_inputs(torch, gen, b, s, h, kv, hd, dtype, rope, sk=None):
    sk = s if sk is None else sk
    q = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, sk, kv, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, sk, kv, hd, device="cuda", generator=gen).to(dtype)
    do = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
    dlse = torch.randn(b, h, s, device="cuda", generator=gen) * 0.1
    cos = sin = None
    if rope:
        ang = torch.rand(s, hd // 2, device="cuda", generator=gen) * 6.3
        cos, sin = ang.cos(), ang.sin()
    return q, k, v, do, dlse, cos, sin


def check_flash_bwd(torch, fa):
    """Phase 3b: the three backward kernels, through the autograd
    Function, against ``flash_attention_bwd_plain`` on the same forward
    outputs; each gradient judged by max |d| / max |plain| (f32 1e-4,
    bf16 5e-2), two calls bitwise equal, and the route the Python rule
    (``uses_merged_backward``) predicts. Beside selfcheck's shapes and the
    slice's, shapes at the edges of the split pair's tensor-core tiling:
    seq 384 (the split pair, as in the JAX package) and 640, four q heads
    a kv head at seq 1024, a non-causal seq 512 over 1024 keys and a grid
    of 64 blocks (b1 h4 s2048); and at the merged kernel's: one key tile
    (seq 128, four q heads a kv head), two (seq 256) and a non-causal seq
    512 over 256 keys; each in f32 and bf16. The slice's shapes are b8
    h16 kv16 hd128 causal with RoPE: seq 2048 f32 (the split pair), seq
    512 f32 (phase 6) and bf16 (phase 9; the merged kernel). Returns each
    kernel's max |kernel - plain| over its own outputs at the slice's
    shapes, keyed by (kernel, dtype)."""
    shapes = []   # (b, s, sk, h, kv, hd, dtype, causal, rope)
    for (b, s, h) in ((4, 512, 8), (1, 2048, 4)):            # selfcheck
        for kv in ((8, 2) if h == 8 else (4, 2)):
            for dt in ("bfloat16", "float32"):
                for causal in (True, False):
                    for rope in (False, True):
                        shapes.append((b, s, s, h, kv, 128, dt, causal,
                                       rope))
    for dt in ("bfloat16", "float32"):                       # hd 256
        shapes.append((1, 512, 512, 4, 2, 256, dt, True, True))
        shapes.append((1, 1024, 1024, 4, 2, 256, dt, False, True))
    for dt in ("bfloat16", "float32"):                       # tiling edges
        shapes += [(2, 384, 384, 8, 2, 128, dt, True, True),
                   (2, 640, 640, 4, 4, 128, dt, True, True),
                   (2, 1024, 1024, 16, 4, 128, dt, True, True),
                   (2, 512, 1024, 8, 8, 128, dt, False, False),
                   (1, 2048, 2048, 4, 4, 128, dt, True, True)]
    for dt in ("bfloat16", "float32"):                       # merged edges
        shapes += [(4, 128, 128, 8, 2, 128, dt, True, True),
                   (4, 256, 256, 8, 8, 128, dt, True, True),
                   (4, 512, 256, 8, 4, 128, dt, False, False)]
    for dt in ("float32", "bfloat16"):       # phase 21: 1 of 4 tensor ranks
        shapes += [(8, 512, 512, 4, 4, 128, dt, True, True),
                   (8, 2048, 2048, 4, 4, 128, dt, True, True)]
    shapes.append((8, 2048, 2048, 16, 16, 128, "float32", True,
                   True))                                    # slice
    for dt in ("float32", "bfloat16"):                      # phases 6, 9
        shapes.append((8, 512, 512, 16, 16, 128, dt, True, True))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bad, slice_err = [], {}
    print(f"{'backward shape':52s} {'kernel':>6s} {'dq':>9s} {'dk':>9s} "
          f"{'dv':>9s} {'tol':>6s} bitwise")
    for (b, s, sk, h, kv, hd, dt, causal, rope) in shapes:
        tol = BWD_RTOL[dt]
        q, k, v, do, dlse, cos, sin = _bwd_inputs(
            torch, gen, b, s, h, kv, hd, getattr(torch, dt), rope, sk)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        counts = (fa.dq_launches, fa.dkv_launches, fa.dqkv_launches)
        o, lse = fa._Flash.apply(q, k, v, cos, sin, causal)
        grads = torch.autograd.grad((o, lse), (q, k, v), (do, dlse),
                                    retain_graph=True)
        again = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        torch.cuda.synchronize()
        ran = [n for n, c0, c1 in zip(
            ("dq", "dkv", "dqkv"), counts,
            (fa.dq_launches, fa.dkv_launches, fa.dqkv_launches))
            if c1 > c0]
        with torch.no_grad():
            ref = fa.flash_attention_bwd_plain(
                q.detach(), k.detach(), v.detach(), o.detach(),
                lse.detach(), do, dlse, cos=cos, sin=sin, causal=causal)
        abs_errs = [(g.float() - r.float()).abs().max().item()
                    for g, r in zip(grads, ref)]
        errs = [e / max(r.float().abs().max().item(), 1e-30)
                for e, r in zip(abs_errs, ref)]
        bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in grads)
        want = (["dqkv"] if fa.uses_merged_backward(s, sk)
                else ["dq", "dkv"])
        ok = max(errs) <= tol and bitwise and finite and ran == want
        name = (f"b{b} s{s}{f' sk{sk}' if sk != s else ''} h{h} kv{kv} "
                f"hd{hd} {dt} {'causal' if causal else 'full'}"
                f"{' rope' if rope else ''}")
        print(f"{name:52s} {'+'.join(ran):>6s} {errs[0]:9.2e} "
              f"{errs[1]:9.2e} {errs[2]:9.2e} {tol:6.0e} {bitwise}"
              f"{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
        # the slice's shapes: each kernel's own outputs
        if b == 8 and h == 16:
            outputs = {"dq": (0,), "dkv": (1, 2), "dqkv": (0, 1, 2)}
            for kname in ran:
                slice_err[kname, dt] = max(abs_errs[i]
                                           for i in outputs[kname])
        del q, k, v, o, lse, grads, again, ref
    torch.cuda.empty_cache()
    if bad:
        fail(f"flash backward kernels disagree with their plain version "
             f"(or are not deterministic, or took the wrong route) on "
             f"{len(bad)} shape(s): {bad}")
    return slice_err


def time_flash_bwd(torch, fa, F, slice_err):
    """Phase 3c: each backward kernel's time at the shapes its main paths
    give it (b8 h16 kv16 hd128 causal with RoPE: dq and dk/dv at seq 2048
    f32; the merged kernel at seq 512 in f32, phase 6, and in bf16, phase
    9), beside its bound, the plain backward's time and
    torch.autograd.grad through scaled_dot_product_attention at the same
    shape and dtype; the dq + dk/dv pair's sum, the function that library
    call computes, beside it; and at seq 512 the split pair called
    directly on the merged kernel's inputs, a yardstick (not a route).
    Returns the kernels' records (launches filled in by the training
    phases)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    records = {}
    for s, dt, kernels in ((2048, "float32", ("dq", "dkv")),
                           (512, "float32", ("dqkv",)),
                           (512, "bfloat16", ("dqkv",))):
        b, h, kv, hd = 8, 16, 16, 128
        q, k, v, do, dlse, cos, sin = _bwd_inputs(
            torch, gen, b, s, h, kv, hd, getattr(torch, dt), True)
        kw = dict(cos=cos, sin=sin, causal=True)
        with torch.no_grad():
            o, lse = fa._Flash.apply(q, k, v, cos, sin, True)
            delta = fa._delta(o, do, dlse)
            plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, dlse, **kw))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dout = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dout, retain_graph=True))
        shape = f"b{b} s{s} h{h} kv{kv} hd{hd} {dt} causal rope"
        peak = backward_peak(hd)
        bound_peak = ("cuda cores fma" if peak is PEAK_FLOPS else
                      "tensor cores 3xTF32" if dt == "float32"
                      else "tensor cores bf16")
        for name in kernels:
            fn = {"dq": fa.flash_attention_bwd_dq,
                  "dkv": fa.flash_attention_bwd_dkv,
                  "dqkv": fa.flash_attention_bwd_dqkv}[name]
            with torch.no_grad():
                kernel_ms = time_ms(torch, lambda: fn(q, k, v, do, lse,
                                                      delta, **kw))
            products, outputs = {"dq": (3, "q"), "dkv": (4, "kv"),
                                 "dqkv": (5, "qkv")}[name]
            bound_ms, bound_by = backward_bound(b, s, h, kv, hd, dt, True,
                                                products, outputs, peak)
            print(f"flash_attention_bwd_{name} at {shape}: kernel "
                  f"{kernel_ms:.4f} ms, plain backward {plain_ms:.4f} ms, "
                  f"autograd.grad through scaled_dot_product_attention "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}, {bound_peak} "
                  f"{peak[dt] / 1e12:.0f} TFLOP/s)")
            timing = {"max_abs_err": slice_err.get((name, dt)),
                      "ms": kernel_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_peak": bound_peak, "library_ms": library_ms,
                      "shape": shape}
            if dt == "bfloat16":
                records[name]["bf16"] = timing
                continue
            records[name] = {
                "name": f"flash_attention_bwd_{name}", "route": "cuda",
                "source": "tpudist_torch/csrc/flash_attention_bwd.cu",
                "replaces": {"dq": "tpudist/ops/pallas/flash_attention.py"
                                   ":296",
                             "dkv": "tpudist/ops/pallas/flash_attention.py"
                                    ":354",
                             "dqkv": "tpudist/ops/pallas/flash_attention"
                                     ".py:423"}[name],
                "launches": None, **timing}
        if s == 2048:
            pair = [records["dq"], records["dkv"]]
            pair_ms = sum(r["ms"] for r in pair)
            bound_ms = sum(r["bound_ms"] for r in pair)
            for r in pair:
                r["pair_ms"] = pair_ms
            print(f"flash backward pair (dq + dk/dv) at {shape}: "
                  f"{pair_ms:.4f} ms, bound {bound_ms:.4f} ms; "
                  f"autograd.grad through scaled_dot_product_attention "
                  f"(all three gradients) {library_ms:.4f} ms "
                  f"({pair_ms / library_ms:.2f}x)")
        else:
            fa.dqkv_workspace_slots = None
            with torch.no_grad():
                fa.flash_attention_bwd_dqkv(q, k, v, do, lse, delta, **kw)
                slots = fa.dqkv_workspace_slots
                split_ms = time_ms(torch, lambda: (
                    fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                    fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               **kw)))
            rec = records["dqkv"] if dt == "float32" \
                else records["dqkv"]["bf16"]
            rec["split_pair_ms"] = split_ms
            rec["workspace_slots"] = slots
            print(f"flash backward at {shape}: merged kernel "
                  f"{rec['ms']:.4f} ms; the split pair (dq + dk/dv called "
                  f"directly, a yardstick, not a route) {split_ms:.4f} ms; "
                  f"the merged kernel's f32 workspace {slots} slots, "
                  f"{4 * slots * b * h * s * hd / 1e6:.1f} MB")
        del q, k, v, do, o, lse, delta, qt, kt, vt, out
        torch.cuda.empty_cache()
    return list(records.values())


def xent_bound(t, v, d, dtype: str, products: int, backward: bool):
    """(bound_ms, bound_by) of the fused head: ``products`` matrix
    products of 2 t V d operations over the tensor cores' peak for
    ``dtype`` (``TC_PEAK_FLOPS``: 3xTF32 for f32), against
    the bytes of h, E, the int64 targets and the f32 per-token vectors
    (loss and lse out; or lse and ct in, dh and dE out) moved once."""
    flops = products * 2 * t * v * d
    elt = 4 if dtype == "float32" else 2
    operands = elt * (t * d + v * d)
    nbytes = operands * (2 if backward else 1) + 8 * t + 2 * 4 * t
    t_ops = flops / TC_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _xent_inputs(torch, gen, t, v, d, dtype):
    """selfcheck's data: h ~ N(0, 1), E ~ 0.02 N(0, 1), uniform targets."""
    h = torch.randn(t, d, device="cuda", generator=gen).to(dtype)
    emb = (torch.randn(v, d, device="cuda", generator=gen) * 0.02).to(dtype)
    tgt = torch.randint(0, v, (t,), device="cuda", generator=gen)
    return h, emb, tgt


def check_fused_xent(torch, fx):
    """Phase 3c: the fused LM-head kernels, through the autograd Function
    (mean loss, grads by ``torch.autograd.grad``), against
    ``fused_xent_fwd_plain`` / ``fused_xent_bwd_plain`` on the card.
    ``tpudist/selfcheck.py``'s shapes at d 256 f32 (loss rtol 1e-4; dh
    and dE rtol 1e-3, atol 5e-3/t), the bench geometry in bf16 (loss
    within 5e-2 of the f32 plain loss, grads finite and within 5e-2 of
    each gradient's largest element against the bf16 plain version), the
    slice's shape in f32 and four shapes at the edges of the kernels'
    tiling, each held to its dtype's tolerance; every shape also run
    twice, bitwise equal.
    The bf16 case at t 4096 (= b8 x s512, phase 9's shape) is above the
    backward's 2048-token chunk, so it holds the separate f32 dE
    accumulator and its final cast to bf16 against the plain version.
    Returns each kernel's max |kernel - plain| at the slice's shape."""
    shapes = [(512, 4096, 256, "float32"), (400, 4096, 256, "float32"),
              (512, 5000, 256, "float32"), (20000, 4096, 256, "float32"),
              (1024, 32000, 2048, "bfloat16"),
              (4096, 32000, 2048, "bfloat16"),
              (16384, 32000, 2048, "float32"),
              # the edges of the kernels' tiling: t, V and d all off the
              # 128-wide tiles and off 16-byte rows; d not a multiple of 8
              # in bf16; just over one backward chunk; a tiny t that the
              # vocab split has to spread over the card
              (384, 4099, 255, "float32"), (300, 1000, 250, "bfloat16"),
              (2100, 4096, 256, "float32"), (16, 32000, 2048, "float32")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bad, slice_err = [], {}
    print(f"{'fused xent shape':34s} {'loss':>9s} {'dh':>9s} {'dE':>9s} "
          f"bitwise")
    for t, v, d, dt in shapes:
        h, emb, tgt = _xent_inputs(torch, gen, t, v, d, getattr(torch, dt))
        h.requires_grad_()
        emb.requires_grad_()
        n0 = (fx.fwd_launches, fx.bwd_launches)
        runs = []
        for _ in range(2):
            per_token = fx._FusedXent.apply(h, emb, tgt)
            loss = torch.mean(per_token)
            runs.append((per_token.detach(), loss.detach(),
                         *torch.autograd.grad(loss, (h, emb))))
        torch.cuda.synchronize()
        ran = (fx.fwd_launches - n0[0], fx.bwd_launches - n0[1]) == (2, 2)
        per_token, loss, dh, de = runs[0]
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        finite = all(bool(torch.isfinite(x.float()).all())
                     for x in (per_token, dh, de))
        with torch.no_grad():
            hd, ed = h.detach(), emb.detach()
            p_tok, p_lse = fx.fused_xent_fwd_plain(hd, ed, tgt)
            ct = torch.full((t,), 1.0 / t, device="cuda")
            p_dh, p_de = fx.fused_xent_bwd_plain(hd, ed, tgt, p_lse, ct)
            if dt == "float32":
                p_loss = p_tok.mean()
                loss_err = (abs(loss.item() - p_loss.item())
                            / abs(p_loss.item()))
                loss_ok = loss_err <= 1e-4
                # allclose(rtol 1e-3, atol 5e-3 / t), as the ratio of
                # each element's error to its allowance
                errs = [((g.float() - r.float()).abs()
                         / (5e-3 / t + 1e-3 * r.float().abs())).max().item()
                        for g, r in ((dh, p_dh), (de, p_de))]
                grads_ok = max(errs) <= 1.0
            else:
                f32_loss = fx.fused_xent_fwd_plain(hd.float(), ed.float(),
                                                   tgt)[0].mean()
                loss_err = (abs(loss.item() - f32_loss.item())
                            / abs(f32_loss.item()))
                loss_ok = loss_err <= 5e-2
                errs = [((g.float() - r.float()).abs().max()
                         / r.float().abs().max()).item()
                        for g, r in ((dh, p_dh), (de, p_de))]
                grads_ok = max(errs) <= 5e-2
        ok = loss_ok and grads_ok and bitwise and finite and ran
        name = f"t{t} V{v} d{d} {dt}"
        print(f"{name:34s} {loss_err:9.2e} {errs[0]:9.2e} {errs[1]:9.2e} "
              f"{bitwise}{'' if ok else '  FAIL'}")
        if not ok:
            bad.append(name)
        if t == 16384:
            slice_err = {
                "fused_xent_fwd": (per_token - p_tok).abs().max().item(),
                "fused_xent_bwd": max((dh - p_dh).abs().max().item(),
                                      (de - p_de).abs().max().item())}
        del h, emb, tgt, runs, per_token, loss, dh, de, p_tok, p_lse, ct, \
            p_dh, p_de
        torch.cuda.empty_cache()
    print("fused xent: loss |d| / |plain|; f32 grads max |d| / (5e-3/t + "
          "1e-3 |plain|) (pass <= 1); bf16 grads max |d| / max |plain|")
    if bad:
        fail(f"fused xent kernels disagree with their plain versions (or "
             f"are not deterministic) on {len(bad)} shape(s): {bad}")
    return slice_err


def time_fused_xent(torch, fx, F, slice_err):
    """Phase 3c, timings: each fused kernel at the training slice's shape
    (t 16384 = b8 x s2048, V 32000, d 2048, f32) and at phase 9's (t 4096
    = b8 x s512, bf16) beside its bound, its plain version and one
    PyTorch call in the same dtype (forward ``F.cross_entropy(h @ emb.T,
    tgt)``; backward ``torch.autograd.grad`` through it w.r.t. (h,
    emb)); and the device memory the head adds over its inputs at the
    slice's shape, forward and backward, fused against that library
    head. Returns the kernels' records."""
    few = dict(warmup=1, runs=5, inner=2)

    def times(t, v, d, dtype, seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        h, emb, tgt = _xent_inputs(torch, gen, t, v, d, dtype)
        with torch.no_grad():
            _, lse = fx.fused_xent_fwd(h, emb, tgt)
            ct = torch.full((t,), 1.0 / t, device="cuda")
            out = {
                "fwd": time_ms(torch, lambda: fx.fused_xent_fwd(
                    h, emb, tgt), **few),
                "fwd_plain": time_ms(torch, lambda: fx.fused_xent_fwd_plain(
                    h, emb, tgt), **few),
                "fwd_lib": time_ms(torch, lambda: F.cross_entropy(
                    h @ emb.T, tgt), **few),
                "bwd": time_ms(torch, lambda: fx.fused_xent_bwd(
                    h, emb, tgt, lse, ct), **few),
                "bwd_plain": time_ms(torch, lambda: fx.fused_xent_bwd_plain(
                    h, emb, tgt, lse, ct), **few)}
        hl, el = (x.detach().requires_grad_() for x in (h, emb))
        loss = F.cross_entropy(hl @ el.T, tgt)
        out["bwd_lib"] = time_ms(torch, lambda: torch.autograd.grad(
            loss, (hl, el), retain_graph=True), **few)
        del loss, lse, ct
        return out, (hl, el, tgt)

    t, v, d = 16384, 32000, 2048
    ms, (hl, el, tgt) = times(t, v, d, torch.float32, 4)

    def head_peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del grads
        return peak / 1e9
    fused_gb = head_peak(lambda: torch.autograd.grad(
        fx.fused_lm_head_xent(hl, el, tgt), (hl, el)))
    lib_gb = head_peak(lambda: torch.autograd.grad(
        F.cross_entropy(hl @ el.T, tgt), (hl, el)))
    del hl, el, tgt
    torch.cuda.empty_cache()
    shape = f"t{t} V{v} d{d} float32"
    print(f"fused xent peak device memory over the inputs, forward + "
          f"backward at {shape}: fused {fused_gb:.4f} GB, "
          f"F.cross_entropy(h @ emb.T) {lib_gb:.4f} GB")
    bt = 4096
    bms = times(bt, v, d, torch.bfloat16, 5)[0]
    torch.cuda.empty_cache()
    bshape = f"t{bt} V{v} d{d} bfloat16"
    records = []
    for name, key, products, backward, line, lib in (
            ("fused_xent_fwd", "fwd", 1, False, 74,
             "F.cross_entropy(h @ emb.T, tgt)"),
            ("fused_xent_bwd", "bwd", 3, True, 168,
             "autograd.grad through it")):
        bound_ms, bound_by = xent_bound(t, v, d, "float32", products,
                                        backward)
        bbound_ms, bbound_by = xent_bound(bt, v, d, "bfloat16", products,
                                          backward)
        for sh, m, b_ms, b_by in ((shape, ms, bound_ms, bound_by),
                                  (bshape, bms, bbound_ms, bbound_by)):
            print(f"{name} at {sh}: kernel {m[key]:.4f} ms, plain "
                  f"{m[key + '_plain']:.4f} ms, {lib} "
                  f"{m[key + '_lib']:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, tensor cores)")
        records.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/csrc/fused_xent.cu",
            "replaces": f"tpudist/ops/pallas/fused_xent.py:{line}",
            "launches": None, "max_abs_err": slice_err[name],
            "ms": ms[key], "plain_ms": ms[key + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_peak": "tensor cores 3xTF32",
            "library_ms": ms[key + "_lib"], "shape": shape,
            "head_peak_gb": fused_gb, "library_head_peak_gb": lib_gb,
            "bf16": {"shape": bshape, "ms": bms[key],
                     "plain_ms": bms[key + "_plain"],
                     "library_ms": bms[key + "_lib"],
                     "bound_ms": bbound_ms, "bound_by": bbound_by,
                     "bound_peak": "tensor cores bf16"}})
    return records


class _EagerBodies:
    """The serve engine with ``prefill``/``decode`` running its bodies
    eagerly instead of replaying its graphs: the reference the graphs
    are held to, never a serving route."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def prefill(self, *args, **kw):
        return self.engine.eager_prefill(*args, **kw)

    def decode(self, *args, **kw):
        return self.engine.eager_decode(*args, **kw)


def _serve_counts(engine):
    """The serve paths' launch counts: the flash forward's through the
    engine's graph accounting, no other kernel."""
    return {"flash_attention_fwd": engine.kernel_launches()}


def _tokens_of(summary, rids=None):
    return {rid: r["tokens"] for rid, r in summary["results"].items()
            if rids is None or rid in rids}


def serve_slice(torch, fa, fx, profile: bool):
    """Phase 4: the serving slice at full width on the graph engine, the
    ladder (8, 4, 2) captured. Returns the engine, its params, phase 4's
    summary and the kernels' launch counts from the main path's run."""
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.models import transformer
    from tpudist_torch.serve import resilience as res_lib
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import ServeEngine, init_params

    cfg = ModelConfig(name="transformer")
    engine = ServeEngine(cfg, slots=8, max_seq=1024, prompt_pad=512,
                         decode_k=8, dtype=torch.float32, device="cuda",
                         adapt_ladder=res_lib.default_ladder(8))
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve slice: V{cfg.vocab_size} L{cfg.n_layers} d{cfg.d_model} "
          f"h{cfg.n_heads} kv{cfg.n_kv_heads} d_ff{cfg.d_ff} float32; "
          f"params {n_params * 4 / 1e9:.3f} GB, kv cache "
          f"{engine.spec.bytes / 1e9:.3f} GB; slots {engine.slots} "
          f"max_seq {engine.max_seq} prompt_pad {engine.prompt_pad} "
          f"decode_k ladder {engine.ladder}")
    requests = sched.make_requests(16, prompt_pad=engine.prompt_pad,
                                   vocab_size=cfg.vocab_size, max_new=32,
                                   rate=0.0, seed=0)

    _reset_launches(fa, fx)
    t0 = time.perf_counter()
    engine.warmup(params)
    warm_s = time.perf_counter() - t0
    summary = sched.run_serve(engine, params, requests)
    torch.cuda.synchronize()
    counts = _serve_counts(engine)
    launches = counts["flash_attention_fwd"]
    engine.assert_two_programs()

    prefills = summary["admitted"] + 1     # + the warmup's eager body
    want = cfg.n_layers * prefills
    print(f"serve slice: {summary['completed']}/{summary['requests']} "
          f"requests, {summary['generated_tokens']} tokens in "
          f"{summary['wall_s']} s over {summary['dispatches']} "
          f"dispatches; warmup {warm_s:.3f} s, of it capture "
          f"{engine.capture_s:.3f} s of 1 prefill + "
          f"{len(engine.ladder)} decode graphs holding "
          f"{engine.graph_pool_bytes / 1e6:.1f} MB; flash kernel "
          f"launches {launches} (want n_layers x prefills = "
          f"{cfg.n_layers} x {prefills} = {want}), "
          f"{fa.launches} of them outside a graph; programs "
          f"{engine.compile_counts()}")
    print(f"serve slice: tokens/s/chip {summary['tokens_per_sec_per_chip']}"
          f"; ttft p50 {summary['ttft_p50_s']} s p99 "
          f"{summary['ttft_p99_s']} s; itl p50 {summary['itl_p50_s']} s "
          f"p99 {summary['itl_p99_s']} s; e2e p50 {summary['e2e_p50_s']} "
          f"s p99 {summary['e2e_p99_s']} s; SLO {summary['status']}")
    if summary["completed"] != len(requests) or summary["truncated"]:
        fail(f"serve slice completed {summary['completed']}/"
             f"{len(requests)} ({summary['truncated']} truncated)")
    if launches != want:
        fail(f"flash kernel launched {launches} times in the serve run, "
             f"want {want}")
    if fa.launches != cfg.n_layers:
        fail(f"{fa.launches} flash launches outside the graphs, want the "
             f"warmup's {cfg.n_layers}: a prefill did not replay")
    for rid, res in summary["results"].items():
        toks = res["tokens"]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            fail(f"request {rid} produced {toks!r}")

    # the graphs against the engine's bodies called eagerly: every
    # request's tokens, then one prefill's first token and logits
    eager = sched.run_serve(_EagerBodies(engine), params, requests)
    same = _tokens_of(eager) == _tokens_of(summary)
    print(f"serve slice: every request's tokens, graphs vs the eager "
          f"bodies: equal {same}")
    if not same:
        fail("the graph engine's tokens differ from its eager bodies'")

    # one replayed prefill's last-position logits (cached path, kernel,
    # q/k rotated up front) against the non-cached forward with RoPE
    # fused into the plain version, and against the eager body
    def plain_attention(q, k, v, *, cos=None, sin=None, causal=True):
        return fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                        causal=causal)[0]
    plain_attention.accepts_rope = True

    req = requests[0]
    args = (req.tokens[None, :], req.prompt_len, 0, req.max_new)
    n0 = engine.kernel_launches()
    _, first = engine.prefill(params, engine.init_state(), *args)
    got = engine.last_logits[0].clone()
    first = int(first)
    if engine.kernel_launches() != n0 + cfg.n_layers:
        fail("the replayed prefill did not count its flash kernels")
    _, first_eager = engine.eager_prefill(params, engine.init_state(),
                                          *args)
    d_eager = (got - engine.last_logits[0]).abs().max().item()
    tokens = torch.as_tensor(req.tokens[None, :], dtype=torch.int64,
                             device="cuda")
    with torch.no_grad():
        ref = transformer.apply(params, tokens, cfg, dtype=torch.float32,
                                attn_impl=plain_attention)[
            0, req.prompt_len - 1]
    err = (got - ref).abs().max().item()
    same = first == int(got.argmax()) == int(ref.argmax())
    print(f"serve slice: replayed prefill (rid {req.rid}, prompt_len "
          f"{req.prompt_len}): first token {first}, eager body's "
          f"{int(first_eager)} (logits max |d| {d_eager:.3e}); logits vs "
          f"plain forward max |d| {err:.3e} (atol 1e-3), argmax equal "
          f"{same}")
    if got.shape != (cfg.vocab_size,) or not bool(torch.isfinite(got).all()):
        fail(f"prefill logits shape {tuple(got.shape)} or not finite")
    if err > 1e-3:
        fail(f"prefill logits differ from the plain forward by {err:.3e}")
    if first != int(first_eager):
        fail("the replayed prefill's first token differs from the eager "
             "body's")

    if profile:
        profile_serve(torch, engine, params, requests)
    return engine, params, summary, counts


def serve_overload(torch, engine, params, base):
    """Phase 4b: overload on phase 4's graph engine. A Poisson stream of
    64 requests at twice the requests/s phase 4 completed, a queue cap of
    8, a TTFT deadline of 4 x phase 4's TTFT p50 and ``--adapt``'s ladder
    with the JAX package's adapt-drill thresholds. Hard checks: the exact
    partition, the program pin, every admitted request completed, and
    the admitted requests' tokens equal to the same requests' in an
    unloaded run; then two runs of one seed on virtual time give equal
    summaries. Returns the launch counts of the overload run."""
    from tpudist_torch.serve import resilience as res_lib
    from tpudist_torch.serve import scheduler as sched

    rate = 2 * base["completed"] / base["wall_s"]
    deadline_s = 4 * base["ttft_p50_s"]
    # the JAX package's adapt drill thresholds (its resilience tests):
    # --adapt's default depth_high of 8 never trips under a cap of 8
    res = res_lib.ResilienceConfig(queue_cap=8, ttft_deadline_s=deadline_s,
                                   adapt=True, validate=True,
                                   depth_high=4.0, depth_low=1.0,
                                   trip_ticks=1, clear_ticks=4, window=2)

    def stream(r):
        return sched.make_requests(64, prompt_pad=engine.prompt_pad,
                                   vocab_size=engine.model_cfg.vocab_size,
                                   max_new=32, rate=r, seed=1)

    engine.reset_kernel_launches()
    s = sched.run_serve(engine, params, stream(rate), resilience=res)
    torch.cuda.synchronize()
    counts = _serve_counts(engine)
    engine.assert_two_programs()
    part = s["partition"]
    want = engine.model_cfg.n_layers * s["admitted"]
    moves = [(t["from_level"], t["to_level"])
             for t in s["adapt_transitions"]]
    print(f"serve overload: 64 requests at {rate:.2f}/s, queue cap 8, "
          f"deadline {deadline_s * 1e3:.3f} ms, ladder {engine.ladder}: "
          f"admitted {s['admitted']}, completed {s['completed']}, shed "
          f"at admission {s['shed_at_admission']}, expired in queue "
          f"{s['expired_in_queue']}, rejected {s['rejected']} (shed "
          f"fraction {s['shed_fraction']}); adapt transitions "
          f"{moves}, final decode_k {s['decode_k_current']}; ttft p50 "
          f"{s['ttft_p50_s']} s p99 {s['ttft_p99_s']} s; itl p99 "
          f"{s['itl_p99_s']} s; tokens/s/chip "
          f"{s['tokens_per_sec_per_chip']}; flash launches "
          f"{counts['flash_attention_fwd']} (want {want})")
    if not (part["admission_exact"] and part["outcome_exact"]) \
            or part["arrived"] != 64:
        fail(f"serve overload partition is not exact: {part}")
    if s["completed"] != s["admitted"] or s["truncated"]:
        fail(f"serve overload completed {s['completed']} of "
             f"{s['admitted']} admitted ({s['truncated']} truncated)")
    if counts["flash_attention_fwd"] != want:
        fail(f"flash kernel launched {counts['flash_attention_fwd']} "
             f"times in the overload run, want {want}")
    # the same requests, every one present at t=0 and none shed
    unloaded = sched.run_serve(engine, params, [
        dataclasses.replace(r, arrival_s=0.0) for r in stream(rate)])
    admitted = set(s["results"])
    same = _tokens_of(s) == _tokens_of(unloaded, admitted)
    print(f"serve overload: the {len(admitted)} admitted requests' tokens "
          f"vs an unloaded run of the stream: equal {same}")
    if not same:
        fail("the overload run's tokens differ from the unloaded run's")

    virtual = [sched.run_serve(
        engine, params, stream(rate), resilience=res,
        virtual=res_lib.VirtualTiming(prefill_s=0.005,
                                      decode_s=8 * base["itl_p50_s"]))
        for _ in range(2)]
    same = virtual[0] == virtual[1]
    v = virtual[0]
    print(f"serve overload: two virtual-time runs of one seed: summaries "
          f"equal {same}; admitted {v['admitted']}, shed "
          f"{v['shed_total']}, transitions {len(v['adapt_transitions'])}, "
          f"ttft p99 {v['ttft_p99_s']} s (virtual)")
    if not same:
        fail("two virtual-time runs of one seed gave different summaries")
    return counts


class _Tee(io.TextIOBase):
    """stdout that is also kept, to read the train CLI's contract."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _launch_counts(fa, fx):
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "flash_attention_bwd_dqkv": fa.dqkv_launches,
            "fused_xent_fwd": fx.fwd_launches,
            "fused_xent_bwd": fx.bwd_launches}


def _reset_launches(fa, fx):
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.dqkv_launches = 0
    fx.fwd_launches = fx.bwd_launches = 0


def check_contract(tag: str, out: str, epochs: int, losses) -> None:
    """The train CLI's stdout contract on ``out`` and falling, finite step
    ``losses``."""
    for epoch in range(1, epochs + 1):
        for line in (f"Epoch {epoch:2d} finished. Avg loss: ",
                     f"Epoch {epoch:2d} eval loss: "):
            if line not in out:
                fail(f"train {tag}: no {line!r} line on stdout")
    if "Training completed." not in out:
        fail(f"train {tag}: no 'Training completed.' line")
    if not (losses and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail(f"train {tag}: step losses {losses} do not fall")


def want_launches(fa, m, seq: int, steps: int, epochs: int, fused: bool,
                  context: int = 1, impl: str = "ring"):
    """Each kernel's launches in one process of a training run of
    ``steps`` steps over ``epochs`` epochs (one eval batch each) of model
    ``m``, a rank's at ``--context`` ways: a ring rank's layer makes one
    causal call over its s/n tokens and two unmasked calls of s/2n a
    remote hop, a Ulysses rank (or one process) one causal call over the
    whole sequence, each call's backward the merged kernel or the split
    pair as ``uses_merged_backward`` routes its length."""
    if context == 1 or impl == "ulysses":
        calls = [seq]
    else:
        s_l = seq // context
        calls = [s_l] + [s_l // 2] * (2 * (context - 1))
    L = m.n_layers
    out = {"flash_attention_fwd": L * len(calls) * (steps + epochs),
           "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
           "flash_attention_bwd_dqkv": 0,
           # the fused head: one forward a step and an eval batch an
           # epoch, one backward a step
           "fused_xent_fwd": steps + epochs if fused else 0,
           "fused_xent_bwd": steps if fused else 0}
    for s in calls:
        if fa.uses_merged_backward(s, s):
            out["flash_attention_bwd_dqkv"] += L * steps
        else:
            out["flash_attention_bwd_dq"] += L * steps
            out["flash_attention_bwd_dkv"] += L * steps
    return out


@contextlib.contextmanager
def _supersteps():
    """Every superstep the train CLI makes inside the block (through
    ``engine.make_superstep``), for the kernel launches its graphs'
    replays ran: a replay does not move the wrappers' counters."""
    from tpudist_torch import engine as engine_lib

    made, real = [], engine_lib.make_superstep

    def make(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]
    engine_lib.make_superstep = make
    try:
        yield made
    finally:
        engine_lib.make_superstep = real


def _path_launches(fa, fx, supersteps):
    """The kernels' launches on a path: the wrappers' counters (eager
    launches) plus each superstep's replayed ones."""
    counts = _launch_counts(fa, fx)
    for sup in supersteps:
        for name, n in sup.kernel_launches().items():
            counts[name] += n
    return counts


@contextlib.contextmanager
def _tuner_watch(torch, made, trials, search):
    """Every probe trial the tuner runs inside the block, appended to
    ``trials`` with the device's reserved memory after it and the graph
    pool its superstep captured, and the search's reserved memory before
    and after in ``search``. The supersteps a probe made leave ``made``
    (``_supersteps``), so a path's launches are the timed run's own: the
    probes restore the wrappers' counters and carry their launches on
    their results."""
    from tpudist_torch import tune

    real_probe, real_tune = tune.probe_mod.probe_candidate, tune.autotune

    def probe(cfg, device, cand, plan, **kw):
        n = len(made)
        res = real_probe(cfg, device, cand, plan, **kw)
        mine, made[n:] = made[n:], []
        trials.append({"cand": cand, "res": res,
                       "reserved": torch.cuda.memory_reserved(),
                       "pool": max((m.graph_pool_bytes for m in mine),
                                   default=0)})
        return res

    def autotune(*args, **kw):
        torch.cuda.synchronize()
        search["before"] = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        out = real_tune(*args, **kw)
        search["wall"] = time.perf_counter() - t0
        search["after"] = torch.cuda.memory_reserved()
        return out
    tune.probe_mod.probe_candidate, tune.autotune = probe, autotune
    try:
        yield
    finally:
        tune.probe_mod.probe_candidate, tune.autotune = real_probe, real_tune


def _cli_run(torch, fa, fx, tag: str, argv, env=None, tuner=None,
             keep: bool = False):
    """``python -m tpudist_torch.train`` (its ``main``) on the card with
    ``argv`` (plus a ``--save-dir`` of its own) and ``env``, the launch
    counts set to 0 just before and read just after. Fails unless it
    exits 0 with a ``success`` verdict and a timing record. Returns its
    stdout, metrics records, launches, supersteps, wall and peak device
    memory. ``tuner`` = ``(trials, search)`` watches the autotuner
    (``_tuner_watch``). ``keep`` leaves the run directory (``run["dir"]``)
    for the caller to read and remove."""
    from tpudist_torch import train as train_lib

    save = ROOT / "build" / "chip_smoke_train" / tag
    shutil.rmtree(save, ignore_errors=True)
    env = {"TPUDIST_VERDICT_PATH": str(save / "job_status.txt"),
           **(env or {})}
    os.environ.update(env)
    try:
        tee = _Tee(sys.stdout)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(fa, fx)
        t0 = time.perf_counter()
        with _supersteps() as made, contextlib.redirect_stdout(tee), (
                _tuner_watch(torch, made, *tuner) if tuner
                else contextlib.nullcontext()):
            rc = train_lib.main(argv + ["--save-dir", str(save)])
        torch.cuda.synchronize()
    finally:
        for k in env:
            del os.environ[k]
    run = {"wall": time.perf_counter() - t0, "dir": save,
           "counts": _path_launches(fa, fx, made), "supersteps": made,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "out": tee.buf.getvalue(),
           "recs": [json.loads(ln) for ln in
                    (save / "metrics.jsonl").read_text().splitlines()]}
    verdict = save / "job_status.txt"
    status = verdict.read_text() if verdict.is_file() else None
    if not keep:
        shutil.rmtree(save, ignore_errors=True)
    torch.cuda.empty_cache()
    run["timing"] = [r for r in run["recs"] if r["kind"] == "timing"]
    if rc != 0 or status != "success" or not run["timing"]:
        fail(f"train {tag}: exit {rc}, verdict {status!r}")
    run["timing"] = run["timing"][-1]
    return run


def _step_line(run, per_step: int, unit: str = "tokens") -> str:
    t = run["timing"]
    sps = t["steps"] / t["run_s"]
    return (f"{sps:.4f} steps/s, {sps * per_step:.1f} {unit}/s, step "
            f"{1e3 * t['run_s'] / t['steps']:.3f} ms (over {t['steps']} "
            f"steps after the warm-up); warm-up + builds "
            f"{t['compile_warmup_s']:.2f} s; wall {run['wall']:.2f} s; "
            f"peak device memory {run['peak_gb']:.3f} GB")


def train_slice(torch, fa, fx, tag: str, seq: int, epochs: int,
                n_samples: int, extra=(), hbm_bytes=None, want_head=None,
                details=None):
    """Phases 5, 6, 8 and 9, the path ``tag``: ``python -m
    tpudist_torch.train`` (its ``main``) on the card at full width:
    BASELINE config #5, global batch 8, seed 42, f32 and ``--lm-head
    auto`` unless ``extra`` flags say otherwise; ``hbm_bytes`` pins the auto head policy's device memory
    (``TPUDIST_HBM_BYTES``), and the resolved head must be ``want_head``
    when given. The launch counts are set to 0 just before and read just
    after; the stdout contract, a falling loss, the verdict file and the
    exact launch counts are checked. Returns the counts; ``details``
    gets the step losses (phase 21b's reference)."""
    from tpudist_torch import config as config_lib
    from tpudist_torch import engine as engine_lib

    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", str(epochs), "--seed", "42", "--log-every", "1",
            *extra]
    cfg = config_lib.parse_args(argv)
    env = {} if hbm_bytes is None else {"TPUDIST_HBM_BYTES": str(hbm_bytes)}
    os.environ.update(env)
    try:
        fused, chunks = engine_lib._resolve_lm_head(cfg,
                                                    torch.device("cuda"))
    finally:
        for k in env:
            del os.environ[k]
    head = "fused" if fused else f"chunked({chunks})" if chunks \
        else "plain"
    m = cfg.model
    print(f"train {tag}: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, "
          f"batch {cfg.batch_size}, {n_samples} samples, {epochs} "
          f"epoch(s), adam nu {cfg.adam_nu_dtype}; --lm-head "
          f"{cfg.lm_head} -> {head}"
          + ("" if hbm_bytes is None
             else f" (TPUDIST_HBM_BYTES={hbm_bytes:.0f})"))
    if want_head is not None and head != want_head:
        fail(f"train {tag}: the head resolved to {head}, want "
             f"{want_head}")
    run = _cli_run(torch, fa, fx, tag, argv, env)
    counts = run["counts"]
    losses = [r["loss"] for r in run["recs"] if r["kind"] == "step"]
    check_contract(tag, run["out"], epochs, losses)
    want = want_launches(fa, m, seq, epochs * (n_samples // cfg.batch_size),
                         epochs, fused)
    print(f"train {tag}: step losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"verdict success; "
          + _step_line(run, cfg.batch_size * m.max_seq_len))
    print(f"train {tag}: kernel launches {counts} (want {want})")
    if counts != want:
        fail(f"train {tag}: kernel launches {counts}, want {want}")
    if details is not None:
        details["losses"] = losses
    return counts


def _epochs_of(run):
    """Each epoch's (Avg loss, eval loss) of a run's metrics."""
    return [(r["avg_loss"], r["eval_loss"]) for r in run["recs"]
            if r["kind"] == "epoch"]


def _graphs_line(run) -> str:
    sup = run["supersteps"][0]
    return (f"{sup.programs} captured programs, capture "
            f"{sup.capture_s:.3f} s, graph pool "
            f"{sup.graph_pool_bytes / 2**20:.1f} MB, replays "
            f"{sup.replays}")


# phase 11's kernel paths
SUPERSTEP = ("train_seq512_bf16_per_step", "train_seq512_bf16_superstep",
             "train_seq512_dp_superstep")


def superstep_slice(torch, fa, fx, card: str):
    """Phase 11a, the paths ``train_seq512_bf16_per_step`` and
    ``train_seq512_bf16_superstep``: phase 9's configuration (BASELINE
    config #5 at seq 512, bf16, bf16 Adam nu, ``--lm-head fused``, global
    batch 8, seed 42) with ``--log-every 4`` over 80 samples (10 steps an
    epoch: two full windows of k = 4 and a 2-step tail), 2 epochs, run
    per-step (``--steps-per-dispatch 1``) and as the superstep (``0``,
    auto -> 4) under a ``TPUDIST_STAGING_BUDGET_MB`` that holds two
    4-step slabs of the staged (int64) token ids, so each epoch streams
    in 3 slabs. Each epoch's Avg and eval loss must be bitwise equal
    between the two runs, each run's launches exact over the 20 true
    steps and 2 evals, the superstep's programs 2 and its replays those
    of the windows. Returns each path's launches."""
    from tpudist_torch import config as config_lib

    seq, epochs, n_samples, k = 512, 2, 80, 4
    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", str(epochs), "--seed", "42", "--log-every", str(k),
            "--dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
            "--lm-head", "fused"]
    cfg = config_lib.parse_args(argv)
    m = cfg.model
    step_bytes = cfg.batch_size * (seq + 1) * 8
    budget_mb = 2 * k * step_bytes / 2**20
    print(f"superstep: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, adam "
          f"nu {cfg.adam_nu_dtype}, --lm-head fused, batch "
          f"{cfg.batch_size}, {n_samples} samples, {epochs} epochs, "
          f"--log-every {k}; staged step {step_bytes} B, "
          f"TPUDIST_STAGING_BUDGET_MB={budget_mb!r}; {card}")
    tokens = cfg.batch_size * seq
    want = want_launches(fa, m, seq, epochs * (n_samples // cfg.batch_size),
                         epochs, fused=True)
    runs, paths = {}, {}
    for how, extra, env in (
            ("per_step", ["--steps-per-dispatch", "1"], {}),
            ("superstep", ["--steps-per-dispatch", "0"],
             {"TPUDIST_STAGING_BUDGET_MB": repr(budget_mb)})):
        tag = f"train_seq512_bf16_{how}"
        # the superstep's run directory is phase 13a's default run
        run = runs[how] = _cli_run(torch, fa, fx, tag, argv + extra, env,
                                   keep=how == "superstep")
        t = run["timing"]
        losses = [r["loss"] for r in run["recs"] if r["kind"] == "step"]
        check_contract(tag, run["out"], epochs, losses)
        print(f"superstep {how}: k={t['steps_per_dispatch']}, "
              + _step_line(run, tokens))
        print(f"superstep {how}: kernel launches {run['counts']} (want "
              f"{want})")
        if run["counts"] != want:
            fail(f"superstep {how}: kernel launches {run['counts']}, want "
                 f"{want}")
        paths[tag] = run["counts"]
    sup, t = runs["superstep"], runs["superstep"]["timing"]
    print(f"superstep: {_graphs_line(sup)}; staging {t['staging_status']}"
          f", {t['staging_slabs']} slabs, stage_wait_s "
          f"{t['stage_wait_s']}, overlap {t['staging_overlap_fraction']}")
    graphs = sup["supersteps"][0]
    # the first window is the eager warm-up; the 10-step epochs have two
    # full windows and a 2-step tail each
    want_replays = {"superstep": 2 * epochs - 1, "step": 2 * epochs}
    if (t["steps_per_dispatch"], graphs.programs, graphs.replays) != (
            k, 2, want_replays):
        fail(f"superstep: k={t['steps_per_dispatch']}, "
             f"{graphs.programs} programs, replays {graphs.replays}; "
             f"want k={k}, 2 programs, replays {want_replays}")
    if not t["staging_streamed"] or t["staging_slabs"] != 3 * epochs:
        fail(f"superstep: staging streamed {t['staging_streamed']} in "
             f"{t['staging_slabs']} slabs, want 3 slabs an epoch")
    a, b = _epochs_of(runs["per_step"]), _epochs_of(sup)
    print(f"superstep: epochs (Avg, eval) per-step {a}, superstep {b}")
    if a != b or len(a) != epochs:
        fail(f"superstep: the epochs' losses differ: per-step {a}, "
             f"superstep {b}")
    p, q = (runs[h]["timing"] for h in ("per_step", "superstep"))
    print(f"superstep: step {1e3 * p['run_s'] / p['steps']:.3f} ms "
          f"per-step, {1e3 * q['run_s'] / q['steps']:.3f} ms superstep "
          f"(ratio {(p['run_s'] / p['steps']) / (q['run_s'] / q['steps']):.4f}"
          f"); {card}")
    return paths, sup, argv + ["--steps-per-dispatch", "0"], {
        "TPUDIST_STAGING_BUDGET_MB": repr(budget_mb)}


def superstep_mlp(torch, fa, fx, card: str):
    """Phase 11b: ``python -m tpudist_torch.train`` at the reference
    defaults (the MLP, 2000 samples, batch 64, 5 epochs: 31 steps an
    epoch), per-step and at the auto k = 25 (one full window and a
    6-step tail an epoch, the full-epoch fast path). The Avg and eval
    losses must be bitwise equal, the superstep's programs 2 and its
    replays those of the windows."""
    runs, rates = {}, {"per_step": [], "superstep": []}
    # in turns: the host-bound rates spread from run to run
    for how in ("per_step", "superstep", "superstep", "per_step"):
        extra = ["--steps-per-dispatch", "1"] if how == "per_step" else []
        run = _cli_run(torch, fa, fx, f"train_mlp_{how}", extra)
        if how in runs and _epochs_of(run) != _epochs_of(runs[how]):
            fail(f"mlp: two {how} runs differ")
        runs[how] = run
        rates[how].append(run["timing"]["steps"] / run["timing"]["run_s"])
        print(f"mlp {how}: k={run['timing']['steps_per_dispatch']}, "
              + _step_line(run, 64, "samples"))
    sup = runs["superstep"]
    graphs = sup["supersteps"][0]
    want_replays = {"superstep": 4, "step": 5 * 6}
    if (sup["timing"]["steps_per_dispatch"], graphs.programs,
            graphs.replays) != (25, 2, want_replays):
        fail(f"mlp: k={sup['timing']['steps_per_dispatch']}, "
             f"{graphs.programs} programs, replays {graphs.replays}")
    a, b = _epochs_of(runs["per_step"]), _epochs_of(sup)
    print(f"mlp: {_graphs_line(sup)}; epochs (Avg, eval) per-step {a}, "
          f"superstep {b}")
    if a != b or len(a) != 5:
        fail(f"mlp: the epochs' losses differ: per-step {a}, superstep "
             f"{b}")
    p, q = (statistics.median(rates[h]) for h in ("per_step", "superstep"))
    print(f"mlp: steps/s per-step {rates['per_step']}, superstep "
          f"{rates['superstep']}; medians {p:.1f} and {q:.1f} (ratio "
          f"{q / p:.4f}); {card}")


# phase 12b's kernel path: the tuned run's timed steps
TUNE_PATH = "tune_seq512_bf16"
MB = 2**20


def _tune_record(tag: str, run):
    recs = [r for r in run["recs"] if r["kind"] == "tune"]
    if len(recs) != 1:
        fail(f"{tag}: {len(recs)} kind=tune records, want 1")
    return recs[0]


def _point(t) -> str:
    return (f"k={t['steps_per_dispatch']}, staging "
            f"{t['staging_budget_mb']} MB, remat={t['remat']}, "
            f"grad_accum={t['grad_accum_steps']}")


def _at_point(t, math: bool = True):
    """The flags of an untuned run at the tuner's committed point (its
    schedule knobs only, unless ``math``)."""
    argv = ["--steps-per-dispatch", str(t["steps_per_dispatch"])]
    if t["staging_budget_mb"] is not None:
        argv += ["--staging-budget-mb", repr(t["staging_budget_mb"])]
    if math:
        argv += ["--grad-accum-steps", str(t["grad_accum_steps"])]
        argv += ["--remat"] if t["remat"] else []
    return argv


def _tuned_search(torch, fa, fx, tag: str, argv, budget: int, card: str):
    """The train CLI with ``--autotune probe`` (``argv`` holds it and a
    fresh ``--autotune-cache-dir``): every trial printed (the discarded
    cold one first) with the device's reserved memory before the search,
    after each trial and after the search. Fails unless the search
    succeeded from a probe within ``budget`` trials (plus the two
    confirmations), the commit measured at least the heuristic start's
    steps/s, the card holds at most one trial's graph pool more than
    before the search, and an infeasible trial carries its error.
    Returns the run, its tune record and the trials."""
    trials, search = [], {}
    run = _cli_run(torch, fa, fx, tag, argv, tuner=(trials, search))
    t = _tune_record(tag, run)
    print(f"{tag}: reserved before the search "
          f"{search['before'] / MB:.1f} MB; {card}")
    for i, tr in enumerate(trials):
        c, r = tr["cand"], tr["res"]
        what = "cold trial (discarded)" if i == 0 else f"trial {i}"
        got = (f"{r.steps_per_sec:.2f} steps/s, spread {r.spread:.4f}"
               if r.feasible else f"pruned: {r.error}")
        peak = ("n/a" if r.hbm_peak_bytes is None
                else f"{r.hbm_peak_bytes / MB:.1f} MB")
        ran = {k: n for k, n in (r.launches or {}).items() if n}
        print(f"{tag}: {what}: k={c.k}, staging {c.staging_budget_mb} MB, "
              f"remat={c.remat}, accum={c.grad_accum_steps}: {got}; "
              f"build+warm-up+capture {r.compile_s:.2f} s, peak reserved "
              f"{peak}, graph pool {tr['pool'] / MB:.1f} MB, reserved "
              f"after {tr['reserved'] / MB:.1f} MB; probe launches {ran}; "
              f"{card}")
        if not r.feasible and not r.error:
            fail(f"{tag}: {what} pruned without an error")
    grown = search["after"] - search["before"]
    pool = max((tr["pool"] for tr in trials), default=0)
    print(f"{tag}: reserved after the search {search['after'] / MB:.1f} MB "
          f"({grown / MB:+.1f} MB; the largest trial pool "
          f"{pool / MB:.1f} MB); search wall {search['wall']:.2f} s; "
          f"{card}")
    sps, base = t["steps_per_sec"], t["baseline_steps_per_sec"]
    print(f"{tag}: tuning {t['status']} ({t['source']}): {_point(t)}; "
          f"{sps} steps/s against the heuristic start's {base}"
          + (f" (x{sps / base:.4f})" if sps and base else "")
          + f", {t['trials']} trials, {t['pruned']} pruned; {card}")
    if (t["source"], t["status"], run["timing"]["tuning_status"]) != (
            "probe", "success", "success"):
        fail(f"{tag}: tuning {t['status']} from {t['source']}, timing "
             f"{run['timing']['tuning_status']}")
    if len(trials) != 1 + t["trials"] or t["trials"] > budget + 2:
        fail(f"{tag}: {len(trials)} probes for {t['trials']} trials "
             f"(budget {budget} + 2 confirmations)")
    if not (sps and base and sps >= base):
        fail(f"{tag}: the commit's {sps} steps/s is not at least the "
             f"heuristic start's {base}")
    if grown > pool:
        fail(f"{tag}: the card holds {grown / MB:.1f} MB more after the "
             f"search, more than one trial's pool ({pool / MB:.1f} MB)")
    if run["timing"]["steps_per_dispatch"] != t["steps_per_dispatch"]:
        fail(f"{tag}: the run dispatched k="
             f"{run['timing']['steps_per_dispatch']}, the tuner committed "
             f"{t['steps_per_dispatch']}")
    return run, t, trials


def _cache_rerun(torch, fa, fx, tag: str, argv, t, card: str,
                 per_step: int, unit: str):
    """The same tuned command again on the same cache directory: a pure
    cache hit, zero probes, the same point. Returns the run."""
    trials, search = [], {}
    run = _cli_run(torch, fa, fx, f"{tag}_cached", argv,
                   tuner=(trials, search))
    t2 = _tune_record(tag, run)
    print(f"{tag} rerun: tuning {t2['status']} ({t2['source']}): "
          f"{_point(t2)}, {t2['trials']} trials, {len(trials)} probes; "
          + _step_line(run, per_step, unit) + f"; {card}")
    keys = ("steps_per_dispatch", "staging_budget_mb", "remat",
            "grad_accum_steps")
    if (t2["source"], t2["trials"], len(trials)) != ("cache", 0, 0) or \
            any(t2[key] != t[key] for key in keys):
        fail(f"{tag} rerun: {t2['source']} with {t2['trials']} trials "
             f"({len(trials)} probes) at {_point(t2)}, want a cache hit "
             f"at {_point(t)}")
    return run


def capture_oom_drill(torch, card: str):
    """Phase 12a's drill: an OOM raised inside a probe's capture (the MLP
    default at k = 25) comes back as a pruned trial, the capture closed,
    the launch counters and the reserved memory where they were, and the
    same probe then measures on the card."""
    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.tune import probe, search

    cfg = config_lib.parse_args([])
    plan = data_lib.plan_epoch(
        data_lib.make_synthetic_data(cfg.data.n_samples,
                                     cfg.data.n_features, cfg.data.seed),
        batch_size=cfg.batch_size, seed=cfg.seed, epoch=0)
    cand = search.Candidate(k=25)
    dev = torch.device("cuda")
    real = engine_lib.Superstep._graph_body

    def oom(self, state, n):
        real(self, state, n)            # some work into the pool first
        raise torch.cuda.OutOfMemoryError("drill: out of memory inside "
                                          "the capture")
    probe.release_memory(dev)
    counts = engine_lib.kernel_launch_counts()
    before = torch.cuda.memory_reserved()
    engine_lib.Superstep._graph_body = oom
    try:
        res = probe.probe_candidate(cfg, dev, cand, plan, repeats=1)
    finally:
        engine_lib.Superstep._graph_body = real
    after = torch.cuda.memory_reserved()
    capturing = torch.cuda.is_current_stream_capturing()
    again = probe.probe_candidate(cfg, dev, cand, plan, repeats=1)
    print(f"capture OOM drill: {res.error}; capturing after "
          f"{capturing}; reserved {before / MB:.1f} -> {after / MB:.1f} MB; "
          f"the same probe then {again.steps_per_sec:.2f} steps/s; {card}")
    if res.feasible or "OutOfMemoryError" not in (res.error or "") \
            or capturing or after > before \
            or engine_lib.kernel_launch_counts() != counts \
            or not again.feasible:
        fail("capture OOM drill: the probe did not come back pruned with "
             "the card as it found it")


def tuner_mlp(torch, fa, fx, card: str):
    """Phase 12a: ``python -m tpudist_torch.train --autotune probe`` at the
    reference defaults (the MLP, 2000 samples, batch 64, 5 epochs,
    --log-every 100: the k ladder 1, 2, 4, 10, 20, 25), the
    dispatch-bound workload. The search must succeed from a probe (see
    ``_tuned_search``), every epoch's Avg and eval loss must be bitwise
    an untuned run's at the committed point, and a second run on the
    same cache must be a pure hit. Then the capture OOM drill."""
    from tpudist_torch import config as config_lib

    cache = ROOT / "build" / "chip_smoke_tune" / "mlp"
    shutil.rmtree(cache, ignore_errors=True)
    argv = ["--autotune", "probe", "--autotune-cache-dir", str(cache)]
    tag = "tune_mlp"
    run, t, _ = _tuned_search(torch, fa, fx, tag, argv,
                              config_lib.AUTOTUNE_DEFAULT_TRIALS, card)
    ref = _cli_run(torch, fa, fx, f"{tag}_untuned", _at_point(t))
    a, b = _epochs_of(run), _epochs_of(ref)
    print(f"{tag}: tuned " + _step_line(run, 64, "samples")
          + "; untuned at the point " + _step_line(ref, 64, "samples")
          + f"; epochs (Avg, eval) tuned {a}, untuned {b}; {card}")
    if a != b or len(a) != 5:
        fail(f"{tag}: the epochs' losses differ: tuned {a}, untuned {b}")
    _cache_rerun(torch, fa, fx, tag, argv, t, card, 64, "samples")
    shutil.rmtree(cache, ignore_errors=True)
    capture_oom_drill(torch, card)


def tuner_full_width(torch, fa, fx, card: str):
    """Phase 12b, the path ``tune_seq512_bf16``: the tuner at full width
    on phase 11a's configuration (BASELINE config #5 at seq 512, bf16,
    bf16 Adam nu, ``--lm-head fused``, global batch 8, seed 42) with
    ``--log-every 8`` over 128 samples (16 steps an epoch: the k ladder
    1, 2, 4, 8), 1 epoch, ``--autotune-trials 8``: the remat and
    grad-accumulation axes and the flash forward, merged backward and
    fused-head kernels inside captured probes. The search must succeed
    (``_tuned_search``), the remat and accumulation points it reached be
    measured or pruned with their error, the run's launches exact (the
    probes' shown apart), its epoch losses bitwise an untuned run's at
    the committed point (and, where a math knob moved, within f32 1e-4
    of an untuned run at the committed schedule alone), and a rerun a
    pure cache hit. Returns the path's launches."""
    from tpudist_torch import config as config_lib

    cache = ROOT / "build" / "chip_smoke_tune" / "seq512"
    shutil.rmtree(cache, ignore_errors=True)
    seq, n_samples = 512, 128
    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", "1", "--seed", "42", "--log-every", "8",
            "--dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
            "--lm-head", "fused"]
    cfg = config_lib.parse_args(argv)
    tuned_argv = argv + ["--autotune", "probe", "--autotune-trials", "8",
                         "--autotune-cache-dir", str(cache)]
    m = cfg.model
    print(f"{TUNE_PATH}: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, adam "
          f"nu {cfg.adam_nu_dtype}, --lm-head fused, batch "
          f"{cfg.batch_size}, {n_samples} samples, 1 epoch, --log-every "
          f"8, --autotune probe --autotune-trials 8; {card}")
    run, t, trials = _tuned_search(torch, fa, fx, TUNE_PATH, tuned_argv, 8,
                                   card)
    for axis, probed in (
            ("remat", [tr for tr in trials[1:] if tr["cand"].remat]),
            ("grad_accum", [tr for tr in trials[1:]
                            if tr["cand"].grad_accum_steps > 1])):
        print(f"{TUNE_PATH}: the {axis} axis: " + ("; ".join(
            f"k={tr['cand'].k} accum={tr['cand'].grad_accum_steps} remat="
            f"{tr['cand'].remat}: " + (
                f"{tr['res'].steps_per_sec:.2f} steps/s"
                + (" (captured)" if tr["cand"].k > 1 else " (per-step)")
                if tr["res"].feasible else f"pruned: {tr['res'].error}")
            for tr in probed) or "not reached within the budget"))
    steps = n_samples // cfg.batch_size
    want = want_launches(fa, m, seq, steps, 1, fused=True)
    probes = dict.fromkeys(want, 0)
    for tr in trials:
        for name, n in (tr["res"].launches or {}).items():
            probes[name] += n
    print(f"{TUNE_PATH}: timed run {_step_line(run, cfg.batch_size * seq)}"
          f"; kernel launches {run['counts']} (want {want}); the probes' "
          f"launches apart {probes}; {card}")
    if run["counts"] != want:
        fail(f"{TUNE_PATH}: kernel launches {run['counts']}, want {want}")
    ref = _cli_run(torch, fa, fx, f"{TUNE_PATH}_untuned",
                   argv + _at_point(t))
    a, b = _epochs_of(run), _epochs_of(ref)
    print(f"{TUNE_PATH}: epochs (Avg, eval) tuned {a}, untuned at the "
          f"point {b}")
    if a != b or len(a) != 1:
        fail(f"{TUNE_PATH}: the epochs' losses differ: tuned {a}, "
             f"untuned {b}")
    if t["remat"] != cfg.remat or t["grad_accum_steps"] != 1:
        sched = _cli_run(torch, fa, fx, f"{TUNE_PATH}_schedule",
                         argv + _at_point(t, math=False))
        c = _epochs_of(sched)
        err = max(abs(x - y) / abs(y) for p, q in zip(a, c)
                  for x, y in zip(p, q))
        print(f"{TUNE_PATH}: a math knob moved: epochs at the schedule "
              f"alone {c}, worst relative difference {err:.3e} (tol 1e-4)")
        if err > 1e-4:
            fail(f"{TUNE_PATH}: the math knob moved the losses by {err:.3e}")
    _cache_rerun(torch, fa, fx, TUNE_PATH, tuned_argv, t, card,
                 cfg.batch_size * seq, "tokens")
    shutil.rmtree(cache, ignore_errors=True)
    return run["counts"]


# phase 13: the observability every default run writes
OBS_SPANS = ("distributed_init", "data_materialize", "model_init", "setup",
             "ckpt_open", "epoch", "dispatch", "stage_slab", "fence",
             "slab_wait", "eval", "hosts_gather", "ckpt_enqueue")
OBS_OFF = ["--trace", "off", "--stall-timeout-s", "0", "--hbm-sample-s", "0"]
OBS_PATHS = ("obs_seq512_bf16_off", "obs_seq512_bf16_on")
OBS_SERVE = ("obs_serve_on", "obs_serve_off")


def _read_json(path: Path, what: str):
    if not path.is_file():
        fail(f"{what}: no {path.name} in the run directory")
    try:
        return json.loads(path.read_text())
    except ValueError as e:
        fail(f"{what}: {path.name} does not parse ({e})")


def _x_names(doc):
    return {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}


def _ledger_line(what: str, d: Path, recs) -> str:
    """The run's memory ledger: one ``kind=memledger`` record and
    ``memledger.json``, whose partition sums to the card's memory."""
    led = _read_json(d / "memledger.json", what)
    n = sum(r["kind"] == "memledger" for r in recs)
    b = led["buckets"]
    if n != 1 or sum(b.values()) != led["total_hbm_bytes"]:
        fail(f"{what}: {n} kind=memledger records, buckets sum "
             f"{sum(b.values())} of {led['total_hbm_bytes']}")
    return (f"ledger {'exact' if led['exact'] else 'INEXACT'}, headroom "
            f"{led['headroom_status']} ({led['headroom_fraction']}) of "
            f"{led['total_hbm_bytes'] / MB:.1f} MB: "
            + ", ".join(f"{k} {v / MB:.1f}" for k, v in b.items())
            + f" MB; program_temp complete "
            f"{led['program_temp_complete']}; problems {led['problems']}")


def step_flops(m, b: int, s: int) -> int:
    """One training step's model flops at batch ``b``, seq ``s`` of model
    ``m``, the count's closed form (``tpudist_torch.obs.mfu``): 6 x
    tokens x the linear layers' and the tied head's weights, plus the
    causal attention's two products over s(s+1)/2 pairs, forward and
    twice that backward."""
    hd = m.d_model // m.n_heads
    linear = m.n_layers * (m.d_model * m.n_heads * hd * 2
                           + 2 * m.d_model * m.n_kv_heads * hd
                           + 3 * m.d_model * m.d_ff)
    pairs = s * (s + 1) // 2
    return (6 * b * s * (linear + m.vocab_size * m.d_model)
            + 12 * b * m.n_heads * hd * pairs * m.n_layers)


def check_obs_dir(what: str, run, epochs: int, n_steps: int, flops: int,
                  card: str) -> None:
    """Phase 13a: a default train run's directory holds the JAX run's
    artifact set: both traces with every span name and nothing dropped,
    the beacon at the final step, a ``kind=hosts`` record an epoch, the
    memory ledger, the timing record's MFU within (0, 1.05] over a flop
    count equal to the closed form ``flops`` (the CPU's count: the
    kernels report the plain versions' formulas), the watermark from the
    card's counters at or above the run's peak allocation, and
    ``run_id`` on every record."""
    d, t = run["dir"], run["timing"]
    for name in ("trace.worker0.json", "pod_trace.json"):
        doc = _read_json(d / name, what)
        missing = set(OBS_SPANS) - _x_names(doc)
        meta = doc["metadata"]
        if missing or meta.get("dropped") != 0 or not meta.get("run_id"):
            fail(f"{what}: {name} lacks spans {sorted(missing)}, dropped "
                 f"{meta.get('dropped')}, run_id {meta.get('run_id')}")
    beat = _read_json(d / "heartbeat.worker0", what)
    if (beat.get("epoch"), beat.get("step")) != (epochs - 1, n_steps):
        fail(f"{what}: the beacon reads epoch {beat.get('epoch')} step "
             f"{beat.get('step')}, want {epochs - 1} and {n_steps}")
    hosts = [r for r in run["recs"] if r["kind"] == "hosts"]
    if [r["epoch"] for r in hosts] != list(range(epochs)) or any(
            "straggler_status" not in r for r in hosts):
        fail(f"{what}: kind=hosts records {hosts}")
    ledger = _ledger_line(what, d, run["recs"])
    unstamped = {r["kind"] for r in run["recs"] if not r.get("run_id")}
    if unstamped or len({r["run_id"] for r in run["recs"]}) != 1:
        fail(f"{what}: records without the run's one run_id: {unstamped}")
    mfu = t.get("mfu")
    if t["model_flops_per_step"] != flops:
        fail(f"{what}: {t['model_flops_per_step']} flops a step, the "
             f"closed form {flops}")
    if not (mfu and 0 < mfu <= 1.05) or t["trace_status"] != "success" \
            or t["hbm_source"] != "memory_stats" \
            or t["hbm_peak_bytes"] < run["peak_bytes"]:
        fail(f"{what}: mfu {mfu}, trace {t['trace_status']}, hbm "
             f"{t['hbm_source']} peak {t['hbm_peak_bytes']} against the "
             f"run's max_memory_allocated {run['peak_bytes']}")
    print(f"{what}: mfu {mfu:.4f} ({t['achieved_tflops_per_chip']:.2f} "
          f"of {t['peak_tflops']} TFLOP/s, {t['model_flops_per_step']:.4e} "
          f"flops a step); hbm peak {t['hbm_peak_bytes'] / MB:.1f} MB "
          f"(max_memory_allocated {run['peak_bytes'] / MB:.1f}), in use "
          f"{t['hbm_bytes_in_use'] / MB:.1f}, reserved "
          f"{t['hbm_bytes_reserved'] / MB:.1f}, fragmentation "
          f"{t['hbm_fragmentation_bytes'] / MB:.1f}, limit "
          f"{t['hbm_limit_bytes'] / MB:.1f} MB; straggler "
          f"{t['straggler_status']}; trace {t['trace_spans']} spans; "
          f"{card}")
    print(f"{what}: {ledger}")


def obs_train(torch, fa, fx, card: str, on, argv, env):
    """Phase 13a: phase 11a's superstep run (``on``: observability on by
    default) is checked by :func:`check_obs_dir`, then the configuration
    runs with ``--trace off --stall-timeout-s 0 --hbm-sample-s 0`` and
    on again, in turns: the losses bitwise equal, the programs, replays
    and launches the same, each run's step time printed. Returns the two
    runs' launches."""
    from tpudist_torch import config as config_lib

    epochs, n_steps = 2, 10
    flops = step_flops(config_lib.parse_args(argv).model, 8, 512)
    check_obs_dir("obs 13a, phase 11a's default run", on, epochs, n_steps,
                  flops, card)
    shutil.rmtree(on["dir"], ignore_errors=True)
    sup = on["supersteps"][0]
    graphs = (sup.programs, sup.replays, sup.captured_launches)
    step_ms = [("on", 1e3 * on["timing"]["run_s"] / on["timing"]["steps"])]
    paths = {}
    for how in ("off", "on"):
        tag = f"obs_seq512_bf16_{how}"
        run = _cli_run(torch, fa, fx, tag,
                       argv + (OBS_OFF if how == "off" else []), env,
                       keep=True)
        t = run["timing"]
        if how == "on":
            check_obs_dir(tag, run, epochs, n_steps, flops, card)
        elif t["trace_status"] != "ungateable" or t["hbm_source"] != "off" \
                or (run["dir"] / "pod_trace.json").exists():
            fail(f"{tag}: trace {t['trace_status']}, hbm "
                 f"{t['hbm_source']}: the observability stayed on")
        shutil.rmtree(run["dir"], ignore_errors=True)
        s2 = run["supersteps"][0]
        same = (_epochs_of(run) == _epochs_of(on)
                and run["counts"] == on["counts"]
                and (s2.programs, s2.replays, s2.captured_launches)
                == graphs)
        print(f"{tag}: epochs (Avg, eval) {_epochs_of(run)}, launches "
              f"{run['counts']}, programs {s2.programs}, replays "
              f"{s2.replays}: equal to the default run's {same}")
        if not same:
            fail(f"{tag}: the losses, launches or graphs differ from the "
                 f"default run's")
        paths[tag] = run["counts"]
        step_ms.append((how, 1e3 * t["run_s"] / t["steps"]))
    print("obs 13a: step ms in turns "
          + ", ".join(f"{h} {ms:.3f}" for h, ms in step_ms) + f"; {card}")
    return paths


@contextlib.contextmanager
def _serve_engines():
    """Every serve engine (dense or paged) the serve CLI builds inside the
    block, for the launches its graphs' replays ran."""
    from tpudist_torch.serve import engine as engine_mod

    made = []
    real = {name: getattr(engine_mod, name)
            for name in ("ServeEngine", "PagedServeEngine")}

    def factory(cls):
        def make(*args, **kw):
            made.append(cls(*args, **kw))
            return made[-1]
        return make
    for name, cls in real.items():
        setattr(engine_mod, name, factory(cls))
    try:
        yield made
    finally:
        for name, cls in real.items():
            setattr(engine_mod, name, cls)


# phase 4's serving configuration through the serve CLI
SERVE_ARGV = ["--vocab-size", "32000", "--n-layers", "4", "--d-model",
              "2048", "--n-heads", "16", "--n-kv-heads", "16", "--d-ff",
              "5504", "--slots", "8", "--max-seq", "1024", "--prompt-pad",
              "512", "--decode-steps-per-dispatch", "8", "--adapt", "on",
              "--requests", "16", "--max-new-tokens", "32", "--seed", "0"]


def obs_serve(torch, fa, fx, card: str):
    """Phase 13b: ``python -m tpudist_torch.serve`` (its ``run``) at phase
    4's configuration on the graph engine, its default trace and memory
    ledger, then with ``--trace off``: one slot track in
    ``pod_trace.json`` for each slot that served, the ledger, ``run_id``
    on every record, the tokens equal, the program pin, the flash
    launches exact. Returns each run's launches."""
    from tpudist_torch.serve import cli as serve_cli

    runs, paths = {}, {}
    for how in ("on", "off"):
        tag = f"obs_serve_{how}"
        save = ROOT / "build" / "chip_smoke_serve" / how
        shutil.rmtree(save, ignore_errors=True)
        argv = SERVE_ARGV + ["--save-dir", str(save)] \
            + (["--trace", "off"] if how == "off" else [])
        _reset_launches(fa, fx)
        with _serve_engines() as made:
            summary = serve_cli.run(serve_cli.parse_args(argv))
        torch.cuda.synchronize()
        engine = made[0]
        engine.assert_two_programs()
        counts = {"flash_attention_fwd": engine.kernel_launches()}
        want = engine.model_cfg.n_layers * (summary["admitted"] + 1)
        recs = [json.loads(ln) for ln in
                (save / "metrics.jsonl").read_text().splitlines()]
        print(f"{tag}: {summary['completed']}/{summary['requests']} "
              f"requests, tokens/s/chip "
              f"{summary['tokens_per_sec_per_chip']}, programs "
              f"{engine.compile_counts()}, graph pools "
              f"{engine.graph_pool_bytes / MB:.1f} MB, flash launches "
              f"{counts['flash_attention_fwd']} (want {want}); {card}")
        if summary["completed"] != 16 or counts["flash_attention_fwd"] \
                != want:
            fail(f"{tag}: completed {summary['completed']}, flash "
                 f"launches {counts['flash_attention_fwd']} (want {want})")
        if how == "on":
            pod = _read_json(save / "pod_trace.json", tag)
            tracks = {e["args"]["name"] for e in pod["traceEvents"]
                      if e.get("ph") == "M" and e.get("tid", 0) >= 1000}
            served = {f"slot{r['slot']}" for r in recs
                      if r["kind"] == "serve_request"
                      and r["event"] == "admitted"}
            if not served or tracks != served \
                    or pod["metadata"].get("dropped") != 0:
                fail(f"{tag}: slot tracks {sorted(tracks)}, slots that "
                     f"served {sorted(served)}")
            print(f"{tag}: {len(tracks)} slot tracks, "
                  f"{pod['metadata']['spans']} spans; "
                  + _ledger_line(tag, save, recs))
            if any(not r.get("run_id") for r in recs):
                fail(f"{tag}: a record without run_id")
        elif (save / "pod_trace.json").exists():
            fail(f"{tag}: --trace off wrote a trace")
        runs[how] = summary
        paths[tag] = counts
        shutil.rmtree(save, ignore_errors=True)
        del engine, made
        torch.cuda.empty_cache()
    same = _tokens_of(runs["on"]) == _tokens_of(runs["off"])
    print(f"obs 13b: tokens traced vs --trace off equal {same}; "
          f"tokens/s/chip on {runs['on']['tokens_per_sec_per_chip']}, off "
          f"{runs['off']['tokens_per_sec_per_chip']}; {card}")
    if not same:
        fail("obs 13b: the traced run's tokens differ from --trace off's")
    return paths


def stall_drill(torch, card: str) -> None:
    """Phase 13c: a CUDA graph (64 4096 x 4096 f32 products) is
    captured while an ``HbmSampler`` reads the allocator's counters every
    millisecond from its thread (the capture must hold, its replay equal
    the eager body within f32 1e-5); then a ``FlightRecorder`` with a
    2 s stall window gets no progress while the graph replays: its
    watchdog writes ``flightrec.worker0`` with the threads' stacks and
    the card's ``memory_stats``, and the replays' output stays equal to
    the first replay's."""
    from tpudist_torch.obs.hbm import HbmSampler
    from tpudist_torch.obs.heartbeat import FlightRecorder

    out = ROOT / "build" / "chip_smoke_stall"
    shutil.rmtree(out, ignore_errors=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(4096, 4096, device=dev, generator=gen) / 64
    w = torch.randn(4096, 4096, device=dev, generator=gen) / 64

    def body():
        y = x
        for _ in range(64):
            y = torch.tanh(y @ w)
        return y
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    sampler = HbmSampler(period_s=0.001, devices=[0])
    try:
        reads = sampler.samples
        with torch.cuda.graph(graph):
            y = body()
        reads = sampler.samples - reads
    finally:
        sampler.close()
    graph.replay()
    torch.cuda.synchronize()
    ref = y.clone()
    d_eager = (ref - eager).abs().max().item()
    print(f"stall drill: the capture ran beside {reads} sampler reads; "
          f"replay vs eager max |d| {d_eager:.3e}; {card}")
    if reads < 1 or d_eager > 1e-5:
        fail(f"stall drill: {reads} sampler reads during the capture, "
             f"replay vs eager {d_eager:.3e}")
    rec = FlightRecorder(str(out), stall_timeout_s=2.0)
    t0 = time.perf_counter()
    n = 0
    try:
        while rec.dumps < 1 and time.perf_counter() - t0 < 30:
            graph.replay()
            n += 1
            if n % 20 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = torch.equal(y, ref)
    finally:
        rec.close()
    doc = _read_json(out / "flightrec.worker0", "stall drill")
    mem = {m["id"]: m["stats"] for m in doc.get("memory_stats") or []}
    card0 = (mem.get(0) or {}).get("allocated_bytes.all.current", 0)
    print(f"stall drill: flight record after {wall:.2f} s and {n} replays "
          f"(reason {doc['reason']}, stall_s {doc['stall_s']}), stacks "
          f"{len(doc['thread_stacks'].splitlines())} lines, memory_stats "
          f"of {len(mem)} card(s), card 0 allocated {card0 / MB:.1f} MB; "
          f"output equal {same}; {card}")
    if doc["reason"] != "stall" or "File" not in doc["thread_stacks"] \
            or card0 <= 0 or not same:
        fail("stall drill: no stall record with stacks and the card's "
             "memory_stats, or the replay's output changed")
    shutil.rmtree(out, ignore_errors=True)
    del graph, x, w, y, ref, eager
    torch.cuda.empty_cache()


# phase 14's paths, each a main path of the flash forward
PAGED_PATHS = ("paged_serve", "paged_prefix_dense", "paged_serve_spec",
               "fixed_memory_dense", "fixed_memory_paged", "paged_serve_cli")
PREFIX = 256             # phase 14's shared system prompt, 16 full pages


def _serve_engine(torch, cfg, paged: bool, slots: int = 8, **kw):
    """Phase 4's engine configuration (max_seq 1024, prompt_pad 512, the
    ladder (8, 4, 2), f32 on the card), dense or paged."""
    from tpudist_torch.serve import resilience as res_lib
    from tpudist_torch.serve.engine import PagedServeEngine, ServeEngine

    cls = PagedServeEngine if paged else ServeEngine
    return cls(cfg, slots=slots, max_seq=1024, prompt_pad=512, decode_k=8,
               dtype=torch.float32, device="cuda",
               adapt_ladder=res_lib.default_ladder(8), **kw)


def _paged_run(torch, fa, fx, tag, engine, params, requests, prefix=None,
               prefixes: int = 0):
    """One main path: the launch counts set to 0, the engine warmed (its
    captures) and ``run_serve`` over ``requests``; the flash forward must
    have launched n_layers x (prefills + prefix registrations), the
    warm-up's eager prefill among the prefills, counted through the
    replays. Returns the summary and the path's launch counts."""
    from tpudist_torch.serve import scheduler as sched

    _reset_launches(fa, fx)
    engine.reset_kernel_launches()
    t0 = time.perf_counter()
    engine.warmup(params)
    warm_s = time.perf_counter() - t0
    summary = sched.run_serve(engine, params, requests,
                              shared_prefix=prefix)
    torch.cuda.synchronize()
    counts = _serve_counts(engine)
    engine.assert_two_programs()
    n = engine.model_cfg.n_layers
    want = n * (summary["admitted"] + prefixes + 1)
    got = counts["flash_attention_fwd"]
    print(f"{tag}: {summary['completed']}/{summary['requests']} requests, "
          f"{summary['generated_tokens']} tokens over "
          f"{summary['dispatches']} dispatches, tokens/s/chip "
          f"{summary['tokens_per_sec_per_chip']}, ttft p50 "
          f"{summary['ttft_p50_s']} s, itl p50 {summary['itl_p50_s']} s "
          f"p99 {summary['itl_p99_s']} s, active slots peak "
          f"{summary['active_slots_peak']}, kv pages peak "
          f"{summary['kv_pages_used_peak']}/{summary['kv_pages_total']}; "
          f"kv cache {engine.spec.bytes} bytes; programs "
          f"{engine.compile_counts()} + verify "
          f"{summary['verify_compiles']}, warmup {warm_s:.3f} s (capture "
          f"{engine.capture_s:.3f} s, graph pools "
          f"{engine.graph_pool_bytes / MB:.1f} MB); flash launches {got} "
          f"(want n_layers x (prefills + registrations + warm-up) = {n} x "
          f"{summary['admitted']} + {prefixes} + 1 = {want})")
    if summary["completed"] != len(requests) or summary["truncated"]:
        fail(f"{tag}: completed {summary['completed']}/{len(requests)} "
             f"({summary['truncated']} truncated)")
    if got != want:
        fail(f"{tag}: flash kernel launched {got} times, want {want}")
    for rid, res in summary["results"].items():
        toks = res["tokens"]
        if len(toks) != 32 or not all(
                0 <= t < engine.model_cfg.vocab_size for t in toks):
            fail(f"{tag}: request {rid} produced {toks!r}")
    return summary, counts


def _full_logits(torch, params, cfg, tokens, **kw):
    """The non-cached forward's tied logits (batch, seq, vocab) in f32, of
    the transformer or the MoE (``kw``: ``attn_impl``)."""
    from tpudist_torch.models import get_model

    h = get_model(cfg.name).hidden_states(params, tokens, cfg,
                                          dtype=torch.float32, **kw)
    if cfg.name == "moe":
        h = h[0]                     # (h, aux)
    return (h @ params.embed.to(torch.float32).T).to(torch.float32)


def _near_ties(torch, params, cfg, requests, want, got, tag) -> int:
    """The requests whose tokens differ from the dense run's ``want``:
    each one's first divergence must be a near-tie, the full forward's
    top-two logit gap there within f32 noise (1e-4 of the logits' largest
    magnitude), or the phase fails. Returns how many differ. (The MoE's
    full forward routes the sequence in groups of its own, where decode
    routed each step's slot batch: the gap is that forward's.)"""
    by_rid = {r.rid: r for r in requests}
    ties = 0
    for rid in sorted(want):
        w, g = want[rid], got.get(rid)
        if g == w:
            continue
        if g is None or len(g) != len(w):
            fail(f"{tag}: request {rid} gave {g!r}, the dense run {w!r}")
        i = next(j for j in range(len(w)) if w[j] != g[j])
        req = by_rid[rid]
        seq = [int(t) for t in req.tokens[:req.prompt_len]] + w[:i]
        with torch.no_grad():
            logits = _full_logits(torch, params, cfg, torch.as_tensor(
                [seq], dtype=torch.int64,
                device=params.embed.device))[0, -1]
        top = logits.topk(2).values
        gap, scale = float(top[0] - top[1]), float(logits.abs().max())
        print(f"{tag}: request {rid} diverges at token {i}: dense "
              f"{w[i]}, this run {g[i]}; the full forward's top-two logit "
              f"gap there {gap:.3e} (f32 noise: 1e-4 x {scale:.3e})")
        if gap > 1e-4 * scale:
            fail(f"{tag}: request {rid}'s tokens differ from the dense "
                 f"run's at token {i}, not at a near-tie")
        ties += 1
    print(f"{tag}: tokens vs the dense run: {len(want) - ties}/"
          f"{len(want)} requests equal, {ties} near-tie divergence(s)")
    return ties


def _ref(summary):
    """A one-card run's tokens and latencies, phase 23's reference."""
    return {"tokens": _tokens_of(summary),
            **{k: summary[k] for k in SERVE_LATENCY}}


def paged_serve(torch, fa, fx, base, card: str, profile: bool, refs=None):
    """Phase 14: the paged serving plane at phase 4's configuration on
    the graph engine. (a) ``PagedServeEngine`` with 16-token pages (512
    pages, the dense capacity) over phase 4's 16 requests: every
    request's tokens equal phase 4's dense tokens and the eager bodies',
    the pin (1, 3, verify 0), the pool drained to 0 pages; (b) with a
    256-token shared prefix and ``speculate_k`` 4 against the dense
    engine on the same prefixed stream: the tokens equal, the pin (1, 3,
    1), the registry's 16 pages held after the drain, the acceptance
    printed; (c) the fixed-memory pair: the dense engine (8 slots)
    against 16 paged slots on 480 pages, strictly fewer bytes, 32
    requests with the prefix: equal tokens, more slots at once; (d) the
    serve CLI with the three paged flags: the memory-bound line, the
    ledger exact with ``kv_pool`` the pool's bytes, the slot and
    ``kv_pages`` tracks, verdict ``success``. Returns each path's
    launches; ``refs`` (a dict) receives 14a's and 14b's runs
    (:func:`_ref`) under ``paged_serve`` and ``paged_serve_spec``."""
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.obs import trace as trace_lib
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import init_params

    cfg = ModelConfig(name="transformer")
    params = init_params(cfg, seed=0, device="cuda")
    paths, ties = {}, 0

    def stream(n, seed, prefix_len=0):
        return sched.make_requests(n, prompt_pad=512,
                                   vocab_size=cfg.vocab_size, max_new=32,
                                   rate=0.0, seed=seed,
                                   prefix_len=prefix_len)

    # 14a: phase 4's stream on the paged engine
    requests = stream(16, 0)
    engine = _serve_engine(torch, cfg, True, page_tokens=16)
    a, paths["paged_serve"] = _paged_run(torch, fa, fx, "paged 14a",
                                         engine, params, requests)
    if refs is not None:
        refs["paged_serve"] = _ref(a)
    if engine.compile_counts() != (1, 3) or engine.verify_traces \
            or engine.alloc.pages_used() != 0:
        fail(f"paged 14a: programs {engine.compile_counts()} + verify "
             f"{len(engine.verify_traces)}, {engine.alloc.pages_used()} "
             f"pages still used after the drain")
    eager = sched.run_serve(_EagerBodies(engine), params, requests)
    same = _tokens_of(eager) == _tokens_of(a)
    print(f"paged 14a: every request's tokens, graphs vs the eager bodies: "
          f"equal {same}")
    if not same:
        fail("paged 14a: the graphs' tokens differ from the eager bodies'")
    ties += _near_ties(torch, params, cfg, requests, _tokens_of(base),
                       _tokens_of(a), "paged 14a")
    print(f"paged 14a: tokens/s/chip {a['tokens_per_sec_per_chip']} "
          f"(phase 4 dense {base['tokens_per_sec_per_chip']}), itl p50 "
          f"{a['itl_p50_s']} s (dense {base['itl_p50_s']} s); {card}")
    del engine, eager
    torch.cuda.empty_cache()

    # 14b: the shared prefix and speculation against the dense engine
    prefix = sched.shared_prefix_tokens(PREFIX, cfg.vocab_size, seed=0)
    requests = stream(16, 0, PREFIX)
    dense = _serve_engine(torch, cfg, False)
    d, paths["paged_prefix_dense"] = _paged_run(
        torch, fa, fx, "paged 14b dense", dense, params, requests)
    engine = _serve_engine(torch, cfg, True, page_tokens=16, speculate_k=4)
    tracer = trace_lib.configure(enabled=True)
    b, paths["paged_serve_spec"] = _paged_run(
        torch, fa, fx, "paged 14b", engine, params, requests, prefix,
        prefixes=1)
    if refs is not None:
        refs["paged_serve_spec"] = _ref(b)
    emits = [e["args"] for e in tracer.events()
             if e["name"] == "decode_emit" and "drafted" in e["args"]]
    trace_lib.configure(enabled=False)
    drafted = sum(e["drafted"] for e in emits)
    accepted = sum(e["accepted"] for e in emits)
    held = engine.alloc.pages_used()
    print(f"paged 14b: spec_accept_rate {b['spec_accept_rate']} (drafted "
          f"{drafted}, accepted {accepted} over {len(emits)} slot-verifies);"
          f" registry holds {held} pages (shared_len "
          f"{engine.alloc.shared_len}) after the drain; tokens/s/chip "
          f"{b['tokens_per_sec_per_chip']} (14a "
          f"{a['tokens_per_sec_per_chip']}, dense on this stream "
          f"{d['tokens_per_sec_per_chip']}), itl p50 "
          f"{b['itl_p50_s']} s (14a {a['itl_p50_s']} s, dense "
          f"{d['itl_p50_s']} s); {card}")
    if engine.compile_counts() != (1, 3) or len(engine.verify_traces) != 1 \
            or held != PREFIX // 16 or engine.alloc.shared_len != PREFIX \
            or not drafted or b["spec_accept_rate"] != round(
                accepted / drafted, 4):
        fail(f"paged 14b: programs {engine.compile_counts()} + verify "
             f"{len(engine.verify_traces)}, registry {held} pages, "
             f"acceptance {accepted}/{drafted} vs "
             f"{b['spec_accept_rate']}")
    ties += _near_ties(torch, params, cfg, requests, _tokens_of(d),
                       _tokens_of(b), "paged 14b")
    if profile:
        profile_paged(torch, engine, params, requests)
    del engine
    torch.cuda.empty_cache()

    # 14c: the fixed-memory pair (the JAX package's bench.py pair)
    requests = stream(32, 1, PREFIX)
    prefix = sched.shared_prefix_tokens(PREFIX, cfg.vocab_size, seed=1)
    dc, paths["fixed_memory_dense"] = _paged_run(
        torch, fa, fx, "paged 14c dense", dense, params, requests)
    dense_bytes = dense.spec.bytes
    del dense
    torch.cuda.empty_cache()
    engine = _serve_engine(torch, cfg, True, slots=16, page_tokens=16,
                           pages=480)
    pc, paths["fixed_memory_paged"] = _paged_run(
        torch, fa, fx, "paged 14c", engine, params, requests, prefix,
        prefixes=1)
    print(f"paged 14c: kv bytes paged {engine.spec.bytes} vs dense "
          f"{dense_bytes}; active slots peak paged "
          f"{pc['active_slots_peak']} vs dense {dc['active_slots_peak']}; "
          f"pages peak {pc['kv_pages_used_peak']}/480; tokens/s/chip "
          f"paged {pc['tokens_per_sec_per_chip']} vs dense "
          f"{dc['tokens_per_sec_per_chip']}, itl p50 {pc['itl_p50_s']} s "
          f"vs {dc['itl_p50_s']} s, e2e p99 {pc['e2e_p99_s']} s vs "
          f"{dc['e2e_p99_s']} s; {card}")
    if not engine.spec.bytes < dense_bytes \
            or pc["active_slots_peak"] <= dc["active_slots_peak"] \
            or pc["kv_pages_used_peak"] > 480:
        fail("paged 14c: the paged pool is not smaller or sustained no "
             "more slots than the dense cache")
    ties += _near_ties(torch, params, cfg, requests, _tokens_of(dc),
                       _tokens_of(pc), "paged 14c")
    del engine, params
    torch.cuda.empty_cache()

    # 14d: the serve CLI with the paged flags
    paths["paged_serve_cli"] = paged_cli(torch, fa, fx, card)
    print(f"paged 14: {ties} near-tie divergence(s) over 14a-14c; {card}")
    return paths


def paged_cli(torch, fa, fx, card: str):
    """Phase 14d: ``python -m tpudist_torch.serve`` (its ``main``) at phase
    4's configuration with ``--kv-page-tokens 16 --shared-prefix 256
    --speculate-k 4``. Returns the path's launches."""
    from tpudist_torch.serve import cli as serve_cli

    save = ROOT / "build" / "chip_smoke_serve" / "paged"
    shutil.rmtree(save, ignore_errors=True)
    argv = SERVE_ARGV + ["--kv-page-tokens", "16", "--shared-prefix",
                         str(PREFIX), "--speculate-k", "4", "--save-dir",
                         str(save)]
    os.environ["TPUDIST_VERDICT_PATH"] = str(save / "job_status.txt")
    tee = _Tee(sys.stdout)
    try:
        _reset_launches(fa, fx)
        with _serve_engines() as made, contextlib.redirect_stdout(tee):
            rc = serve_cli.main(argv)
        torch.cuda.synchronize()
    finally:
        del os.environ["TPUDIST_VERDICT_PATH"]
    engine = made[0]
    engine.assert_two_programs()
    counts = _serve_counts(engine)
    verdict = (save / "job_status.txt").read_text() \
        if (save / "job_status.txt").is_file() else None
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()]
    serve = [r for r in recs if r["kind"] == "serve"][-1]
    led = [r for r in recs if r["kind"] == "memledger"]
    bound = [ln for ln in tee.buf.getvalue().splitlines()
             if ln.startswith("tpudist: serve kv memory bound")]
    want = engine.model_cfg.n_layers * (serve["admitted"] + 2)
    pod = _read_json(save / "pod_trace.json", "paged 14d")
    tracks = {e["args"]["name"] for e in pod["traceEvents"]
              if e.get("ph") == "M" and e.get("tid", 0) >= 1000}
    served = {f"slot{r['slot']}" for r in recs
              if r["kind"] == "serve_request" and r["event"] == "admitted"}
    kv_track = [e for e in pod["traceEvents"]
                if e.get("ph") == "C" and e.get("name") == "kv_pages"]
    print(f"paged 14d: exit {rc}, verdict {verdict!r}; "
          f"{bound[0] if bound else 'no memory-bound line'}; "
          f"{serve['completed']}/{serve['requests']} requests, "
          f"tokens/s/chip {serve['tokens_per_sec_per_chip']}, spec accept "
          f"{serve['spec_accept_rate']}, pages peak "
          f"{serve['kv_pages_used_peak']}/{serve['kv_pages_total']}; "
          f"ledger kv_pool {led[0]['kv_pool_bytes'] if led else None} "
          f"(spec.bytes {engine.spec.bytes}) exact "
          f"{led[0]['exact'] if led else None}; {len(tracks)} slot "
          f"tracks, {len(kv_track)} kv_pages counter samples; flash "
          f"launches {counts['flash_attention_fwd']} (want {want}); {card}")
    if rc != 0 or verdict != "success" or not bound \
            or "(ledger)" not in bound[0] or not led \
            or not led[0]["exact"] \
            or led[0]["kv_pool_bytes"] != engine.spec.bytes \
            or serve["completed"] != 16 or serve["verify_compiles"] != 1 \
            or not served or tracks != served or not kv_track \
            or counts["flash_attention_fwd"] != want:
        fail("paged 14d: the serve CLI's paged run failed a check")
    shutil.rmtree(save, ignore_errors=True)
    del engine, made
    torch.cuda.empty_cache()
    return counts


# phase 15's paths, each a main path of the flash forward: the tuned
# serve CLI, its point untuned and its cache hit (15a), the two KV
# layouts (15c), the requeued attempt, the stalled, the garbage and the
# clean run (15d), the tightened-shed overload (15e)
SERVE_TUNE_PATHS = ("serve_tuned", "serve_tuned_point", "serve_tuned_cache",
                    "serve_layout_hs", "serve_layout_st", "serve_requeue",
                    "serve_slow", "serve_garbage", "serve_chaos_clean",
                    "serve_shed_breach")


@contextlib.contextmanager
def _serve_summaries():
    """The summary of every ``run_serve`` the serve CLI calls inside the
    block, with that run's alert engine (its fired alerts)."""
    from tpudist_torch.serve import scheduler as sched

    runs = []
    real_run, real_alerts = sched.run_serve, sched.AlertEngine

    class Alerts(real_alerts):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs.append({"alerts": self})

    def run_serve(*args, **kw):
        out = real_run(*args, **kw)
        runs[-1]["summary"] = out
        return out
    sched.run_serve, sched.AlertEngine = run_serve, Alerts
    try:
        yield runs
    finally:
        sched.run_serve, sched.AlertEngine = real_run, real_alerts


def _serve_cli(torch, fa, fx, tag: str, argv, env=None, want_rc: int = 0,
               prefixes: int = 0):
    """One main path: ``python -m tpudist_torch.serve`` (its ``main``)
    on the card with ``argv`` (plus a ``--save-dir`` of its own) and
    ``env``, the launch counts set to 0 just before and read just after.
    Fails unless it exits ``want_rc``, its verdict file says so, the
    served engine's pin holds and the flash forward launched exactly
    n_layers x (prefills + ``prefixes`` registrations + the warm-up's).
    Returns the run: exit code,
    stdout, records, summary, alert engine, launches, wall."""
    from tpudist_torch.serve import cli as serve_cli

    save = ROOT / "build" / "chip_smoke_serve" / tag
    shutil.rmtree(save, ignore_errors=True)
    env = {"TPUDIST_VERDICT_PATH": str(save / "job_status.txt"),
           **(env or {})}
    os.environ.update(env)
    tee = _Tee(sys.stdout)
    try:
        _reset_launches(fa, fx)
        t0 = time.perf_counter()
        with _serve_engines() as made, _serve_summaries() as runs, \
                contextlib.redirect_stdout(tee):
            rc = serve_cli.main(argv + ["--save-dir", str(save)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k in env:
            del os.environ[k]
    verdict = (save / "job_status.txt").read_text() \
        if (save / "job_status.txt").is_file() else None
    if rc != want_rc or not made or not runs \
            or verdict != ("success" if want_rc == 0 else "fail"):
        fail(f"{tag}: exit {rc} (want {want_rc}), verdict {verdict!r}")
    engine = made[-1]               # the served one (probes come first)
    engine.assert_two_programs()
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()]
    summary = runs[-1]["summary"]
    counts = _serve_counts(engine)
    want = engine.model_cfg.n_layers * (summary["admitted"] + prefixes + 1)
    run = {"rc": rc, "out": tee.buf.getvalue(), "recs": recs,
           "summary": summary, "alerts": runs[-1]["alerts"],
           "counts": counts, "wall": wall, "outside": fa.launches,
           "n_layers": engine.model_cfg.n_layers,
           "programs": (engine.compile_counts(),
                        len(getattr(engine, "verify_traces", [])))}
    print(f"{tag}: exit {rc}, verdict {verdict}; {summary['completed']}/"
          f"{summary['requests']} requests (admitted "
          f"{summary['admitted']}, rejected {summary['rejected']}, shed "
          f"{summary['shed_total']}), tokens/s/chip "
          f"{summary['tokens_per_sec_per_chip']}, itl p50 "
          f"{summary['itl_p50_s']} s p99 {summary['itl_p99_s']} s, "
          f"programs {run['programs']}, alert_events "
          f"{summary['alert_events']}; flash launches "
          f"{counts['flash_attention_fwd']} (want n_layers x (prefills + "
          f"warm-up) = {want}); {wall:.3f} s")
    if counts["flash_attention_fwd"] != want:
        fail(f"{tag}: flash kernel launched "
             f"{counts['flash_attention_fwd']} times, want {want}")
    engine.release()
    shutil.rmtree(save, ignore_errors=True)
    del engine, made
    torch.cuda.empty_cache()
    return run


def _point_argv(t) -> list:
    """Serve CLI flags for a tuned point (a ``kind=serve_tune`` record)."""
    argv = ["--decode-steps-per-dispatch", str(t["decode_k"]),
            "--kv-layout", t["layout"]]
    if t["kv_page_tokens"]:
        argv += ["--kv-page-tokens", str(t["kv_page_tokens"]),
                 "--speculate-k", str(t["speculate_k"])]
    return argv


def _tune_line(t) -> str:
    return (f"decode_k={t['decode_k']} layout={t['layout']} "
            f"kv_page_tokens={t['kv_page_tokens']} "
            f"speculate_k={t['speculate_k']}")


def serve_tuner_cli(torch, fa, fx, card: str):
    """Phase 15a: ``--serve-tune probe`` through the serve CLI at phase
    4's flags. Hard checks: exit 0, one ``kind=serve_tune`` record from a
    probe (status success, at most 8 trials, none pruned), the committed
    tokens/s at least the start's, the pin, the probes' launches kept
    off the counters, the tokens bitwise those of a ``--serve-tune off``
    run at the committed point; then ``cache-only`` on the same
    directory: a hit with 0 trials. Returns each path's launches."""
    cache = ROOT / "build" / "chip_smoke_serve" / "tune_cache"
    shutil.rmtree(cache, ignore_errors=True)
    paths = {}
    tuned = _serve_cli(torch, fa, fx, "serve 15a tuned", SERVE_ARGV + [
        "--serve-tune", "probe", "--tune-cache-dir", str(cache)])
    paths["serve_tuned"] = tuned["counts"]
    rec = [r for r in tuned["recs"] if r["kind"] == "serve_tune"]
    line = [ln for ln in tuned["out"].splitlines()
            if ln.startswith("tpudist: serve tune ")]
    print(f"serve 15a: {line[0] if line else 'no serve tune line'}; "
          f"flash launches outside the graphs {tuned['outside']} (the "
          f"warm-up's {tuned['n_layers']}: the probes restored the "
          f"counters); {card}")
    t = rec[0] if len(rec) == 1 else None
    if t is None or t["source"] != "probe" or t["status"] != "success" \
            or not 0 < t["trials"] <= 8 or t["pruned"] != 0 \
            or t["tokens_per_sec"] < t["baseline_tokens_per_sec"] \
            or tuned["outside"] != tuned["n_layers"]:
        fail(f"serve 15a: serve_tune records {rec}, outside launches "
             f"{tuned['outside']}")
    print(f"serve 15a: committed {_tune_line(t)} at "
          f"{t['tokens_per_sec']:.1f} tokens/s probed, the start "
          f"{t['baseline_tokens_per_sec']:.1f}, {t['trials']} trials, "
          f"{t['pruned']} pruned; {card}")
    plain = _serve_cli(torch, fa, fx, "serve 15a point", SERVE_ARGV
                       + _point_argv(t))
    paths["serve_tuned_point"] = plain["counts"]
    hit = _serve_cli(torch, fa, fx, "serve 15a cache", SERVE_ARGV + [
        "--serve-tune", "cache-only", "--tune-cache-dir", str(cache)])
    paths["serve_tuned_cache"] = hit["counts"]
    h = [r for r in hit["recs"] if r["kind"] == "serve_tune"]
    same = _tokens_of(tuned["summary"]) == _tokens_of(plain["summary"]) \
        == _tokens_of(hit["summary"])
    print(f"serve 15a: tokens tuned vs --serve-tune off at the point vs "
          f"the cache hit: equal {same}; cache-only {h[0]['source']} "
          f"{h[0]['trials']} trials at {_tune_line(h[0])}; tokens/s/chip "
          f"tuned {tuned['summary']['tokens_per_sec_per_chip']}, point "
          f"{plain['summary']['tokens_per_sec_per_chip']}, cache "
          f"{hit['summary']['tokens_per_sec_per_chip']}; {card}")
    if not same or h[0]["source"] != "cache" or h[0]["trials"] != 0 \
            or _tune_line(h[0]) != _tune_line(t):
        fail("serve 15a: the tuned run's tokens differ from the point's, "
             "or the cache rerun was no 0-trial hit at the point")
    shutil.rmtree(cache, ignore_errors=True)
    return paths


def serve_tuner_space(torch, fa, fx, card: str):
    """Phase 15b: ``autotune_serve(mode="probe", trials=16)`` in-process
    at phase 4's shape, on a fresh cache: one line a trial (the
    candidate, tokens/s, dispatch ms, spread, tokens, feasible or its
    error, reserved memory after it and the trial's peak). Hard checks:
    none pruned, the reserved memory after the search within one
    trial's footprint of before, the launch counters untouched."""
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.serve import tune as serve_tune
    from tpudist_torch.serve.engine import init_params

    cache = ROOT / "build" / "chip_smoke_serve" / "tune_space"
    shutil.rmtree(cache, ignore_errors=True)
    cfg = ModelConfig(name="transformer")
    params = init_params(cfg, seed=0, device="cuda")
    trials = []
    real = serve_tune.probe_candidate

    def probe(*args, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        res = real(*args, **kw)
        trials.append((args[3], res, torch.cuda.memory_reserved(),
                       torch.cuda.max_memory_reserved() - before))
        return res
    counts = engine_lib.kernel_launch_counts()
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    serve_tune.probe_candidate = probe
    t0 = time.perf_counter()
    try:
        out = serve_tune.autotune_serve(
            cfg, "cuda", params, slots=8, max_seq=1024, prompt_pad=512,
            mode="probe", cache_dir=str(cache), trials=16)
    finally:
        serve_tune.probe_candidate = real
    wall = time.perf_counter() - t0
    after = torch.cuda.memory_reserved()
    for cand, res, reserved, peak in trials:
        print(f"serve 15b: trial decode_k={cand.decode_k} "
              f"layout={cand.layout} kv_page_tokens={cand.kv_page_tokens} "
              f"speculate_k={cand.speculate_k}: {res.tokens_per_sec:.1f} "
              f"tokens/s, dispatch {res.dispatch_ms:.3f} ms, spread "
              f"{res.spread:.4f}, tokens {res.tokens}, "
              + ("feasible" if res.feasible else f"PRUNED ({res.error})")
              + f"; reserved after {reserved / MB:.1f} MB, trial peak "
              f"{peak / MB:.1f} MB over its start")
    footprint = max((p for *_, p in trials), default=0)
    print(f"serve 15b: {out.source} {out.status}: {out.trials} trials, "
          f"{out.pruned} pruned in {wall:.3f} s, committed "
          f"decode_k={out.tuned.decode_k} layout={out.tuned.layout} "
          f"kv_page_tokens={out.tuned.kv_page_tokens} "
          f"speculate_k={out.tuned.speculate_k} at "
          f"{out.tokens_per_sec:.1f} tokens/s (start "
          f"{out.baseline_tokens_per_sec:.1f}); reserved memory "
          f"{before / MB:.1f} MB before, {after / MB:.1f} after (one "
          f"trial's footprint up to {footprint / MB:.1f}); {card}")
    if out.pruned or out.source != "probe" \
            or after - before > footprint \
            or engine_lib.kernel_launch_counts() != counts:
        fail("serve 15b: a pruned trial, memory not back, or the probes "
             "moved the launch counters")
    shutil.rmtree(cache, ignore_errors=True)
    del params
    torch.cuda.empty_cache()


def _superstep_ms(torch, engine, params, requests, runs: int = 7):
    """Median wall ms of one replayed decode superstep over the full
    slot batch (each slot prefilled from ``requests``), fenced on the
    tokens."""
    state = engine.init_state()
    for slot, req in enumerate(requests[:engine.slots]):
        engine.prefill(params, state, req.tokens[None, :], req.prompt_len,
                       slot, 480)[1].item()
    engine.decode(params, state)[1].cpu()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode(params, state)[1].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serve_layouts(torch, fa, fx, card: str, profile: bool):
    """Phase 15c: phase 4's stream on phase 4's engine at ``layout="hs"``
    and at ``"st"`` in one call: the tokens equal, or the first
    divergence a near tie (phase 14's rule, printed and counted); each
    run's tokens/s/chip and replayed decode superstep; ``st``'s run (phase
    4's) carries no alert at the default gates. ``--profile`` adds each
    superstep's busy share and largest kernels. Returns the launches."""
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import init_params

    cfg = ModelConfig(name="transformer")
    params = init_params(cfg, seed=0, device="cuda")
    requests = sched.make_requests(16, prompt_pad=512,
                                   vocab_size=cfg.vocab_size, max_new=32,
                                   rate=0.0, seed=0)
    paths, runs, step = {}, {}, {}
    for layout in ("hs", "st"):
        tag = f"serve_layout_{layout}"
        engine = _serve_engine(torch, cfg, False, layout=layout)
        runs[layout], paths[tag] = _paged_run(
            torch, fa, fx, f"serve 15c {layout}", engine, params, requests)
        step[layout] = _superstep_ms(torch, engine, params, requests)
        if profile:
            state = engine.init_state()
            for slot, req in enumerate(requests[:engine.slots]):
                engine.prefill(params, state, req.tokens[None, :],
                               req.prompt_len, slot, 480)[1].item()
            wall, rows = _profiled(
                torch, lambda: engine.decode(params, state)[1].cpu())
            busy = sum(r[1] for r in rows)
            print(f"profile: layout {layout}, one replayed decode "
                  f"superstep: {wall:.3f} ms wall, device kernel time "
                  f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy)")
            for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
                print(f"profile:   {ms:9.3f} ms {count:5d}x  {key[:80]}")
        engine.release()
        del engine
        torch.cuda.empty_cache()
    ties = _near_ties(torch, params, cfg, requests, _tokens_of(runs["st"]),
                      _tokens_of(runs["hs"]), "serve 15c hs vs st")
    st = runs["st"]
    print(f"serve 15c: tokens/s/chip hs {runs['hs']['tokens_per_sec_per_chip']}"
          f" vs st {st['tokens_per_sec_per_chip']}; replayed decode "
          f"superstep hs {step['hs']:.3f} ms vs st {step['st']:.3f} ms; "
          f"{ties} near-tie divergence(s); st's alert_events "
          f"{st['alert_events']} (status {st['status']}); {card}")
    if st["alert_events"] != 0 or st["status"] != "success":
        fail(f"serve 15c: phase 4's run at the default gates has "
             f"{st['alert_events']} alert events, status {st['status']}")
    del params
    torch.cuda.empty_cache()
    return paths


def _terminal(recs, attempt: int):
    """(admitted rids, {rid: [terminal events]}) of one attempt."""
    from tpudist_torch.serve import resilience as res_lib

    admitted, terminal = set(), {}
    for r in recs:
        if r["kind"] != "serve_request" or r["requeue_attempt"] != attempt:
            continue
        if r["event"] == res_lib.ADMITTED:
            admitted.add(r["rid"])
        elif r["event"] in res_lib.TERMINAL_EVENTS:
            terminal.setdefault(r["rid"], []).append(r["event"])
    return admitted, terminal


def serve_chaos(torch, fa, fx, card: str):
    """Phase 15d: the serve chaos surface through the CLI at phase 4's
    flags on virtual time. (i) ``--chaos serve_kill@0:3 --requeue-attempt
    0`` in a process of its own: exit 137, a flushed ``kind=chaos``
    record, no ``kind=serve``; (ii) the same flags without ``--chaos`` at
    ``--requeue-attempt 1``: exit 0, ``kind=serve_resume``, the lost rids
    exactly those attempt 0 admitted with no terminal event, every rid
    in exactly one terminal bucket across the attempts, the pin; (iii)
    ``serve_slow@0:2,s=0.05,steps=3``: completes, its ITL p99 above a
    clean run's; (iv) ``request_garbage@0:0,n=6``: six rejections with a
    named reason, the well-formed tokens the clean run's. Returns each
    path's launches."""
    argv = SERVE_ARGV + ["--virtual-clock"]
    paths = {}
    save = ROOT / "build" / "chip_smoke_serve" / "kill"
    shutil.rmtree(save, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.serve", *argv, "--chaos",
         "serve_kill@0:3", "--requeue-attempt", "0", "--save-dir",
         str(save)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()] \
        if (save / "metrics.jsonl").is_file() else []
    chaos = [r for r in recs if r["kind"] == "chaos"]
    print(f"serve 15d kill: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.3f} s; chaos records "
          f"{[(r['fault'], r['at_dispatch']) for r in chaos]}, "
          f"kind=serve records "
          f"{sum(r['kind'] == 'serve' for r in recs)}")
    if proc.returncode != 137 or len(chaos) != 1 \
            or any(r["kind"] == "serve" for r in recs):
        fail(f"serve 15d kill: exit {proc.returncode}, records "
             f"{sorted({r['kind'] for r in recs})}: "
             f"{proc.stderr[-2000:]}")
    # (ii) the requeued attempt, in the dead attempt's directory
    tag = "serve 15d requeue"
    os.environ["TPUDIST_VERDICT_PATH"] = str(save / "job_status.txt")
    tee = _Tee(sys.stdout)
    try:
        from tpudist_torch.serve import cli as serve_cli
        _reset_launches(fa, fx)
        with _serve_engines() as made, _serve_summaries() as runs, \
                contextlib.redirect_stdout(tee):
            rc = serve_cli.main(argv + ["--requeue-attempt", "1",
                                        "--save-dir", str(save)])
        torch.cuda.synchronize()
    finally:
        del os.environ["TPUDIST_VERDICT_PATH"]
    engine = made[-1]
    engine.assert_two_programs()
    s = runs[-1]["summary"]
    counts = _serve_counts(engine)
    want_launch = engine.model_cfg.n_layers * (s["admitted"] + 1)
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()]
    adm0, term0 = _terminal(recs, 0)
    _, term1 = _terminal(recs, 1)
    lost = sorted(rid for rid, evs in term1.items() if "lost" in evs)
    resume = [r for r in recs if r["kind"] == "serve_resume"]
    buckets = {}
    for term in (term0, term1):
        for rid, evs in term.items():
            buckets.setdefault(rid, []).extend(evs)
    print(f"{tag}: exit {rc}; attempt 0 admitted {sorted(adm0)}, "
          f"terminal {sorted(term0)}; attempt 1 lost {lost}, resume "
          f"{[{k: r[k] for k in ('completed_prior', 'lost', 'replayed')} for r in resume]}, "
          f"summary lost {s['lost']} completed_prior "
          f"{s['completed_prior']}, completed {s['completed']}/"
          f"{s['requests']}; {len(buckets)} rids with "
          f"{sum(len(v) for v in buckets.values())} terminal events; "
          f"programs {engine.compile_counts()}; flash launches "
          f"{counts['flash_attention_fwd']} (want {want_launch}); {card}")
    if rc != 0 or len(resume) != 1 or not lost \
            or lost != sorted(adm0 - set(term0)) \
            or resume[0]["lost"] != len(lost) \
            or resume[0]["completed_prior"] != len(term0) \
            or s["lost"] != len(lost) \
            or sorted(buckets) != list(range(16)) \
            or any(len(v) != 1 for v in buckets.values()) \
            or counts["flash_attention_fwd"] != want_launch:
        fail(f"{tag}: the lost accounting or the buckets are not exact")
    paths["serve_requeue"] = counts
    engine.release()
    shutil.rmtree(save, ignore_errors=True)
    del engine, made
    torch.cuda.empty_cache()

    clean = _serve_cli(torch, fa, fx, "serve 15d clean", argv)
    paths["serve_chaos_clean"] = clean["counts"]
    slow = _serve_cli(torch, fa, fx, "serve 15d slow", argv + [
        "--chaos", "serve_slow@0:2,s=0.05,steps=3"])
    paths["serve_slow"] = slow["counts"]
    c, sl = clean["summary"], slow["summary"]
    print(f"serve 15d slow: itl p50 {sl['itl_p50_s']} s p99 "
          f"{sl['itl_p99_s']} s against the clean run's {c['itl_p50_s']} "
          f"s / {c['itl_p99_s']} s (virtual); completed {sl['completed']}"
          f"; {card}")
    if sl["completed"] != 16 or not sl["itl_p99_s"] > c["itl_p99_s"] \
            or _tokens_of(sl) != _tokens_of(c):
        fail("serve 15d slow: the stall does not show in the ITL p99, or "
             "the run did not complete with the clean tokens")
    garbage = _serve_cli(torch, fa, fx, "serve 15d garbage", argv + [
        "--chaos", "request_garbage@0:0,n=6"])
    paths["serve_garbage"] = garbage["counts"]
    g = garbage["summary"]
    reasons = [r["reason"] for r in garbage["recs"]
               if r["kind"] == "serve_request" and r["event"] == "rejected"]
    same = _tokens_of(g) == _tokens_of(c)
    print(f"serve 15d garbage: rejected {g['rejected']} of {g['arrived']} "
          f"arrivals, reasons {sorted(reasons)}; the well-formed tokens vs "
          f"the clean run's: equal {same}; {card}")
    if g["rejected"] != 6 or len(reasons) != 6 or not all(reasons) \
            or g["completed"] != 16 or not same:
        fail("serve 15d garbage: not six named rejections, or the "
             "well-formed requests' tokens changed")
    return paths


def serve_alerts(torch, fa, fx, base, card: str):
    """Phase 15e: phase 4b's overload (64 Poisson requests at twice phase
    4's rate, queue cap 8, TTFT deadline 4 x its p50) through the serve
    CLI with ``TPUDIST_SERVE_SHED_MAX`` tightened to 0.05: exit 1, a fail
    verdict, and for every failed gate (``rules.SERVE_STATUS_RULES``) an
    alert of its rule fired by the scheduler's engine mid-run. Returns
    the launches."""
    from tpudist_torch import rules

    rate = 2 * base["completed"] / base["wall_s"]
    deadline_ms = 4e3 * base["ttft_p50_s"]
    run = _serve_cli(torch, fa, fx, "serve 15e shed breach", SERVE_ARGV + [
        "--requests", "64", "--request-rate", f"{rate:.6f}",
        "--queue-cap", "8", "--ttft-deadline-ms", f"{deadline_ms:.6f}",
        "--seed", "1"], env={"TPUDIST_SERVE_SHED_MAX": "0.05"}, want_rc=1)
    s, alerts = run["summary"], run["alerts"]
    failed = [(field, rule) for field, rule in rules.SERVE_STATUS_RULES
              if s[field] == "fail"]
    fired = {a["alert"] for a in alerts.history}
    print(f"serve 15e: shed fraction {s['shed_fraction']} (max 0.05), "
          f"status {s['status']}; failed gates {failed}; alert_events "
          f"{s['alert_events']}, alerts "
          f"{[(a['alert'], a['state'], a['value']) for a in alerts.history]}"
          f"; {card}")
    if s["status"] != "fail" or ("serve_shed_status", "serve_shed") \
            not in failed or any(rule not in fired for _, rule in failed) \
            or s["alert_events"] < len(failed):
        fail("serve 15e: a failed gate without its mid-run alert")
    return {"serve_shed_breach": run["counts"]}


def serve_tune_chaos(torch, fa, fx, base, card: str, profile: bool):
    """Phase 15: the serve tuner (15a through the CLI, 15b the whole knob
    space), the two KV layouts (15c), the chaos surface with requeue
    replay (15d) and ``alert_events`` (15e), at phase 4's
    configuration. Returns each path's launches."""
    t0 = time.perf_counter()
    paths = serve_tuner_cli(torch, fa, fx, card)
    serve_tuner_space(torch, fa, fx, card)
    paths.update(serve_layouts(torch, fa, fx, card, profile))
    paths.update(serve_chaos(torch, fa, fx, card))
    paths.update(serve_alerts(torch, fa, fx, base, card))
    print(f"serve 15: phase wall {time.perf_counter() - t0:.3f} s; {card}")
    return paths


# phase 16: the serve drill at BASELINE config #5's width and depth, its
# prompts padded to 128 tokens (cache rows of 256): the flash kernel
# takes multiples of 128 only, so at the drill's own 8 every prefill
# would attend densely, as the JAX drill's does on a TPU. The drill's
# facts do not depend on the pad (the seeded schedule and the virtual
# clock make them). 16b is a main path of the flash forward
DRILL_MODEL = {"--vocab-size": 32000, "--n-layers": 4, "--d-model": 2048,
               "--n-heads": 16, "--n-kv-heads": 16, "--d-ff": 5504,
               "--max-seq": 256, "--prompt-pad": 128}
DRILL_PATH = "serve_drill_overload"


@contextlib.contextmanager
def _drill_env(env):
    """``os.environ`` with every ``TPUDIST_`` variable but ``env``'s
    taken out, as the drill gives its attempts, for the block."""
    saved = dict(os.environ)
    for k in [k for k in os.environ if k.startswith("TPUDIST_")]:
        del os.environ[k]
    os.environ.update(env)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _drill_serve(run_dir: Path, d: str):
    """The ``kind=serve`` and ``kind=serve_warmup`` records of one of
    the drill's attempt directories."""
    recs = [json.loads(ln) for ln in
            (run_dir / d / "metrics.jsonl").read_text().splitlines()]
    return ([r for r in recs if r["kind"] == "serve"],
            [r for r in recs if r["kind"] == "serve_warmup"])


def serve_drill(torch, fa, fx, card: str):
    """Phase 16: (a) the port's serve drill (``run_matrix`` then
    ``verify_matrix``) with ``TPUDIST_PLATFORM=cuda`` at config #5's
    model: every attempt a ``python -m tpudist_torch.serve`` process on
    the card, each scenario's verifier ``ok``, its facts and its
    attempts' wall printed, and every attempt's ``kind=serve_warmup``
    naming the card with a graph pool (only a captured run has one);
    (b) the overload scenario's flags in-process through the serve CLI
    on the virtual clock, as the drill's attempt runs them: the flash
    launches exact and the canonical summary equal to (a)'s
    ``overload0``, the evidence that the drill's path ran the kernel.
    Returns 16b's launches."""
    from tpudist_torch.obs import goodput
    from tpudist_torch.serve import drill

    name = torch.cuda.get_device_name(0)
    run_dir = ROOT / "build" / "chip_smoke_drill"
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with _drill_env({"TPUDIST_PLATFORM": "cuda",
                     "PYTHONPATH": str(ROOT)}):
        results = drill.run_matrix(str(run_dir), model=DRILL_MODEL)
    report = drill.verify_matrix(str(run_dir), results)
    matrix_s = time.perf_counter() - t0
    for sc, res in results["scenarios"].items():
        rep_sc = report["scenarios"][sc]
        attempts = goodput.load_jsonl(str(run_dir / res["dirs"][0] /
                                          goodput.ATTEMPTS_NAME))
        for d in res["dirs"][1:]:
            attempts += goodput.load_jsonl(str(run_dir / d /
                                               goodput.ATTEMPTS_NAME))
        wall = sum(a["end_ts"] - a["start_ts"] for a in attempts)
        print(f"serve 16a {sc}: ok {rep_sc['ok']}, rcs {res['rcs']}, "
              f"{len(attempts)} attempt(s) {wall:.3f} s; facts "
              f"{json.dumps(rep_sc['facts'], sort_keys=True)}; {card}")
        for problem in rep_sc["problems"]:
            print(f"serve 16a {sc}: problem: {problem}")
        for d in res["dirs"]:
            _, warm = _drill_serve(run_dir, d)
            want = len(res["rcs"]) if len(res["dirs"]) == 1 else 1
            print(f"serve 16a {d}: warm-up records "
                  f"{[(w['requeue_attempt'], w['device'], w['capture_s'], w['graph_pool_bytes']) for w in warm]}")
            if len(warm) != want or any(
                    w["device"] != name or not w["graph_pool_bytes"] > 0
                    for w in warm):
                fail(f"serve 16a {d}: not every attempt ran on the card "
                     f"({name})")
    print(f"serve 16a: matrix {'ok' if report['ok'] else 'NOT ok'} over "
          f"{len(results['scenarios'])} scenarios in {matrix_s:.3f} s; "
          f"{card}")
    if not report["ok"]:
        fail("serve 16a: a drill scenario failed its verifier")

    # (b) overload0's attempt, in this process
    argv = list(drill._with_model(drill.SCENARIOS["overload"]["flags"],
                                  DRILL_MODEL))
    env = drill.attempt_env({"TPUDIST_PLATFORM": "cuda"},
                            {"TPUDIST_RUN_ID": "serve-drill-overload"})
    with _drill_env({}):
        run = _serve_cli(torch, fa, fx, "serve 16b overload", argv, env=env)
    got = drill._canonical_summary(
        [r for r in run["recs"] if r["kind"] == "serve"][-1])
    want = drill._canonical_summary(_drill_serve(run_dir, "overload0")[0][-1])
    diff = sorted(k for k in set(got) | set(want)
                  if got.get(k) != want.get(k))
    print(f"serve 16b: canonical summary vs 16a's overload0: equal "
          f"{not diff}{f' (diverging keys {diff})' if diff else ''}; "
          f"shed fraction {got.get('shed_fraction')}, ttft p99 "
          f"{got.get('ttft_p99_s')} s (virtual); {card}")
    if diff:
        fail("serve 16b: the in-process overload's summary differs from "
             "the drill's attempt's")
    shutil.rmtree(run_dir, ignore_errors=True)
    print(f"serve 16: phase wall {time.perf_counter() - t0:.3f} s; {card}")
    return {DRILL_PATH: run["counts"]}


# phase 17: train-side elastic and chaos at BASELINE config #5's width
# and depth in phase 9's training configuration (bf16, bf16 nu, the
# fused head, seq 512), so every drill attempt launches the flash
# forward, the merged flash backward and both fused-head kernels. The
# flags follow the drill's BASE_FLAGS (a later flag wins): at the drill's
# --lr 1e-2 this transformer diverges (step losses 10.85 -> 25.92 over 8
# steps, PERF.md, PR 17), so it trains at phase 9's 1e-3
TRAIN_DRILL_MODEL = ("--model", "transformer", "--seq-len", "512",
                     "--dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
                     "--lm-head", "fused", "--lr", "1e-3")
TRAIN_DRILL_PATH = "train_drill_sharded"
# the drill's families run this many at a time on the card (each a few
# CLI processes, start-up bound; the script's time limit), so a family's
# walls are taken beside three others'
DRILL_LANES = 4
# each family's facts that the seeded schedule fixes, as the CPU drill
# reports them (tests/test_torch_chaos_drill*.py)
CHAOS_FACTS = {
    "hang": {"rcs": [137, 0], "fired": ["hang"], "policy": "stall",
             "final_step": 8, "resume": (3, 2, None), "lost": 2},
    "telemetry_garbage": {"rcs": [0], "fired": ["telemetry_garbage"],
                          "final_step": 8, "lost": 0},
    "kill": {"rcs": [113, 0], "fired": ["kill"], "policy": "preemption",
             "final_step": 8, "resume": (3, 2, None), "lost": 2},
    "slow": {"rcs": [0], "fired": ["slow"], "final_step": 8, "lost": 0},
    "corrupt_shard": {"rcs": [113, 0], "fired": ["corrupt_shard", "kill"],
                      "policy": "preemption", "final_step": 8,
                      "resume": (3, 4, 6), "lost": 4},
    "torn_manifest": {"rcs": [113, 0], "fired": ["torn_manifest"],
                      "policy": "preemption", "final_step": 8,
                      "resume": (3, 3, None), "lost": 3},
    "fs_error": {"rcs": [0], "fired": ["fs_error"], "final_step": 8,
                 "lost": 0, "ckpt": {"write_retries": 5, "write_errors": 1,
                                     "write_skips": 1}},
}


def _save_bytes(cfg) -> int:
    """The shard bytes of one sharded save of ``cfg``'s train state: the
    f32 params, mu at the compute dtype, nu at its storage dtype."""
    m = cfg.model
    hd = m.d_model // m.n_heads
    per_layer = (2 * m.d_model * m.d_model + 2 * m.d_model * m.n_kv_heads
                 * hd + 3 * m.d_model * m.d_ff + 2 * m.d_model)
    n = m.vocab_size * m.d_model + m.n_layers * per_layer + m.d_model
    return n * (4 + (2 if cfg.dtype == "bfloat16" else 4)
                + (2 if cfg.adam_nu_dtype == "bfloat16" else 4))


def _drop_shards(d: Path) -> None:
    """Delete a verified directory's ``worker*.npz`` (the verifier reads
    only the json)."""
    for p in d.glob("elastic/steps/*/worker*.npz"):
        p.unlink()


def _fact_diff(facts, want):
    """The keys where a family's verifier facts leave the CPU drill's."""
    got = {"rcs": facts.get("rcs"), "fired": facts.get("fired"),
           "policy": facts.get("policy"),
           "final_step": facts.get("final_step"),
           "lost": (facts.get("goodput") or {}).get("lost_steps")}
    if "resume" in want:
        r = facts.get("resume") or {}
        got["resume"] = (r.get("resumed_from_step"), r.get("steps_lost"),
                         r.get("fallback_from"))
    if "ckpt" in want:
        got["ckpt"] = facts.get("ckpt")
    return sorted(k for k in want if got.get(k) != want[k])


def train_chaos(torch, fa, fx, card: str):
    """Phase 17: (a) the port's chaos drill (``run_baseline``, then
    ``run_family`` for ``DRILL_LANES`` families at a time and
    ``verify_family`` for each as it ends) with
    ``TPUDIST_PLATFORM=cuda`` at config #5's width in phase 9's training
    configuration under the drill's ``BASE_FLAGS`` (8 steps, sharded
    saves at steps 3, 6 and 8): every attempt a ``python -m
    tpudist_torch.train`` process on the card; each of the seven
    families ``ok`` from the port's verifier, its pinned facts the CPU
    drill's (``hang`` with its mid-run ``stall`` alert in
    ``alerts.jsonl``, ``telemetry_garbage`` with ``bad_frames`` >= 1 and
    ``live_status.json`` ending ``ok``),
    its final committed crc signature the baseline's (the bitwise-resume
    pin: the verifier fails a family whose signature differs). The
    verifier reads only json (indexes, manifests, records), so each
    verified directory's ``worker*.npz`` is deleted as soon as it is
    verified: the disk holds the saves of ``DRILL_LANES`` families.
    (b) the baseline's flags in-process through the train CLI: the
    kernel launches exact and the final crc signature equal to (a)'s
    baseline, bytes that do not depend on the process. (c) what the
    asynchronous writer buys at this width: enqueue, drain, bytes and
    the writer's GB/s, sync against async, and the steps/s with saves
    every 2 steps against none mid-epoch. Returns (b)'s launches."""
    from tpudist_torch import config as config_lib
    from tpudist_torch.chaos import drill, verify
    from tpudist_torch.obs import goodput

    name = torch.cuda.get_device_name(0)
    cfg = config_lib.parse_args(list(drill.BASE_FLAGS)
                                + list(TRAIN_DRILL_MODEL))
    per_save = _save_bytes(cfg)
    run_dir = ROOT / "build" / "chip_smoke_chaos"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    disk = shutil.disk_usage(run_dir)
    # a family holds at most four saves (two attempts) until it is
    # verified; DRILL_LANES families run at once
    need = (1 + 4 * DRILL_LANES) * per_save + 2 * 2**30
    print(f"train 17: a save {per_save / 1e9:.3f} GB; disk "
          f"{disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} GB, "
          f"need {need / 1e9:.1f}")
    if disk.free < need:
        fail(f"train 17: {disk.free / 1e9:.1f} GB free under {run_dir}, "
             f"the drill needs {need / 1e9:.1f} GB ({1 + 4 * DRILL_LANES} "
             f"saves + 2 GB)")

    def on_card(d: Path):
        logs = sorted(d.glob("*.log"))
        for log in logs:
            if f"1 {name} device(s)" not in log.read_text():
                fail(f"train 17a: {log.relative_to(run_dir)} did not run "
                     f"on the card ({name})")
        return len(logs)

    def walls(d: Path):
        return [round(a["end_ts"] - a["start_ts"], 3) for a in
                goodput.load_jsonl(str(d / goodput.ATTEMPTS_NAME))]

    t0 = time.perf_counter()
    env = {"TPUDIST_PLATFORM": "cuda", "PYTHONPATH": str(ROOT)}
    with _drill_env(env):
        base = drill.run_baseline(str(run_dir), model=TRAIN_DRILL_MODEL)
    on_card(run_dir / drill.BASELINE_DIR)
    recs = goodput.load_jsonl(str(run_dir / drill.BASELINE_DIR /
                                  "metrics.jsonl"))
    losses = [r["loss"] for r in recs if r["kind"] == "step"]
    sig = verify.crc_signature(str(run_dir / drill.BASELINE_DIR))
    print(f"train 17a baseline: {base['wall_s']} s, step losses {losses}, "
          f"final step {sig and sig['step']}, "
          f"{len((sig or {}).get('leaves', {}))} leaves; {card}")
    if sig is None or sig["step"] != 8 or not (
            losses and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail("train 17a: the baseline left no step-8 commit, or its "
             "losses are not finite and falling")
    _drop_shards(run_dir / drill.BASELINE_DIR)
    results = {"schema": 1, "baseline": base, "families": {}}
    bad = []

    def run_family(family):
        t1 = time.perf_counter()
        res = drill.run_family(str(run_dir), family, model=TRAIN_DRILL_MODEL)
        return res, time.perf_counter() - t1

    def check(family, res, family_s):
        results["families"][family] = res
        rep = verify.verify_family(str(run_dir), res)
        n_logs = on_card(run_dir / family)
        diff = _fact_diff(rep["facts"], CHAOS_FACTS[family])
        facts = {k: v for k, v in rep["facts"].items()
                 if k != "resume"}
        resume = rep["facts"].get("resume") or {}
        picked = {k: resume.get(k) for k in (
            "source", "resumed_from_step", "steps_lost", "fallback_from")}
        print(f"train 17a {family}: ok {rep['ok']}, facts equal to the "
              f"CPU drill's {not diff}{f' (differ: {diff})' if diff else ''}"
              f"; {n_logs} attempt(s) on the card, walls "
              f"{walls(run_dir / family)} s, family "
              f"{family_s:.3f} s; facts "
              f"{json.dumps(facts, sort_keys=True)}; resume "
              f"{json.dumps(picked)}; {card}")
        if resume.get("corrupt_shard"):
            print(f"train 17a {family}: corrupt_shard "
                  f"{resume['corrupt_shard'][:160]}")
        if drill.FAMILIES[family].get("live"):
            # the live bus's own evidence: the mid-run stall alert, the
            # decoder's resynchronisation
            status = _read_json(run_dir / family / "live_status.json",
                                "17a")
            print(f"train 17a {family}: live_status "
                  f"{status.get('status')}, counters "
                  f"{status.get('counters')}, alert rules fired "
                  f"{rep['facts'].get('alert_rules')}; {card}")
            if family == "hang" and "stall" not in rep["facts"].get(
                    "alert_rules", []):
                bad.append(family)
            if family == "telemetry_garbage" and not (
                    (rep["facts"].get("bad_frames") or 0) >= 1
                    and status.get("status") == "ok"):
                bad.append(family)
        for problem in rep["problems"]:
            print(f"train 17a {family}: problem: {problem}")
        if not rep["ok"] or diff:
            bad.append(family)
        _drop_shards(run_dir / family)

    # the families' attempts are CLI processes in directories of their
    # own (ephemeral live-bus ports): DRILL_LANES run side by side, each
    # verified, and its saves dropped, as it ends
    with _drill_env(env), concurrent.futures.ThreadPoolExecutor(
            DRILL_LANES) as pool:
        running = {pool.submit(run_family, f): f for f in drill.FAMILIES}
        for fut in concurrent.futures.as_completed(running):
            check(running[fut], *fut.result())
    results["families"] = {f: results["families"][f]
                           for f in drill.FAMILIES}
    drill.write_results(str(run_dir), results)
    report = verify.verify_matrix(str(run_dir), results)
    matrix_s = time.perf_counter() - t0
    print(f"train 17a: matrix {'ok' if report['ok'] else 'NOT ok'} over "
          f"{len(results['families'])} families + the baseline in "
          f"{matrix_s:.3f} s; {card}")
    if bad or not report["ok"]:
        fail(f"train 17a: families {bad} failed the verifier or left the "
             f"CPU drill's facts")

    # (b) the baseline's flags in this process
    argv = list(drill.BASE_FLAGS) + list(TRAIN_DRILL_MODEL)
    torch.cuda.empty_cache()
    run = _cli_run(torch, fa, fx, "17b sharded", argv, keep=True)
    got = verify.crc_signature(str(run["dir"]))
    shutil.rmtree(run["dir"], ignore_errors=True)
    want = want_launches(fa, cfg.model, 512, 8, 1, True)
    losses = [r["loss"] for r in run["recs"] if r["kind"] == "step"]
    print(f"train 17b: crc signature equal to 17a's baseline {got == sig}; "
          f"step losses {losses}; kernel launches {run['counts']} (want "
          f"{want}); " + _step_line(run, cfg.batch_size * 512))
    if got != sig:
        fail("train 17b: the in-process run's committed bytes differ "
             "from the drill's baseline")
    if run["counts"] != want:
        fail(f"train 17b: kernel launches {run['counts']}, want {want}")

    # (c) what the asynchronous writer buys
    rows = {}
    for mode, extra in (("sync", ["--ckpt-every-steps", "2",
                                  "--ckpt-sync"]),
                        ("async", ["--ckpt-every-steps", "2"]),
                        ("none", ["--ckpt-every-steps", "0"])):
        torch.cuda.empty_cache()
        r = _cli_run(torch, fa, fx, f"17c {mode}",
                     [a for a in argv if a != "--ckpt-sync"] + extra
                     + ["--steps-per-dispatch", "1"])
        t = r["timing"]
        enq = [x["enqueue_ms"] for x in r["recs"] if x["kind"] == "ckpt"]
        (drain,) = [x for x in r["recs"] if x["kind"] == "ckpt_drain"]
        rows[mode] = {"sps": t["steps"] / t["run_s"], "wall": r["wall"],
                      "enqueue": enq, "drain": drain}
        gbps = (drain["bytes_written"] / drain["write_s"] / 1e9
                if drain["write_s"] else 0.0)
        print(f"train 17c {mode}: {drain['saves']} saves, enqueue ms "
              f"{enq} (sum {sum(enq):.1f}), drain ms {drain['drain_ms']}, "
              f"{drain['bytes_written'] / max(drain['saves'], 1) / 1e9:.4f} "
              f"GB a save, writer {drain['write_s']:.3f} s = {gbps:.3f} GB/s "
              f"(crc32 + npz + index); timed {t['steps']} steps "
              f"{rows[mode]['sps']:.4f} steps/s, run {t['run_s']:.3f} s, "
              f"CLI wall {r['wall']:.3f} s; {card}")
    s, a, n = rows["sync"], rows["async"], rows["none"]
    print(f"train 17c: steps/s with saves every 2 steps: sync "
          f"{s['sps']:.4f}, async {a['sps']:.4f}, none mid-epoch "
          f"{n['sps']:.4f}; the step path held by saves: sync "
          f"{sum(s['enqueue']) / 1e3:.3f} s, async "
          f"{sum(a['enqueue']) / 1e3:.3f} s + drain "
          f"{a['drain']['drain_ms'] / 1e3:.3f} s; {card}")
    shutil.rmtree(run_dir, ignore_errors=True)
    print(f"train 17: phase wall {time.perf_counter() - t0:.3f} s; {card}")
    return {TRAIN_DRILL_PATH: run["counts"]}


# phase 18: the MoE model at bench.py's MoE row (bench.py:165-168), the
# JAX package's own MoE configuration at full width: V 32000, L 4, d
# 2048, h 16, kv 16, d_ff 2752 an expert, 8 experts, top 2, capacity
# factor 1.25, routing groups of 256 tokens; only the batch (8) and the
# samples are cut. Its attention and LM head are the transformer's, so
# its paths launch rows 1, 2, 5 and 6; its routing, dispatch and expert
# GEMMs are plain PyTorch, as they are plain XLA in the JAX package
MOE_MODEL = ("--model", "moe", "--vocab-size", "32000", "--n-layers", "4",
             "--d-model", "2048", "--n-heads", "16", "--n-kv-heads", "16",
             "--d-ff", "2752", "--n-experts", "8", "--expert-top-k", "2",
             "--moe-group-size", "256")
MOE_TRAIN_PATHS = ("train_moe_per_step", "train_moe_superstep")
# phase 18a's flags (phases 9 and 17's: bf16, bf16 Adam nu, the fused
# head, lr 1e-3) at seq 512, batch 8, 32 samples (4 steps an epoch), 2
# epochs, a step record every 4
MOE_TRAIN_ARGV = [*MOE_MODEL, "--seq-len", "512", "--train-batch-size",
                  "8", "--n-samples", "32", "--epochs", "2", "--seed", "42",
                  "--log-every", "4", "--dtype", "bfloat16",
                  "--adam-nu-dtype", "bfloat16", "--lm-head", "fused",
                  "--lr", "1e-3"]
MOE_SERVE_PATHS = ("serve_moe", "paged_serve_moe", "serve_moe_cli")


def moe_model_config(seq: int):
    """Phase 18's model (``MOE_MODEL``) as a ``ModelConfig`` at ``seq``."""
    from tpudist_torch import config as config_lib

    return config_lib.parse_args([*MOE_MODEL, "--seq-len", str(seq)]).model


def moe_step_flops(m, b: int, s: int) -> int:
    """One MoE training step's model flops at batch ``b``, seq ``s``, the
    count's closed form (``tests/test_torch_moe.py``): the dense closed
    form without the FFN (:func:`step_flops`), plus each layer's router
    GEMM, the experts' three GEMMs over the capacity rows (groups x E x
    capacity), the dispatch product (forward and the activations' grad),
    the combine product (forward and both grads) and routing's own two
    products over the k picks."""
    from tpudist_torch.models import moe

    t = b * s
    g = moe.group_size(m, t)
    cap = moe.capacity(m, g)
    E, k, d = m.n_experts, m.expert_top_k, m.d_model
    rows = (t // g) * E * cap
    routed = (6 * t * d * E + 18 * rows * d * m.d_ff
              + 10 * t * E * cap * d + 6 * t * E * k * cap)
    return (step_flops(dataclasses.replace(m, d_ff=0), b, s)
            + m.n_layers * routed)


def moe_train(torch, fa, fx, card: str, details=None):
    """Phase 18a, the paths ``train_moe_per_step`` and
    ``train_moe_superstep``: ``python -m tpudist_torch.train --model
    moe`` (its ``main``) at ``MOE_MODEL``'s width, seq 512, bf16, bf16
    Adam nu, ``--lm-head fused``, ``--lr 1e-3`` (phases 9 and 17's),
    global batch 8, 32 samples (4 steps an epoch), 2 epochs, ``--log-every
    4``: per-step (``--steps-per-dispatch 1``) and as the superstep (auto
    -> k = 4: the first epoch's window the eager warm-up, the second a
    replay). Each run: the stdout contract, falling losses, verdict
    ``success``, exact launches (flash forward 4 x (steps + eval
    batches), merged backward 4 x steps, fused forward steps + evals,
    fused backward steps), ``kind=timing``'s flop count equal to its
    closed form and ``0 < mfu <= 1.05``; each epoch's Avg and eval loss
    bitwise equal between the two; the superstep's 2 programs and 1
    replay. Returns each path's launches; ``details`` takes the
    superstep run's step losses, its epochs and its timing record."""
    from tpudist_torch import config as config_lib

    seq, epochs, n_samples = 512, 2, 32
    argv = list(MOE_TRAIN_ARGV)
    cfg = config_lib.parse_args(argv)
    m = cfg.model
    steps = epochs * (n_samples // cfg.batch_size)
    want = want_launches(fa, m, seq, steps, epochs, fused=True)
    flops = moe_step_flops(m, cfg.batch_size, seq)
    hd = m.d_model // m.n_heads
    n_params = m.vocab_size * m.d_model + m.n_layers * (
        2 * m.d_model * m.n_heads * hd + 2 * m.d_model * m.n_kv_heads * hd
        + m.d_model * m.n_experts + 3 * m.n_experts * m.d_model * m.d_ff)
    print(f"moe 18a: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} E{m.n_experts} "
          f"top{m.expert_top_k} cf{m.capacity_factor} group "
          f"{m.moe_group_size}; {n_params / 1e6:.1f} M params; "
          f"{cfg.dtype}, adam nu {cfg.adam_nu_dtype}, --lm-head fused, "
          f"batch {cfg.batch_size}, seq {seq}, {n_samples} samples, "
          f"{epochs} epochs; closed-form flops a step {flops:.4e}; {card}")
    runs, paths = {}, {}
    for how, k in (("per_step", "1"), ("superstep", "0")):
        tag = f"train_moe_{how}"
        run = runs[how] = _cli_run(torch, fa, fx, tag, argv + [
            "--steps-per-dispatch", k])
        t = run["timing"]
        losses = [r["loss"] for r in run["recs"] if r["kind"] == "step"]
        check_contract(tag, run["out"], epochs, losses)
        print(f"moe 18a {how}: k={t['steps_per_dispatch']}, step losses "
              f"{losses}; " + _step_line(run, cfg.batch_size * seq))
        print(f"moe 18a {how}: mfu {t['mfu']} "
              f"({t['achieved_tflops_per_chip']} of {t['peak_tflops']} "
              f"TFLOP/s, {t['model_flops_per_step']} flops a step); "
              f"kernel launches {run['counts']} (want {want}); {card}")
        if run["counts"] != want:
            fail(f"moe 18a {how}: kernel launches {run['counts']}, want "
                 f"{want}")
        if t["model_flops_per_step"] != flops or not (
                t["mfu"] and 0 < t["mfu"] <= 1.05):
            fail(f"moe 18a {how}: {t['model_flops_per_step']} flops a "
                 f"step (closed form {flops}), mfu {t['mfu']}")
        paths[tag] = run["counts"]
    sup = runs["superstep"]
    graphs = sup["supersteps"][0] if sup["supersteps"] else None
    print(f"moe 18a superstep: {_graphs_line(sup) if graphs else 'none'}")
    if sup["timing"]["steps_per_dispatch"] != 4 or graphs is None or (
            graphs.programs, graphs.replays) != (2, {"superstep": 1,
                                                     "step": 0}):
        fail("moe 18a: the superstep did not run k = 4 as 2 programs and "
             "1 replay")
    a, b = _epochs_of(runs["per_step"]), _epochs_of(sup)
    print(f"moe 18a: epochs (Avg, eval) per-step {a}, superstep {b}")
    if a != b or len(a) != epochs:
        fail(f"moe 18a: the epochs' losses differ: per-step {a}, "
             f"superstep {b}")
    if details is not None:
        details.update(
            losses=[r["loss"] for r in sup["recs"] if r["kind"] == "step"],
            epochs=b, timing=sup["timing"], peak_gb=sup["peak_gb"])
    return paths


def moe_step_check(torch, fa, fx, fused: bool):
    """Phase 18b: one MoE training step at ``MOE_MODEL``'s width, seq
    512, batch 8, f32: the loss (xent + the weighted router aux) and
    every param grad, the router's and every expert's included, through
    the kernels and through the plain versions on the card, within f32
    1e-4 (max |d| / max |plain| per tensor), with the plain head or the
    fused one (its kernels against their plain versions). Also printed:
    whether the two runs routed every token alike (a router near-tie
    that f32 rounding tips sends a token elsewhere)."""
    from tpudist_torch import data as data_lib
    from tpudist_torch.models import moe, transformer

    seq = 512
    cfg = moe_model_config(seq)
    model = moe.init(cfg, generator=torch.Generator(
        device="cuda").manual_seed(42))
    tokens = torch.as_tensor(data_lib.make_synthetic_tokens(
        8, seq + 1, cfg.vocab_size, 42), device="cuda").long()
    routes, real_route = [], moe._route

    def route(*args):
        out = real_route(*args)
        routes.append(out[0].detach())
        return out

    def loss_and_grads(attn_impl, head):
        h, aux = moe.hidden_states(model, tokens[:, :-1], cfg,
                                   dtype=torch.float32, attn_impl=attn_impl)
        loss = head(model.embed, h, tokens[:, 1:]) \
            + cfg.router_aux_weight * aux
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), grads

    def kernel_head(emb, h, targets):
        return transformer.head_loss(emb, h, targets, fused_xent=fused)

    moe._route = route
    try:
        before = _launch_counts(fa, fx)
        loss_k, grads_k = loss_and_grads(transformer._attention,
                                         kernel_head)
        ran = {k: v - before[k] for k, v in _launch_counts(fa, fx).items()}
        loss_p, grads_p = loss_and_grads(
            plain_attention(torch, fa),
            plain_head(torch, fx) if fused else kernel_head)
    finally:
        moe._route = real_route
    torch.cuda.synchronize()
    n = len(routes) // 2
    moved = sum(int((a != b).any(dim=(-2, -1)).sum())
                for a, b in zip(routes[:n], routes[n:]))
    errs = {"loss": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())}
    for (name, _), gk, gp in zip(model.named_parameters(), grads_k,
                                 grads_p):
        errs[name] = ((gk - gp).abs().max()
                      / gp.abs().max().clamp_min(1e-30)).item()
    worst = max(errs, key=errs.get)
    tag = f"moe 18b{' fused head' if fused else ''}"
    print(f"{tag}: loss {loss_k.item():.6f} (kernels) vs "
          f"{loss_p.item():.6f} (plain); worst relative error "
          f"{errs[worst]:.3e} ({worst}) over the loss and "
          f"{len(errs) - 1} grads (tol 1e-4); router "
          f"{errs['layers.w_router']:.3e}, experts w_gate "
          f"{errs['layers.w_gate']:.3e} w_up {errs['layers.w_up']:.3e} "
          f"w_down {errs['layers.w_down']:.3e}; token-layer routings "
          f"that differ {moved} of {n * 8 * seq}; kernel launches {ran}")
    del model, grads_k, grads_p, routes
    torch.cuda.empty_cache()
    if errs[worst] > 1e-4 or not math.isfinite(errs[worst]):
        fail(f"{tag}: {worst} off by {errs[worst]:.3e}")
    if ran["flash_attention_bwd_dqkv"] != cfg.n_layers:
        fail(f"{tag}: the merged backward kernel ran "
             f"{ran['flash_attention_bwd_dqkv']} times, want "
             f"{cfg.n_layers}")
    if fused and (ran["fused_xent_fwd"], ran["fused_xent_bwd"]) != (1, 1):
        fail(f"{tag}: the fused head kernels did not run once")


def moe_serve(torch, fa, fx, card: str, tokens=None):
    """Phase 18c, the paths ``serve_moe`` and ``paged_serve_moe``: phase
    4's stream (16 requests at t=0, 32 new tokens each) through
    ``ServeEngine`` over the MoE at ``MOE_MODEL``'s width in f32 on CUDA
    graphs (slots 8, max_seq 1024, prompt_pad 512, decode_k 8, the ladder
    (8, 4, 2)): every request completed, the pin, the flash launches
    exact, the replayed tokens equal to the eager bodies', one replayed
    prefill's logits within f32 1e-3 of the plain forward's; then the
    same stream on ``PagedServeEngine`` (16-token pages): every request's
    tokens equal to the dense engine's, or a first divergence at a
    near-tie under phase 14's rule, printed and counted. Returns each
    path's launches; ``tokens`` (a dict) receives the dense engine's
    tokens under ``serve_moe`` and the paged engine's run (:func:`_ref`)
    under ``paged_serve_moe``."""
    from tpudist_torch.models import moe
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import init_params

    cfg = moe_model_config(1024)
    params = init_params(cfg, seed=0, device="cuda")
    requests = sched.make_requests(16, prompt_pad=512,
                                   vocab_size=cfg.vocab_size, max_new=32,
                                   rate=0.0, seed=0)
    paths = {}
    engine = _serve_engine(torch, cfg, False)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"moe 18c: params {n_params * 4 / 1e9:.3f} GB f32, kv cache "
          f"{engine.spec.bytes / 1e9:.3f} GB; prefill "
          f"groups of {moe.group_size(cfg, 512)} tokens, capacity "
          f"{moe.capacity(cfg, moe.group_size(cfg, 512))}; decode one "
          f"group of {engine.slots}, capacity "
          f"{moe.capacity(cfg, engine.slots)}; {card}")
    dense, paths["serve_moe"] = _paged_run(torch, fa, fx, "moe 18c dense",
                                           engine, params, requests)
    if tokens is not None:
        tokens["serve_moe"] = _tokens_of(dense)
    eager = sched.run_serve(_EagerBodies(engine), params, requests)
    same = _tokens_of(eager) == _tokens_of(dense)
    print(f"moe 18c dense: every request's tokens, graphs vs the eager "
          f"bodies: equal {same}")
    if not same:
        fail("moe 18c: the graph engine's tokens differ from its eager "
             "bodies'")

    def plain(q, k, v, *, cos=None, sin=None, causal=True):
        return fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                        causal=causal)[0]
    plain.accepts_rope = True
    req = requests[0]
    _, first = engine.prefill(params, engine.init_state(),
                              req.tokens[None, :], req.prompt_len, 0,
                              req.max_new)
    got = engine.last_logits[0].clone()
    with torch.no_grad():
        ref = _full_logits(torch, params, cfg, torch.as_tensor(
            req.tokens[None, :], dtype=torch.int64, device="cuda"),
            attn_impl=plain)[0, req.prompt_len - 1]
    err = (got - ref).abs().max().item()
    print(f"moe 18c dense: replayed prefill (rid {req.rid}, prompt_len "
          f"{req.prompt_len}): first token {int(first)}; logits vs the "
          f"plain forward max |d| {err:.3e} (atol 1e-3), argmax equal "
          f"{int(got.argmax()) == int(ref.argmax())}")
    if not bool(torch.isfinite(got).all()) or err > 1e-3:
        fail(f"moe 18c: prefill logits differ from the plain forward by "
             f"{err:.3e}")
    engine.release()
    del engine, eager
    torch.cuda.empty_cache()

    engine = _serve_engine(torch, cfg, True, page_tokens=16)
    paged, paths["paged_serve_moe"] = _paged_run(
        torch, fa, fx, "moe 18c paged", engine, params, requests)
    if tokens is not None:
        tokens["paged_serve_moe"] = _ref(paged)
    ties = _near_ties(torch, params, cfg, requests, _tokens_of(dense),
                      _tokens_of(paged), "moe 18c paged")
    print(f"moe 18c: tokens/s/chip dense {dense['tokens_per_sec_per_chip']}"
          f", paged {paged['tokens_per_sec_per_chip']}; itl p50 dense "
          f"{dense['itl_p50_s']} s, paged {paged['itl_p50_s']} s; ttft p50 "
          f"dense {dense['ttft_p50_s']} s; near-tie divergences {ties}; "
          f"{card}")
    engine.release()
    del engine, params
    torch.cuda.empty_cache()
    return paths


def moe_serve_cli(torch, fa, fx, card: str):
    """Phase 18d, the path ``serve_moe_cli``: ``python -m
    tpudist_torch.serve --model moe`` (its ``main``) at phase 4's serving
    flags and ``MOE_MODEL``'s width (the serve CLI takes the capacity
    factor and the routing group from ``ModelConfig``'s defaults, as the
    JAX serve CLI does): exit 0, the verdict and the SLO status
    ``success`` (every serve gate passed), the program pin, the flash
    launches exact. Returns its launches."""
    argv = list(SERVE_ARGV)
    argv[argv.index("--d-ff") + 1] = "2752"
    argv += ["--model", "moe", "--n-experts", "8", "--expert-top-k", "2"]
    run = _serve_cli(torch, fa, fx, "moe 18d serve CLI", argv)
    if run["summary"]["status"] != "success" or run["summary"].get(
            "model") != "moe":
        fail(f"moe 18d: SLO status {run['summary']['status']}, model "
             f"{run['summary'].get('model')}")
    print(f"moe 18d: model {run['summary']['model']}, SLO "
          f"{run['summary']['status']}; {card}")
    return {"serve_moe_cli": run["counts"]}


def moe_phase(torch, fa, fx, card: str, profile: bool, tokens=None,
              details=None):
    """Phase 18: the MoE trained (18a), one full-width step's grads
    kernels vs plain (18b, plain and fused head), served on the dense
    and the paged engine (18c) and through the serve CLI (18d). Returns
    each main path's launches (``tokens``: as :func:`moe_serve`;
    ``details``: as :func:`moe_train`)."""
    t0 = time.perf_counter()
    paths = moe_train(torch, fa, fx, card, details)
    torch.cuda.empty_cache()
    for fused in (False, True):
        moe_step_check(torch, fa, fx, fused)
    paths.update(moe_serve(torch, fa, fx, card, tokens))
    paths.update(moe_serve_cli(torch, fa, fx, card))
    if profile:
        profile_moe(torch, card)
    print(f"moe 18: phase wall {time.perf_counter() - t0:.3f} s; {card}")
    return paths


def profile_moe(torch, card: str):
    """--profile: two steady MoE training steps in phase 18a's
    configuration (bf16, bf16 nu, the fused head, per-step): wall,
    device kernel time and busy share, and the device time of the GEMMs
    by what they compute, read from the ``aten::bmm`` calls' input
    shapes: the experts' (a dimension of d_ff, batched over the
    experts), the other batched products (dispatch, combine and
    routing's), and the rest of the step."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib

    cfg = config_lib.parse_args(
        [*MOE_MODEL, "--seq-len", "512", "--train-batch-size", "8",
         "--lm-head", "fused", "--dtype", "bfloat16", "--adam-nu-dtype",
         "bfloat16"])
    m, dev = cfg.model, torch.device("cuda")
    state = engine_lib.init_state(cfg, dev)
    step = engine_lib.make_train_step(cfg, dev)
    batch = (torch.as_tensor(data_lib.make_synthetic_tokens(
        8, 513, m.vocab_size), device=dev).long(),)
    state, loss = step(state, batch)
    loss.item()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, loss = step(state, batch)
        loss.item()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(r[1] for r in kernels)
    experts = products = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key != "aten::bmm" or e.device_type.name != "CPU":
            continue
        dims = {d for shape in e.input_shapes for d in shape}
        if m.d_ff in dims:
            experts += e.device_time_total / 1e3
        else:
            products += e.device_time_total / 1e3
    print(f"profile: moe 2 train steps (bf16, bf16 nu, fused head): "
          f"{wall:.3f} ms wall, device kernel time {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% busy); expert GEMMs {experts:.3f} ms "
          f"({100 * experts / busy:.1f}% of the kernel time), the other "
          f"batched products (dispatch, combine, routing) {products:.3f} ms "
          f"({100 * products / busy:.1f}%); {card}")
    for key, ms, count in sorted(kernels, key=lambda r: -r[1])[:12]:
        print(f"profile:   {ms:9.3f} ms {100 * ms / busy:5.1f}% {count:5d}x"
              f"  {key[:80]}")
    del state, step
    torch.cuda.empty_cache()


# phase 19: the rest of observability on the card. Each kernel row's
# device-side names, as Kineto reports them (the merged flash backward is
# its dk/dv kernel plus the dq reduce; the fused head's backward is three
# kernels)
ROW_KERNELS = {"row 1": ("flash_fwd_kernel",),
               "row 2": ("flash_bwd_dkv_kernel", "flash_bwd_dq_reduce_kernel"),
               "row 5": ("xent_fwd_kernel",),
               "row 6": ("xent_dl_kernel", "xent_dh_kernel",
                         "xent_de_kernel")}
OBS_LIVE_PATHS = ("train_live_window", "train_profile_dir", "serve_live")


@contextlib.contextmanager
def _scraper(port: int, paths, period_s: float = 0.25):
    """A thread that GETs ``paths`` from ``127.0.0.1:port`` every
    ``period_s`` while the block runs: yields ``{path: [bodies of the
    answers]}`` (refused connections, before the exporter is up or after
    it closes, are skipped)."""
    import threading
    import urllib.request

    got = {p: [] for p in paths}
    stop = threading.Event()

    def loop():
        while not stop.wait(period_s):
            for p in paths:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{p}", timeout=2) as r:
                        got[p].append(r.read().decode())
                except OSError:
                    pass
    t = threading.Thread(target=loop, name="chip-smoke-scrape", daemon=True)
    t.start()
    try:
        yield got
    finally:
        stop.set()
        t.join(timeout=5)


def _top_ops(tracks, n: int):
    """The ``n`` device ops with the most time over all tracks: (name, ms,
    count)."""
    by = {}
    for ops in tracks.values():
        for t0, t1, name in ops:
            ms, c = by.get(name, (0.0, 0))
            by[name] = (ms + (t1 - t0) / 1e3, c + 1)
    return sorted(((k, ms, c) for k, (ms, c) in by.items()),
                  key=lambda r: -r[1])[:n]


def _names(op: str, kernel: str) -> bool:
    """Does the device op ``op`` (Kineto's name: the kernel's signature,
    ``void flash_fwd_kernel<...>(...)``) name ``kernel``?"""
    i = op.find(kernel)
    while i >= 0:
        end = i + len(kernel)
        if (i == 0 or not (op[i - 1].isalnum() or op[i - 1] == "_")) and (
                end == len(op) or not (op[end].isalnum() or op[end] == "_")):
            return True
        i = op.find(kernel, i + 1)
    return False


def _rows_seen(names):
    """Each kernel row of ROW_KERNELS with the kernels of it that the
    device ops ``names`` name."""
    return {row: [k for k in ks if any(_names(n, k) for n in names)]
            for row, ks in ROW_KERNELS.items()}


def live_window(torch, fa, fx, sup, argv, env, card: str):
    """Phase 19a, the path ``train_live_window``: phase 11a's superstep
    run (its ``argv`` and streaming ``env``) with ``--live on --live-port
    P --profile-window 2``, P a free port: exit 0 and verdict success;
    ``/healthz`` and ``/metrics`` scraped while it runs, one answer at
    least with the pod steps/s gauge; ``live_status.json`` ending ``ok``
    with 0 bad frames; the ``kind=devtime`` record (``comm_status``
    success on one card, window and compute > 0, 2 dispatches, one device
    track named for the card) and the capture's device ops naming rows 1,
    2, 5 and 6's kernels: the profiler sees the kernels inside replayed
    CUDA graphs; the ``devtime`` rows of ``pod_trace.json`` inside the
    ``profile_window`` span; each epoch's Avg and eval loss bitwise 11a's
    (``sup``, the same run without the bus and the window); the launches
    exact. ``TPUDIST_GOODPUT_MIN`` is set near 0, as the drills set it:
    a 20-step run is start-up dominated, and the live status grades the
    bus, not this run's goodput."""
    from tpudist_torch import config as config_lib
    from tpudist_torch.obs import devtime

    port = _free_port()
    argv = argv + ["--live", "on", "--live-port", str(port),
                   "--profile-window", "2"]
    env = {**env, "TPUDIST_GOODPUT_MIN": "0.00001"}
    cfg = config_lib.parse_args(argv)
    want = want_launches(fa, cfg.model, 512, 20, 2, True)
    t0 = time.perf_counter()
    with _scraper(port, ("/healthz", "/metrics")) as got:
        run = _cli_run(torch, fa, fx, "train_live_window", argv, env,
                       keep=True)
    d, problems = run["dir"], []
    scrapes = got["/metrics"]
    with_sps = [b for b in scrapes if "\ntpudist_steps_per_sec " in b]
    status = _read_json(d / "live_status.json", "19a")
    dev = [r for r in run["recs"] if r["kind"] == "devtime"]
    rec = dev[0] if len(dev) == 1 else {}
    analysis = devtime.analyze_capture(str(d / "profile" / "worker0"))
    tracks = analysis["tracks"]
    names = {op for ops in tracks.values() for _, _, op in ops}
    rows = _rows_seen(names)
    pod = _read_json(d / "pod_trace.json", "19a")
    span = [e for e in pod["traceEvents"]
            if e.get("name") == "profile_window" and e.get("ph") == "X"]
    evs = [e for e in pod["traceEvents"]
           if e.get("cat") == devtime.DEVTIME_CAT]
    lo = min((e["ts"] for e in evs), default=None)
    hi = max((e["ts"] + e["dur"] for e in evs), default=None)
    t = run["timing"]
    busy = rec.get("compute_s", 0) / rec["window_s"] if rec.get(
        "window_s") else None
    print(f"obs 19a: exit 0, verdict success; scrapes /healthz "
          f"{len(got['/healthz'])}, /metrics {len(scrapes)} "
          f"({len(with_sps)} with tpudist_steps_per_sec); live_status "
          f"{status.get('status')}, counters {status.get('counters')}, "
          f"hosts {sorted(status.get('hosts', {}))}, alerts "
          f"{[a['alert'] for a in status.get('alerts', {}).get('firing', [])]}"
          f"; {card}")
    print(f"obs 19a: devtime {json.dumps({k: v for k, v in rec.items() if k not in ('per_device', 'ts', 'mono')}, sort_keys=True)}")
    print(f"obs 19a: device tracks {sorted(tracks)}; "
          f"{sum(len(v) for v in tracks.values())} device ops, "
          f"{len(names)} names; window {rec.get('window_s')} s, device "
          f"busy share {busy}; rows by name {json.dumps(rows)}")
    for name, ms, c in _top_ops(tracks, 5):
        print(f"obs 19a: top device op {ms:.3f} ms x{c} {name[:110]}")
    if span and evs:
        s0, s1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
        print(f"obs 19a: pod_trace profile_window [{s0:.1f}, {s1:.1f}] "
              f"us, {len(evs)} devtime events in [{lo:.1f}, {hi:.1f}]: "
              f"margins {lo - s0:.1f} us after its start, {s1 - hi:.1f} "
              f"us before its end")
    print(f"obs 19a: the window's profiler stop "
          f"{rec.get('capture_stop_s')} s (in the loop), its trace export "
          f"{rec.get('capture_export_s')} s (at run end)")
    a, b = _epochs_of(sup), _epochs_of(run)
    print(f"obs 19a: epochs (Avg, eval) {b}, 11a's {a}; kernel launches "
          f"{run['counts']} (want {want}); k={t['steps_per_dispatch']}, "
          + _step_line(run, cfg.batch_size * 512) + f"; phase "
          f"{time.perf_counter() - t0:.3f} s; {card}")
    if not with_sps or not got["/healthz"]:
        problems.append("no scrape answered with the steps/s gauge")
    if status.get("status") != "ok" \
            or (status.get("counters") or {}).get("bad_frames") != 0 \
            or not (status.get("counters") or {}).get("records"):
        problems.append(f"live_status {status.get('status')}, counters "
                        f"{status.get('counters')}")
    if (rec.get("comm_status"), rec.get("dispatches"),
            len(rec.get("per_device") or [])) != ("success", 2, 1) \
            or not rec.get("window_s") or not rec.get("compute_s"):
        problems.append(f"the devtime record {len(dev)}: {rec}")
    if len(tracks) != 1 or torch.cuda.get_device_name(0) \
            not in next(iter(tracks), ""):
        problems.append(f"device tracks {sorted(tracks)}")
    missing = [r for r, ks in rows.items() if not ks]
    if missing:
        problems.append(f"no kernel of {missing} on the device track")
    if not span or not evs or lo < span[0]["ts"] \
            or hi > span[0]["ts"] + span[0]["dur"]:
        problems.append("devtime events outside the profile_window span")
    if a != b or len(a) != 2:
        problems.append(f"epochs {b} differ from 11a's {a}")
    if run["counts"] != want or t["steps_per_dispatch"] != 4:
        problems.append(f"launches {run['counts']}, k "
                        f"{t['steps_per_dispatch']}")
    shutil.rmtree(d, ignore_errors=True)
    if problems:
        fail("obs 19a: " + "; ".join(problems))
    return run["counts"]


def profile_dir_run(torch, fa, fx, sup, argv, card: str):
    """Phase 19b, the path ``train_profile_dir``: one epoch of phase 11a's
    configuration with ``--profile-dir``: per-step dispatch with the
    autotuner off, as in the JAX package, a Kineto trace in
    ``<dir>/worker0`` that ``analyze_capture`` reads, the launches exact;
    then ``python -m tpudist_torch.bench.profile`` at the same
    configuration, ``--steps 5``: exit 0, its ops naming rows 1 and 5's
    kernels, ``total_us_per_step`` printed beside the StepTimer's step
    (11a's superstep run, ``sup``)."""
    from tpudist_torch import config as config_lib
    from tpudist_torch.obs import devtime

    t0 = time.perf_counter()
    prof = ROOT / "build" / "chip_smoke_profile"
    shutil.rmtree(prof, ignore_errors=True)
    argv = list(argv)
    argv[argv.index("--epochs") + 1] = "1"
    argv += ["--autotune", "probe", "--profile-dir", str(prof / "full")]
    cfg = config_lib.parse_args(argv)
    want = want_launches(fa, cfg.model, 512, 10, 1, True)
    run = _cli_run(torch, fa, fx, "train_profile_dir", argv)
    t = run["timing"]
    analysis = devtime.analyze_capture(str(prof / "full" / "worker0"))
    names = {op for ops in analysis["tracks"].values() for _, _, op in ops}
    print(f"obs 19b: --profile-dir: k={t['steps_per_dispatch']}, tuning "
          f"{t['tuning_status']}; capture {analysis['capture_files']}, "
          f"tracks {sorted(analysis['tracks'])}, window "
          f"{analysis['pod']['window_s']:.3f} s, compute "
          f"{analysis['pod']['compute_s']:.3f} s; rows by name "
          f"{json.dumps(_rows_seen(names))}; kernel launches "
          f"{run['counts']} (want {want}); "
          + _step_line(run, cfg.batch_size * 512))
    problems = []
    if (t["steps_per_dispatch"], t["tuning_status"]) != (1, "ungateable"):
        problems.append(f"k={t['steps_per_dispatch']}, tuning "
                        f"{t['tuning_status']}")
    if len(analysis["tracks"]) != 1 or not analysis["pod"]["compute_s"]:
        problems.append(f"tracks {sorted(analysis['tracks'])}")
    if run["counts"] != want:
        problems.append(f"launches {run['counts']}, want {want}")
    out = prof / "bench.json"
    cmd = [sys.executable, "-m", "tpudist_torch.bench.profile", "--steps",
           "5", "--top", "60", "--trace-dir", str(prof / "bench"),
           "--out", str(out), "--model", "transformer", "--seq-len", "512",
           "--train-batch-size", "8", "--dtype", "bfloat16",
           "--adam-nu-dtype", "bfloat16", "--lm-head", "fused"]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t1
    summ = json.loads(out.read_text()) if proc.returncode == 0 else {}
    tops = [o["name"] for o in summ.get("top_ops", [])]
    rank = {row: [i for i, n in enumerate(tops)
                  if any(_names(n, k) for k in ks)]
            for row, ks in ROW_KERNELS.items() if row in ("row 1", "row 5")}
    p = sup["timing"]
    print(f"obs 19b: bench.profile exit {proc.returncode} in {wall:.3f} s; "
          f"total_us_per_step {summ.get('total_us_per_step')} (device "
          f"kernels, copies, memsets) beside the StepTimer's step "
          f"{1e3 * p['run_s'] / p['steps']:.3f} ms (11a superstep) and "
          f"{1e3 * t['run_s'] / t['steps']:.3f} ms (19b, under the "
          f"full-run profiler); by category {summ.get('by_category_us')}; "
          f"ranks of rows 1 and 5 in its top ops {rank}; {card}")
    for o in summ.get("top_ops", [])[:5]:
        print(f"obs 19b: bench.profile top op {o['us_per_step']} us/step "
              f"{o['category']} {o['name'][:110]}")
    if proc.returncode != 0:
        problems.append(f"bench.profile exit {proc.returncode}: "
                        f"{(proc.stdout + proc.stderr)[-2000:]}")
    elif not all(rank.values()):
        problems.append(f"bench.profile's ops lack {rank}")
    shutil.rmtree(prof, ignore_errors=True)
    print(f"obs 19b: phase {time.perf_counter() - t0:.3f} s; {card}")
    if problems:
        fail("obs 19b: " + "; ".join(problems))
    return run["counts"]


def serve_live(torch, fa, fx, card: str):
    """Phase 19c, the path ``serve_live``: ``python -m tpudist_torch.serve
    --live-port P`` at phase 4's configuration (``SERVE_ARGV``) with 128
    new tokens a request: a scrape of ``/metrics`` while it serves with
    the serve gauges, exit 0, the pin and the launches (``_serve_cli``),
    the tokens equal to a run without the port."""
    t0 = time.perf_counter()
    port = _free_port()
    # phase 4's stream with 128 new tokens a request: the loop ticks its
    # SLO record every 8 decode dispatches, so the run is long enough for
    # scrapes between ticks
    argv = list(SERVE_ARGV)
    argv[argv.index("--max-new-tokens") + 1] = "128"
    with _scraper(port, ("/metrics",), period_s=0.05) as got:
        live = _serve_cli(torch, fa, fx, "serve_live",
                          argv + ["--live-port", str(port)])
    plain = _serve_cli(torch, fa, fx, "serve_live_off", argv)
    gauges = sorted({ln.split()[0].split("{")[0] for b in got["/metrics"]
                     for ln in b.splitlines()
                     if ln.startswith("tpudist_serve_")})
    same = _tokens_of(live["summary"]) == _tokens_of(plain["summary"])
    print(f"obs 19c: {len(got['/metrics'])} scrapes of /metrics while "
          f"serving, serve gauges {gauges}; exporter line "
          f"{'serve live exporter on' in live['out']}; tokens equal to "
          f"the run without the port {same}; tokens/s/chip "
          f"{live['summary']['tokens_per_sec_per_chip']} vs "
          f"{plain['summary']['tokens_per_sec_per_chip']}; phase "
          f"{time.perf_counter() - t0:.3f} s; {card}")
    if not gauges or not same:
        fail("obs 19c: no scrape with the serve gauges, or the tokens "
             "differ")
    return live["counts"]


def obs_live(torch, fa, fx, sup, argv, env, card: str):
    """Phase 19: (a) the live bus and the device-time window over phase
    11a's superstep, (b) ``--profile-dir`` and ``python -m
    tpudist_torch.bench.profile``, (c) the serve CLI's exporter. Returns
    each path's launches."""
    t0 = time.perf_counter()
    paths = {"train_live_window": live_window(torch, fa, fx, sup, argv,
                                              env, card)}
    torch.cuda.empty_cache()
    paths["train_profile_dir"] = profile_dir_run(torch, fa, fx, sup, argv,
                                                 card)
    torch.cuda.empty_cache()
    paths["serve_live"] = serve_live(torch, fa, fx, card)
    print(f"obs 19: phase wall {time.perf_counter() - t0:.3f} s; {card}")
    return paths


def remat_check(torch, card: str):
    """Phase 12b: one full-width training step (BASELINE config #5, seq
    512, f32, the fused head) with ``--remat`` (each layer checkpointed,
    recomputed in the backward) and without, each captured as a CUDA
    graph after an eager warm-up and replayed: the loss and every param
    grad within f32 1e-4 (max |d| / max |no remat| per tensor)."""
    from tpudist_torch import data as data_lib
    from tpudist_torch.config import flagship_model_config
    from tpudist_torch.models import transformer

    cfg = flagship_model_config(512)
    model = transformer.init(
        cfg, generator=torch.Generator(device="cuda").manual_seed(42))
    tokens = torch.as_tensor(data_lib.make_synthetic_tokens(
        8, 513, cfg.vocab_size, 42), device="cuda").long()
    params = list(model.parameters())

    def step(remat):
        loss = transformer.loss_fn(model, tokens, cfg, dtype=torch.float32,
                                   remat=remat, fused_xent=True)
        return (loss.detach(), *torch.autograd.grad(loss, params))

    outs, pools = {}, {}
    main = torch.cuda.current_stream()
    for remat in (False, True):
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            step(remat)
        main.wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = step(remat)
        graph.replay()
        torch.cuda.synchronize()
        pools[remat] = torch.cuda.memory_reserved() - reserved
        outs[remat] = [x.clone() for x in out]
        del graph, out
        torch.cuda.empty_cache()
    ref, got = outs[False], outs[True]
    errs = [((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
            for g, r in zip(got, ref)]
    worst = max(errs)
    print(f"remat check: seq 512 f32 fused head, replayed graphs: loss "
          f"{got[0].item():.6f} (remat) vs {ref[0].item():.6f}; worst "
          f"relative difference {worst:.3e} over the loss and "
          f"{len(errs) - 1} grads (tol 1e-4); graph pools "
          f"{pools[True] / MB:.1f} MB with remat, {pools[False] / MB:.1f} "
          f"MB without; {card}")
    del model, outs, ref, got
    torch.cuda.empty_cache()
    if not worst <= 1e-4:
        fail(f"remat check: remat moved the step by {worst:.3e}")


_NEXT_PORT = [None]


def _free_port() -> int:
    """A port for a spawned job's coordinator: below the kernel's
    ephemeral range (where neither a bind to port 0 nor an outgoing
    connection, NCCL's many among them, ever lands), each handed out
    once a run and checked free by a bind. A port bound at 0 and
    released could be taken by a connection before the rank binds it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    base = low - 2000
    if base < 1024:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]
    if _NEXT_PORT[0] is None:
        _NEXT_PORT[0] = os.getpid() % 1000
    for _ in range(1000):
        port = base + _NEXT_PORT[0] % 1000
        _NEXT_PORT[0] += 1
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    fail(f"no free port in [{base}, {base + 1000})")


def _spawn(target, args_by_rank, timeout_s: float, what: str):
    """Run ``target(*args, queue)`` in one fresh process per entry of
    ``args_by_rank`` (``spawn``: the card's state is not forked); each puts
    one dict with its ``rank`` on the queue. Returns them by rank; fails
    when a process exits non-zero, puts nothing or outlives
    ``timeout_s`` (30 s past a rank's non-zero ``rc``). Every process is
    gone when it returns."""
    import multiprocessing as mp
    import queue as queue_lib

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args, q))
             for args in args_by_rank]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:
                r = q.get(timeout=5)
            except queue_lib.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            results[r["rank"]] = r
            if r.get("rc"):
                # a rank that failed leaves its peers waiting on it: they
                # get a short grace to fail alike, then are killed
                deadline = min(deadline, time.monotonic() + 30)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if len(results) < len(procs) or any(codes):
        fail(f"{what}: process exit codes {codes}, results from ranks "
             f"{sorted(results)} (their rc "
             f"{[results[r].get('rc') for r in sorted(results)]})")
    return [results[r] for r in range(len(procs))]


def _dp_train_rank(rank, world, port, argv, verdict, queue):
    """Phase 10a, one rank in a process of its own: the train CLI's
    ``main`` under the env contract, its launch counts set to 0 just
    before and read just after."""
    os.environ.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                      TPUDIST_NUM_PROCESSES=str(world),
                      TPUDIST_PROCESS_ID=str(rank),
                      TPUDIST_VERDICT_PATH=verdict)
    import torch

    from tpudist_torch import train as train_lib
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx

    from tpudist_torch import engine as engine_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the run's train state, for this rank's params and moments bytes
    states, real_init = [], engine_lib.init_state

    def init_state(*args, **kw):
        states.append(real_init(*args, **kw))
        return states[-1]
    engine_lib.init_state = init_state
    tee = _Tee(sys.stdout)
    _reset_launches(fa, fx)
    t0 = time.perf_counter()
    with _supersteps() as made, contextlib.redirect_stdout(tee):
        rc = train_lib.main(argv)
    torch.cuda.synchronize()
    state = states[0] if states else None
    params_b = None if state is None else sum(
        p.numel() * p.element_size() for p in state.params.parameters())
    queue.put({"rank": rank, "rc": rc,
               "counts": _path_launches(fa, fx, made),
               "graphs": [(sup.programs, sup.replays) for sup in made],
               "out": tee.buf.getvalue(),
               "wall": time.perf_counter() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "params_bytes": params_b,
               "opt_bytes": None if state is None
               else engine_lib.state_bytes_per_device(state) - params_b})


def dp_train_slice(torch, fa, card: str, tag: str = "train_seq512_dp",
                   n_samples: int = 32, dispatch=("--log-every", "1"),
                   want_graphs=None, extra=("--lm-head", "fused"),
                   details=None):
    """Phase 10a, the path ``train_seq512_dp``: ``python -m
    tpudist_torch.train`` as one process per visible card under the
    ``TPUDIST_COORDINATOR`` / ``TPUDIST_NUM_PROCESSES`` /
    ``TPUDIST_PROCESS_ID`` contract (NCCL, one card a rank), BASELINE
    config #5 at seq 512, f32, ``--lm-head fused``, global batch 8, 32
    samples, 1 epoch. Rank 0 alone prints the contract, every rank's
    verdict and the final one say success, and every rank launches each
    kernel exactly as its share of the path calls it. Returns the
    launches summed over the ranks. Phase 11c runs it as the path ``tag``
    with other ``n_samples`` and ``dispatch`` flags (the superstep, its
    NCCL all-reduce captured), where each rank's ``(programs,
    replays)`` must be ``want_graphs``; phase 20b with ``extra`` flags
    in place of ``--lm-head fused`` (the head must still be fused), and
    a ``details`` dict that gets the step losses, the timing record and
    each rank's record."""
    from tpudist_torch import config as config_lib

    seq, epochs = 512, 1
    world = torch.cuda.device_count()
    save = ROOT / "build" / "chip_smoke_train" / tag
    shutil.rmtree(save, ignore_errors=True)
    argv = ["--model", "transformer", "--seq-len", str(seq),
            "--train-batch-size", "8", "--n-samples", str(n_samples),
            "--epochs", str(epochs), "--seed", "42", *dispatch,
            *extra, "--save-dir", str(save)]
    cfg = config_lib.parse_args(argv)
    m = cfg.model
    print(f"train {tag}: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} kv{m.n_kv_heads} d_ff{m.d_ff} {cfg.dtype}, global "
          f"batch {cfg.batch_size} over {world} process(es) (local "
          f"{cfg.batch_size // world}), {n_samples} samples, {epochs} "
          f"epoch(s), {' '.join(extra)}; {card}")
    verdict = save / "job_status.txt"
    port = _free_port()
    ranks = _spawn(_dp_train_rank,
                   [(r, world, port, argv, str(verdict))
                    for r in range(world)], 300, f"train {tag}")
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()]
    timing = [r for r in recs if r["kind"] == "timing"]
    losses = [r["loss"] for r in recs if r["kind"] == "step"]
    statuses = [verdict.read_text() if verdict.is_file() else None] + [
        (save / f"job_status.txt.worker{r}").read_text()
        if (save / f"job_status.txt.worker{r}").is_file() else None
        for r in range(world)]
    shutil.rmtree(save, ignore_errors=True)
    if [r["rc"] for r in ranks] != [0] * world or not timing \
            or statuses != ["success"] * (world + 1):
        fail(f"train {tag}: exit codes {[r['rc'] for r in ranks]}, final "
             f"and worker verdicts {statuses}")
    out = ranks[0]["out"]
    check_contract(tag, out, epochs, losses)
    if f"{world} process(es) (nccl)" not in out:
        fail(f"train {tag}: rank 0 did not report {world} NCCL process(es)")
    for r in ranks[1:]:
        if "Epoch" in r["out"] or "Training completed." in r["out"]:
            fail(f"train {tag}: rank {r['rank']} printed the contract")
    want = want_launches(fa, m, seq, epochs * (n_samples // cfg.batch_size),
                         epochs, fused=True)
    t = timing[-1]
    sps = t["steps"] / t["run_s"]
    print(f"train {tag}: step losses {losses}; "
          f"verdicts {statuses}; {sps:.4f} steps/s, "
          f"{sps * cfg.batch_size * m.max_seq_len:.1f} tokens/s over "
          f"{world} card(s), step {1e3 * t['run_s'] / t['steps']:.2f} ms "
          f"(over {t['steps']} steps after the first); first step + "
          f"loads {t['compile_warmup_s']:.2f} s; rank walls "
          f"{[round(r['wall'], 2) for r in ranks]} s; peak device memory "
          f"by rank {[round(r['peak_gb'], 3) for r in ranks]} GB")
    total = dict.fromkeys(want, 0)
    for r in ranks:
        print(f"train {tag}: rank {r['rank']} kernel launches "
              f"{r['counts']} (want {want})")
        if r["counts"] != want:
            fail(f"train {tag}: rank {r['rank']} kernel launches "
                 f"{r['counts']}, want {want}")
        if want_graphs is not None:
            print(f"train {tag}: rank {r['rank']} (programs, replays) "
                  f"{r['graphs']}")
            if r["graphs"] != [want_graphs]:
                fail(f"train {tag}: rank {r['rank']} (programs, replays) "
                     f"{r['graphs']}, want {[want_graphs]}")
        for k, v in r["counts"].items():
            total[k] += v
    if details is not None:
        details.update(losses=losses, timing=t, ranks=ranks)
    return total


def _dp_batches(torch, cfg, rank: int, world: int, device):
    """Two steps' batches of this rank: its shard of global batches of 8
    (``plan_epoch``), on ``device``."""
    from tpudist_torch import data as data_lib
    tokens = data_lib.make_synthetic_tokens(
        16, cfg.model.max_seq_len + 1, cfg.model.vocab_size, cfg.seed)
    plan = data_lib.plan_epoch((tokens,), batch_size=cfg.batch_size,
                               seed=cfg.seed, epoch=0, process_index=rank,
                               process_count=world)
    slab, = plan.slab(0, 2)
    return [(torch.as_tensor(b, device=device).long(),) for b in slab]


# Phase 10b holds a param to the one process's only where its first |g|
# is at least this share of its tensor's largest. Adam's first steps are
# near lr sign(g), so a gradient that the reduce rounds by dg (~4e-6 of
# the largest) moves its param by ~lr dg / |g|: a good part of lr where
# |g| is small. Measured at full width (PERF.md, PR 9), the params' worst
# distance falls with the floor: 1.5e-3 of the largest element at |g| >=
# 1e-6, 2.3e-4 at 1e-5, 3.2e-5 at 1 % of the largest |g|.
G_FLOOR = 1e-2


def _dp_reduce_rank(rank, ports, queue):
    """Phase 10b, one of two ranks on card 0: NCCL's refusal; on rank 0,
    two steps of one process at the global batch of 8 before any group
    is up; then two steps of the engine's data-parallel step over gloo,
    timed alone. Rank 0 then holds the reduced gradients each step
    handed to Adam against the global batch's gradients at the same
    params, and its losses and params against the one process's (the
    params where the first reduced gradient's |g| is at least ``G_FLOOR``
    of its tensor's largest); the replicas are compared bitwise."""
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import torch
    import torch.distributed as dist

    from tpudist_torch import config as config_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refusal = None
    try:
        distributed.initialize(f"localhost:{ports[0]}", 2, rank,
                               device="cuda")
        distributed.shutdown()
    except ValueError as e:
        refusal = str(e)
    # phase 10a's model, f32, fused head
    cfg = config_lib.parse_args(
        ["--model", "transformer", "--seq-len", "512", "--train-batch-size",
         "8", "--lm-head", "fused", "--seed", "42"])
    dev = torch.device("cuda", 0)
    # rank 0 keeps, of each data-parallel step, the reduced gradients
    # the step hands to Adam and the params they were taken at
    taken, live = [], {}
    real_apply = engine_lib.Adam.apply

    def apply(self, grads, state, params, *scalars):
        if live.get("keep"):
            taken.append(([g.detach().clone() for g in grads],
                          [p.detach().clone() for p in params]))
        return real_apply(self, grads, state, params, *scalars)
    engine_lib.Adam.apply = apply

    def two_steps(index, count):
        state = engine_lib.init_state(cfg, dev)
        step = engine_lib.make_train_step(cfg, dev)
        losses, step_ms = [], []
        for batch in _dp_batches(torch, cfg, index, count, dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, step_ms

    if rank == 0:
        one = two_steps(0, 1)
        live["keep"] = True
    distributed.initialize(f"localhost:{ports[1]}", 2, rank, device="cuda",
                           backend="gloo")
    state, losses, step_ms = two_steps(rank, 2)
    same = True
    for p in state.params.parameters():
        theirs = p.detach().clone() if rank == 1 else torch.empty_like(p)
        dist.broadcast(theirs, src=1)
        same = same and torch.equal(theirs, p.detach())
    distributed.shutdown()
    out = {"rank": rank, "refusal": refusal, "losses": losses,
           "step_ms": step_ms, "same": same}
    if rank == 0:
        one_state, out["one_losses"], out["one_step_ms"] = one
        names = [n for n, _ in state.params.named_parameters()]
        out["params"] = {}
        for name, p, w, g1 in zip(names, state.params.parameters(),
                                  one_state.params.parameters(),
                                  taken[0][0]):
            d = (p - w).detach().abs()
            worst = int(d.argmax())
            w_max = w.abs().max().item()

            def within(held):
                """(max |d| / max |w| where held, elements not held)"""
                return ((d[held].max().item() / w_max if held.any()
                         else 0.0), int((~held).sum()))
            out["params"][name] = {
                "err": d.max().item() / w_max,
                "held": within(g1.abs() >= G_FLOOR * g1.abs().max()),
                # the same at absolute floors, for the reader
                "abs_floors": {f: within(g1.abs() >= f)
                               for f in (1e-6, 1e-5)},
                "beyond": int((d > 1e-4 * w_max).sum()),
                "numel": d.numel(), "lr_units": d.max().item() / cfg.lr,
                "g1_at_worst": g1.flatten()[worst].abs().item()}
        # the global batch's gradients at each step's params, in the
        # one process's (now spare) model
        loss_fn = engine_lib.make_loss_fn(cfg, dev)
        scratch = one_state.params
        out["grad_errs"] = []
        for (grads, before), batch in zip(
                taken, _dp_batches(torch, cfg, 0, 1, dev)):
            with torch.no_grad():
                for p, b in zip(scratch.parameters(), before):
                    p.copy_(b)
            _, want = engine_lib._microbatch(loss_fn, scratch, batch, 1)
            out["grad_errs"].append({
                name: ((g - w).abs().max()
                       / w.abs().max().clamp_min(1e-30)).item()
                for name, g, w in zip(names, grads, want)})
    queue.put(out)


def dp_reduce_check(torch, card: str):
    """Phase 10b: the gradient reduce across two ranks on the one card.
    NCCL cannot put two ranks on one card, and ``initialize`` must say so;
    with gloo (host copies) passed explicitly, two steps of the engine's
    data-parallel step at local batch 4: at each, the reduced gradients
    handed to Adam against the global batch of 8's at the same params
    within f32 1e-4 of each gradient's largest element (phase 7's
    yardstick); against one process stepping the global batch on the
    card, the losses within f32 1e-4, and the params after the 2 steps
    within f32 1e-4 of each param's largest element where the first
    gradient's |g| is at least ``G_FLOOR`` of its tensor's largest (the
    elements left out are counted: there Adam's near-sign step turns the
    reduce's rounding of g into a good part of lr); the two ranks' losses
    equal and their params bitwise equal."""
    ports = (_free_port(), _free_port())
    a, b = _spawn(_dp_reduce_rank, [(r, ports) for r in range(2)], 300,
                  "dp reduce")
    for r in (a, b):
        if not (r["refusal"] and "would share one card" in r["refusal"]):
            fail(f"dp reduce: rank {r['rank']}: two NCCL ranks on one "
                 f"card were not refused ({r['refusal']!r})")
    print(f"dp reduce: NCCL refused two ranks on one card: {a['refusal']}")
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       a["one_losses"]))
    grad_worst = [max(e, key=e.get) for e in a["grad_errs"]]
    grad_err = max(e[w] for e, w in zip(a["grad_errs"], grad_worst))
    print(f"dp reduce: 2 gloo ranks on one card, local batch 4, 2 steps: "
          f"reduced gradients vs the global batch's at the same params, "
          f"worst of each step "
          + ", ".join(f"{w} {e[w]:.3e}" for e, w in
                      zip(a["grad_errs"], grad_worst))
          + f" of its largest element over {len(a['grad_errs'][0])} "
          f"params (tol 1e-4); losses {a['losses']} (rank 1 "
          f"{b['losses']}) vs one process {a['one_losses']}, relative "
          f"error {loss_err:.3e} (tol 1e-4); ranks' params bitwise "
          f"equal: {a['same'] and b['same']}")
    for name, p in a["params"].items():
        print(f"dp reduce: param {name} after 2 steps vs one process, max "
              f"|d| / its largest element: {p['held'][0]:.3e} where the "
              f"first |g| >= {G_FLOOR:g} of its largest (tol 1e-4; "
              f"{p['held'][1]} of {p['numel']} elements left out); "
              + "; ".join(f"{e:.3e} where |g| >= {f:g} ({n} left out)"
                          for f, (e, n) in p["abs_floors"].items())
              + f"; {p['err']:.3e} over all elements ({p['lr_units']:.3f} "
              f"lr, {p['beyond']} beyond 1e-4), the worst one's first |g| "
              f"{p['g1_at_worst']:.3e}")
    print(f"dp reduce: step times (gloo through host memory, two ranks "
          f"on one card: not a fabric number) rank 0 "
          f"{[round(x, 3) for x in a['step_ms']]} ms, rank 1 "
          f"{[round(x, 3) for x in b['step_ms']]} ms; one process at "
          f"batch 8 {[round(x, 3) for x in a['one_step_ms']]} ms; {card}")
    if len(a["grad_errs"]) != 2 or a["losses"] != b["losses"] \
            or not (a["same"] and b["same"]):
        fail("dp reduce: the two ranks disagree")
    param_worst = max(a["params"], key=lambda n: a["params"][n]["held"][0])
    param_err = a["params"][param_worst]["held"][0]
    if not (loss_err <= 1e-4 and grad_err <= 1e-4 and param_err <= 1e-4):
        fail(f"dp reduce: off by {loss_err:.3e} (loss against one "
             f"process), {grad_err:.3e} (gradients at the same params), "
             f"{param_err:.3e} ({param_worst} after 2 steps, where the "
             f"first |g| >= {G_FLOOR:g} of its largest)")


# ------------------------------------------------------- phase 20: FSDP

# phase 9's configuration: config #5, s512, bf16, bf16 nu, fused head
FSDP_ARGV = ["--model", "transformer", "--seq-len", "512",
             "--train-batch-size", "8", "--dtype", "bfloat16",
             "--adam-nu-dtype", "bfloat16", "--lm-head", "fused",
             "--seed", "42"]
FSDP_PATHS = ("train_fsdp_body", "train_fsdp_superstep")
FSDP_CLI_PATHS = ("train_seq512_bf16_dp_all", "train_seq512_bf16_fsdp")
# tests/test_fsdp.py:51
FSDP_RTOL, FSDP_ATOL = 2e-3, 2e-4


def _fsdp_body_rank(port, queue):
    """Phase 20a in a process of its own: a one-rank NCCL group and its
    mesh (every axis 1). The replicated step body takes 4 steps; the
    sharded body (its all-gathers and reduce-scatters issued over the
    one-rank fsdp group) 8 steps and an eval, its state held bitwise
    against the replicated one's after 4; then the sharded body as a
    k = 4 superstep over the same 8 steps (the first window eager with
    the two captures, the second replayed) and the eval, bitwise its
    per-step run. The launch counts are set to 0 just before each
    sharded run and read just after."""
    import torch

    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.obs import devtime as devtime_lib
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    from tpudist_torch.parallel import distributed
    from tpudist_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed.initialize(f"localhost:{port}", 1, 0, device="cuda")
    dev = ctx.device
    cfg = config_lib.parse_args(FSDP_ARGV)
    mesh = mesh_lib.build_mesh(cfg.parallel, device_type="cuda")
    tokens = data_lib.make_synthetic_tokens(
        64, cfg.model.max_seq_len + 1, cfg.model.vocab_size, cfg.seed)
    slab, = data_lib.plan_epoch((tokens,), batch_size=cfg.batch_size,
                                seed=cfg.seed, epoch=0).slab(0, 8)
    slab = torch.as_tensor(slab, device=dev).long()       # (8, 8, 513)

    def leaves(state):
        return [t.detach().clone() for t in (
            *state.params.parameters(), *state.opt_state.mu,
            *state.opt_state.nu)]

    def same(a, b):
        return len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    def steps(step, state, lo, hi):
        """Steps ``[lo, hi)`` of the slab."""
        losses, ms = [], []
        for i in range(lo, hi):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, (slab[i],))
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, ms

    out = {"rank": 0, "world": ctx.process_count,
           "mesh": mesh_lib.mesh_shape(mesh)}
    state, out["dp_losses"], out["dp_ms"] = steps(
        engine_lib.make_train_step(cfg, dev),
        engine_lib.init_state(cfg, dev), 0, 4)
    dp4 = leaves(state)
    del state
    torch.cuda.empty_cache()

    state = engine_lib.init_state(cfg, dev, mesh)
    out["sharded_dims"] = sum(d is not None for d in state.layout.dims)
    step = engine_lib.make_train_step(cfg, dev, mesh)
    ev = engine_lib.make_eval_fn(cfg, dev, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches(fa, fx)
    state, losses4, ms4 = steps(step, state, 0, 4)
    out["same4"] = same(leaves(state), dp4) and losses4 == out["dp_losses"]
    state, losses8, ms8 = steps(step, state, 4, 8)
    out["eval"] = ev(state, (slab[0],)).item()
    torch.cuda.synchronize()
    out["counts"] = _launch_counts(fa, fx)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["losses"], out["ms"] = losses4 + losses8, ms4 + ms8
    out["ops"] = devtime_lib.collective_bytes(step.reduced_operands())
    per_step = leaves(state)
    del state, dp4
    torch.cuda.empty_cache()

    state = engine_lib.init_state(cfg, dev, mesh)
    sup = engine_lib.make_superstep(cfg, dev, 4, mesh)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches(fa, fx)
    sup_losses = []
    for w in range(2):
        t0 = time.perf_counter()
        state, total, losses = sup(state, total, (slab[4 * w:4 * w + 4],),
                                   0, 4)
        sup_losses += losses.tolist()
        out[f"window{w}_s"] = time.perf_counter() - t0
    sup_eval = ev(state, (slab[0],)).item()
    torch.cuda.synchronize()
    out["sup_counts"] = _path_launches(fa, fx, [sup])
    out["sup_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["graphs"] = (sup.programs, dict(sup.replays))
    out["pool_mb"] = sup.graph_pool_bytes / 2**20
    out["sup_same"] = (same(leaves(state), per_step)
                       and sup_losses == out["losses"]
                       and sup_eval == out["eval"])
    out["sup_losses"] = sup_losses
    sup.release()
    del state, per_step
    distributed.shutdown()
    queue.put(out)


def fsdp_body(torch, fa, card: str):
    """Phase 20a (one card): :func:`_fsdp_body_rank` in a spawned
    process. Fails unless the sharded body is bitwise the replicated one
    after 4 steps, its k = 4 superstep bitwise its per-step run (2
    programs, one replay), and both runs' launches exact. Prints the
    step's collective rows, the peak memory and the step times. Returns
    the two paths' launches."""
    from tpudist_torch import config as config_lib

    t0 = time.perf_counter()
    cfg = config_lib.parse_args(FSDP_ARGV)
    m = cfg.model
    (r,) = _spawn(_fsdp_body_rank, [(_free_port(),)], 600,
                  "train fsdp body")
    want = want_launches(fa, m, 512, 8, 1, fused=True)
    print(f"train fsdp body: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"{cfg.dtype}, adam nu {cfg.adam_nu_dtype}, fused head, batch 8, "
          f"mesh {r['mesh']} ({r['world']} NCCL rank), "
          f"{r['sharded_dims']} params gathered and reduce-scattered; "
          f"{card}")
    print(f"train fsdp body: replicated losses {r['dp_losses']}; sharded "
          f"{r['losses']}; bitwise after 4 steps (losses, params, mu, "
          f"nu): {r['same4']}")
    dp_ms, ms = statistics.median(r["dp_ms"][1:]), statistics.median(
        r["ms"][1:])
    print(f"train fsdp body: step {ms:.3f} ms sharded against "
          f"{dp_ms:.3f} replicated (medians after the first, host clock "
          f"fenced a step); peak device memory {r['peak_gb']:.3f} GB, "
          f"superstep {r['sup_peak_gb']:.3f} GB (graph pool "
          f"{r['pool_mb']:.1f} MB)")
    for row in r["ops"]["ops"]:
        print(f"train fsdp body: collective {row['op']} {row['dtype']} "
              f"{row['bytes']} B x {row['count']} a step")
    print(f"train fsdp body: superstep k=4 losses {r['sup_losses']}, "
          f"eval {r['eval']}, bitwise its per-step run: {r['sup_same']}; "
          f"(programs, replays) {r['graphs']}; windows "
          f"{r['window0_s']:.3f} s (eager + captures), "
          f"{r['window1_s']:.3f} s (replayed)")
    print(f"train fsdp body: kernel launches {r['counts']}, superstep "
          f"{r['sup_counts']} (want {want})")
    if not r["same4"]:
        fail("train fsdp body: the sharded body is not bitwise the "
             "replicated one after 4 steps")
    if not r["sup_same"]:
        fail("train fsdp body: the sharded superstep is not bitwise its "
             "per-step run")
    if r["graphs"] != (2, {"superstep": 1, "step": 0}):
        fail(f"train fsdp body: (programs, replays) {r['graphs']}")
    kinds = {row["op"] for row in r["ops"]["ops"]}
    if not {"all_gather", "reduce_scatter", "all_reduce"} <= kinds:
        fail(f"train fsdp body: collectives {sorted(kinds)}")
    for tag, counts in zip(FSDP_PATHS, (r["counts"], r["sup_counts"])):
        if counts != want:
            fail(f"train fsdp body: {tag} kernel launches {counts}, want "
                 f"{want}")
    print(f"train fsdp body: phase 20a {time.perf_counter() - t0:.1f} s")
    return dict(zip(FSDP_PATHS, (r["counts"], r["sup_counts"])))


def fsdp_cli(torch, fa, card: str):
    """Phase 20b (two cards or more): the train CLI at 20a's
    configuration, one NCCL process a card, replicated and with ``--fsdp
    <cards>``; every verdict ``success`` and exact launches
    (``dp_train_slice``), the step losses of the two within rtol 2e-3 /
    atol 2e-4, each rank's params and optimizer-state bytes side by
    side."""
    world = torch.cuda.device_count()
    flags = FSDP_ARGV[FSDP_ARGV.index("--dtype"):FSDP_ARGV.index("--seed")]
    runs = {}
    paths = {}
    for tag, extra in zip(FSDP_CLI_PATHS,
                          (flags, flags + ["--fsdp", str(world)])):
        runs[tag] = {}
        paths[tag] = dp_train_slice(torch, fa, card, tag=tag, extra=extra,
                                    details=runs[tag])
    dp, fsdp = (runs[t] for t in FSDP_CLI_PATHS)
    for a, b in zip(dp["ranks"], fsdp["ranks"]):
        print(f"train fsdp cli: rank {a['rank']} params "
              f"{b['params_bytes'] / 2**20:.1f} MB sharded against "
              f"{a['params_bytes'] / 2**20:.1f} replicated, optimizer "
              f"state {b['opt_bytes'] / 2**20:.1f} MB against "
              f"{a['opt_bytes'] / 2**20:.1f}; peak {b['peak_gb']:.3f} GB "
              f"against {a['peak_gb']:.3f}")
    err = max(abs(x - y) - FSDP_RTOL * abs(y)
              for x, y in zip(fsdp["losses"], dp["losses"]))
    print(f"train fsdp cli: {world} cards, losses --fsdp {world} "
          f"{fsdp['losses']} against replicated {dp['losses']}")
    if len(fsdp["losses"]) != len(dp["losses"]) or err > FSDP_ATOL:
        fail(f"train fsdp cli: the --fsdp {world} losses are not within "
             f"rtol {FSDP_RTOL} / atol {FSDP_ATOL} of the replicated run's")
    if not all(b["params_bytes"] < a["params_bytes"]
               for a, b in zip(dp["ranks"], fsdp["ranks"])):
        fail("train fsdp cli: a rank's params are not sharded")
    return paths


# ------------------------------------------ phase 21: tensor parallelism

# phase 6's configuration: config #5, s512, f32; its auto head resolves
# to the plain one on the card, which splits over tensor (vocab-parallel)
TP_ARGV = ["--model", "transformer", "--seq-len", "512",
           "--train-batch-size", "8", "--lm-head", "plain", "--seed", "42"]
TP_PATHS = ("train_tp_body", "train_tp_superstep")
# phase 6's CLI flags (train_slice's at seq 512, 32 samples, 1 epoch)
PHASE6_ARGV = ["--model", "transformer", "--seq-len", "512",
               "--train-batch-size", "8", "--n-samples", "32", "--epochs",
               "1", "--seed", "42", "--log-every", "1"]
TP_MOE_ARGV = [*MOE_MODEL, "--seq-len", "512", "--train-batch-size", "8",
               "--n-samples", "32", "--epochs", "1", "--seed", "42",
               "--log-every", "1", "--lm-head", "plain", "--lr", "1e-3"]
TP_CLI_PATHS = ("train_seq512_tp", "train_seq512_fsdp2_tp2",
                "train_moe_f32_one", "train_moe_tp")


def _tp_body_rank(port, queue):
    """Phase 21a in a process of its own: a one-rank NCCL group and its
    mesh, with the mesh's one-rank tensor group handed to the layout, so
    the step runs the tensor-parallel path (the Megatron operators'
    all-reduces, the vocab-parallel lookup and head with their
    cross-rank lse) with every collective issued. The replicated body 4
    steps; the tensor-parallel body 8 steps and an eval, bitwise the
    replicated one after 4; then as a k = 4 superstep over the same 8
    steps, bitwise its per-step run. Launch counts set to 0 just before
    each tensor-parallel run and read just after."""
    import torch

    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.obs import devtime as devtime_lib
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    from tpudist_torch.parallel import distributed
    from tpudist_torch.parallel import mesh as mesh_lib
    from tpudist_torch.parallel import tensor as tensor_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed.initialize(f"localhost:{port}", 1, 0, device="cuda")
    dev = ctx.device
    cfg = config_lib.parse_args(TP_ARGV)
    mesh = mesh_lib.build_mesh(cfg.parallel, device_type="cuda")
    tokens = data_lib.make_synthetic_tokens(
        64, cfg.model.max_seq_len + 1, cfg.model.vocab_size, cfg.seed)
    slab, = data_lib.plan_epoch((tokens,), batch_size=cfg.batch_size,
                                seed=cfg.seed, epoch=0).slab(0, 8)
    slab = torch.as_tensor(slab, device=dev).long()       # (8, 8, 513)
    # the vocab-parallel head's calls: its logits' shape
    heads, xent = [], tensor_lib._VocabParallelXent.apply

    def spy(logits, *rest):
        heads.append(tuple(logits.shape))
        return xent(logits, *rest)
    tensor_lib._VocabParallelXent.apply = spy

    def leaves(state):
        return [t.detach().clone() for t in (
            *state.params.parameters(), *state.opt_state.mu,
            *state.opt_state.nu)]

    def same(a, b):
        return len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    def steps(step, state, lo, hi):
        losses, ms = [], []
        for i in range(lo, hi):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, (slab[i],))
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, ms

    def tp_state():
        state = engine_lib.init_state(cfg, dev, mesh)
        state.layout.tensor_group = mesh.get_group("tensor")
        return state

    out = {"rank": 0, "world": ctx.process_count,
           "mesh": mesh_lib.mesh_shape(mesh)}
    state, out["dp_losses"], out["dp_ms"] = steps(
        engine_lib.make_train_step(cfg, dev),
        engine_lib.init_state(cfg, dev), 0, 4)
    dp4 = leaves(state)
    del state
    torch.cuda.empty_cache()

    state = tp_state()
    step = engine_lib.make_train_step(cfg, dev, mesh)
    ev = engine_lib.make_eval_fn(cfg, dev, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches(fa, fx)
    heads.clear()
    state, losses4, ms4 = steps(step, state, 0, 4)
    out["same4"] = same(leaves(state), dp4) and losses4 == out["dp_losses"]
    state, losses8, ms8 = steps(step, state, 4, 8)
    out["eval"] = ev(state, (slab[0],)).item()
    torch.cuda.synchronize()
    out["counts"] = _launch_counts(fa, fx)
    out["heads"] = sorted(set(heads))
    out["n_heads"] = len(heads)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["losses"], out["ms"] = losses4 + losses8, ms4 + ms8
    out["ops"] = devtime_lib.collective_bytes(step.reduced_operands())
    out["n_all_reduce"] = sum(op == "all_reduce"
                              for op, _, _ in step.reduced_operands())
    per_step = leaves(state)
    del state, dp4
    torch.cuda.empty_cache()

    state = tp_state()
    sup = engine_lib.make_superstep(cfg, dev, 4, mesh)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches(fa, fx)
    sup_losses = []
    for w in range(2):
        t0 = time.perf_counter()
        state, total, losses = sup(state, total, (slab[4 * w:4 * w + 4],),
                                   0, 4)
        sup_losses += losses.tolist()
        out[f"window{w}_s"] = time.perf_counter() - t0
    sup_eval = ev(state, (slab[0],)).item()
    torch.cuda.synchronize()
    out["sup_counts"] = _path_launches(fa, fx, [sup])
    out["sup_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["graphs"] = (sup.programs, dict(sup.replays))
    out["pool_mb"] = sup.graph_pool_bytes / 2**20
    out["sup_same"] = (same(leaves(state), per_step)
                       and sup_losses == out["losses"]
                       and sup_eval == out["eval"])
    out["sup_losses"] = sup_losses
    sup.release()
    del state, per_step
    distributed.shutdown()
    queue.put(out)


def tp_body(torch, fa, card: str):
    """Phase 21a (one card): :func:`_tp_body_rank` in a spawned process.
    Fails unless the tensor-parallel body is bitwise the replicated one
    after 4 steps, its k = 4 superstep bitwise its per-step run (2
    programs, one replay: the operators' collectives captured), both
    runs' launches exact, the head vocab-parallel on every loss, and the
    step's all-reduces those of the tensor path (per layer two operator
    exits forward and two entries backward; the lookup's exit, the head's
    entry and its lse max, exp sum and gold logit; the three norms' and
    the loss's means). Prints the collective rows, the peak memory and
    the step times. Returns the two paths' launches."""
    from tpudist_torch import config as config_lib

    t0 = time.perf_counter()
    cfg = config_lib.parse_args(TP_ARGV)
    m = cfg.model
    (r,) = _spawn(_tp_body_rank, [(_free_port(),)], 600, "train tp body")
    want = want_launches(fa, m, 512, 8, 1, fused=False)
    print(f"train tp body: V{m.vocab_size} L{m.n_layers} d{m.d_model} "
          f"h{m.n_heads} {cfg.dtype}, plain head (vocab-parallel), batch "
          f"8, mesh {r['mesh']} ({r['world']} NCCL rank) with its tensor "
          f"group; {card}")
    print(f"train tp body: replicated losses {r['dp_losses']}; tensor "
          f"path {r['losses']}; bitwise after 4 steps (losses, params, "
          f"mu, nu): {r['same4']}")
    dp_ms, ms = statistics.median(r["dp_ms"][1:]), statistics.median(
        r["ms"][1:])
    print(f"train tp body: step {ms:.3f} ms on the tensor path against "
          f"{dp_ms:.3f} replicated (medians after the first, host clock "
          f"fenced a step); peak device memory {r['peak_gb']:.3f} GB, "
          f"superstep {r['sup_peak_gb']:.3f} GB (graph pool "
          f"{r['pool_mb']:.1f} MB)")
    for row in r["ops"]["ops"]:
        print(f"train tp body: collective {row['op']} {row['dtype']} "
              f"{row['bytes']} B x {row['count']} a step")
    print(f"train tp body: superstep k=4 losses {r['sup_losses']}, eval "
          f"{r['eval']}, bitwise its per-step run: {r['sup_same']}; "
          f"(programs, replays) {r['graphs']}; windows "
          f"{r['window0_s']:.3f} s (eager + captures), "
          f"{r['window1_s']:.3f} s (replayed)")
    print(f"train tp body: vocab-parallel head logits {r['heads']} on "
          f"{r['n_heads']} losses; kernel launches {r['counts']}, "
          f"superstep {r['sup_counts']} (want {want})")
    if not r["same4"]:
        fail("train tp body: the tensor path is not bitwise the "
             "replicated body after 4 steps")
    if not r["sup_same"]:
        fail("train tp body: the tensor path's superstep is not bitwise "
             "its per-step run")
    if r["graphs"] != (2, {"superstep": 1, "step": 0}):
        fail(f"train tp body: (programs, replays) {r['graphs']}")
    if r["heads"] != [(8, 512, m.vocab_size)] or r["n_heads"] != 9:
        fail(f"train tp body: the vocab-parallel head ran {r['n_heads']} "
             f"times at {r['heads']}")
    want_ar = 4 * m.n_layers + 9
    if r["n_all_reduce"] != want_ar:
        fail(f"train tp body: {r['n_all_reduce']} all-reduces a step, "
             f"the tensor path issues {want_ar}")
    for tag, counts in zip(TP_PATHS, (r["counts"], r["sup_counts"])):
        if counts != want:
            fail(f"train tp body: {tag} kernel launches {counts}, want "
                 f"{want}")
    print(f"train tp body: phase 21a {time.perf_counter() - t0:.1f} s")
    return dict(zip(TP_PATHS, (r["counts"], r["sup_counts"])))


def _mesh_cli(torch, fa, card: str, tag: str, argv, seq: int,
              fused: bool = False, n_accum: int = 1, rank_fn=None,
              want=None):
    """The train CLI at ``argv`` as one NCCL process a visible card
    (``rank_fn``, ``_dp_train_rank`` by default): every verdict
    ``success``, the contract on rank
    0 alone, and each rank's launches exactly one process's (the tensor
    ranks run every layer on their heads; ``fused``: the fused head's
    too; ``n_accum`` microbatches a step), or exactly ``want`` when
    given (a context rank's share; ``False``: rank 0's). Returns the
    step losses, the
    timing record, rank 0's records, each rank's record and the launches
    summed."""
    from tpudist_torch import config as config_lib

    world = torch.cuda.device_count()
    save = ROOT / "build" / "chip_smoke_train" / tag
    shutil.rmtree(save, ignore_errors=True)
    argv = argv + ["--save-dir", str(save)]
    cfg = config_lib.parse_args(argv)
    verdict = save / "job_status.txt"
    port = _free_port()
    ranks = _spawn(rank_fn or _dp_train_rank,
                   [(r, world, port, argv, str(verdict))
                    for r in range(world)], 420, f"train {tag}")
    recs = [json.loads(ln) for ln in
            (save / "metrics.jsonl").read_text().splitlines()]
    timing = [r for r in recs if r["kind"] == "timing"]
    losses = [r["loss"] for r in recs if r["kind"] == "step"]
    statuses = [verdict.read_text() if verdict.is_file() else None] + [
        (save / f"job_status.txt.worker{r}").read_text()
        if (save / f"job_status.txt.worker{r}").is_file() else None
        for r in range(world)]
    shutil.rmtree(save, ignore_errors=True)
    if [r["rc"] for r in ranks] != [0] * world or not timing \
            or statuses != ["success"] * (world + 1):
        fail(f"train {tag}: exit codes {[r['rc'] for r in ranks]}, final "
             f"and worker verdicts {statuses}")
    out = ranks[0]["out"]
    check_contract(tag, out, cfg.epochs, losses)
    for r in ranks[1:]:
        if "Epoch" in r["out"] or "Training completed." in r["out"]:
            fail(f"train {tag}: rank {r['rank']} printed the contract")
    if want is None:
        want = want_launches(fa, cfg.model, seq, n_accum * cfg.epochs * (
            cfg.data.n_samples // cfg.batch_size), cfg.epochs, fused=fused)
    elif want is False:
        # a tuned run's point (remat, accumulation) is the tuner's: every
        # rank holds rank 0's launches, which the caller compares
        want = ranks[0]["counts"]
    total = dict.fromkeys(want, 0)
    for r in ranks:
        if r["counts"] != want:
            fail(f"train {tag}: rank {r['rank']} kernel launches "
                 f"{r['counts']}, want {want}")
        for k, v in r["counts"].items():
            total[k] += v
    t = timing[-1]
    print(f"train {tag}: {world} NCCL processes, step losses {losses}; "
          f"verdicts {statuses}; step {1e3 * t['run_s'] / t['steps']:.2f} "
          f"ms (over {t['steps']} steps after the first); "
          f"{t['model_flops_per_step']} flops a step a rank; rank walls "
          f"{[round(r['wall'], 2) for r in ranks]} s; peak device memory "
          f"by rank {[round(r['peak_gb'], 3) for r in ranks]} GB; each "
          f"rank's launches {want}; {card}")
    for line in out.splitlines():
        if line.startswith("tpudist: collectives"):
            print(f"train {tag}: rank 0's {line[len('tpudist: '):]}")
    return {"losses": losses, "timing": t, "ranks": ranks, "counts": total,
            "cfg": cfg, "recs": recs}


def _tp_bytes(tag: str, run, whole: int) -> None:
    """Each rank's params and optimizer-state bytes against the whole
    (replicated) state's; fails unless a rank's params are below half
    the whole."""
    for r in run["ranks"]:
        print(f"train {tag}: rank {r['rank']} params "
              f"{r['params_bytes'] / 2**20:.1f} MiB against "
              f"{whole / 2**20:.1f} replicated, optimizer state "
              f"{r['opt_bytes'] / 2**20:.1f} MiB against "
              f"{2 * whole / 2**20:.1f}")
        if not r["params_bytes"] < whole / 2:
            fail(f"train {tag}: rank {r['rank']}'s params are not split")


def _tp_close(tag: str, got, want) -> None:
    err = max((abs(x - y) - FSDP_RTOL * abs(y) for x, y in zip(got, want)),
              default=math.inf)
    print(f"train {tag}: losses {got} against {want}")
    if len(got) != len(want) or err > FSDP_ATOL:
        fail(f"train {tag}: the losses are not within rtol {FSDP_RTOL} / "
             f"atol {FSDP_ATOL} of the reference's")


def _whole_bytes(argv) -> int:
    """The f32 params' bytes of ``argv``'s model, whole."""
    from tpudist_torch import config as config_lib
    from tpudist_torch.models import get_model

    m = config_lib.parse_args(argv).model
    shapes = get_model(m.name)._layer_shapes(m).values()
    return 4 * (m.vocab_size * m.d_model + m.d_model
                + sum(math.prod(sh) for sh in shapes))


def tp_cli(torch, fa, fx, card: str, phase6_losses):
    """Phase 21b (two cards or more): the train CLI at one NCCL process a
    card. ``--tensor <cards>`` (data 1) at phase 6's flags, held to phase
    6's one-card step losses (this run's) at rtol 2e-3 / atol 2e-4; with
    four cards or a multiple, ``--fsdp 2 --tensor 2`` held to the same;
    then bench.py's MoE row in f32 (``TP_MOE_ARGV``) on one card and at
    ``--tensor <cards>``, held to it. Every verdict ``success``, exact
    launches on every rank, each rank's flop count the closed form's
    tensor part (the MoE's router, dispatch and combine whole on every
    rank), each rank's params and optimizer bytes against replicated.
    Returns the paths' launches."""
    from tpudist_torch import config as config_lib
    from tpudist_torch.models import moe as moe_lib

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    paths = {}
    whole = _whole_bytes(PHASE6_ARGV)
    m = config_lib.parse_args(PHASE6_ARGV).model
    runs = [("train_seq512_tp", ["--tensor", str(world)], world)]
    if world % 4 == 0:
        runs.append(("train_seq512_fsdp2_tp2", ["--fsdp", "2", "--tensor",
                                                "2"], 2))
    for tag, extra, tensor in runs:
        run = _mesh_cli(torch, fa, card, tag, PHASE6_ARGV + extra, 512)
        if "--lm-head auto -> plain" not in run["ranks"][0]["out"]:
            fail(f"train {tag}: the auto head did not resolve to plain")
        _tp_close(tag, run["losses"], phase6_losses)
        batch = 8 // (world // tensor)
        want = step_flops(m, batch, 512) // tensor
        if run["timing"]["model_flops_per_step"] != want:
            fail(f"train {tag}: {run['timing']['model_flops_per_step']} "
                 f"flops a step a rank, the closed form's 1/{tensor} of "
                 f"batch {batch}'s is {want}")
        _tp_bytes(tag, run, whole)
        paths[tag] = run["counts"]

    one = _cli_run(torch, fa, fx, TP_CLI_PATHS[2], TP_MOE_ARGV)
    one_losses = [r["loss"] for r in one["recs"] if r["kind"] == "step"]
    check_contract(TP_CLI_PATHS[2], one["out"], 1, one_losses)
    print(f"train {TP_CLI_PATHS[2]}: one card, step losses {one_losses}; "
          + _step_line(one, 8 * 512))
    paths[TP_CLI_PATHS[2]] = one["counts"]
    run = _mesh_cli(torch, fa, card, TP_CLI_PATHS[3],
                    TP_MOE_ARGV + ["--tensor", str(world)], 512)
    _tp_close(TP_CLI_PATHS[3], run["losses"], one_losses)
    mm = run["cfg"].model
    t = 8 * 512
    g = moe_lib.group_size(mm, t)
    cap = moe_lib.capacity(mm, g)
    E, k, d = mm.n_experts, mm.expert_top_k, mm.d_model
    rows = (t // g) * E * cap
    want = (step_flops(dataclasses.replace(mm, d_ff=0), 8, 512) // world
            + mm.n_layers * (6 * t * d * E + 18 * rows * d * mm.d_ff // world
                             + 10 * t * E * cap * d + 6 * t * E * k * cap))
    print(f"train {TP_CLI_PATHS[3]}: {run['timing']['model_flops_per_step']}"
          f" flops a step a rank (closed form {want}; the whole step's "
          f"{moe_step_flops(mm, 8, 512)})")
    if run["timing"]["model_flops_per_step"] != want:
        fail(f"train {TP_CLI_PATHS[3]}: flops a step a rank "
             f"{run['timing']['model_flops_per_step']}, want {want}")
    _tp_bytes(TP_CLI_PATHS[3], run, _whole_bytes(TP_MOE_ARGV))
    paths[TP_CLI_PATHS[3]] = run["counts"]
    print(f"train tp cli: phase 21b {time.perf_counter() - t0:.1f} s")
    return paths


SERVE_MESH_PATHS = ("serve_mesh", "serve_moe_mesh")
SERVE_MESH_CLI_PATHS = ("serve_mesh_cli", "serve_moe_mesh_cli",
                        "serve_mesh_cli_wide")
# phase 18d's MoE flags through the serve CLI
MOE_SERVE_ARGV = [*SERVE_ARGV[:SERVE_ARGV.index("--d-ff") + 1], "2752",
                  *SERVE_ARGV[SERVE_ARGV.index("--d-ff") + 2:], "--model",
                  "moe", "--n-experts", "8", "--expert-top-k", "2"]


def _serve_mesh_rank(port, moe: bool, queue):
    """Phase 22a in a process of its own: a one-rank NCCL group and its
    serve mesh (``ParallelConfig()``: data 1), phase 4's engine on it over
    phase 4's stream, then (``moe``) phase 18c's dense MoE engine, whose
    decode graphs capture the all-gather of the router probabilities
    over the one-rank slot group. The launch counts set to 0 just before
    each run and read just after."""
    import torch

    from tpudist_torch.config import ModelConfig, ParallelConfig
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    from tpudist_torch.parallel import distributed
    from tpudist_torch.parallel import mesh as mesh_lib
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed.initialize(f"localhost:{port}", 1, 0, device="cuda")
    mesh = mesh_lib.build_mesh(ParallelConfig(), device_type="cuda")
    out = {"rank": 0, "world": ctx.process_count, "backend": ctx.backend}
    requests = sched.make_requests(16, prompt_pad=512, vocab_size=32000,
                                   max_new=32, rate=0.0, seed=0)
    runs = [("serve_mesh", ModelConfig(name="transformer"))]
    if moe:
        runs.append(("serve_moe_mesh", moe_model_config(1024)))
    for tag, cfg in runs:
        params = init_params(cfg, seed=0, device="cuda")
        engine = _serve_engine(torch, cfg, False, mesh=mesh)
        _reset_launches(fa, fx)
        t0 = time.perf_counter()
        engine.warmup(params)
        warm_s = time.perf_counter() - t0
        summary = sched.run_serve(engine, params, requests)
        engine.stop_followers()
        torch.cuda.synchronize()
        engine.assert_two_programs()
        out[tag] = {
            "tokens": _tokens_of(summary), "admitted": summary["admitted"],
            "completed": summary["completed"],
            "launches": engine.kernel_launches(), "outside": fa.launches,
            "prefills": engine.local_prefills,
            "programs": engine.compile_counts(), "split": engine.split,
            "ways": (engine._slot_kw["slot_group"].ways if engine.split
                     else None),
            "n_chips": summary["n_chips"], "warm_s": warm_s,
            "capture_s": engine.capture_s,
            "pool_mb": engine.graph_pool_bytes / MB,
            **{k: summary[k] for k in SERVE_LATENCY}}
        engine.release()
        del engine, params
        torch.cuda.empty_cache()
    distributed.shutdown()
    queue.put(out)


SERVE_LATENCY = ("tokens_per_sec_per_chip", "ttft_p50_s", "ttft_p99_s",
                 "itl_p50_s", "itl_p99_s")


def _latency_line(summary) -> str:
    return (f"tokens/s/chip {summary['tokens_per_sec_per_chip']}, ttft p50 "
            f"{summary['ttft_p50_s']} s p99 {summary['ttft_p99_s']} s, itl "
            f"p50 {summary['itl_p50_s']} s p99 {summary['itl_p99_s']} s")


def serve_mesh_one(torch, fa, card: str, refs):
    """Phase 22a (one card): :func:`_serve_mesh_rank` in a spawned
    process. ``refs`` holds phase 4's tokens under ``serve`` and, where
    phase 18c ran, its dense engine's under ``serve_moe`` (the MoE runs
    only then). Fails unless every request's tokens are bitwise theirs,
    the program pin holds, the flash forward launched n_layers x
    (prefills + the warm-up's) with every prefill on the one rank, and
    ``n_chips`` is 1. Returns the paths' launches."""
    t0 = time.perf_counter()
    (r,) = _spawn(_serve_mesh_rank, [(_free_port(), "serve_moe" in refs)],
                  300, "serve mesh one rank")
    paths = {}
    for tag, ref, name in (("serve_mesh", "serve", "phase 4's"),
                           ("serve_moe_mesh", "serve_moe",
                            "phase 18c's dense engine's")):
        if tag not in r:
            continue
        run = r[tag]
        want = 4 * (run["admitted"] + 1)
        same = run["tokens"] == refs[ref]
        print(f"serve mesh 22a {tag}: {r['world']} {r['backend']} rank, "
              f"slots split {run['split']} (slot group of {run['ways']}); "
              f"{run['completed']}/16 requests, tokens bitwise {name}: "
              f"{same}; programs {run['programs']}, prefills "
              f"{run['prefills']}, flash launches {run['launches']} (want "
              f"n_layers x (prefills + warm-up) = {want}), n_chips "
              f"{run['n_chips']}; warm-up {run['warm_s']:.3f} s (capture "
              f"{run['capture_s']:.3f} s, graph pools {run['pool_mb']:.1f} "
              f"MB); " + _latency_line(run) + f"; {card}")
        if not same:
            fail(f"serve mesh 22a {tag}: the tokens differ from {name}")
        if run["programs"] != (1, 3) or run["launches"] != want \
                or run["prefills"] != run["admitted"] \
                or run["outside"] != 4 or run["n_chips"] != 1 \
                or not run["split"]:
            fail(f"serve mesh 22a {tag}: programs {run['programs']}, "
                 f"launches {run['launches']} (want {want}), prefills "
                 f"{run['prefills']}, outside a graph {run['outside']}, "
                 f"n_chips {run['n_chips']}, split {run['split']}")
        paths[tag] = {"flash_attention_fwd": run["launches"]}
    print(f"serve mesh 22a: phase wall {time.perf_counter() - t0:.1f} s")
    return paths


def phase4_engine(torch):
    """Phase 4's engine and params anew, warmed (phase 22b's one-card
    reference in the full run, where phase 4's are gone)."""
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.serve.engine import init_params

    cfg = ModelConfig(name="transformer")
    engine = _serve_engine(torch, cfg, False)
    params = init_params(cfg, seed=0, device="cuda")
    engine.warmup(params)
    return engine, params


def _serve_rank(rank, world, port, argv, verdict, queue):
    """Phase 22b, one rank in a process of its own: the serve CLI's
    ``main`` under the env contract, its launch counts set to 0 just
    before and read just after; rank 0's summary."""
    os.environ.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                      TPUDIST_NUM_PROCESSES=str(world),
                      TPUDIST_PROCESS_ID=str(rank),
                      TPUDIST_VERDICT_PATH=verdict)
    import torch

    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    from tpudist_torch.serve import cli as serve_cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tee = _Tee(sys.stdout)
    _reset_launches(fa, fx)
    t0 = time.perf_counter()
    with _serve_engines() as made, _serve_summaries() as runs, \
            contextlib.redirect_stdout(tee):
        rc = serve_cli.main(argv)
    torch.cuda.synchronize()
    engine = made[-1]
    summary = runs[-1]["summary"] if runs else None
    queue.put({"rank": rank, "rc": rc, "out": tee.buf.getvalue(),
               "wall": time.perf_counter() - t0,
               "launches": engine.kernel_launches(),
               "outside": fa.launches, "prefills": engine.local_prefills,
               "programs": engine.compile_counts(),
               "verify": len(getattr(engine, "verify_traces", [])),
               "span": engine.span, "kv_bytes": engine.card_kv_bytes(),
               "pool": (None if getattr(engine, "pool_group", None) is None
                        else engine.pool_group[1:]),
               "point": (engine.decode_k, engine.layout,
                         engine.spec.page_tokens if engine.paged else 0,
                         engine.speculate_k),
               "rungs": len(engine.ladder),
               "summary": None if summary is None else {
                   "tokens": _tokens_of(summary),
                   **{k: summary[k] for k in (
                       *SERVE_LATENCY, "status", "n_chips", "admitted",
                       "completed", "requests", "wall_s", "slots")}}})


def _cli_params(torch, argv):
    """The serve CLI's model at ``argv`` and its seeded params on the
    card (the near-tie rule's full forward)."""
    from tpudist_torch.config import ModelConfig
    from tpudist_torch.serve import cli as serve_cli
    from tpudist_torch.serve.engine import init_params

    a = serve_cli.parse_args(argv)
    cfg = ModelConfig(name=a.model, vocab_size=a.vocab_size,
                      n_layers=a.n_layers, d_model=a.d_model,
                      n_heads=a.n_heads, n_kv_heads=a.n_kv_heads,
                      d_ff=a.d_ff, max_seq_len=a.max_seq,
                      n_experts=a.n_experts, expert_top_k=a.expert_top_k)
    return cfg, init_params(cfg, seed=a.seed, device="cuda")


def serve_mesh_cli(torch, fa, fx, card: str, engine, params):
    """Phase 22b (two cards or more): the serve CLI as one NCCL process a
    card at phase 4's flags (8 slots: a share a card), at phase 18d's MoE
    flags, and at 8 slots a card with 16 requests a card. Each against one
    card: the first two against the serve CLI on one card, the third
    against phase 4's engine over its stream. Fails unless every rank
    exits 0, every verdict is ``success``, ``n_chips`` is the cards, each
    rank's pin holds and its flash launches are n_layers x (its prefills
    + the warm-up's), the prefills over the ranks are the requests, and
    every request's tokens equal the one-card run's or first diverge at
    a near-tie (phase 14's rule, counted). Prints tokens/s/chip, TTFT and
    ITL beside the one-card run's. Returns the paths' launches (summed
    over the ranks)."""
    from tpudist_torch.serve import scheduler as sched

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    wide = [*SERVE_ARGV, "--slots", str(8 * world), "--requests",
            str(16 * world)]
    requests = sched.make_requests(16 * world, prompt_pad=512,
                                   vocab_size=32000, max_new=32, rate=0.0,
                                   seed=0)
    engine.reset_kernel_launches()
    one_wide = sched.run_serve(engine, params, requests)
    print(f"serve mesh 22b: phase 4's engine over {16 * world} requests "
          f"on one card: " + _latency_line(one_wide))
    refs = {}
    for tag, argv in ((SERVE_MESH_CLI_PATHS[0], SERVE_ARGV),
                      (SERVE_MESH_CLI_PATHS[1], MOE_SERVE_ARGV)):
        one = _serve_cli(torch, fa, fx, f"{tag} one card", argv)
        refs[tag] = one["summary"]
    refs[SERVE_MESH_CLI_PATHS[2]] = one_wide
    streams = {SERVE_MESH_CLI_PATHS[2]: requests}
    paths = {}
    for tag, argv in zip(SERVE_MESH_CLI_PATHS,
                         (SERVE_ARGV, MOE_SERVE_ARGV, wide)):
        save = ROOT / "build" / "chip_smoke_serve" / tag
        shutil.rmtree(save, ignore_errors=True)
        verdict = save / "job_status.txt"
        port = _free_port()
        ranks = _spawn(_serve_rank,
                       [(r, world, port, argv + ["--save-dir", str(save)],
                         str(verdict)) for r in range(world)], 300,
                       f"serve {tag}")
        statuses = [verdict.read_text() if verdict.is_file() else None] + [
            (save / f"job_status.txt.worker{r}").read_text()
            if (save / f"job_status.txt.worker{r}").is_file() else None
            for r in range(world)]
        shutil.rmtree(save, ignore_errors=True)
        got = ranks[0]["summary"]
        if [r["rc"] for r in ranks] != [0] * world \
                or statuses != ["success"] * (world + 1) or got is None \
                or got["status"] != "success" or got["n_chips"] != world:
            fail(f"serve {tag}: exit codes {[r['rc'] for r in ranks]}, "
                 f"final and worker verdicts {statuses}, summary "
                 f"{None if got is None else (got['status'], got['n_chips'])}")
        for r in ranks:
            want = 4 * (r["prefills"] + 1)
            print(f"serve {tag}: rank {r['rank']} slots {r['span']}, "
                  f"programs {r['programs']}, prefills {r['prefills']}, "
                  f"flash launches {r['launches']} (want n_layers x "
                  f"(prefills + warm-up) = {want}), wall {r['wall']:.2f} s")
            if r["programs"] != (1, 3) or r["launches"] != want \
                    or r["outside"] != 4:
                fail(f"serve {tag}: rank {r['rank']} programs "
                     f"{r['programs']}, launches {r['launches']} (want "
                     f"{want}), outside a graph {r['outside']}")
        n_pre = sum(r["prefills"] for r in ranks)
        if got["completed"] != got["requests"] \
                or not n_pre == got["admitted"] == got["requests"]:
            fail(f"serve {tag}: {got['completed']}/{got['requests']} "
                 f"completed, prefills over the ranks {n_pre}, admitted "
                 f"{got['admitted']}")
        ref = refs[tag]
        cfg, ref_params = engine.model_cfg, params
        if tag != SERVE_MESH_CLI_PATHS[2] \
                and got["tokens"] != _tokens_of(ref):
            cfg, ref_params = _cli_params(torch, argv)
        stream = streams.get(tag) or sched.make_requests(
            16, prompt_pad=512, vocab_size=32000, max_new=32, rate=0.0,
            seed=0)
        ties = _near_ties(torch, ref_params, cfg, stream, _tokens_of(ref),
                          got["tokens"], f"serve {tag}")
        del ref_params
        torch.cuda.empty_cache()
        print(f"serve {tag}: {world} NCCL processes, status "
              f"{got['status']}, n_chips {got['n_chips']}, near-ties "
              f"{ties}; {world} cards " + _latency_line(got)
              + "; one card " + _latency_line(ref) + f"; {card}")
        paths[tag] = {"flash_attention_fwd": sum(r["launches"]
                                                 for r in ranks)}
    print(f"serve mesh 22b: phase wall {time.perf_counter() - t0:.1f} s")
    return paths


# phase 23a's runs: (model, engine options, shared-prefix tokens, the
# one-card reference's key)
PAGED_MESH_PATHS = ("paged_mesh", "paged_mesh_spec", "paged_moe_mesh")
PAGED_MESH_REFS = {"paged_mesh": "paged_serve",
                   "paged_mesh_spec": "paged_serve_spec",
                   "paged_moe_mesh": "paged_serve_moe"}


def _paged_runs(moe: bool):
    from tpudist_torch.config import ModelConfig

    tf = ModelConfig(name="transformer")
    runs = {"paged_mesh": (tf, {}, 0),
            "paged_mesh_spec": (tf, {"speculate_k": 4}, PREFIX)}
    if moe:
        runs["paged_moe_mesh"] = (moe_model_config(1024), {}, 0)
    return runs


def _paged_stream(cfg, prefix_len: int):
    from tpudist_torch.serve import scheduler as sched

    requests = sched.make_requests(16, prompt_pad=512,
                                   vocab_size=cfg.vocab_size, max_new=32,
                                   rate=0.0, seed=0, prefix_len=prefix_len)
    prefix = (sched.shared_prefix_tokens(prefix_len, cfg.vocab_size, seed=0)
              if prefix_len else None)
    return requests, prefix


def _paged_mesh_rank(port, moe: bool, queue):
    """Phase 23a in a process of its own: a one-rank NCCL group and its
    serve mesh, ``PagedServeEngine(mesh=...)`` (16-token pages) over
    phase 14a's stream, 14b's prefixed stream with speculation and
    (``moe``) 18c's paged MoE. The launch counts set to 0 just before
    each run and read just after."""
    import torch

    from tpudist_torch.config import ParallelConfig
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    from tpudist_torch.parallel import distributed
    from tpudist_torch.parallel import mesh as mesh_lib
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed.initialize(f"localhost:{port}", 1, 0, device="cuda")
    mesh = mesh_lib.build_mesh(ParallelConfig(), device_type="cuda")
    out = {"rank": 0, "world": ctx.process_count, "backend": ctx.backend}
    params = {}
    for tag, (cfg, kw, prefix_len) in _paged_runs(moe).items():
        if cfg.name not in params:
            params.clear()
            torch.cuda.empty_cache()
            params[cfg.name] = init_params(cfg, seed=0, device="cuda")
        requests, prefix = _paged_stream(cfg, prefix_len)
        engine = _serve_engine(torch, cfg, True, page_tokens=16, mesh=mesh,
                               **kw)
        _reset_launches(fa, fx)
        t0 = time.perf_counter()
        engine.warmup(params[cfg.name])
        warm_s = time.perf_counter() - t0
        summary = sched.run_serve(engine, params[cfg.name], requests,
                                  shared_prefix=prefix)
        engine.stop_followers()
        torch.cuda.synchronize()
        engine.assert_two_programs()
        out[tag] = {
            "tokens": _tokens_of(summary), "admitted": summary["admitted"],
            "completed": summary["completed"], "prefixes": int(bool(prefix_len)),
            "n_layers": cfg.n_layers,
            "launches": engine.kernel_launches(), "outside": fa.launches,
            "prefills": engine.local_prefills,
            "programs": (*engine.compile_counts(), len(engine.verify_traces)),
            "pool": engine.pool_group is not None,
            "n_chips": summary["n_chips"],
            "warm_s": warm_s, "capture_s": engine.capture_s,
            "pool_mb": engine.graph_pool_bytes / MB,
            **{k: summary[k] for k in SERVE_LATENCY}}
        engine.release()
        del engine
        torch.cuda.empty_cache()
    distributed.shutdown()
    queue.put(out)


def paged_refs(torch):
    """``--only-serve-mesh``'s references for 23a: phase 14a's and 14b's
    paged engines on one card over their streams (:func:`_ref`)."""
    from tpudist_torch.serve import scheduler as sched
    from tpudist_torch.serve.engine import init_params

    refs, params = {}, None
    for tag, (cfg, kw, prefix_len) in _paged_runs(False).items():
        params = params or init_params(cfg, seed=0, device="cuda")
        requests, prefix = _paged_stream(cfg, prefix_len)
        engine = _serve_engine(torch, cfg, True, page_tokens=16, **kw)
        engine.warmup(params)
        refs[PAGED_MESH_REFS[tag]] = _ref(sched.run_serve(
            engine, params, requests, shared_prefix=prefix))
        engine.release()
        del engine
        torch.cuda.empty_cache()
    return refs


def paged_mesh_one(torch, fa, card: str, refs):
    """Phase 23a (one card): :func:`_paged_mesh_rank` in a spawned
    process. ``refs`` holds the one-card runs under ``paged_serve`` and
    ``paged_serve_spec`` (phase 14a's and 14b's) and, where phase 18c ran,
    ``paged_serve_moe`` (the MoE runs only then). Fails unless every
    request's tokens are bitwise theirs, the pins are (1, 3, 0) and (1,
    3, 1), the flash forward launched n_layers x (prefills +
    registrations + the warm-up's) with every prefill on the one rank,
    the pool is whole and ``n_chips`` is 1. Returns the paths' launches."""
    t0 = time.perf_counter()
    (r,) = _spawn(_paged_mesh_rank,
                  [(_free_port(), "paged_serve_moe" in refs)], 300,
                  "paged serve mesh one rank")
    paths = {}
    for tag in PAGED_MESH_PATHS:
        if tag not in r:
            continue
        run, ref = r[tag], refs[PAGED_MESH_REFS[tag]]
        verify = int(tag == "paged_mesh_spec")
        prefills = run["admitted"] + run["prefixes"]
        want = run["n_layers"] * (prefills + 1)
        same = run["tokens"] == ref["tokens"]
        print(f"paged mesh 23a {tag}: {r['world']} {r['backend']} rank, "
              f"pool split {run['pool']}; {run['completed']}/16 "
              f"requests, tokens bitwise {PAGED_MESH_REFS[tag]}'s: {same}; "
              f"programs {run['programs']}, prefills {run['prefills']}, "
              f"flash launches {run['launches']} (want n_layers x "
              f"(prefills + registrations + warm-up) = {want}), n_chips "
              f"{run['n_chips']}; warm-up {run['warm_s']:.3f} s (capture "
              f"{run['capture_s']:.3f} s, graph pools {run['pool_mb']:.1f} "
              f"MB); " + _latency_line(run) + "; one card "
              + _latency_line(ref) + f"; {card}")
        if not same:
            fail(f"paged mesh 23a {tag}: the tokens differ from "
                 f"{PAGED_MESH_REFS[tag]}'s")
        if run["programs"] != (1, 3, verify) or run["launches"] != want \
                or run["prefills"] != prefills \
                or run["outside"] != run["n_layers"] \
                or run["n_chips"] != 1 or run["pool"]:
            fail(f"paged mesh 23a {tag}: programs {run['programs']}, "
                 f"launches {run['launches']} (want {want}), prefills "
                 f"{run['prefills']}, outside a graph {run['outside']}, "
                 f"n_chips {run['n_chips']}, pool {run['pool']}")
        paths[tag] = {"flash_attention_fwd": run["launches"]}
    print(f"paged mesh 23a: phase wall {time.perf_counter() - t0:.1f} s")
    return paths


# phase 23b's serve CLI runs on one NCCL process a card, each with the
# one-card run it is held to
PAGED_MESH_CLI = (
    ("paged_mesh_cli", [*SERVE_ARGV, "--kv-page-tokens", "16"]),
    ("paged_mesh_cli_split", [*SERVE_ARGV, "--kv-page-tokens", "16",
                              "--kv-pages", "479"]),
    ("paged_mesh_cli_spec", [*SERVE_ARGV, "--kv-page-tokens", "16",
                             "--speculate-k", "4", "--shared-prefix",
                             str(PREFIX)]),
    ("paged_moe_mesh_cli", [*MOE_SERVE_ARGV, "--kv-page-tokens", "16"]),
    ("serve_tune_mesh_cli", [*SERVE_ARGV, "--serve-tune", "probe"]))
KILL_BOUND_S = 120


def _cli_procs(world: int, argv, save: Path, env=None):
    """``python -m tpudist_torch.serve`` as ``world`` processes under the
    env contract on the cards (one a card), saving under ``save``;
    returns (exit codes, outputs, wall)."""
    port = _free_port()
    base = {**os.environ, "TPUDIST_PLATFORM": "cuda",
            "PYTHONPATH": str(ROOT),
            "TPUDIST_VERDICT_PATH": str(save / "job_status.txt"),
            **(env or {})}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpudist_torch.serve", *argv, "--save-dir",
         str(save)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**base, "TPUDIST_COORDINATOR": f"localhost:{port}",
             "TPUDIST_NUM_PROCESSES": str(world),
             "TPUDIST_PROCESS_ID": str(r)}) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def _records(save: Path, kind: str):
    return [r for r in (json.loads(ln) for ln in
                        (save / "metrics.jsonl").read_text().splitlines())
            if r["kind"] == kind]


def serve_kill_mesh(torch, card: str, world: int):
    """Phase 23b's kill: phase 4's flags paged at one process a card with
    ``serve_kill@0:3`` under ``--requeue-attempt 0``, then attempt 1 in
    the same save directory. Fails unless rank 0 exits 137 with its
    flushed ``kind=chaos`` record and no summary, every other rank leaves
    non-zero naming its lost leader within ``KILL_BOUND_S``, attempt 1
    exits 0 on every rank with one summary, its lost rids are exactly
    attempt 0's admitted rids with no terminal event, and every rid lands
    in one terminal bucket across the attempts."""
    from tpudist_torch.serve import resilience as res_lib

    argv = [*SERVE_ARGV, "--kv-page-tokens", "16"]
    save = ROOT / "build" / "chip_smoke_serve" / "serve_kill_mesh"
    shutil.rmtree(save, ignore_errors=True)
    save.mkdir(parents=True)
    rcs, outs, wall = _cli_procs(world, argv + [
        "--chaos", "serve_kill@0:3", "--requeue-attempt", "0"], save)
    before = _records(save, "serve_request")
    print(f"serve kill 23b attempt 0: exit codes {rcs}, wall {wall:.2f} s "
          f"(bound {KILL_BOUND_S} s); rank 1: "
          + next((ln for ln in outs[1].splitlines()
                  if "lost its leader" in ln), "no lost-leader line")[:160])
    if rcs[0] != 137 or 0 in rcs[1:] or wall > KILL_BOUND_S \
            or _records(save, "serve") \
            or [r["fault"] for r in _records(save, "chaos")] \
            != ["serve_kill"] \
            or not all("lost its leader (rank 0)" in o for o in outs[1:]):
        fail(f"serve kill 23b: attempt 0 exit codes {rcs} in {wall:.2f} s"
             f", or a summary, or no chaos record, or no lost-leader exit")
    rcs, outs, wall = _cli_procs(world, argv + ["--requeue-attempt", "1"],
                                 save)
    events = _records(save, "serve_request")
    admitted = {r["rid"] for r in before if r["event"] == res_lib.ADMITTED}
    done = {r["rid"] for r in before if r["event"] in res_lib.TERMINAL_EVENTS}
    lost = {r["rid"] for r in events[len(before):]
            if r["event"] == res_lib.LOST}
    terminal = {}
    for r in events:
        if r["event"] in res_lib.TERMINAL_EVENTS:
            terminal.setdefault(r["rid"], []).append(r["event"])
    serve = _records(save, "serve")
    print(f"serve kill 23b attempt 1: exit codes {rcs}, wall {wall:.2f} s; "
          f"attempt 0 done {len(done)}, lost {sorted(lost)} (admitted "
          f"without an outcome {sorted(admitted - done)}); {len(terminal)} "
          f"rids terminal, once each "
          f"{all(len(v) == 1 for v in terminal.values())}; {card}")
    if rcs != [0] * world or not lost or lost != admitted - done \
            or sorted(terminal) != list(range(16)) \
            or any(len(v) != 1 for v in terminal.values()) \
            or len(serve) != 1 or serve[0]["n_chips"] != world:
        fail("serve kill 23b: the requeued attempt failed its checks")
    shutil.rmtree(save, ignore_errors=True)


def paged_mesh_cli(torch, fa, fx, card: str):
    """Phase 23b (two cards or more): :data:`PAGED_MESH_CLI` through the
    serve CLI as one NCCL process a card (:func:`_serve_rank`), each
    against its flags' run on one card (the tuner's against phase 4's
    dense flags: every candidate's greedy tokens are the dense ones), then
    :func:`serve_kill_mesh` and the serve drill's matrix at ``world`` the
    cards. Fails unless every rank exits 0 with ``success``, ``n_chips``
    is the cards, each rank's pin is (1, its ladder's rungs, verify), it
    ran every prefill (the admissions and a prefix's registration; at a
    dense point that splits the slots, the owners' prefills sum to the
    admissions) and its flash launches
    are n_layers x (its prefills + the warm-up's), the tuned point is
    one on every rank, the split pool holds 480 / cards rows a card plus
    its discard row, and every request's tokens equal the one-card run's
    or first diverge at a near-tie. Prints each card's pool bytes and
    tokens/s/chip, TTFT and ITL beside one card's. Returns the paths'
    launches (summed over the ranks)."""
    from tpudist_torch.obs import goodput
    from tpudist_torch.serve import drill
    from tpudist_torch.serve import scheduler as sched

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    refs = {"dense": _serve_cli(torch, fa, fx, "paged mesh 23b dense one "
                                "card", SERVE_ARGV)["summary"]}
    for tag, argv in PAGED_MESH_CLI[:4]:
        refs[tag] = _serve_cli(torch, fa, fx, f"{tag} one card", argv,
                               prefixes=int("--shared-prefix" in argv)
                               )["summary"]
    refs["serve_tune_mesh_cli"] = refs["dense"]
    paths, ties = {}, 0
    for tag, argv in PAGED_MESH_CLI:
        save = ROOT / "build" / "chip_smoke_serve" / tag
        shutil.rmtree(save, ignore_errors=True)
        verdict = save / "job_status.txt"
        port = _free_port()
        ranks = _spawn(_serve_rank,
                       [(r, world, port, argv + ["--save-dir", str(save)],
                         str(verdict)) for r in range(world)],
                       600, f"serve {tag}")
        statuses = [verdict.read_text() if verdict.is_file() else None] + [
            (save / f"job_status.txt.worker{r}").read_text()
            if (save / f"job_status.txt.worker{r}").is_file() else None
            for r in range(world)]
        tune = [json.loads(ln) for ln in (save / "metrics.jsonl")
                .read_text().splitlines()] if tag.startswith("serve_tune") \
            else []
        shutil.rmtree(save, ignore_errors=True)
        got = ranks[0]["summary"]
        if [r["rc"] for r in ranks] != [0] * world \
                or statuses != ["success"] * (world + 1) or got is None \
                or got["status"] != "success" or got["n_chips"] != world \
                or got["completed"] != got["requests"]:
            fail(f"serve {tag}: exit codes {[r['rc'] for r in ranks]}, "
                 f"final and worker verdicts {statuses}, summary "
                 f"{None if got is None else (got['status'], got['n_chips'], got['completed'])}")
        points = {r["point"] for r in ranks}
        verify = int(ranks[0]["point"][3] >= 2)
        prefills = got["admitted"] + int("--shared-prefix" in argv)
        # a dense point (the tuner's may be one) splits the slots: a
        # prefill runs on its slot's owner, 22b's rule
        owners = ranks[0]["point"][2] == 0 and ranks[0]["span"][1] \
            - ranks[0]["span"][0] < got["slots"]
        rows = None if "--kv-pages" not in argv else (480 // world, 480)
        for r in ranks:
            want = 4 * (r["prefills"] + 1)
            print(f"serve {tag}: rank {r['rank']} point {r['point']}, "
                  f"programs {r['programs']} + verify {r['verify']}, "
                  f"prefills {r['prefills']}, pool (ways, index, lo, rows, "
                  f"n_rows) {r['pool']}, card kv bytes {r['kv_bytes']}, flash "
                  f"launches {r['launches']} (want n_layers x (prefills + "
                  f"warm-up) = {want}), wall {r['wall']:.2f} s")
            if r["programs"] != (1, r["rungs"]) or r["verify"] != verify \
                    or r["launches"] != want or r["outside"] != 4 \
                    or not owners and r["prefills"] != prefills \
                    or (r["pool"] and tuple(r["pool"][3:5])) != rows:
                fail(f"serve {tag}: rank {r['rank']} programs "
                     f"{r['programs']} + {r['verify']}, launches "
                     f"{r['launches']} (want {want}), outside a graph "
                     f"{r['outside']}, prefills {r['prefills']} (want "
                     f"{prefills}), pool {r['pool']}")
        if len(points) != 1 or owners and sum(
                r["prefills"] for r in ranks) != prefills:
            fail(f"serve {tag}: the ranks served other points {points}, or "
                 f"the owners' prefills do not sum to {prefills}")
        if tune:
            rec = [t for t in tune if t["kind"] == "serve_tune"]
            print(f"serve {tag}: {len(rec)} serve_tune record(s); "
                  + (_tune_line(rec[0]) if rec else ""))
            if len(rec) != 1 or rec[0]["status"] != "success" \
                    or rec[0]["pruned"]:
                fail(f"serve {tag}: serve_tune records {rec}")
        ref = refs[tag]
        if got["tokens"] != _tokens_of(ref):
            cfg, ref_params = _cli_params(torch, argv)
            stream = sched.make_requests(
                16, prompt_pad=512, vocab_size=cfg.vocab_size, max_new=32,
                rate=0.0, seed=0,
                prefix_len=PREFIX if "--shared-prefix" in argv else 0)
            ties += _near_ties(torch, ref_params, cfg, stream,
                               _tokens_of(ref), got["tokens"],
                               f"serve {tag}")
            del ref_params
            torch.cuda.empty_cache()
        print(f"serve {tag}: {world} NCCL processes, status "
              f"{got['status']}, n_chips {got['n_chips']}, tokens equal one "
              f"card's {got['tokens'] == _tokens_of(ref)}; {world} cards "
              + _latency_line(got) + "; one card " + _latency_line(ref)
              + f"; {card}")
        paths[tag] = {"flash_attention_fwd": sum(r["launches"]
                                                 for r in ranks)}
    serve_kill_mesh(torch, card, world)

    run_dir = ROOT / "build" / "chip_smoke_drill_mesh"
    shutil.rmtree(run_dir, ignore_errors=True)
    t1 = time.perf_counter()
    with _drill_env({"TPUDIST_PLATFORM": "cuda", "PYTHONPATH": str(ROOT)}):
        results = drill.run_matrix(str(run_dir), model=DRILL_MODEL,
                                   world=world)
    report = drill.verify_matrix(str(run_dir), results)
    for sc, res in results["scenarios"].items():
        attempts = []
        for d in res["dirs"]:
            attempts += goodput.load_jsonl(str(run_dir / d /
                                               goodput.ATTEMPTS_NAME))
        print(f"serve drill 23b {sc}: ok {report['scenarios'][sc]['ok']}, "
              f"rcs {res['rcs']}, followers {res['follower_rcs']}, "
              f"{len(attempts)} attempt(s) "
              f"{sum(a['end_ts'] - a['start_ts'] for a in attempts):.3f} s; "
              f"problems {report['scenarios'][sc]['problems']}")
    print(f"serve drill 23b: matrix {'ok' if report['ok'] else 'NOT ok'} "
          f"at world {world} in {time.perf_counter() - t1:.1f} s; {card}")
    if not report["ok"]:
        fail("serve drill 23b: a scenario failed its verifier")
    shutil.rmtree(run_dir, ignore_errors=True)
    print(f"paged mesh 23b: {ties} near-tie divergence(s); phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return paths


def plain_attention(torch, fa):
    """Attention through the plain versions on the card, forward and
    backward: the reference the step-level check holds the kernels
    against."""
    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, cos, sin, causal):
            o, lse = fa.flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                              causal=causal)
            ctx.save_for_backward(q, k, v, o, lse, cos, sin)
            ctx.causal = causal
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse, cos, sin = ctx.saved_tensors
            dq, dk, dv = fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, torch.zeros_like(lse), cos=cos,
                sin=sin, causal=ctx.causal)
            return dq, dk, dv, None, None, None

    def attention(q, k, v, *, cos=None, sin=None, causal=True):
        return Plain.apply(q, k, v, cos, sin, causal)
    attention.accepts_rope = True
    return attention


def plain_head(torch, fx):
    """The fused head through the kernels' plain versions on the card,
    forward and backward: the step-level check's reference for it."""
    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, emb, tgt):
            loss, lse = fx.fused_xent_fwd_plain(h, emb, tgt)
            ctx.save_for_backward(h, emb, tgt, lse)
            return loss

        @staticmethod
        def backward(ctx, ct):
            h, emb, tgt, lse = ctx.saved_tensors
            return (*fx.fused_xent_bwd_plain(h, emb, tgt, lse, ct), None)

    def head(emb, h, targets):
        b, s, d = h.shape
        return torch.mean(Plain.apply(h.reshape(b * s, d), emb,
                                      targets.reshape(b * s)))
    return head


def head_vs_f64(torch, fx, h, emb, tgt) -> str:
    """The fused head alone at a training step's data: max |x - float64|
    / max |float64| of lse, dh and dE (ct = 1 / t), for the kernels and
    for the plain versions."""
    t = h.shape[0]
    ct = torch.full((t,), 1.0 / t, device="cuda")
    with torch.no_grad():
        _, lse = fx.fused_xent_fwd(h, emb, tgt)
        kernel = (lse, *fx.fused_xent_bwd(h, emb, tgt, lse, ct))
        _, lse = fx.fused_xent_fwd_plain(h, emb, tgt)
        plain = (lse, *fx.fused_xent_bwd_plain(h, emb, tgt, lse, ct))
        hd, ed = h.double(), emb.double()
        dl = hd @ ed.T
        lse = torch.logsumexp(dl, dim=1)
        dl = torch.exp(dl - lse[:, None])
        dl[torch.arange(t, device="cuda"), tgt] -= 1.0
        dl /= t
        exact = (lse, dl @ ed, dl.T @ hd)
        del dl
    errs = []
    for name, k, p, x in zip(("lse", "dh", "dE"), kernel, plain, exact):
        m = x.abs().max()
        errs.append(f"{name} {((k.double() - x).abs().max() / m).item():.2e} "
                    f"(plain {((p.double() - x).abs().max() / m).item():.2e})")
    return "; ".join(errs)


def step_check(torch, fa, fx, seq: int, fused: bool = False):
    """Phase 7: one training step's loss and every param grad at full
    width, through the kernels and through the plain versions on the
    card, within f32 1e-4 (max |d| / max |plain| per tensor). ``fused``
    takes the fused LM head (its kernels against their plain versions)
    where the plain whole-logits head is the default."""
    from tpudist_torch import data as data_lib
    from tpudist_torch.config import flagship_model_config
    from tpudist_torch.models import transformer

    cfg = flagship_model_config(seq)
    model = transformer.init(
        cfg, generator=torch.Generator(device="cuda").manual_seed(42))
    tokens = torch.as_tensor(data_lib.make_synthetic_tokens(
        8, seq + 1, cfg.vocab_size, 42), device="cuda").long()

    def loss_and_grads(attn_impl, head):
        h = transformer.hidden_states(model, tokens[:, :-1], cfg,
                                      dtype=torch.float32,
                                      attn_impl=attn_impl)
        loss = head(model.embed, h, tokens[:, 1:])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), grads, h.detach()

    def kernel_head(emb, h, targets):
        return transformer.head_loss(emb, h, targets, fused_xent=fused)

    before = _launch_counts(fa, fx)
    loss_k, grads_k, h = loss_and_grads(transformer._attention, kernel_head)
    ran = {k: v - before[k] for k, v in _launch_counts(fa, fx).items()}
    loss_p, grads_p, _ = loss_and_grads(
        plain_attention(torch, fa),
        plain_head(torch, fx) if fused else kernel_head)
    torch.cuda.synchronize()
    errs = {"loss": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())}
    for (name, _), gk, gp in zip(model.named_parameters(), grads_k,
                                 grads_p):
        errs[name] = ((gk - gp).abs().max()
                      / gp.abs().max().clamp_min(1e-30)).item()
    worst = max(errs, key=errs.get)
    tag = f"seq {seq}{' fused head' if fused else ''}"
    print(f"step check {tag}: loss {loss_k.item():.6f} (kernels) vs "
          f"{loss_p.item():.6f} (plain); worst relative error "
          f"{errs[worst]:.3e} ({worst}) over the loss and "
          f"{len(errs) - 1} grads (tol 1e-4); kernel launches {ran}")
    if fused:
        print(f"step check {tag}: the head alone against float64, max |d| "
              f"/ max |f64|: " + head_vs_f64(
                  torch, fx, h.reshape(-1, cfg.d_model), model.embed.detach(),
                  tokens[:, 1:].reshape(-1)))
    del model, grads_k, grads_p, h
    torch.cuda.empty_cache()
    if errs[worst] > 1e-4 or not math.isfinite(errs[worst]):
        fail(f"step check {tag}: {worst} off by {errs[worst]:.3e}")
    merged = fa.uses_merged_backward(seq, seq)
    if not ran["flash_attention_bwd_dqkv" if merged
               else "flash_attention_bwd_dkv"]:
        fail(f"step check {tag}: the backward kernels did not run")
    if fused and (ran["fused_xent_fwd"], ran["fused_xent_bwd"]) != (1, 1):
        fail(f"step check {tag}: the fused head kernels did not run once")


def profile_train(torch, seq: int, lm_head: str = "plain",
                  dtype: str = "float32"):
    """--profile: device time by kernel over two steady training steps at
    full width with the ``lm_head`` head in ``dtype`` (bf16 with the bf16
    Adam second moment, as phase 9), and the device's busy share of their
    wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib

    cfg = config_lib.parse_args(
        ["--model", "transformer", "--seq-len", str(seq),
         "--train-batch-size", "8", "--lm-head", lm_head, "--dtype", dtype]
        + (["--adam-nu-dtype", "bfloat16"] if dtype == "bfloat16" else []))
    dev = torch.device("cuda")
    state = engine_lib.init_state(cfg, dev)
    step = engine_lib.make_train_step(cfg, dev)
    batch = (torch.as_tensor(data_lib.make_synthetic_tokens(
        8, seq + 1, cfg.model.vocab_size), device=dev).long(),)
    state, loss = step(state, batch)
    loss.item()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, loss = step(state, batch)
        loss.item()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(r[1] for r in rows)
    print(f"profile: 2 train steps at seq {seq} {dtype}, --lm-head "
          f"{lm_head}: "
          f"{wall:.3f} ms wall, "
          f"device kernel time {busy:.3f} ms ({100 * busy / wall:.1f}% "
          f"busy)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"profile:   {ms:9.3f} ms {100 * ms / busy:5.1f}% {count:5d}x"
              f"  {key[:80]}")
    head = [r for r in rows if "xent_" in r[0]]
    if head:
        ms = sum(r[1] for r in head)
        print(f"profile:   the fused head's kernels: {ms:.3f} ms "
              f"({100 * ms / busy:.1f}%, {sum(r[2] for r in head)} "
              f"launches)")
    del state
    torch.cuda.empty_cache()


def mma_peaks(torch, build):
    """--profile: the rate the tensor cores reach through mma.sync, the
    flash forward's instruction (``tpudist_torch/csrc/mma_peak.cu``:
    independent accumulator chains, no loads, 4 blocks of 8 warps an
    SM), beside the data sheet's dense peaks, which only wgmma reaches."""
    import ctypes

    fn = build.load("mma_peak", ("mma_peak.cu",)).tpudist_mma_peak
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float)]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, name, peak in ((0, "TF32 m16n8k8", 495.0),
                             (1, "bf16 m16n8k16", 989.0)):
        rate = ctypes.c_float()
        err = fn(kind, 4 * sms, 2000, ctypes.byref(rate))
        if err:
            fail(f"mma_peak ({name}) failed: cudaError {err}")
        print(f"profile: mma.sync {name}: {rate.value:.1f} TFLOP/s "
              f"({100 * rate.value / peak:.1f} % of the data sheet's "
              f"{peak:.0f} dense)")


def _profiled(torch, fn):
    """``fn()`` under torch.profiler, fenced: its wall ms and the device
    kernels' (name, ms, count) rows."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [(e.key, e.device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_time_total > 0
                  and e.device_type.name == "CUDA"]


def profile_superstep(torch, tag: str, argv, k: int):
    """--profile: phase 11's configuration ``argv``: one replayed k-step
    superstep against k per-step steps on the same state and batches,
    each window's wall, device kernel time and busy share."""
    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.parallel import staging as staging_lib

    cfg = config_lib.parse_args(argv)
    dev = torch.device("cuda")
    if cfg.model.name == "mlp":
        sources = data_lib.make_synthetic_data(
            cfg.data.n_samples, cfg.data.n_features, cfg.data.seed)
    else:
        sources = (data_lib.make_synthetic_tokens(
            cfg.data.n_samples, cfg.model.max_seq_len + 1,
            cfg.model.vocab_size, cfg.data.seed),)
    plan = data_lib.plan_epoch(sources, batch_size=cfg.batch_size,
                               seed=cfg.seed, epoch=0)
    slab = staging_lib.put_slab(plan.slab(0, k), dev).arrays_for()
    state = engine_lib.init_state(cfg, dev)
    sup = engine_lib.make_superstep(cfg, dev, k)
    step = engine_lib.make_train_step(cfg, dev)
    total = torch.zeros((), device=dev)
    for _ in range(2):          # the eager warm-up and captures, a replay
        state, total, _ = sup(state, total, slab, 0, k)
    for i in range(k):
        state, _ = step(state, tuple(a[i] for a in slab))

    def replay():
        sup(state, total, slab, 0, k)[2].cpu()

    def per_step():
        for i in range(k):
            loss = step(state, tuple(a[i] for a in slab))[1]
        loss.cpu()

    for how, fn in (("one replayed superstep", replay),
                    (f"{k} per-step steps", per_step)):
        wall, rows = _profiled(torch, fn)
        busy = sum(r[1] for r in rows)
        print(f"profile: {tag}, {how} (k={k}): {wall:.3f} ms wall, "
              f"device kernel time {busy:.3f} ms "
              f"({100 * busy / wall:.1f}% busy), "
              f"{sum(r[2] for r in rows)} kernels")
    del state, sup, step
    torch.cuda.empty_cache()


def profile_serve(torch, engine, params, requests):
    """Device time by kernel in windows at the slice's shapes, one
    prefill per slot and then one decode superstep over the full batch,
    each replayed from its graph and run as the engine's eager body, and
    the device's busy share of each window's wall time (the profiler's
    own host cost is inside the wall). Returns each window's (wall ms,
    busy ms, flash forward kernels)."""
    out = {}

    def window(name, fn):
        wall, rows = _profiled(torch, fn)
        busy = sum(r[1] for r in rows)
        flash = sum(c for k, _, c in rows if "flash_fwd_kernel" in k)
        print(f"profile: {name}: {wall:.3f} ms wall, device kernel time "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy), "
              f"flash_fwd_kernel x{flash}")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"profile:   {ms:9.3f} ms {count:5d}x  {key[:80]}")
        out[name] = (wall, busy, flash)

    for how, eng in (("graphs", engine), ("eager bodies",
                                          _EagerBodies(engine))):
        state = engine.init_state()

        def prefills():
            for slot, req in enumerate(requests[:engine.slots]):
                eng.prefill(params, state, req.tokens[None, :],
                            req.prompt_len, slot, req.max_new)[1].item()

        def superstep():
            eng.decode(params, state)[1].cpu()

        window(f"{engine.slots} prefills, {how}", prefills)
        window(f"one decode superstep ({engine.decode_k} steps, "
               f"{engine.slots} slots), {how}", superstep)
    n = engine.model_cfg.n_layers * engine.slots
    print(f"profile: flash_fwd_kernel in the replayed prefills: "
          f"{out[f'{engine.slots} prefills, graphs'][2]} (n_layers x "
          f"prefills = {n})")
    return out


def profile_paged(torch, engine, params, requests):
    """--profile: device time by kernel of one replayed paged decode
    superstep and one replayed verify dispatch over the full batch (each
    slot prefilled into private pages), and each window's busy share;
    phase 4's dense superstep is profiled beside it (``profile_serve``)."""
    state = engine.init_state()
    alloc = engine.new_allocator()
    width = engine.decode_k + engine.speculate_k
    for slot, req in enumerate(requests[:engine.slots]):
        if not (alloc.admit(slot, req.prompt_len)
                and alloc.ensure(slot, req.prompt_len + width)):
            fail("profile: the paged pool cannot hold the window")
        engine.prefill(params, state, req.tokens[None, :], req.prompt_len,
                       slot, req.max_new)[1].item()
    draft = [[0] * (engine.speculate_k - 1)] * engine.slots
    for name, fn in (
            (f"one paged decode superstep ({engine.decode_k} steps, "
             f"{engine.slots} slots), graphs",
             lambda: engine.decode(params, state)[1].cpu()),
            (f"one verify dispatch (window {engine.speculate_k}, "
             f"{engine.slots} slots), graphs",
             lambda: engine.verify(params, state, draft)[1].cpu())):
        wall, rows = _profiled(torch, fn)
        busy = sum(r[1] for r in rows)
        print(f"profile: {name}: {wall:.3f} ms wall, device kernel time "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}% busy)")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"profile:   {ms:9.3f} ms {count:5d}x  {key[:80]}")


# ------------------------------------------------ phase 24: the expert axis

EXPERT_PATHS = ("train_expert_body", "train_expert_superstep")
# 24b holds its mesh runs to one card's in f32: 18a's flags with f32
# compute and Adam nu, over 16 samples (2 steps an epoch; k = 2, so
# epoch 0's window runs eager with the captures and epoch 1's replays).
# In bf16 the expert ranks sum their partial outputs (and the tokens' and
# gates' partial grads) across cards in bf16, where one card sums them
# inside one product: over 18a's 8 steps that moved the second eval loss
# by 0.30 of 10.95 at --expert 4 (--fsdp 4, no expert axis: 0.043); and
# over 8 steps even f32 drifts 0.3 % at --data 2 --expert 2 (PERF.md §6).
# The bf16 run at 18a's own flags is measured beside 18a's and held to
# 5e-2, which says it trains and lands near one card and no more: the
# fault of --expert-drift (the exit's all-reduce left out) moves it by
# 0.071 and passes. The f32 holds over 4 steps are the fault check:
# that fault moves them by 0.023 at step 2 and 0.28 by the end
EXPERT_F32_ARGV = [*MOE_TRAIN_ARGV[:MOE_TRAIN_ARGV.index("--n-samples")],
                   "--n-samples", "16", "--epochs", "2", "--seed", "42",
                   "--log-every", "2", "--dtype", "float32",
                   "--adam-nu-dtype", "float32",
                   *MOE_TRAIN_ARGV[MOE_TRAIN_ARGV.index("--lm-head"):]]
EXPERT_BF16_RTOL = 5e-2


def _expert_body_rank(port, queue):
    """Phase 24a in a process of its own: a one-rank NCCL group and its
    mesh, with the mesh's one-rank expert group handed to the layout, so
    the step runs the expert path (the routed FFN's two entries and its
    exit over the expert group, this rank's columns of dispatch and
    combine) with every collective issued. Phase 18a's configuration
    (``MOE_TRAIN_ARGV``) per-step over 18a's two epochs (4 steps, then
    the eval batch, each), then as the k = 4 superstep over the same
    steps (epoch 0's window eager with the two captures, epoch 1's
    replayed). Launch counts set to 0 just before each run and read just
    after."""
    import torch

    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.obs import devtime as devtime_lib
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    from tpudist_torch.parallel import distributed
    from tpudist_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed.initialize(f"localhost:{port}", 1, 0, device="cuda")
    dev = ctx.device
    cfg = config_lib.parse_args(MOE_TRAIN_ARGV)
    m = cfg.model
    mesh = mesh_lib.build_mesh(cfg.parallel, device_type="cuda")
    # the train CLI's data, epoch plans and eval batch
    tokens = data_lib.make_synthetic_tokens(
        cfg.data.n_samples, m.max_seq_len + 1, m.vocab_size, cfg.data.seed)
    slabs = [torch.as_tensor(data_lib.plan_epoch(
        (tokens,), batch_size=cfg.batch_size, seed=cfg.seed,
        epoch=e).slab(0, 4)[0], device=dev).long() for e in range(2)]
    eval_batch = data_lib.to_device((data_lib.make_synthetic_tokens(
        cfg.batch_size, m.max_seq_len + 1, m.vocab_size,
        cfg.data.seed + 1),), dev)

    def expert_state():
        state = engine_lib.init_state(cfg, dev, mesh)
        state.layout.expert_group = mesh.get_group("expert")
        return state

    def leaves(state):
        return [t.detach().clone() for t in (
            *state.params.parameters(), *state.opt_state.mu,
            *state.opt_state.nu)]

    out = {"rank": 0, "world": ctx.process_count,
           "mesh": mesh_lib.mesh_shape(mesh)}
    state = expert_state()
    lay = state.layout
    step = engine_lib.make_train_step(cfg, dev, mesh)
    ev = engine_lib.make_eval_fn(cfg, dev, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches(fa, fx)
    losses, evals, ms = [], [], []
    for e in range(2):
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, (slabs[e][i],))
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
        evals.append(ev(state, eval_batch).item())
    torch.cuda.synchronize()
    out.update(losses=losses, evals=evals, ms=ms,
               counts=_launch_counts(fa, fx),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               ops=devtime_lib.collective_bytes(step.reduced_operands()),
               n_all_reduce=sum(op == "all_reduce" for op, _, _ in
                                step.reduced_operands()),
               # one a param the spec keeps whole over fsdp, the loss's,
               # and the expert path's three a layer
               want_all_reduce=(sum(d is None for d in lay.dims) + 1
                                + 3 * m.n_layers))
    per_step = leaves(state)
    del state
    torch.cuda.empty_cache()

    state = expert_state()
    sup = engine_lib.make_superstep(cfg, dev, 4, mesh)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    _reset_launches(fa, fx)
    sup_losses, sup_evals = [], []
    for e in range(2):
        t0 = time.perf_counter()
        state, total, got = sup(state, total, (slabs[e],), 0, 4)
        sup_losses += got.tolist()
        out[f"window{e}_s"] = time.perf_counter() - t0
        sup_evals.append(ev(state, eval_batch).item())
    torch.cuda.synchronize()
    out.update(sup_counts=_path_launches(fa, fx, [sup]),
               graphs=(sup.programs, dict(sup.replays)),
               pool_mb=sup.graph_pool_bytes / 2**20,
               sup_losses=sup_losses, sup_evals=sup_evals,
               sup_same=(sup_losses == losses and sup_evals == evals
                         and all(torch.equal(x, y) for x, y in
                                 zip(leaves(state), per_step))))
    sup.release()
    del state, per_step
    distributed.shutdown()
    queue.put(out)


def expert_body(torch, fa, card: str, ref):
    """Phase 24a (one card): :func:`_expert_body_rank` in a spawned
    process. Fails unless its step losses at 18a's step records and its
    eval losses are bitwise 18a's (``ref``: :func:`moe_train`'s
    ``details``), its superstep bitwise its per-step run (2 programs, one
    replay: the expert operators' all-reduces captured), both runs'
    launches exact (flash forward 4 x (8 steps + 2 evals), the merged
    backward 4 x 8, the fused head 10 and 8), and the step's all-reduces
    those of the sharded body with the expert path's three a layer.
    Prints the collective rows, the step times and the peak memory.
    Returns the two paths' launches."""
    from tpudist_torch import config as config_lib

    t0 = time.perf_counter()
    cfg = config_lib.parse_args(MOE_TRAIN_ARGV)
    m = cfg.model
    (r,) = _spawn(_expert_body_rank, [(_free_port(),)], 600,
                  "train expert body")
    want = want_launches(fa, m, 512, 8, 2, fused=True)
    got = ([r["losses"][3], r["losses"][7]], r["evals"])
    want18 = (ref["losses"], [ev for _, ev in ref["epochs"]])
    print(f"train expert body: 18a's MoE (V{m.vocab_size} L{m.n_layers} "
          f"d{m.d_model} E{m.n_experts} top{m.expert_top_k}), {cfg.dtype}, "
          f"adam nu {cfg.adam_nu_dtype}, fused head, batch 8, seq 512, mesh "
          f"{r['mesh']} ({r['world']} NCCL rank) with its expert group; "
          f"{card}")
    print(f"train expert body: step losses {r['losses']}, evals "
          f"{r['evals']}; at 18a's step records and evals {got}, 18a's "
          f"{want18}: bitwise {got == want18}")
    step_ms = statistics.median(r["ms"][1:])
    t18 = ref["timing"]
    print(f"train expert body: step {step_ms:.3f} ms per-step (median "
          f"after the first, host clock fenced a step) against 18a's "
          f"superstep {1e3 * t18['run_s'] / t18['steps']:.3f} ms; peak "
          f"device memory {r['peak_gb']:.3f} GB (18a's superstep run "
          f"{ref['peak_gb']:.3f}); graph pool {r['pool_mb']:.1f} MB")
    for row in r["ops"]["ops"]:
        print(f"train expert body: collective {row['op']} {row['dtype']} "
              f"{row['bytes']} B x {row['count']} a step")
    print(f"train expert body: superstep k=4 losses {r['sup_losses']}, "
          f"evals {r['sup_evals']}, bitwise its per-step run: "
          f"{r['sup_same']}; (programs, replays) {r['graphs']}; windows "
          f"{r['window0_s']:.3f} s (eager + captures), "
          f"{r['window1_s']:.3f} s (replayed)")
    print(f"train expert body: {r['n_all_reduce']} all-reduces a step "
          f"(want {r['want_all_reduce']}); kernel launches {r['counts']}, "
          f"superstep {r['sup_counts']} (want {want})")
    if got != want18:
        fail(f"train expert body: losses {got} are not bitwise 18a's "
             f"{want18}")
    if not r["sup_same"]:
        fail("train expert body: the superstep is not bitwise its "
             "per-step run")
    if r["graphs"] != (2, {"superstep": 1, "step": 0}):
        fail(f"train expert body: (programs, replays) {r['graphs']}")
    if r["n_all_reduce"] != r["want_all_reduce"]:
        fail(f"train expert body: {r['n_all_reduce']} all-reduces a "
             f"step, the expert path issues {r['want_all_reduce']}")
    for tag, counts in zip(EXPERT_PATHS, (r["counts"], r["sup_counts"])):
        if counts != want:
            fail(f"train expert body: {tag} kernel launches {counts}, "
                 f"want {want}")
    print(f"train expert body: phase 24a {time.perf_counter() - t0:.1f} s")
    return dict(zip(EXPERT_PATHS, (r["counts"], r["sup_counts"])))


def _expert_gap(got, want, rtol: float):
    """``got``'s and ``want``'s step losses and epochs (Avg, eval), their
    largest ``|d|`` and largest ``|d| - rtol |want|``."""
    a = got["losses"] + [x for ep in got["epochs"] for x in ep]
    b = want["losses"] + [x for ep in want["epochs"] for x in ep]
    err = max((abs(x - y) - rtol * abs(y) for x, y in zip(a, b)),
              default=math.inf)
    worst = max((abs(x - y) for x, y in zip(a, b)), default=math.inf)
    return a, b, worst, err


def _expert_close(tag: str, got, want, rtol: float, atol: float,
                  count: int) -> None:
    """``got``'s step losses and epochs (Avg, eval) within ``rtol`` /
    ``atol`` of ``want``'s, ``count`` of them on each side (the step
    records and twice the epochs)."""
    a, b, worst, err = _expert_gap(got, want, rtol)
    print(f"train {tag}: step losses and epochs (Avg, eval) {a} against "
          f"one card's {b}: max |d| {worst:.6f}")
    if len(a) != count or len(b) != count or err > atol:
        fail(f"train {tag}: the losses are not within rtol {rtol} / atol "
             f"{atol} of one card's")


def _one_card(torch, fa, fx, tag: str, argv, n_accum: int = 1):
    """One card's run of ``argv`` (the train CLI in this process): the
    contract, exact launches; its step losses, epochs and timing."""
    from tpudist_torch import config as config_lib

    cfg = config_lib.parse_args(argv)
    m = cfg.model
    run = _cli_run(torch, fa, fx, tag, argv)
    losses = [r["loss"] for r in run["recs"] if r["kind"] == "step"]
    check_contract(tag, run["out"], cfg.epochs, losses)
    want = want_launches(fa, m, m.max_seq_len, n_accum * cfg.epochs * (
        cfg.data.n_samples // cfg.batch_size), cfg.epochs,
        fused=cfg.lm_head == "fused")
    if run["counts"] != want:
        fail(f"train {tag}: kernel launches {run['counts']}, want {want}")
    print(f"train {tag}: one card, step losses {losses}; "
          + _step_line(run, cfg.batch_size * m.max_seq_len))
    return run["counts"], {"losses": losses, "epochs": _epochs_of(run),
                           "timing": run["timing"]}


def expert_cli(torch, fa, fx, card: str, ref):
    """Phase 24b (two cards or more): the train CLI at one NCCL process
    a card, the superstep (k = 4) with ``--profile-window 1`` (epoch 1's
    replayed window). At phase 18a's flags, ``--expert <cards>`` beside
    18a's run (``ref``), held to ``EXPERT_BF16_RTOL``. Then in f32 over
    4 steps (``EXPERT_F32_ARGV``), each held to one card's run of the
    same flags at rtol 2e-3 / atol 2e-4: ``--expert <cards>``; with four cards or
    a multiple, ``--data 2 --expert 2``, ``--fsdp 2 --expert 2`` and
    ``--tensor 2 --expert 2``; and the two shapes of the global routing
    at ``--fsdp <cards>`` (the batch split over every card; at ``--data``
    alone each card routes its own rows, as the JAX package's
    data-parallel path does): ``--moe-group-size 2048`` (groups of 2048
    tokens over ranks of 4096 / cards) and ``--grad-accum-steps 2``.
    Every verdict ``success``, exact launches on every rank. Prints, for
    each, each rank's params and Adam bytes against the whole state's,
    the step time and tokens/s/chip beside one card's, and rank 0's
    exposed communication share of the window. Returns the paths'
    launches."""
    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    tokens = 8 * 512
    window = ["--profile-window", "1"]
    # (tag, flags, its one-card reference's tag and flags); the first at
    # 18a's flags beside 18a's run, the rest in f32
    runs = [("train_moe_bf16_expert", ["--expert", str(world)], None, [])]
    meshes = [("expert", ["--expert", str(world)])]
    if world % 4 == 0:
        meshes += [("d2e2", ["--data", "2", "--expert", "2"]),
                   ("f2e2", ["--fsdp", "2", "--expert", "2"]),
                   ("t2e2", ["--tensor", "2", "--expert", "2"])]
    runs += [(f"train_moe_f32_{name}", flags, "train_moe_f32_one", [])
             for name, flags in meshes]
    for name, extra in (("span", ["--moe-group-size", "2048"]),
                        ("accum", ["--grad-accum-steps", "2"])):
        runs.append((f"train_moe_f32_{name}", ["--fsdp", str(world)] + extra,
                     f"train_moe_f32_one_{name}", extra))
    paths, ones = {}, {None: ref}
    for tag, flags, one_tag, one_flags in runs:
        n_accum = 2 if "--grad-accum-steps" in flags else 1
        argv = MOE_TRAIN_ARGV if one_tag is None else EXPERT_F32_ARGV
        if one_tag not in ones:
            paths[one_tag], ones[one_tag] = _one_card(
                torch, fa, fx, one_tag, argv + one_flags, n_accum)
        one = ones[one_tag]
        whole = _whole_bytes(argv)
        run = _mesh_cli(torch, fa, card, tag, argv + flags + window, 512,
                        fused=True, n_accum=n_accum)
        got = {"losses": run["losses"],
               "epochs": [(r["avg_loss"], r["eval_loss"])
                          for r in run["recs"] if r["kind"] == "epoch"]}
        if one_tag is None:
            _expert_close(tag, got, one, EXPERT_BF16_RTOL, EXPERT_BF16_RTOL,
                          6)
        else:
            _expert_close(tag, got, one, FSDP_RTOL, FSDP_ATOL, 6)
        t, t1 = run["timing"], one["timing"]
        ms, ms1 = (1e3 * x["run_s"] / x["steps"] for x in (t, t1))
        tps, tps1 = (tokens * x["steps"] / x["run_s"] / n
                     for x, n in ((t, world), (t1, 1)))
        print(f"train {tag}: step {ms:.3f} ms against one card's "
              f"{ms1:.3f} ({ms / ms1:.3f}x); tokens/s/chip {tps:.1f} "
              f"against {tps1:.1f} ({tps / tps1:.3f}x); k="
              f"{t['steps_per_dispatch']}; {card}")
        for r in run["ranks"]:
            print(f"train {tag}: rank {r['rank']} params "
                  f"{r['params_bytes'] / 2**20:.1f} MiB against "
                  f"{whole / 2**20:.1f} whole, Adam mu + nu "
                  f"{r['opt_bytes'] / 2**20:.1f} MiB; peak "
                  f"{r['peak_gb']:.3f} GB")
        dev = [r for r in run["recs"] if r["kind"] == "devtime"]
        rec = dev[0] if dev else {}
        print(f"train {tag}: rank 0's window {rec.get('window_s')} s over "
              f"{rec.get('dispatches')} dispatch(es): compute "
              f"{rec.get('compute_s')} s, comm {rec.get('comm_s')} s, "
              f"exposed {rec.get('exposed_comm_s')} s, exposed share "
              f"{rec.get('exposed_comm_frac')} ({rec.get('comm_status')})")
        if "--expert" in flags and not all(
                r["params_bytes"] < 0.7 * whole for r in run["ranks"]):
            fail(f"train {tag}: a rank holds more than 0.7 of the params")
        if rec.get("dispatches") != 1:
            fail(f"train {tag}: no device window: {rec}")
        paths[tag] = run["counts"]
    print(f"train expert cli: phase 24b {time.perf_counter() - t0:.1f} s")
    return paths


def _exit_fault_rank(rank, world, port, argv, verdict, queue):
    """``_dp_train_rank`` with a fault planted for ``--expert-drift``:
    the routed FFN's exit returns this rank's partial output, its
    all-reduce over the expert group left out."""
    from tpudist_torch.parallel import tensor as tensor_lib

    tensor_lib.StepGroups.exit = lambda self, x, group=None: x
    _dp_train_rank(rank, world, port, argv, verdict, queue)


def expert_drift(torch, fa, fx, card: str) -> int:
    """``--expert-drift`` (two cards or more): what 24b's holds tell
    apart. A mesh without the expert axis (``--fsdp <cards>``) beside one
    card at 18a's flags (bf16, 8 steps) and in f32 over 8 steps, where
    24b's ``--expert`` runs drifted; the fault of ``_exit_fault_rank``
    at ``--expert <cards>``, at 18a's flags and in f32 over 24b's 4
    steps; and 24b's routing group spanning ranks (``--fsdp <cards>
    --moe-group-size 2048``) at a second seed. Prints each run's
    ``|d|`` to one card's run of the same flags and whether 24b's hold
    (``EXPERT_BF16_RTOL``; f32 rtol 2e-3 / atol 2e-4) passes it; fails
    only if a run fails."""
    t0 = time.perf_counter()
    w = str(torch.cuda.device_count())
    f32_8 = EXPERT_F32_ARGV + ["--n-samples", "32"]
    span7 = EXPERT_F32_ARGV + ["--seed", "7", "--moe-group-size", "2048"]
    bf16 = (EXPERT_BF16_RTOL, EXPERT_BF16_RTOL)
    f32 = (FSDP_RTOL, FSDP_ATOL)
    # (tag, argv, the mesh's flags, the rank's process, the hold)
    runs = [("drift_bf16_fsdp", MOE_TRAIN_ARGV, ["--fsdp", w], None, bf16),
            ("drift_bf16_fault", MOE_TRAIN_ARGV, ["--expert", w],
             _exit_fault_rank, bf16),
            ("drift_f32_fault", EXPERT_F32_ARGV, ["--expert", w],
             _exit_fault_rank, f32),
            ("drift_f32_8_fsdp", f32_8, ["--fsdp", w], None, f32),
            ("drift_f32_span_seed7", span7, ["--fsdp", w], None, f32)]
    ones = {}
    for tag, argv, flags, rank_fn, (rtol, atol) in runs:
        if tuple(argv) not in ones:
            ones[tuple(argv)] = _one_card(torch, fa, fx, f"{tag}_one",
                                          argv, 1)[1]
        one = ones[tuple(argv)]
        run = _mesh_cli(torch, fa, card, tag, argv + flags, 512,
                        fused=True, rank_fn=rank_fn)
        got = {"losses": run["losses"], "epochs": [
            (r["avg_loss"], r["eval_loss"]) for r in run["recs"]
            if r["kind"] == "epoch"]}
        a, b, worst, err = _expert_gap(got, one, rtol)
        print(f"drift {tag}: step losses and epochs (Avg, eval) {a} "
              f"against one card's {b}: |d| "
              f"{[abs(x - y) for x, y in zip(a, b)]}, max {worst:.6f}; "
              f"24b's hold (rtol {rtol} / atol {atol}) "
              f"{'passes' if err <= atol else 'fails'} it; {card}")
    print(f"expert drift: {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CONTEXT_PATHS = ("train_context_ring_virtual",)
# 25b: BASELINE config #5 at full width, seq 2048, batch 8, f32, 16
# samples (2 steps an epoch), 2 epochs: 4 steps and 2 evals, per-step
# with a step record a step; the plain head unless a run says otherwise
CONTEXT_ARGV = ["--model", "transformer", "--seq-len", "2048",
                "--train-batch-size", "8", "--n-samples", "16", "--epochs",
                "2", "--seed", "42", "--log-every", "1",
                "--steps-per-dispatch", "1", "--lm-head", "plain"]
# the MoE at 18a's shape in f32 (24b's flags) with ample capacity: the
# JAX test's premise (tests/test_moe.py:159), where each context shard's
# own routing is one card's routing
CONTEXT_MOE_ARGV = EXPERT_F32_ARGV + ["--capacity-factor", "4.0"]
# 25b's hold on the transformer runs: absolute, about 6x the largest
# sound reading (3.147e-5, the ring at --context 4); the MoE keeps 24b's
# rtol 2e-3 / atol 2e-4, its aux loss taken per context shard
CP_ATOL = 2e-4


def ring_merge_check(torch, fa):
    """Phase 25a, first: the ring's hop merge on the card, the JAX
    package's ``check_ring_flash_merge`` (``tpudist/selfcheck.py:
    168-210``): two disjoint-kv ``flash_attention_with_lse`` calls
    merged by ``merge_partials`` against one whole-kv call, forward and
    the q/k/v grads of a random cotangent (the merge feeds each call's
    backward a nonzero lse cotangent), at its shape b2 s1024 h4 kv2
    hd128: in bf16 at its tolerances (forward atol 3e-2, grads atol
    0.5), and in f32 at 1e-4 (the forward's max |d|, each grad's max |d|
    / max |whole|)."""
    from tpudist_torch.ops import ring_attention as ring

    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    b, s, h, kv, hd = 2, 1024, 4, 2, 128
    c = s // 2
    for dt, tol, grad_tol, rel in (("bfloat16", 3e-2, 0.5, False),
                                   ("float32", 1e-4, 1e-4, True)):
        dtype = getattr(torch, dt)
        q, k, v, ct = (torch.randn(b, s, n, hd, device="cuda",
                                   generator=gen).to(dtype)
                       for n in (h, kv, kv, h))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o, _ = fa.flash_attention_with_lse(q, k, v, causal=False)
        whole = o.float()
        o1, l1 = fa.flash_attention_with_lse(q, k[:, :c].contiguous(),
                                             v[:, :c].contiguous(),
                                             causal=False)
        o2, l2 = fa.flash_attention_with_lse(q, k[:, c:].contiguous(),
                                             v[:, c:].contiguous(),
                                             causal=False)
        merged, _ = ring.merge_partials(o1.float(), l1, o2.float(), l2)
        g_whole = torch.autograd.grad((whole * ct.float()).sum(), (q, k, v))
        g_merged = torch.autograd.grad((merged * ct.float()).sum(),
                                       (q, k, v))
        err = (merged - whole).abs().max().item()
        gerrs = [((g.float() - w.float()).abs().max()
                  / (w.float().abs().max() if rel else 1)).item()
                 for g, w in zip(g_merged, g_whole)]
        ok = (err <= tol and max(gerrs) <= grad_tol
              and bool(torch.isfinite(merged).all()))
        print(f"ring merge b{b} s{s} h{h} kv{kv} hd{hd} {dt}: two kv halves "
              f"merged against one call, forward max |d| {err:.3e} (tol "
              f"{tol}), dq/dk/dv {'max |d| / max |whole|' if rel else 'max |d|'}"
              f" {[f'{e:.3e}' for e in gerrs]} (tol {grad_tol})"
              f"{'' if ok else '  FAIL'}")
        if not ok:
            fail(f"ring merge: two merged kernel calls disagree with one "
                 f"whole-kv call in {dt}")
        del q, k, v, ct, o, o1, o2, g_whole, g_merged
    torch.cuda.empty_cache()


def _virtual_ring(torch, ring, q, k, v, do, n: int, use_flash: bool):
    """The zigzag ring over ``n`` virtual ranks on one card: each rank's
    output (its zigzag rows) from :func:`ring.ring_attention` with a
    :class:`ring.VirtualRotation` (every rank's blocks handed over in
    ring order), the outputs concatenated in rank order and the grads
    of ``do`` at those rows. Returns ``(o, grads, rows)``."""
    s_l = q.shape[1] // n
    pos = [ring.zigzag_positions(r, s_l, n, device=q.device)
           for r in range(n)]
    ks, vs = [k[:, p] for p in pos], [v[:, p] for p in pos]
    outs = [ring.ring_attention(q, k, v, rot=ring.VirtualRotation(ks, vs, r),
                                use_flash=use_flash)[0] for r in range(n)]
    rows = torch.cat(pos)
    o = torch.cat(outs, dim=1)
    grads = torch.autograd.grad(o, (q, k, v), do[:, rows])
    return o, grads, rows


def context_unsupported_hops(torch, card: str) -> None:
    """Phase 25a, the hop shape the kernel does not take: the zigzag ring
    at the MoE's hop shape under ``--context 4`` at seq 512 (b8, s_local
    128, hops of 64, h16 kv16 hd128, f32) over 4 virtual ranks. Left to
    pick its route (``use_flash=None``) on the card it raises before any
    launch, and the train CLI's ``check_context`` refuses that
    --seq-len / --context pair on the card (and takes it on the CPU);
    the einsum ring (``use_flash=False``, the hops' plain version) is
    held against one dense causal call at phase 3's f32 tolerances,
    forward and grads. No kernel is launched."""
    from tpudist_torch import config as config_lib
    from tpudist_torch import train as train_lib
    from tpudist_torch.ops import ring_attention as ring
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx

    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    n, b, s, h, hd = 4, 8, 512, 16, 128
    q, k, v, do = (torch.randn(b, s, h, hd, device="cuda", generator=gen)
                   for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    torch.cuda.synchronize()
    _reset_launches(fa, fx)
    try:
        _virtual_ring(torch, ring, q, k, v, do, n, None)
        raised = None
    except ValueError as e:
        raised = str(e)
    cfg = config_lib.parse_args(["--model", "moe", "--seq-len", str(s),
                                 "--context", str(n),
                                 "--train-batch-size", str(b)])
    train_lib.check_context(cfg, n)
    try:
        train_lib.check_context(cfg, n, device_type="cuda")
        refused = None
    except ValueError as e:
        refused = str(e)
    o, grads, rows = _virtual_ring(torch, ring, q, k, v, do, n, False)
    torch.cuda.synchronize()
    counts = _launch_counts(fa, fx)
    dense = fa.flash_attention_plain(q, k, v, causal=True)[0][:, rows]
    g_dense = torch.autograd.grad(dense, (q, k, v), do[:, rows])
    err = (o - dense).abs().max().item()
    gerrs = [((g - r).abs().max() / r.abs().max()).item()
             for g, r in zip(grads, g_dense)]
    print(f"context ring 25a b{b} s{s} h{h} kv{h} hd{hd} float32, {n} "
          f"virtual ranks (hops of {s // n // 2}): the route left to the "
          f"ring raised {raised!r}; check_context on the card refused "
          f"{refused!r}; the einsum ring against one dense causal call: "
          f"forward max |d| {err:.3e} (tol {ATOL['float32']}), dq/dk/dv "
          f"max |d| / max |ref| {[f'{e:.3e}' for e in gerrs]} (tol "
          f"{BWD_RTOL['float32']}); kernel launches {counts}; {card}")
    if raised is None or refused is None or any(counts.values()):
        fail(f"context ring 25a: at hops of {s // n // 2} the card's ring "
             f"raised {raised!r}, check_context refused {refused!r}, "
             f"launches {counts}")
    if err > ATOL["float32"] or max(gerrs) > BWD_RTOL["float32"]:
        fail("context ring 25a: the einsum ring disagrees with dense "
             "attention")


def context_ring(torch, fa, fx, F, card: str, records):
    """Phase 25a (one card): :func:`ring_merge_check`; then the zigzag
    ring with flash hops over 4 virtual ranks in one process (the
    injectable rotation: ``ring.VirtualRotation``) at config #5's
    attention, b8 s2048 h16 kv16 hd128 in f32 and h16 kv4 in bf16 (GQA
    compact kv on the ring): its output and q/k/v grads against one
    causal ``flash_attention`` call over the whole sequence and against
    the port's einsum ring on the same inputs, at phase 3's tolerances
    (forward max |d| f32 1e-4 / bf16 3e-2, grads max |d| / max |ref|
    f32 1e-4 / bf16 5e-2); :func:`context_unsupported_hops`. The launch
    counts are set to 0 just before
    the flash ring's forward and backward and read just after: per
    virtual rank 1 + 2 (n - 1) forward calls, each with its merged
    backward (s_local 512, c 256), no split pair. Then the forward and
    the merged backward at the hop shapes (b8 c256 h16 unmasked, the
    local s512 causal) beside their bounds, their plain versions and
    SDPA (its grad) on the same inputs; these rows join the forward's
    and the merged backward's ``records`` as ``hop_timings``. Returns
    the path's launches."""
    from tpudist_torch.ops import ring_attention as ring

    t0 = time.perf_counter()
    ring_merge_check(torch, fa)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    n, b, s, h, hd = 4, 8, 2048, 16, 128
    total = None
    for kv, dt in ((16, "float32"), (4, "bfloat16")):
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(b, s, m, hd, device="cuda",
                                   generator=gen).to(dtype)
                       for m in (h, kv, kv, h))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        torch.cuda.synchronize()
        _reset_launches(fa, fx)
        o, grads, rows = _virtual_ring(torch, ring, q, k, v, do, n, True)
        torch.cuda.synchronize()
        counts = _launch_counts(fa, fx)
        total = counts if total is None else {
            key: total[key] + counts[key] for key in counts}
        want = {"flash_attention_fwd": n * (1 + 2 * (n - 1)),
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_bwd_dqkv": n * (1 + 2 * (n - 1)),
                "fused_xent_fwd": 0, "fused_xent_bwd": 0}
        whole = fa.flash_attention(q, k, v, causal=True)[:, rows]
        g_whole = torch.autograd.grad(whole, (q, k, v), do[:, rows])
        o_e, g_e, _ = _virtual_ring(torch, ring, q, k, v, do, n, False)
        shape = f"b{b} s{s} h{h} kv{kv} hd{hd} {dt}"
        ok = counts == want and bool(torch.isfinite(o.float()).all())
        for ref, ref_g, what in ((whole, g_whole, "one causal flash call"),
                                 (o_e, g_e, "the einsum ring")):
            err = (o.float() - ref.float()).abs().max().item()
            gerrs = [((g.float() - r.float()).abs().max()
                      / r.float().abs().max()).item()
                     for g, r in zip(grads, ref_g)]
            good = err <= ATOL[dt] and max(gerrs) <= BWD_RTOL[dt]
            ok = ok and good
            print(f"context ring 25a {shape}, {n} virtual ranks, flash hops"
                  f" against {what}: forward max |d| {err:.3e} (tol "
                  f"{ATOL[dt]}), dq/dk/dv max |d| / max |ref| "
                  f"{[f'{e:.3e}' for e in gerrs]} (tol {BWD_RTOL[dt]})"
                  f"{'' if good else '  FAIL'}")
        print(f"context ring 25a {shape}: kernel launches {counts} (want "
              f"{want}); {card}")
        if not ok:
            fail(f"context ring 25a: the flash-hop ring at {shape} "
                 f"disagrees or launched {counts}, want {want}")
        del q, k, v, do, o, grads, whole, g_whole, o_e, g_e
        torch.cuda.empty_cache()
    context_unsupported_hops(torch, card)

    # the hop shapes' times: a remote hop's unmasked chunk call and the
    # local causal call, f32 and (the chunk) bf16 with compact kv
    fwd_rows, bwd_rows = [], []
    for (sq, kv, dt, causal) in ((256, 16, "float32", False),
                                 (512, 16, "float32", True),
                                 (256, 4, "bfloat16", False)):
        dtype = getattr(torch, dt)
        q, k, v, dout = (torch.randn(b, sq, m, hd, device="cuda",
                                     generator=gen).to(dtype)
                         for m in (h, kv, kv, h))
        shape = (f"b{b} s{sq} h{h} kv{kv} hd{hd} {dt} "
                 f"{'causal' if causal else 'full'}")
        # the library call takes the kv heads expanded to the q heads
        qt, kt, vt = (x.repeat_interleave(h // x.shape[2], dim=2)
                      .transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            kernel_ms = time_ms(torch, lambda: fa.flash_attention_with_lse(
                q, k, v, causal=causal))
            plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal))
            library_ms = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
            o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
            dlse = torch.randn(b, h, sq, device="cuda", generator=gen) * 0.1
            delta = fa._delta(o, dout, dlse)
            bwd_ms = time_ms(torch, lambda: fa.flash_attention_bwd_dqkv(
                q, k, v, dout, lse, delta, causal=causal))
            bwd_plain_ms = time_ms(
                torch, lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, dout, dlse, causal=causal))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        bwd_library_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True))
        bound_ms, bound_by = attention_bound(b, sq, sq, h, kv, hd, dt,
                                             causal)
        bbound_ms, bbound_by = backward_bound(b, sq, h, kv, hd, dt, causal,
                                              5, "qkv", backward_peak(hd),
                                              rope=False)
        note = " (kv expanded)" if kv != h else ""
        print(f"flash_attention_fwd at the ring hop {shape}: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention{note} {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); {card}")
        print(f"flash_attention_bwd_dqkv at the ring hop {shape}: kernel "
              f"{bwd_ms:.4f} ms, plain backward {bwd_plain_ms:.4f} ms, "
              f"autograd.grad through scaled_dot_product_attention{note} "
              f"{bwd_library_ms:.4f} ms, bound {bbound_ms:.4f} ms "
              f"({bbound_by}); {card}")
        fwd_rows.append({"shape": shape, "ms": kernel_ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
        bwd_rows.append({"shape": shape, "ms": bwd_ms,
                         "plain_ms": bwd_plain_ms,
                         "library_ms": bwd_library_ms,
                         "bound_ms": bbound_ms, "bound_by": bbound_by})
        del q, k, v, dout, qt, kt, vt, o, lse, delta, out
        torch.cuda.empty_cache()
    for rec in records:
        if rec["name"] == "flash_attention_fwd":
            rec["hop_timings"] = fwd_rows
        elif rec["name"] == "flash_attention_bwd_dqkv":
            rec["hop_timings"] = bwd_rows
    print(f"context ring: phase 25a {time.perf_counter() - t0:.1f} s")
    return {CONTEXT_PATHS[0]: total}


def context_cli(torch, fa, fx, card: str, ones=None):
    """Phase 25b (two cards or more): the train CLI at one NCCL process a
    card, each run beside one card's run of the same flags over 4 steps
    (the transformer within ``CP_ATOL`` absolute, the MoE at rtol 2e-3 /
    atol 2e-4). At ``CONTEXT_ARGV`` (config #5 at full
    width, seq 2048, batch 8, f32): ``--context <cards>`` with the ring
    and with Ulysses, ``--context <cards> --lm-head fused`` (rows 5-6 on
    a context shard's tokens); with four cards or a multiple ``--data 2
    --context 2``, ``--fsdp 2 --context 2`` and ``--tensor 2 --context
    2``; the MoE (``CONTEXT_MOE_ARGV``, 18a's shape in f32 at capacity
    4.0) at ``--data 2 --context 2`` and ``--expert 2 --context 2``;
    then ``--context <cards>`` as the k = 2 superstep (its rotations
    captured in the CUDA graph), bitwise its per-step run. Every
    verdict ``success`` and the contract; exact launches a rank
    (:func:`want_launches`); each run's step time and tokens/s/chip
    beside one card's, rank 0's exposed comm share from a
    ``--profile-window 1`` capture, rank 0's collectives line. Returns
    the paths' launches; ``ones`` (a dict) gets the one-card runs' records
    by tag (``one``, ``one_fused``, ``one_moe``)."""
    from tpudist_torch import config as config_lib

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    w = str(world)
    window = ["--profile-window", "1"]
    fused = [a if a != "plain" else "fused" for a in CONTEXT_ARGV]
    # (tag, argv, its one-card reference's tag)
    runs = [("train_cp_ring", CONTEXT_ARGV + ["--context", w], "one"),
            ("train_cp_ulysses", CONTEXT_ARGV + ["--context", w,
                                                 "--cp-impl", "ulysses"],
             "one"),
            ("train_cp_ring_fused", fused + ["--context", w], "one_fused")]
    if world % 4 == 0:
        runs += [(f"train_cp_ring_{name}", CONTEXT_ARGV + flags, "one")
                 for name, flags in (
                     ("d2c2", ["--data", "2", "--context", "2"]),
                     ("f2c2", ["--fsdp", "2", "--context", "2"]),
                     ("t2c2", ["--tensor", "2", "--context", "2"]))]
        runs += [(f"train_cp_moe_{name}", CONTEXT_MOE_ARGV + flags,
                  "one_moe")
                 for name, flags in (
                     ("d2c2", ["--data", "2", "--context", "2"]),
                     ("e2c2", ["--expert", "2", "--context", "2"]))]
    one_argv = {"one": CONTEXT_ARGV, "one_fused": fused,
                "one_moe": CONTEXT_MOE_ARGV}
    paths = {}
    ones = {} if ones is None else ones
    for tag, argv, one_tag in runs:
        if one_tag not in ones:
            paths[f"train_cp_{one_tag}"], ones[one_tag] = _one_card(
                torch, fa, fx, f"train_cp_{one_tag}", one_argv[one_tag])
        one = ones[one_tag]
        cfg = config_lib.parse_args(argv)
        m, p = cfg.model, cfg.parallel
        steps = cfg.epochs * (cfg.data.n_samples // cfg.batch_size)
        want = want_launches(fa, m, m.max_seq_len, steps, cfg.epochs,
                             cfg.lm_head == "fused", p.context, cfg.cp_impl)
        run = _mesh_cli(torch, fa, card, tag, argv + window,
                        m.max_seq_len, want=want)
        got = {"losses": run["losses"],
               "epochs": [(r["avg_loss"], r["eval_loss"])
                          for r in run["recs"] if r["kind"] == "epoch"]}
        hold = (FSDP_RTOL, FSDP_ATOL) if m.name == "moe" else (0.0, CP_ATOL)
        _expert_close(tag, got, one, *hold,
                      steps // cfg.log_every + 2 * cfg.epochs)
        t, t1 = run["timing"], one["timing"]
        ms, ms1 = (1e3 * x["run_s"] / x["steps"] for x in (t, t1))
        tokens = cfg.batch_size * m.max_seq_len
        tps, tps1 = (tokens * x["steps"] / x["run_s"] / n
                     for x, n in ((t, world), (t1, 1)))
        print(f"train {tag}: step {ms:.3f} ms against one card's "
              f"{ms1:.3f} ({ms / ms1:.3f}x); tokens/s/chip {tps:.1f} "
              f"against {tps1:.1f} ({tps / tps1:.3f}x); rank walls "
              f"{[round(r['wall'], 2) for r in run['ranks']]} s; peak "
              f"by rank {[round(r['peak_gb'], 3) for r in run['ranks']]} "
              f"GB; {card}")
        dev = [r for r in run["recs"] if r["kind"] == "devtime"]
        rec = dev[0] if dev else {}
        print(f"train {tag}: rank 0's window {rec.get('window_s')} s over "
              f"{rec.get('dispatches')} dispatch(es): compute "
              f"{rec.get('compute_s')} s, comm {rec.get('comm_s')} s, "
              f"exposed {rec.get('exposed_comm_s')} s, exposed share "
              f"{rec.get('exposed_comm_frac')} ({rec.get('comm_status')})")
        if rec.get("dispatches") != 1:
            fail(f"train {tag}: no device window: {rec}")
        paths[tag] = run["counts"]
        if tag == "train_cp_ring":
            # the superstep next, its rotations captured: a ring that
            # does not capture fails before the other meshes run
            paths.update(_cp_superstep(torch, fa, card, got))
    print(f"train context cli: phase 25b {time.perf_counter() - t0:.1f} s")
    return paths


def _cp_superstep(torch, fa, card: str, per_step):
    """25b's superstep: ``--context <cards>`` at k = 2 (epoch 0's window
    eager with the two captures, epoch 1's replayed, the ring's NCCL
    rotations inside the graph), its step records and epochs bitwise
    the per-step run's (``per_step``), each rank (2 programs, one
    replay), exact launches. Returns its path's launches."""
    from tpudist_torch import config as config_lib

    world = torch.cuda.device_count()
    tag = "train_cp_ring_superstep"
    argv = CONTEXT_ARGV + ["--context", str(world)]
    argv[argv.index("--log-every") + 1] = "2"
    argv[argv.index("--steps-per-dispatch") + 1] = "2"
    cfg = config_lib.parse_args(argv)
    m = cfg.model
    want = want_launches(fa, m, m.max_seq_len, 4, 2, False, world, "ring")
    run = _mesh_cli(torch, fa, card, tag, argv, m.max_seq_len, want=want)
    got = ([r["loss"] for r in run["recs"] if r["kind"] == "step"],
           [(r["avg_loss"], r["eval_loss"]) for r in run["recs"]
            if r["kind"] == "epoch"])
    ref = ([per_step["losses"][1], per_step["losses"][3]],
           per_step["epochs"])
    graphs = [r["graphs"] for r in run["ranks"]]
    print(f"train {tag}: k = 2, step records and epochs {got} against the "
          f"per-step run's {ref}: bitwise {got == ref}; each rank's "
          f"(programs, replays) {graphs}")
    if got != ref:
        fail(f"train {tag}: the superstep is not bitwise its per-step run")
    if any(g != [(2, {"superstep": 1, "step": 0})] for g in graphs):
        fail(f"train {tag}: (programs, replays) by rank {graphs}")
    return {tag: run["counts"]}


# ------------------------------------------------------------- phase 26

OVERLAP_PATHS = ("train_overlap_off", "train_overlap_bucketed_4mb",
                 "train_overlap_bucketed_1mb", "train_overlap_superstep")
# 26a and 26b: phase 6's flags (config #5 at seq 512, f32, the plain
# head), 16 samples (2 steps an epoch), 2 epochs: 4 steps and 2 evals,
# per-step with a step record a step
OVERLAP_ARGV = ["--model", "transformer", "--seq-len", "512",
                "--train-batch-size", "8", "--n-samples", "16", "--epochs",
                "2", "--seed", "42", "--log-every", "1",
                "--steps-per-dispatch", "1", "--lm-head", "plain"]
BUCKETED = ["--grad-overlap", "bucketed"]


def _overlap_body_rank(port, queue):
    """Phase 26a in a process of its own: a one-rank NCCL group and no
    mesh, so the step is the replicated data-parallel body with its
    gradient mean issued (one all-reduce a param). Phase 6's model
    (``OVERLAP_ARGV``) over 8 steps on the CLI's data (two epochs' slabs
    of 4): ``--grad-overlap off``, then ``bucketed`` at 4 MB and at 1 MB
    (a hook a param counts down its bucket; the reduces issued with
    ``async_op=True`` as the backward produces them), then the bucketed
    4 MB step as the k = 4 superstep (epoch 0's window eager with the
    two captures, epoch 1's replayed: the hooks' async all-reduces and
    their waits inside the graph). Launch counts set to 0 just before
    each run and read just after."""
    import torch

    from tpudist_torch import config as config_lib
    from tpudist_torch import data as data_lib
    from tpudist_torch import engine as engine_lib
    from tpudist_torch.obs import devtime as devtime_lib
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx
    from tpudist_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed.initialize(f"localhost:{port}", 1, 0, device="cuda")
    dev = ctx.device
    base = config_lib.parse_args(OVERLAP_ARGV)
    m = base.model
    tokens = data_lib.make_synthetic_tokens(
        32, m.max_seq_len + 1, m.vocab_size, base.data.seed)
    slabs = [torch.as_tensor(data_lib.plan_epoch(
        (tokens,), batch_size=base.batch_size, seed=base.seed,
        epoch=e).slab(0, 4)[0], device=dev).long() for e in range(2)]

    def leaves(state):
        return [t.detach().clone() for t in (
            *state.params.parameters(), *state.opt_state.mu,
            *state.opt_state.nu)]

    out = {"rank": 0, "world": ctx.process_count, "runs": {}}
    ref = None
    for tag, flags in zip(OVERLAP_PATHS[:3], (
            [], BUCKETED + ["--grad-bucket-mb", "4"],
            BUCKETED + ["--grad-bucket-mb", "1"])):
        cfg = config_lib.parse_args(OVERLAP_ARGV + flags)
        state = engine_lib.init_state(cfg, dev)
        step = engine_lib.make_train_step(cfg, dev)
        torch.cuda.synchronize()
        _reset_launches(fa, fx)
        losses, ms = [], []
        for e in range(2):
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, (slabs[e][i],))
                losses.append(loss.item())
                ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        got = leaves(state)
        run = {"losses": losses, "ms": ms, "counts": _launch_counts(fa, fx),
               "ops": devtime_lib.collective_bytes(step.reduced_operands())}
        if ref is None:
            ref = (losses, got)
            run["same"] = True
        else:
            run["same"] = losses == ref[0] and all(
                torch.equal(x, y) for x, y in zip(got, ref[1]))
        out["runs"][tag] = run
        del state, step, got
        torch.cuda.empty_cache()

    cfg = config_lib.parse_args(OVERLAP_ARGV + BUCKETED
                                + ["--grad-bucket-mb", "4"])
    state = engine_lib.init_state(cfg, dev)
    sup = engine_lib.make_superstep(cfg, dev, 4)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    _reset_launches(fa, fx)
    sup_losses = []
    for e in range(2):
        t0 = time.perf_counter()
        state, total, got = sup(state, total, (slabs[e],), 0, 4)
        sup_losses += got.tolist()
        out[f"window{e}_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["runs"][OVERLAP_PATHS[3]] = {
        "losses": sup_losses, "counts": _path_launches(fa, fx, [sup]),
        "graphs": (sup.programs, dict(sup.replays)),
        "pool_mb": sup.graph_pool_bytes / 2**20,
        "same": sup_losses == ref[0] and all(
            torch.equal(x, y) for x, y in zip(leaves(state), ref[1]))}
    sup.release()
    del state, ref
    distributed.shutdown()
    queue.put(out)


def overlap_body(torch, fa, card: str):
    """Phase 26a (one card): :func:`_overlap_body_rank` in a spawned
    process. Fails unless ``bucketed`` at 4 MB and at 1 MB is bitwise
    ``off`` after 8 steps (every loss, param, ``mu`` and ``nu``), its k =
    4 superstep bitwise too (2 programs, one replay), every run's
    launches exact (flash forward and merged backward 4 x 8), and the
    collective rows equal across modes. Prints the step times and the
    rows. Returns the paths' launches."""
    from tpudist_torch import config as config_lib

    t0 = time.perf_counter()
    m = config_lib.parse_args(OVERLAP_ARGV).model
    (r,) = _spawn(_overlap_body_rank, [(_free_port(),)], 600,
                  "train overlap body")
    want = want_launches(fa, m, 512, 8, 0, fused=False)
    runs = r["runs"]
    print(f"train overlap body: phase 6's model (V{m.vocab_size} "
          f"L{m.n_layers} d{m.d_model}), f32, batch 8, seq 512, the "
          f"replicated step on {r['world']} NCCL rank; {card}")
    for tag, run in runs.items():
        line = (f"train {tag}: losses {run['losses']}; bitwise the off "
                f"run: {run['same']}; kernel launches {run['counts']} "
                f"(want {want})")
        if "ms" in run:
            line += (f"; step {statistics.median(run['ms'][1:]):.3f} ms "
                     f"(median after the first, host clock fenced)")
        else:
            line += (f"; (programs, replays) {run['graphs']}; windows "
                     f"{r['window0_s']:.3f} s (eager + captures), "
                     f"{r['window1_s']:.3f} s (replayed); graph pool "
                     f"{run['pool_mb']:.1f} MB")
        print(line)
        if not run["same"]:
            fail(f"train {tag}: not bitwise the off run")
        if run["counts"] != want:
            fail(f"train {tag}: kernel launches {run['counts']}, want "
                 f"{want}")
    ops = {tag: runs[tag]["ops"] for tag in OVERLAP_PATHS[:3]}
    print(f"train overlap body: collectives a step "
          f"{ops[OVERLAP_PATHS[0]]['n_collectives']} "
          f"({ops[OVERLAP_PATHS[0]]['ici_bytes_total']} B)")
    if any(o != ops[OVERLAP_PATHS[0]] for o in ops.values()):
        fail(f"train overlap body: the modes' collectives differ: {ops}")
    if runs[OVERLAP_PATHS[3]]["graphs"] != (2, {"superstep": 1, "step": 0}):
        fail(f"train overlap body: (programs, replays) "
             f"{runs[OVERLAP_PATHS[3]]['graphs']}")
    print(f"train overlap body: phase 26a {time.perf_counter() - t0:.1f} s")
    return {tag: run["counts"] for tag, run in runs.items()}


def _probe_watch_rank(rank, world, port, argv, verdict, queue):
    """``_dp_train_rank`` with each tuner probe's candidate printed (the
    bucket axis's trials among them)."""
    from tpudist_torch import tune

    real = tune.probe_mod.probe_candidate

    def probe(cfg, device, cand, plan, **kw):
        print(f"chip_smoke: probe k={cand.k} grad_bucket_mb="
              f"{cand.grad_bucket_mb} remat={cand.remat} grad_accum="
              f"{cand.grad_accum_steps}")
        return real(cfg, device, cand, plan, **kw)
    tune.probe_mod.probe_candidate = probe
    _dp_train_rank(rank, world, port, argv, verdict, queue)


def _refused_rank(rank, world, port, argv, verdict, queue):
    """One rank of a run the train CLI refuses: its exit code and its
    stdout and stderr."""
    os.environ.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                      TPUDIST_NUM_PROCESSES=str(world),
                      TPUDIST_PROCESS_ID=str(rank),
                      TPUDIST_VERDICT_PATH=verdict)
    from tpudist_torch import train as train_lib

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee), contextlib.redirect_stderr(tee):
        rc = train_lib.main(argv)
    queue.put({"rank": rank, "rc": rc, "out": tee.buf.getvalue()})


def _grad_dcn(run) -> int:
    """The gradient rows' cross-slice bytes of a run's devtime record
    (the rows above the 4-byte loss all-reduce)."""
    (rec,) = [r for r in run["recs"] if r["kind"] == "devtime"]
    return sum(r["dcn_bytes"] for r in rec["collectives"] if r["bytes"] > 64)


def overlap_cli(torch, fa, fx, card: str):
    """Phase 26b (two cards or more): the train CLI at ``--data <cards>``,
    one NCCL process a card, phase 6's flags (``OVERLAP_ARGV``) with
    ``--profile-window 1``: ``off``, ``bucketed`` at 4 MB and at 64 MB,
    bitwise on every rank (the step records and the epochs; a rank's
    replica is the one it reduced); the bucketed step as the k = 2
    superstep (epoch 0's window eager with the captures, epoch 1's
    replayed), its records bitwise its per-step run's; under
    ``TPUDIST_SLICE_MAP=2`` (two slices of cards) ``flat`` (off) against
    ``hierarchical`` (bucketed), bitwise, the gradients' cross-slice
    bytes in the ratio 2; ``--autotune probe`` with ``bucketed`` (the
    bucket axis probed, the committed steps/s at least the start's, the
    losses bitwise an untuned run's at the point); ``--fsdp 2 --data 2
    --grad-overlap bucketed`` refused on every rank with the JAX
    package's message. Every verdict ``success`` and exact launches a
    rank. Prints each run's step time and rank 0's exposed comm share of
    its window beside ``off``'s, with ``comm_status``. Returns the
    paths' launches."""
    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    data = ["--data", str(world)]
    window = ["--profile-window", "1"]
    paths, got = {}, {}

    def one(tag, flags, env=None, rank_fn=None, argv=OVERLAP_ARGV,
            want=None):
        os.environ.update(env or {})
        try:
            run = _mesh_cli(torch, fa, card, tag, argv + data + flags, 512,
                            rank_fn=rank_fn, want=want)
        finally:
            for k in env or {}:
                del os.environ[k]
        got[tag] = run
        paths[tag] = run["counts"]
        t = run["timing"]
        dev = [r for r in run["recs"] if r["kind"] == "devtime"]
        rec = dev[0] if dev else {}
        print(f"train {tag}: step {1e3 * t['run_s'] / t['steps']:.3f} ms; "
              f"rank 0's window {rec.get('window_s')} s: compute "
              f"{rec.get('compute_s')} s, comm {rec.get('comm_s')} s, "
              f"exposed {rec.get('exposed_comm_s')} s, exposed share "
              f"{rec.get('exposed_comm_frac')} ({rec.get('comm_status')}, "
              f"{rec.get('fabric')}); {card}")
        return run

    def records(run):
        return ([r["loss"] for r in run["recs"] if r["kind"] == "step"],
                [(r["avg_loss"], r["eval_loss"]) for r in run["recs"]
                 if r["kind"] == "epoch"])

    off = records(one("train_overlap_dp_off", window))
    for mb in ("4", "64"):
        tag = f"train_overlap_dp_bucketed_{mb}mb"
        run = one(tag, BUCKETED + ["--grad-bucket-mb", mb] + window)
        line = (f"tpudist: grad overlap bucketed: bucket {mb} MB over the "
                f"data axis (reduce dispatched as backward produces each "
                f"bucket)")
        if line not in run["ranks"][0]["out"]:
            fail(f"train {tag}: rank 0 did not print {line!r}")
        print(f"train {tag}: records {records(run)} against off's {off}: "
              f"bitwise {records(run) == off}")
        if records(run) != off:
            fail(f"train {tag}: not bitwise the off run")

    # the superstep, its hooks' async all-reduces captured
    sup_argv = list(OVERLAP_ARGV)
    sup_argv[sup_argv.index("--log-every") + 1] = "2"
    sup_argv[sup_argv.index("--steps-per-dispatch") + 1] = "2"
    run = one("train_overlap_dp_superstep", BUCKETED
              + ["--grad-bucket-mb", "4"], argv=sup_argv)
    rec = records(run)
    ref = ([off[0][1], off[0][3]], off[1])
    graphs = [r["graphs"] for r in run["ranks"]]
    print(f"train overlap superstep: k = 2, step records and epochs {rec} "
          f"against the per-step run's {ref}: bitwise {rec == ref}; each "
          f"rank's (programs, replays) {graphs}")
    if rec != ref:
        fail("train overlap superstep: not bitwise its per-step run")
    if any(g != [(2, {"superstep": 1, "step": 0})] for g in graphs):
        fail(f"train overlap superstep: (programs, replays) {graphs}")

    # two slices of cards: the ladder, flat against hierarchical
    if world % 2 == 0:
        env = {"TPUDIST_SLICE_MAP": "2"}
        flat = one("train_overlap_dp_flat", window, env)
        hier = one("train_overlap_dp_hierarchical",
                   BUCKETED + ["--grad-bucket-mb", "4", "--cross-slice",
                               "hierarchical"] + window, env)
        a, b = _grad_dcn(flat), _grad_dcn(hier)
        print(f"train overlap slices: flat {records(flat)} against "
              f"hierarchical {records(hier)}: bitwise "
              f"{records(flat) == records(hier)}; the gradients' "
              f"cross-slice bytes {a} against {b} ({a / max(b, 1):.4f}x)")
        if records(flat) != records(hier):
            fail("train overlap slices: flat and hierarchical differ")
        if a != 2 * b or not b:
            fail(f"train overlap slices: cross-slice bytes {a} against "
                 f"{b}, want the ratio 2")

    # the tuner's bucket axis
    cache = ROOT / "build" / "chip_smoke_train" / "overlap_tune_cache"
    shutil.rmtree(cache, ignore_errors=True)
    run = one("train_overlap_dp_tuned", BUCKETED + [
        "--grad-bucket-mb", "4", "--autotune", "probe",
        "--autotune-cache-dir", str(cache)], rank_fn=_probe_watch_rank,
        want=False)
    shutil.rmtree(cache, ignore_errors=True)
    t = _tune_record("train_overlap_dp_tuned", run)
    probed = sorted({float(ln.split("grad_bucket_mb=")[1].split()[0])
                     for ln in run["ranks"][0]["out"].splitlines()
                     if ln.startswith("chip_smoke: probe")
                     and "grad_bucket_mb=None" not in ln})
    print(f"train overlap tuned: {t['status']} ({t['source']}), "
          f"{t['trials']} trial(s); bucket bounds probed {probed} MB; "
          f"committed {_point(t)}, grad_bucket_mb {t['grad_bucket_mb']}: "
          f"{t['steps_per_sec']} steps/s against the start's "
          f"{t['baseline_steps_per_sec']}")
    if len(probed) < 2:
        fail(f"train overlap tuned: the bucket axis was not probed: "
             f"{probed}")
    if t["status"] != "success" or t["source"] != "probe" \
            or t["steps_per_sec"] < t["baseline_steps_per_sec"]:
        fail(f"train overlap tuned: {t}")
    point = _at_point(t) + ["--grad-bucket-mb", repr(t["grad_bucket_mb"])]
    argv = list(OVERLAP_ARGV)
    argv[argv.index("--steps-per-dispatch"):
         argv.index("--steps-per-dispatch") + 2] = []
    at = one("train_overlap_dp_tuned_point", BUCKETED + point, argv=argv,
             want=False)
    print(f"train overlap tuned: records {records(run)} against an "
          f"untuned run's at the point {records(at)}: bitwise "
          f"{records(run) == records(at)}; launches a rank "
          f"{run['ranks'][0]['counts']} against {at['ranks'][0]['counts']}")
    if records(run) != records(at) \
            or run["ranks"][0]["counts"] != at["ranks"][0]["counts"]:
        fail("train overlap tuned: not bitwise an untuned run at the "
             "point")

    # a sharded mesh refuses the flag, with the JAX engine's message
    if world % 4 == 0:
        save = ROOT / "build" / "chip_smoke_train" / "overlap_refused"
        shutil.rmtree(save, ignore_errors=True)
        argv = OVERLAP_ARGV + ["--fsdp", "2", "--data", str(world // 2)] \
            + BUCKETED + ["--save-dir", str(save)]
        port = _free_port()
        ranks = _spawn(_refused_rank, [
            (r, world, port, argv, str(save / "job_status.txt"))
            for r in range(world)], 300, "train overlap refused")
        shutil.rmtree(save, ignore_errors=True)
        msg = ("--grad-overlap bucketed requires the explicit-collective "
               "pure-DP mesh (only the 'data' axis > 1); this mesh routes "
               "gradients through the jit+shardings partitioner")
        refused = [r["rc"] == 1 and msg in r["out"] for r in ranks]
        print(f"train overlap refused: --fsdp 2 --data {world // 2} "
              f"--grad-overlap bucketed: exit codes "
              f"{[r['rc'] for r in ranks]}, the JAX message on every rank "
              f"{all(refused)}")
        if not all(refused):
            fail("train overlap refused: a rank did not refuse with the "
                 "JAX message")
    print(f"train overlap cli: phase 26b {time.perf_counter() - t0:.1f} s")
    return paths


SWEEP_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "ppermute")


def _collective_check_rank(rank, world, port, queue):
    """26c's check in a process of its own (one NCCL rank a card): each
    kind at 1 MB against its closed form (``collectives.expected``) on
    the card."""
    import torch

    from tpudist_torch.ops import collectives
    from tpudist_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", world, rank, device="cuda")
    out = {"rank": rank}
    for kind in SWEEP_KINDS:
        op, _, nbytes = collectives.build_op(kind, message_bytes=2**20,
                                             device=torch.device("cuda"))
        got = op()
        want = collectives.expected(kind, world, rank, 2**20).cuda()
        out[kind] = (nbytes, bool(torch.equal(got, want)))
    torch.cuda.synchronize()
    distributed.shutdown()
    queue.put(out)


def _sweep_cli(world: int, argv, timeout_s: float):
    """``python -m tpudist_torch.bench.sweep`` as one process a visible
    card under the env contract; returns each rank's exit code and rank
    0's output. Every process is gone when it returns."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, TPUDIST_COORDINATOR=f"localhost:{port}",
                   TPUDIST_NUM_PROCESSES=str(world),
                   TPUDIST_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpudist_torch.bench.sweep", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs[0]


def overlap_sweep(torch, card: str) -> None:
    """Phase 26c: each collective's result at 1 MB against its closed
    form on the card (one NCCL process a card), then ``python -m
    tpudist_torch.bench.sweep`` over one process a card: all five kinds
    from 1 MB to 1 GB, its exit code and verdict file those of
    ``gate(records)``, whatever it says, then ``--peak-gbps`` far below
    and far above the measured bus bandwidth (exit 0 and ``success``,
    exit 1 and ``fail``). Prints the best bus GB/s per kind and its
    percentage of the peak the sweep gated on, the NVLink status it was
    read from and the topology (``nvidia-smi topo -m``)."""
    from tpudist_torch.bench import sweep

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    port = _free_port()
    ranks = _spawn(_collective_check_rank,
                   [(r, world, port) for r in range(world)], 300,
                   "collectives check")
    for r in ranks:
        bad = [k for k in SWEEP_KINDS if not r[k][1]]
        if bad:
            fail(f"collectives: rank {r['rank']}'s {bad} at 1 MB differ "
                 f"from their closed form")
    print(f"collectives: {list(SWEEP_KINDS)} at 1 MB over {world} NCCL "
          f"rank(s) equal their closed form on every rank; {card}")
    for args in (["nvlink", "--status", "-i", "0"], ["topo", "-m"]):
        out = sweep._smi(*args)
        print(f"nvidia-smi {' '.join(args)}:\n{(out or '(none)').rstrip()}")
    tmp = ROOT / "build" / "chip_smoke_sweep"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    rows, verdict = tmp / "sweep.jsonl", tmp / "status.txt"
    rcs, out = _sweep_cli(world, [
        "--kinds", ",".join(SWEEP_KINDS), "--min-mb", "1", "--max-mb",
        "1024", "--iters", "10", "--out", str(rows), "--verdict-path",
        str(verdict), "--bench-out", str(tmp / "BENCH_COLLECTIVES.json")],
        900)
    for line in out.splitlines():
        if line.startswith("tpudist: sweep on"):
            print(line)
    records = [json.loads(ln) for ln in rows.read_text().splitlines()]
    g = sweep.gate(records, 90.0)
    want_rc = {True: 0, False: 1, None: 3}[g["ok"]]
    want_status = {True: "success", False: "fail", None: "ungateable"}[
        g["ok"]]
    status = verdict.read_text() if verdict.is_file() else None
    best = {}
    for r in records:
        if r["bus_gbps"] > best.get(r["kind"], (0, None))[0]:
            best[r["kind"]] = (r["bus_gbps"], r)
    for kind, (gbps, r) in best.items():
        pct = r["pct_of_ring_peak"]
        print(f"collectives sweep: {kind} best bus {gbps:.2f} GB/s at "
              f"{r['message_bytes']} B (algo {r['algo_gbps']:.2f} GB/s, "
              f"min {r['min_s'] * 1e3:.4f} ms, mean "
              f"{r['mean_s'] * 1e3:.4f} ms); "
              + (f"{pct:.1f} % of the peak" if pct is not None
                 else "no peak to gate on") + f"; {world} cards; {card}")
    print(f"collectives sweep: exit codes {rcs}, verdict {status!r}; "
          f"gate(records) {g}")
    if rcs != [want_rc] * world or status != want_status:
        fail(f"collectives sweep: exit codes {rcs} and verdict {status!r}, "
             f"gate(records) says {want_rc} and {want_status!r}")
    # one card moves no bytes between cards: its all-reduce bus rate is
    # 0 by the nccl-tests factor 2 (n - 1) / n, so there is no rate to
    # set a peak far below or above (its gate is ungateable, held above)
    bus = best["all_reduce"][0] if world > 1 else None
    for peak, rc, word in (() if bus is None else
                           ((bus / 1e3, 0, "success"),
                            (bus * 1e3, 1, "fail"))):
        verdict.unlink(missing_ok=True)
        rcs, _ = _sweep_cli(world, [
            "--kinds", "all_reduce", "--min-mb", "1024", "--max-mb", "1024",
            "--iters", "3", "--peak-gbps", repr(peak), "--verdict-path",
            str(verdict)], 300)
        status = verdict.read_text() if verdict.is_file() else None
        print(f"collectives sweep: --peak-gbps {peak:.4f}: exit codes "
              f"{rcs}, verdict {status!r}")
        if rcs != [rc] * world or status != word:
            fail(f"collectives sweep: --peak-gbps {peak}: exit codes {rcs},"
                 f" verdict {status!r}, want {rc} and {word!r}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"collectives: phase 26c {time.perf_counter() - t0:.1f} s")


def _cp_fault_rank(rank, world, port, argv, verdict, queue):
    """``_dp_train_rank`` with a fault planted for ``--context-drift``:
    the context ranks left out of the step's mean (each rank's grads and
    loss its own sequence chunk's, never averaged over the chunks)."""
    from tpudist_torch import engine as engine_lib

    real = engine_lib.make_layout

    def make_layout(*args, **kw):
        lay = real(*args, **kw)
        lay.mean_group = lay.batch_group
        return lay
    engine_lib.make_layout = make_layout
    engine_lib.ShardLayout.mean_ways = property(lambda self: self.batch)
    _dp_train_rank(rank, world, port, argv, verdict, queue)


def context_drift(torch, fa, fx, card: str, one) -> None:
    """``--context-drift`` (two cards or more, beside ``--only-context``):
    25b's ``--context <cards>`` ring run with :func:`_cp_fault_rank`'s
    fault in every spawned rank, against 25b's one-card run (``one``);
    prints each ``|d|`` and whether 25b's hold (``CP_ATOL``) passes it.
    Fails only if the run fails."""
    t0 = time.perf_counter()
    tag = "drift_cp_mean"
    argv = CONTEXT_ARGV + ["--context", str(torch.cuda.device_count())]
    run = _mesh_cli(torch, fa, card, tag, argv, 2048,
                    rank_fn=_cp_fault_rank, want=want_launches(
                        fa, _model_of(argv), 2048, 4, 2, False,
                        torch.cuda.device_count(), "ring"))
    got = {"losses": run["losses"], "epochs": [
        (r["avg_loss"], r["eval_loss"]) for r in run["recs"]
        if r["kind"] == "epoch"]}
    a, b, worst, err = _expert_gap(got, one, 0.0)
    print(f"drift {tag}: the context ranks left out of the step's mean; "
          f"step losses and epochs (Avg, eval) {a} against one card's {b}: "
          f"|d| {[abs(x - y) for x, y in zip(a, b)]}, max {worst:.6f}; "
          f"25b's hold ({CP_ATOL} absolute) "
          f"{'passes' if err <= CP_ATOL else 'fails'} it; {card}")
    print(f"context drift: {time.perf_counter() - t0:.1f} s")


def _model_of(argv):
    from tpudist_torch import config as config_lib
    return config_lib.parse_args(argv).model


def _guarded(what: str, fn, *args):
    """``fn(*args)``; a phase that fails (``fail``'s exit, or an
    exception) is reported and its paths left out, so the modes after it
    still run. Returns ``(paths, ok)``."""
    try:
        return fn(*args), True
    except SystemExit as e:
        print(f"chip_smoke: {what} failed ({e.code}); going on",
              flush=True)
    except Exception:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: {what} raised; going on", flush=True)
    return {}, False


def only_modes(torch, fa, fx, card: str, args) -> int:
    """``--only-overlap``, ``--only-expert`` and ``--only-context`` (any
    of them, with ``--context-drift`` beside the last), in one run:
    phase 3's checks of the flash and fused-head kernels once, then each
    mode's phases, a mode that fails reported and the next run; then the
    kernels' launches by path, and the result line unless a mode
    failed. ``--only-overlap`` is phases 26a-c."""
    import torch.nn.functional as F

    fwd = check_flash(torch, fa, F)
    check_flash_bwd(torch, fa)
    check_fused_xent(torch, fx)
    paths, failed = {}, []
    multi = torch.cuda.device_count() >= 2

    def run(what, fn, *a):
        got, ok = _guarded(what, fn, *a)
        paths.update(got)
        if not ok:
            failed.append(what)
        torch.cuda.empty_cache()

    if args.only_overlap:
        run("26a", overlap_body, torch, fa, card)
        if multi:
            run("26b", overlap_cli, torch, fa, fx, card)
        run("26c", lambda: overlap_sweep(torch, card) or {})
    if args.only_context:
        run("25a", context_ring, torch, fa, fx, F, card, [fwd])
        if multi:
            ones = {}
            run("25b", context_cli, torch, fa, fx, card, ones)
            if args.context_drift and "one" in ones:
                run("drift", lambda: context_drift(
                    torch, fa, fx, card, ones["one"]) or {})
    before = set(paths)
    if args.only_expert:
        ref = {}
        run("18a", moe_train, torch, fa, fx, card, ref)
        if ref:
            run("24a", expert_body, torch, fa, card, ref)
            if multi:
                run("24b", expert_cli, torch, fa, fx, card, ref)
    # the MoE's paths run the fused head as well
    expert = set(paths) - before
    # every path ran the flash forward and a backward (the merged kernel
    # or the split pair, as its lengths route it); the exact counts were
    # held path by path
    bwd = ("flash_attention_bwd_dq", "flash_attention_bwd_dqkv")
    missing = [p for p in paths if paths[p]["flash_attention_fwd"] < 1
               or sum(paths[p][name] for name in bwd) < 1
               or (p in expert and min(paths[p]["fused_xent_fwd"],
                                       paths[p]["fused_xent_bwd"]) < 1)]
    print(json.dumps({"launches": paths,
                      "hop_timings": fwd.get("hop_timings")}))
    if missing:
        fail(f"the flash kernels launched no time on {missing}")
    if failed:
        fail(f"phase(s) {failed} failed")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the serve "
                         "slice")
    ap.add_argument("--only-tp", action="store_true",
                    help="phases 1-2, phase 6 (21b's reference) and "
                         "phase 21 alone: tensor parallelism on the "
                         "visible cards")
    ap.add_argument("--only-serve-mesh", action="store_true",
                    help="phases 1-2, phase 3's flash forward checks, "
                         "phase 4, phase 22 and phase 23 alone: serving "
                         "on the visible cards")
    ap.add_argument("--only-expert", action="store_true",
                    help="phases 1-2, phase 3's checks of the flash and "
                         "fused-head kernels, phase 18a (the reference) "
                         "and phase 24 alone: the MoE's expert axis on "
                         "the visible cards")
    ap.add_argument("--only-context", action="store_true",
                    help="phases 1-2, phase 3's checks of the flash and "
                         "fused-head kernels and phase 25 alone: context "
                         "parallelism (the ring and Ulysses) on the "
                         "visible cards")
    ap.add_argument("--only-overlap", action="store_true",
                    help="phases 1-2, phase 3's checks of the flash and "
                         "fused-head kernels and phase 26 alone: the "
                         "overlap plane and the collective sweep on the "
                         "visible cards (with --only-expert and "
                         "--only-context: each mode after the checks, "
                         "run once)")
    ap.add_argument("--context-drift", action="store_true",
                    help="beside --only-context, on two cards or more: "
                         "25b's ring run with the context ranks left out "
                         "of the step's mean, against 25b's hold")
    ap.add_argument("--expert-drift", action="store_true",
                    help="phases 1-2, then on two cards or more a mesh "
                         "without the expert axis, a planted expert "
                         "fault and a second seed, each against 24b's "
                         "holds")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from tpudist_torch.ops.cuda import build
    from tpudist_torch.ops.cuda import flash_attention as fa
    from tpudist_torch.ops.cuda import fused_xent as fx

    # phase 1: device
    walls = PhaseWalls()
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for f32 matmuls and cuDNN convolutions")

    # phase 2: build every kernel of the paths from the checkout
    build_all(build, fa, fx)
    walls.lap("1-2")
    if args.only_tp:
        return only_tp(torch, fa, fx, card)
    if args.only_serve_mesh:
        return only_serve_mesh(torch, fa, fx, card)
    if args.only_overlap or args.only_expert or args.only_context:
        return only_modes(torch, fa, fx, card, args)
    if args.context_drift:
        fail("--context-drift runs beside --only-context")
    if args.expert_drift:
        if torch.cuda.device_count() < 2:
            fail("--expert-drift runs on two cards or more")
        return expert_drift(torch, fa, fx, card)

    # phase 3: kernels vs plain versions, timings
    fwd = check_flash(torch, fa, F)
    bwd = time_flash_bwd(torch, fa, F, check_flash_bwd(torch, fa))
    xent = time_fused_xent(torch, fx, F, check_fused_xent(torch, fx))
    walls.lap("3")

    # phases 4-6 and 8-9: the serving paths and the training paths at
    # full width, each with the launch counts set to 0 just before
    paths, phase6 = {}, {}
    engine, params, base, paths["serve"] = serve_slice(torch, fa, fx,
                                                       args.profile)
    # phase 22a's references: phase 4's tokens and phase 18c's; phase
    # 23a's: phase 14a's, 14b's and 18c's paged runs
    serve_tokens = {"serve": _tokens_of(base)}
    # phase 4b: overload on the same graph engine
    paths["serve_overload"] = serve_overload(torch, engine, params, base)
    walls.lap("4")
    del engine, params
    torch.cuda.empty_cache()
    for tag, seq, epochs, kw in (
            ("train_seq2048", 2048, 2, {}),
            ("train_seq512", 512, 1, {"details": phase6}),
            # phase 8: the fused head at the slice's shape
            ("train_seq2048_fused", 2048, 1,
             dict(extra=("--lm-head", "fused"), want_head="fused")),
            # phase 9: bf16, bf16 Adam nu, the auto policy picking the
            # fused head under a device memory pinned at 3 GB (the state
            # alone is 2.15 GB there)
            ("train_seq512_bf16_auto", 512, 1,
             dict(extra=("--dtype", "bfloat16", "--lm-head", "auto",
                         "--adam-nu-dtype", "bfloat16"),
                  hbm_bytes=3e9, want_head="fused"))):
        paths[tag] = train_slice(torch, fa, fx, tag, seq, epochs=epochs,
                                 n_samples=32, **kw)
    walls.lap("5-6, 8-9")

    # phase 7: one full-width training step, kernels vs plain versions
    for seq, fused in ((512, False), (2048, False), (2048, True)):
        step_check(torch, fa, fx, seq, fused)
    walls.lap("7")

    # phase 10: data parallelism, the CLI at one process a card (NCCL),
    # then the reduce across two ranks on one card (gloo)
    torch.cuda.empty_cache()
    paths["train_seq512_dp"] = dp_train_slice(torch, fa, card)
    dp_reduce_check(torch, card)
    walls.lap("10")

    # phase 11: the superstep on CUDA graphs: (a) phase 9's configuration
    # per-step and as the superstep under a streaming staging budget,
    # (b) the MLP default, (c) phase 10a's spawn with the all-reduce
    # captured
    torch.cuda.empty_cache()
    sup_paths, obs_on, obs_argv, obs_env = superstep_slice(torch, fa, fx,
                                                           card)
    paths.update(sup_paths)
    superstep_mlp(torch, fa, fx, card)
    paths["train_seq512_dp_superstep"] = dp_train_slice(
        torch, fa, card, tag="train_seq512_dp_superstep", n_samples=80,
        dispatch=("--log-every", "4", "--steps-per-dispatch", "4"),
        want_graphs=(2, {"superstep": 1, "step": 2}))
    walls.lap("11")

    # phase 12: the autotuner on the card: (a) the MLP default and the
    # capture OOM drill, (b) remat against no remat replayed, then the
    # full-width search with remat and accumulation in captured probes
    torch.cuda.empty_cache()
    tuner_mlp(torch, fa, fx, card)
    remat_check(torch, card)
    paths[TUNE_PATH] = tuner_full_width(torch, fa, fx, card)
    walls.lap("12")

    # phase 13: the observability every default run writes: (a) phase
    # 11a's default run's artifacts, then its configuration off and on
    # again; (b) phase 4's serving configuration through the serve CLI,
    # traced and not; (c) the stall watchdog during graph replays
    torch.cuda.empty_cache()
    paths.update(obs_train(torch, fa, fx, card, obs_on, obs_argv, obs_env))
    paths.update(obs_serve(torch, fa, fx, card))
    stall_drill(torch, card)
    walls.lap("13")

    # phase 14: the paged serving plane: (a) phase 4's stream paged, (b)
    # a shared prefix and speculation, (c) the fixed-memory pair, (d) the
    # serve CLI with the paged flags
    torch.cuda.empty_cache()
    paths.update(paged_serve(torch, fa, fx, base, card, args.profile,
                             serve_tokens))
    walls.lap("14")

    # phase 15: the serve tuner through the CLI and over the whole knob
    # space, the two KV layouts, the chaos surface with requeue replay,
    # and alert_events
    torch.cuda.empty_cache()
    paths.update(serve_tune_chaos(torch, fa, fx, base, card, args.profile))
    walls.lap("15")

    # phase 16: the serve drill's matrix on the card at config #5's
    # model, then its overload in-process
    torch.cuda.empty_cache()
    paths.update(serve_drill(torch, fa, fx, card))
    walls.lap("16")

    # phase 17: the train side's chaos drill on the card at config #5's
    # width, its baseline in-process, and what the asynchronous
    # checkpoint writer buys
    torch.cuda.empty_cache()
    paths.update(train_chaos(torch, fa, fx, card))
    walls.lap("17")

    # phase 18: the MoE at bench.py's width: (a) the train CLI per-step
    # and as the superstep, (b) one step's grads kernels vs plain, (c)
    # the dense and paged engines, (d) the serve CLI
    torch.cuda.empty_cache()
    moe18 = {}
    paths.update(moe_phase(torch, fa, fx, card, args.profile,
                           serve_tokens, moe18))
    walls.lap("18")

    # phase 19: the rest of observability: (a) the live bus and the
    # device-time window over phase 11a's superstep, (b) --profile-dir and
    # python -m tpudist_torch.bench.profile, (c) the serve CLI's exporter
    torch.cuda.empty_cache()
    paths.update(obs_live(torch, fa, fx, obs_on, obs_argv, obs_env, card))
    walls.lap("19")

    # phase 20: FSDP: (a) the sharded step body and its superstep on a
    # one-rank NCCL mesh against the replicated body, (b) with two cards
    # or more, the train CLI with --fsdp <cards> against its replicated
    # run
    torch.cuda.empty_cache()
    paths.update(fsdp_body(torch, fa, card))
    if torch.cuda.device_count() >= 2:
        paths.update(fsdp_cli(torch, fa, card))
    walls.lap("20")

    # phase 21: tensor parallelism: (a) the tensor path's step body and
    # its superstep on a one-rank NCCL mesh against the replicated body,
    # (b) with two cards or more, the train CLI with --tensor <cards>
    # (and --fsdp 2 --tensor 2) held to phase 6's losses, and the MoE at
    # --tensor <cards> held to its one-card run
    torch.cuda.empty_cache()
    paths.update(tp_body(torch, fa, card))
    if torch.cuda.device_count() >= 2:
        paths.update(tp_cli(torch, fa, fx, card, phase6["losses"]))
    walls.lap("21")

    # phase 22: serving on several cards: (a) phase 4's engine and phase
    # 18c's dense MoE engine on a one-rank NCCL serve mesh, bitwise their
    # tokens, (b) with two cards or more, the serve CLI as one NCCL
    # process a card against one card's run
    torch.cuda.empty_cache()
    paths.update(serve_mesh_one(torch, fa, card, serve_tokens))
    if torch.cuda.device_count() >= 2:
        paths.update(serve_mesh_cli(torch, fa, fx, card,
                                    *phase4_engine(torch)))
    walls.lap("22")

    # phase 23: the paged plane on a serve mesh: (a) phase 14a's, 14b's
    # and 18c's paged engines on a one-rank NCCL serve mesh, bitwise their
    # tokens, (b) with two cards or more, the serve CLI's paged runs
    # (replicated and split pools, speculation with a shared prefix, the
    # MoE, the tuner) at one NCCL process a card against one card's,
    # serve_kill with its requeued attempt, and the drill at the cards
    torch.cuda.empty_cache()
    paths.update(paged_mesh_one(torch, fa, card, serve_tokens))
    if torch.cuda.device_count() >= 2:
        paths.update(paged_mesh_cli(torch, fa, fx, card))
    walls.lap("23")

    # phase 24: the MoE's expert axis: (a) phase 18a's configuration on a
    # one-rank NCCL mesh whose expert group the layout takes, bitwise
    # 18a's losses, per-step and replayed (24b, on several cards, runs
    # under --only-expert)
    torch.cuda.empty_cache()
    paths.update(expert_body(torch, fa, card, moe18))
    walls.lap("24")

    # phase 25: context parallelism: (a) the ring's hop merge, then the
    # zigzag ring with flash hops over 4 virtual ranks on one card against
    # one causal kernel call and the einsum ring, and the hop shapes'
    # times (25b, on several cards, runs under --only-context)
    torch.cuda.empty_cache()
    paths.update(context_ring(torch, fa, fx, F, card, [fwd] + bwd))
    walls.lap("25")
    if args.profile:
        for seq, head, dt in ((2048, "plain", "float32"),
                              (2048, "fused", "float32"),
                              (512, "plain", "float32"),
                              (512, "fused", "bfloat16")):
            profile_train(torch, seq, head, dt)
        profile_superstep(torch, "mlp", [], 25)
        profile_superstep(
            torch, "seq 512 bf16 fused", [
                "--model", "transformer", "--seq-len", "512",
                "--train-batch-size", "8", "--n-samples", "80",
                "--dtype", "bfloat16", "--adam-nu-dtype", "bfloat16",
                "--lm-head", "fused"], 4)
        mma_peaks(torch, build)

    reaches = {"flash_attention_fwd": tuple(paths),
               "flash_attention_bwd_dq": ("train_seq2048",
                                          "train_seq2048_fused"),
               "flash_attention_bwd_dkv": ("train_seq2048",
                                           "train_seq2048_fused"),
               "flash_attention_bwd_dqkv": ("train_seq512",
                                            "train_seq512_bf16_auto",
                                            "train_seq512_dp", *SUPERSTEP,
                                            TUNE_PATH, *OBS_PATHS,
                                            TRAIN_DRILL_PATH,
                                            *MOE_TRAIN_PATHS,
                                            *OBS_LIVE_PATHS[:2],
                                            *FSDP_PATHS, *TP_PATHS,
                                            *(p for p in TP_CLI_PATHS
                                              if p in paths),
                                            *EXPERT_PATHS, *CONTEXT_PATHS),
               "fused_xent_fwd": ("train_seq2048_fused",
                                  "train_seq512_bf16_auto",
                                  "train_seq512_dp", *SUPERSTEP,
                                  TUNE_PATH, *OBS_PATHS, TRAIN_DRILL_PATH,
                                  *MOE_TRAIN_PATHS, *OBS_LIVE_PATHS[:2],
                                  *FSDP_PATHS, *EXPERT_PATHS),
               "fused_xent_bwd": ("train_seq2048_fused",
                                  "train_seq512_bf16_auto",
                                  "train_seq512_dp", *SUPERSTEP,
                                  TUNE_PATH, *OBS_PATHS, TRAIN_DRILL_PATH,
                                  *MOE_TRAIN_PATHS, *OBS_LIVE_PATHS[:2],
                                  *FSDP_PATHS, *EXPERT_PATHS)}
    records = [fwd] + bwd + xent
    for rec in records:
        by_path = {p: paths[p].get(rec["name"], 0) for p in paths}
        rec["launches_by_path"] = by_path
        rec["launches"] = sum(by_path.values())
        missing = [p for p in reaches[rec["name"]] if by_path[p] < 1]
        if missing:
            fail(f"{rec['name']} launched no time on {missing}")

    print(walls.line())
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class PhaseWalls:
    """Each phase's wall time in the full run, printed as one line at its
    end: what the script's time limit is spent on."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.rows = []

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        self.rows.append((phase, now - self.last))
        self.last = now

    def line(self) -> str:
        return ("chip_smoke: phase walls " + ", ".join(
            f"{p} {s:.1f} s" for p, s in self.rows)
            + f"; total {time.perf_counter() - self.t0:.1f} s")


def only_tp(torch, fa, fx, card: str) -> int:
    """``--only-tp``: phase 3's kernel checks, phase 6's run (phase 21b's
    reference), then phase 21 on the visible cards, then the result
    line."""
    import torch.nn.functional as F

    # phase 3's checks, rows 1-4 at a tensor rank's heads among them
    check_flash(torch, fa, F)
    check_flash_bwd(torch, fa)
    phase6 = {}
    paths = {"train_seq512": train_slice(torch, fa, fx, "train_seq512", 512,
                                         epochs=1, n_samples=32,
                                         details=phase6)}
    torch.cuda.empty_cache()
    paths.update(tp_body(torch, fa, card))
    if torch.cuda.device_count() >= 2:
        paths.update(tp_cli(torch, fa, fx, card, phase6["losses"]))
    for name in ("flash_attention_fwd", "flash_attention_bwd_dqkv"):
        missing = [p for p in paths if paths[p].get(name, 0) < 1]
        if missing:
            fail(f"{name} launched no time on {missing}")
    print(json.dumps({"launches": paths}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def only_serve_mesh(torch, fa, fx, card: str) -> int:
    """``--only-serve-mesh``: phase 3's flash forward checks, phase 4,
    then phases 22 and 23 on the visible cards (22a and 23a without the
    MoE, whose reference, phase 18c, does not run here; 23a against
    14a's and 14b's engines run here on one card), then the result
    line."""
    import torch.nn.functional as F

    check_flash(torch, fa, F)
    engine, params, base, counts = serve_slice(torch, fa, fx, False)
    paths = {"serve": counts}
    torch.cuda.empty_cache()
    paths.update(serve_mesh_one(torch, fa, card,
                                {"serve": _tokens_of(base)}))
    if torch.cuda.device_count() >= 2:
        paths.update(serve_mesh_cli(torch, fa, fx, card, engine, params))
    engine.release()
    del engine, params
    torch.cuda.empty_cache()
    paths.update(paged_mesh_one(torch, fa, card, paged_refs(torch)))
    if torch.cuda.device_count() >= 2:
        paths.update(paged_mesh_cli(torch, fa, fx, card))
    missing = [p for p in paths
               if paths[p].get("flash_attention_fwd", 0) < 1]
    if missing:
        fail(f"flash_attention_fwd launched no time on {missing}")
    print(json.dumps({"launches": paths}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
