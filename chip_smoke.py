"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds ops/csrc/*.cu for sm_90a (one process per
             source, in parallel); ptxas's registers / shared memory /
             spills per kernel and the build seconds are printed;
3. kernels — each serving kernel against its plain PyTorch version at the
             serving path's shapes (GPT_SMALL, batch 8, max_seq 1024; the
             paged pools [513, 16, 12, 64] with tables from a seeded
             permutation of pages 1..512, one dead lane with a zeroed
             table row, two lanes sharing their first 4 pages), in bf16
             and in float32: bf16 outputs per element within 2^-7 x
             (|plain| + its row's max |plain|) + 1e-5, float32 within
             1e-5, updated KV caches bitwise (paged: pages 1..512 — page
             0 is the scratch page dead lanes write — and the shared and
             dead-lane pages untouched), logits_head also at batch 96;
             then each kernel, its plain version and one PyTorch library
             call are timed as CUDA-graph replays (device time without
             the host's enqueue, which the eager time eager_ms includes;
             fused_ln's yardstick F.layer_norm on the same rows, its
             weight and bias rounded to x's dtype as PyTorch needs them),
             in both dtypes;
             the decode kernels also with every
             lane at position 15, 511 and 1023 (checked against the plain
             version there too), and the paged one beside paged_gather +
             SDPA as well as SDPA on the pre-gathered view;
3w. widths — the widths the reference takes that the port once raised
             on (ROADMAP C4, C5), one small case each, bf16 and float32,
             against the plain versions: flash at head_dim 24, 48, 80,
             96 (padded to the next instance) and 160, 256, 320 (the
             split route; also its bias forms: a random bias a head with
             SQ = T, causal, and a padding bias a batch row with SQ = 1),
             the slab and paged decode kernels at hd 8, 20, 96 (the next
             power-of-two instance) and 160, 256, 320 (the split route),
             caches bitwise, the fused-LN forward and backward at D 2,560
             to 65,536 (the backward's looped block a row, the forward's
             two-pass one), logits_head at D 8,192 (the streamed
             instance); then the flash split route's forward, dQ and
             dK/dV timed at [16, 1024, 8, 256] causal bf16 beside SDPA,
             and the decode pair's at [8, 1024, 4, 256] (every lane at
             1023) beside SDPA on the slab and on the gathered view;
4. serving — a GPT_SMALL bf16 engine (seed weights, max_batch 8, max_seq
             1024, buckets 64..512) serves 16 seeded greedy requests
             through Scheduler + EngineLoop; every request must finish
             "done" and every kernel's launch count must be what the
             decode ticks imply (counts are zeroed just before); span
             tracing is on (its default) here and in every later phase;
4m. front-door — a ``FrontDoor`` over phase 4's engine on an ephemeral
             port: 4 ``/generate`` requests carrying a trace context in
             their bodies and one migrated through ``/prefill`` (pushed
             over the KV socket to the front door's own
             ``KVTransferServer``) and ``/resume``; every request done,
             its root span under the caller's span, the migration's
             ``serve/kv_send`` and ``serve/kv_adopt`` in its trace,
             launches exactly the ticks'; ``GET /metrics`` parses and its
             ``paddle_serve_*`` counters equal the registry's; ``GET
             /health`` carries ``span_rollups_ms``; a ``FleetPoller``
             over the one replica writes a ``FLEET.json`` whose rollup
             counts the requests the registry counted; an ``SLOEngine``
             fed phase 4's TTFTs and TPOTs prints ``slo_status()`` (not a
             gate). Then the decode tick's host ms with tracing on and
             off, in turns, 8 requests resident (printed, not gated);
4b. serve-paged — the same engine with kv_layout="paged" (page 16,
             default pool, prefix cache on) serves 16 greedy requests in a
             seeded order, 8 of them behind one 256-token system prompt:
             launch counts as in 4 with decode_paged in place of
             decode_slab, exactly 7 prefix-cache hits, 7 x 256 prompt
             tokens not prefilled, and every page back in the pool after
             the cache is cleared; its spans go to a process sink, and
             ``tools/trace_assemble`` finds each request one tree with no
             orphan: one ``serve/request`` root, one ``queue_wait`` and
             one ``prefill`` under it, a ``decode_tick`` for each token
             after the first (the tick spans, grouped by start, are the
             engine's ticks, each group its batch), one ``evict``;
4s. serve-spec — speculative decoding at full width: target GPT_SMALL
             bf16 with verify_window 4, draft GPT_SMALL at 3 layers from
             seed 1 (k 3), phase 4's 16 prompts x 64 greedy tokens through
             Scheduler + EngineLoop: every request done; launches exactly
             fused_ln 2 x 3, decode_slab 3, logits_head 1 a draft tick and
             none for the target's verify; the spec histogram's count
             equal to the windows; tokens/s, TTFT, TPOT, acceptance rate,
             tokens a window, verify ms and draft tick ms printed beside
             phase 4's;
4q. serve-int8 — GPT_SMALL with int8 weights (chunk 256): weight_nbytes
             and resident bytes (memory_allocated growth across
             construction, f32 truth dropped, KV cache excluded) below
             bf16's / 1.9; phase 4's traffic with phase 4's launch counts;
             a 256-token teacher-forced stream of decode logits against
             the f32 engine within the reference's bars (max_rel_err <
             0.06, perplexity drift < 0.02), top-1 agreement printed;
4d. serve-disagg — phase 4b's engine twice, as a prefill and a decode
             replica (``LocalReplica``) behind a ``DisaggRouter`` with a
             ``SharedPrefixIndex``: phase 4b's 16 requests, one thread a
             request, migrate at their first token (KV pages CRC-stamped
             and fingerprinted, 4-page chunks); every request done, 16
             migrated, 0 fallbacks, both pools whole after the prefix
             caches are cleared, ``paddle_kv_transfer_bytes_total`` out ==
             in == the handoffs' page bytes from ``pages_for(len)``, no
             decode tick on the prefill engine and launches exactly
             fused_ln 2L, decode_paged L, logits_head 1 a tick of the
             decode engine; TTFT, TPOT, tokens/s, handoff ms, export and
             adopt ms (CRC and copy shares), the prefix counts and the
             token agreement with 4b printed beside 4b's numbers (both
             replicas share the one card); each routed request is one
             trace across both replicas: ``serve/route`` its root, the
             prefill and the decode replica's ``serve/request`` on two
             loop threads, ``serve/kv_adopt``, no orphan (the in-process
             handoff has no socket hop: 4m times ``serve/kv_send``);
4g. serve-gang — the subprocess serving gang: ``python -m
             paddle_tpu_torch.tools.serve_fault_bench --device cuda`` as a
             subprocess (its card lane: GPT_SMALL bf16 replicas with phase
             4b's engine, two processes sharing the card, behind
             ``GangFrontDoor``): ``replica_sigkill`` (4b's 16 prompts x 64
             tokens at once, the busiest replica SIGKILLed mid-decode),
             ``engine_poisoned``, ``warm_restart_prefix`` (one replica with
             a prefix store, SIGKILLed and restored), ``disagg_gang`` (a
             prefill and a decode replica, 4b's 16 requests across the KV
             socket), ``engine_hang`` and ``overload_storm``. Gates: 0
             lost, 0 duplicated and no non-200 answer; restarts with causes
             crash, poisoned and hang; the idempotent retry's recorded
             answer under the original trace id; at least one record
             restored and the repeated system prompt prefilled
             suffix-only (the replica's own
             ``paddle_serve_prefill_tokens_total``); 16 migrated, 0
             fallbacks, KV bytes out == in == the pages' bytes; every
             surviving incarnation's heartbeat launches exactly fused_ln
             2L, decode_paged L, logits_head 1 a decode tick (its counts
             summed into the kernels line). Printed beside the card's
             name: each replica's start-up split (import, weights, engine,
             restore, warmup, ready), failover latency, TTFT / TPOT p50 /
             p99 beside 4b's, restart downtime, the prefix store's publish
             ms, and the token agreement with 4b (not gated: bf16 and a
             prefill in another bucket shape can part);
4tk. tp-kernels — the three tensor-parallel engines of 4t and 5t start
             at once (threads; each spawns its follower rank, the two
             ranks of an engine sharing cuda:0 over gloo) while the four
             kernels of the tp decode tick are checked at a rank's shapes
             against their plain versions, bf16 (``bf16_check``) and
             float32 (1e-5), caches and pools bitwise: fused_ln [8, 768]
             (every rank), decode_slab at nh / tp = 6 heads ([8, 1024, 6,
             64], a masked lane), decode_paged on pools [513, 16, 6, 64]
             (phase 3's tables), logits_head [8, 768] x [768, 50257] (the
             driver); the errors go into the kernels line as
             ``tp_max_abs_err``;
4t. serve-tp2 — GPT_SMALL bf16, ``EngineConfig(sharding="tp", tp=2)``,
             ``tp_devices=("cuda:0", "cuda:0")``, phase 4b's engine
             config and traffic (page 16, 513 pages, 8 slots, max_seq
             1024, 16 greedy requests, 8 behind one 256-token prompt)
             through Scheduler + EngineLoop. Gates: every request done; 7
             prefix hits and 7 x 256 tokens not prefilled; each rank's
             launches exact (decode_paged L and fused_ln 2L a tick a rank,
             logits_head 1 a tick on the driver; both ranks' counts zeroed
             just before, and summed into the kernels line); each rank's
             weight bytes exact after ``drop_reference_params()`` (the
             replicated leaves plus half of Megatron's split leaves, no
             head on the follower; storage and resident, layernorm
             parameters float32) and its pool exactly half of 4b's; with 8
             slots live, 16 timed ticks move exactly 2L all-reduces of [8,
             768] bf16 a tick a rank (``paddle_collective_bytes_total``);
             bf16 numbers: 8 prompts' prefill logits and 4 ticks (every
             engine fed the bf16 tp=1 engine's greedy tokens) stray from
             a float32 tp=1 engine's at most twice as far as a bf16 tp=1
             engine's (same seed weights) do, and the prefill's greedy
             tokens equal the bf16 tp=1 engine's, 8 of 8; the followers
             gone after ``close()``. Printed: TTFT p50 / p99
             and TPOT p50 beside 4b's, the tick on the host clock, the
             staged all-reduces' ms and share of it, the driver's device
             busy ms (``torch.profiler``, 16 more ticks), each rank's
             start-up split, and how many streams equal 4b's (not gated);
5. parity  — a 2-layer GPT_SMALL in float32 (TF32 off): prefill logits
             within 1e-4 of the full forward, and the slab and paged
             kernel engines and the plain-PyTorch engines must emit
             identical greedy tokens, with per-step logits within 1e-4; a
             repeated 80-token prompt prefills only its last 16 tokens
             with logits within 1e-4 of the first; two requests on a
             10-page pool are preempted and resumed and still emit the
             slab engine's tokens;
5s. spec-parity — the same model, slab and paged, k 3: a self-draft spec
             engine emits the target-alone kernel engine's greedy tokens
             with acceptance exactly 1.0 and 4 tokens a window; the kernel
             spec engine with a 1-layer draft emits the plain spec
             engine's (fused_decode=False) tokens, token for token;
5d. disagg-parity — the same model, slab and paged, one request at a
             time: the router's greedy tokens equal the colocated kernel
             engine's, token for token; an exported and adopted slot reads
             back bitwise from both pools; a page_size mismatch raises
             ``CacheConfigMismatch`` naming the field and keeps no page; a
             router without a decode replica degrades with
             ``no_phase_fleet`` and emits the same tokens;
5t. tp-parity — the same model, tp=2 (4tk's engines, ranks sharing the
             card) against tp=1 kernel engines, slab and paged: 4 prompts
             x 16 greedy tokens in one batch, prefill and per-step logits
             within 1e-4 and the tokens equal; a paged tp=2 -> tp=1
             handoff (one frame a rank a projection a chunk), the adopted
             pages bitwise the source's and the adopted slot's tokens the
             tp=1 engine's own; every follower of 4t and 5t gone after
             ``close()``. (4tk, 4t and 5t run after 5d, in this order.)
6. train kernels — flash forward, dQ, dK/dV against their plain versions
             at the training path's shapes (q/k/v [16, 1024, 12, 64]
             sliced from one packed qkv, causal) in bf16 (each element
             within 2^-7 x (|plain| + its row's max |plain|) + 1e-5, lse
             within 2e-5) and at batch 2 in float32 (2e-5 forward, 3e-4
             backward), and the flat AdamW sweep over n = 163,109,376
             with bf16 and float32 moments, bitwise (and at n 100,003
             and at an odd n one element off alignment: the vector tail
             and the scalar instance); the fused-layernorm
             forward (ln2 form: residual + bias_add emitting s; plain;
             dropout mask) and backward (dsx; dsx + mask) at rows
             [16 x 1024, 768] bf16 and [256, 768] float32 (s bitwise, y,
             ds, dx per element, mu/rstd 1e-5, dscale/dbias per column
             within 2^-18 x sum |term|, a second backward launch bitwise
             equal), and every form of both at 8 small shapes (odd D,
             each register path's cap and past it, R = 1), aligned and
             one element off; the CE forward at phase 7b's call [2048,
             768] x [768, 50304 -> 51200] and ERNIE-base's "vd" call with
             the decoder bias [960, 768] x [30522 -> 30720, 768], bf16,
             256 rows float32, and 6 small shapes in both layouts with
             and without the bias (D 772, padded and odd head strides;
             lse, gold 1e-4), timed by graph replay beside
             torch.matmul's floor; dQ's D = rowsum(dO * o) within 2e-5 of the plain
             one and dK/dV fed that D (as ``_Flash.backward`` feeds it);
             two more launches of dQ and dK/dV (and dK/dV taking D from
             its own dQ launch) bitwise equal; then the bf16 kernels,
             their plain versions and the library yardsticks are timed
             (the three flash kernels, SDPA's forward and the fused-LN
             forms and backward, each beside F.layer_norm /
             aten.native_layer_norm_backward, by CUDA-graph replay,
             eager_ms beside), and the pair dQ -> dK/dV as one
             record (``pair``: graph-timed, beside one SDPA backward and
             the two kernels' summed bound);
7. training — GPT_SMALL at full width and depth, batch 16 x 1024, bf16,
             flash, dots remat, flat AdamW kernel: 2 warm-up + 10 timed
             steps through tools/train_bench.py (counts zeroed just
             before the timed steps); every loss finite, the last below
             the first, launches per step flash_fwd 2L, flash_bwd_dq L,
             flash_bwd_dkv L, opt_adamw_flat 1;
7m. train-monitor — phase 7 again with ``train_bench --monitor``: one
             ``TrainMonitor`` row a timed step (each step syncs on its
             loss), every ``STEP_RECORD_KEYS`` key finite, the rows' MFU
             train_bench's own within 10%, the timed window's goodput
             over half ``productive_step``, launches as phase 7's; then
             the step's ms with the observability (tracing, the flight
             recorder, the registry, the monitor rows) on and off, in
             turns (printed, not gated);
7b. training-fln-vchunk — the same with the fused-layernorm block and the
             vocab-chunked CE (``train_bench --fused-ln --ce-vchunk
             1024``): launches per step as in 7 plus fused_ln 4L + 1,
             fused_ln_bwd 2L + 1 and ce_fwd 8 (one a 2048-row chunk);
             then 2-layer float32 card parity checks (TF32 off): 3 steps
             of the kernel step vs the plain step (every kernel lever off,
             plain sweep) for the flash arm and for the fused arm (flash,
             fused_ln, vocab chunk 1024, row chunks of 256), losses within
             1e-5 relative, step-1 gradients within 3e-4;
7a. attribution — the device-side observability on the main paths
             (``tools/profile_step.py``, ``observability/attribution.py``,
             ``utils/device_trace.py``): 7b's configuration, 2 warm-up
             steps, then two ``torch.profiler`` captures of 2 steps each.
             Gates a capture: the ``ATTRIBUTION.json`` passes ``validate``;
             every port kernel event maps to a ``KERNELS`` entry (paired
             one to one with the launches the wrappers recorded); each hand
             kernel's events a step equal its launch delta a step and 7b's
             counts; each hand kernel row's flops and bytes equal the sum
             of ``ops/kernel_costs.py``'s costs over its launches; the busy
             union is at most the capture's wall and the rows add up to it
             within 1 µs a step. Then 4b's engine (paged, 8 slots
             resident), 16 ticks captured: events a tick exactly fused_ln
             2L, decode_paged L, logits_head 1. Seeded regression: one
             step captured with ``remat="full"``, diffed by
             ``tools/perf_diff.py`` against a baseline from the first
             capture, must fail, with a ``config_lever`` cause naming remat
             and ``attribution.step.flops`` out of band. Printed, not
             gated: the A/A diff of the two plain captures, each hand
             kernel's fraction of its bound, the gap share (against the
             steps' wall without the profiler), the top residue groups;
8. flash-bias — the bias forms of the flash forward, dQ and dK/dV against
             their plain versions: bias [BB, SQ, T] with BB in {B, B*nh},
             SQ in {1, T}, causal and full, float32 and bf16, head_dim 64
             and 8 (padded), T 200, a random bias and a padding bias whose
             first key tile is wholly padded (-0.5 f32 max): float32
             within 1e-5, bf16 per element,
             every output finite; then at ERNIE-base's call ([48, 512, 12,
             64] bf16, a [48, 1, 1, 512] padding bias) each bias kernel,
             the same kernel without the bias, its plain version and SDPA
             with the same float attn_mask are timed (CUDA-graph replay
             for the kernels and the SDPA forward); dK/dV fed dQ's D, the
             backward kernels bitwise equal across launches, and the pair
             dQ -> dK/dV timed beside one SDPA backward with the mask;
9. ernie   — ERNIE-base (L 12, nh 12, D 768, d_ff 3072, V 30522) pretrains
             at full width and depth through ``train_bench --model
             ernie``: batch 48 x 512, bf16, flash with the padding bias,
             remat off, 2 warm-up + 10 timed momentum steps (counts zeroed
             just before them); losses finite and falling, launches per
             step exactly flash_fwd_bias, flash_bwd_dq_bias and
             flash_bwd_dkv_bias L each; 9b the same with ``--pad``
             (lengths 128-512); samples/s, MFU, peak GB printed;
9p. ernie-parity — 2-layer ERNIE_BASE in float32 (TF32 off), batch 4 x
             512 with padded lengths: 3 steps of the flash arm and of the
             fused arm (flash, fused_ln, vocab-chunked CE through ce_fwd's
             "vd" layout with the decoder bias) against the plain arm,
             losses within 1e-5 relative, every updated leaf within 1e-5
             of its largest |value|;
10k. opt-kernels — the sgd, momentum and adam kinds of the optimizer
             sweep (``ops/csrc/opt_megakernel.cu``) against their plain
             versions, bitwise: at ResNet-50's group size (25,557,032
             float32), at n 1, 7, 1001, 4099 and unaligned; sgd in float32
             and bf16, Nesterov off and on, AdamW's coeff 0.01; then each
             timed beside its plain version, its bytes bound and
             ``torch._fused_sgd_`` / ``_fused_adam_`` / ``_fused_adamw_``;
10p. fluid-parity — the fluid MLP under SGD, Momentum, Adam and AdamW
             (``fuse=True``, 5 steps) and ResNet-18 at 32² (3 steps) train
             on the card through the kernel route and through
             ``FLAGS_fuse_optimizer_pallas=False`` from the same scope:
             float32, losses and every persistable bitwise; one launch of
             the optimizer's kernel a step on the kernel route (counts
             zeroed just before), none on the other;
10. resnet50 — ResNet-50 (batch 128, 224², class 1000, float32) trains
             through ``Program`` → ``Momentum(0.01, 0.9, fuse=True)
             .minimize`` → ``Executor(CUDAPlace(0)).run`` (``train_bench
             --model resnet50``): the loss falls over 6 steps on one fixed
             fed batch; 1 warm-up + 10 timed steps on data made on the
             card, exactly one ``opt_momentum`` launch a step; then the
             ``--no-fuse`` arm; img/s, ms a step, MFU, peak GB printed.

11k. parallel-kernels — before the gangs, each kernel of phase 11's
             path at every gloo layout's per-rank shapes against its plain
             version, bf16: flash forward, dQ and dK/dV at [B/dp/M, 1024,
             nh/tp, 64] (bf16_check; lse and D within 2e-5), the fused-LN
             ln2 and plain forms and the backward with and without dsx on
             the B·1024/(dp·M·tp) rows of a microbatch (bf16_check; s
             bitwise; dscale / dbias within 2^-18 x sum |term|), ce_fwd on
             the last stage's row chunk with a GPT_SMALL head (1e-4), the
             AdamW sweep at (b)'s dp shard (bf16 and float32 moments,
             bitwise); each kernel's largest error goes into its record as
             ``parallel_max_abs_err``.

11. train-parallel — GPT training over ranks that share the one card
             over gloo (each collective staged through host memory): three
             ``python -m paddle_tpu_torch.parallel.launch`` gangs running
             ``train_bench``'s parallel lane (a nonzero exit fails the
             run), two ranks for (a)-(d) in turn, eight for (e), one NCCL
             rank for (f). GPT_SMALL at full width, bf16, flash, fused
             LN, vocab chunk 1024, dots remat, global batch 16 x 1024, 1
             warm-up + 3 timed steps, in (a) dp 2 psum at 6 layers, (b)
             dp 2 reduce-scatter with the flat sweep and a bf16 wire at 6
             layers, (c) tp 2 with sequence parallelism at 3 layers, (d)
             pp 2 with 4 microbatches at 6 layers, (e) dp 2 x pp 2 x tp 2
             with 2 microbatches at 2 layers (depth is the only cut, to
             keep the script inside its limit: (a), (b), (d) 12 -> 6, (c)
             6 -> 3 and (e) 4 -> 2 layers since the tp serving phases
             came; a gloo step's time is staging and shrinks with the
             layers), (f) one rank over an NCCL world of one. Every
             rank's launches a step are exactly its path's (flash 2L·M /
             L·M / L·M, fused LN 4L·M and its backward 2L·M plus M each on
             the last stage, ce_fwd there once a 2048-row chunk, the
             AdamW sweep once in (b) and (f); L and M the rank's layers
             and microbatches), its losses finite and falling, and its
             wire-byte counter equal to the ring model's bytes for the
             layout (under tp the sequence collectives too: 6 all-gathers
             and 5 sum-scatters of [mb, 1024, 768] bf16 a layer a
             microbatch, the remat recompute's included); 11p, first in
             each layout: 3 float32 steps at lr 1e-2 of a 2-layer
             GPT_SMALL (TF32 off, global batch 8 x 256) held against the
             world-1 run, which each rank runs itself first
             (``train_bench.parity_reference``, ``parity_ok``):
             each step's loss within 2e-4 and grad norm within 1e-3, the
             rank's update (p - p0) and its moments (under reduce-scatter
             its flat shard against the same slice of the world-1
             moments) within 1e-3 in the 2-norm, each leaf's update
             within 1e-2, the params within 2e-4 + 2e-3·|p| on all but
             1e-4 of the elements; ms a step, tokens/s and wire bytes
             printed a configuration; in (a) each rank traces one more step
             and prints ``comm_opt.measure_overlap_fraction`` of it (the
             staged collectives' host ranges against the device's work;
             not gated).

12. elastic — fault-tolerant GPT training (``python -m
             paddle_tpu_torch.tools.fault_bench --device cuda``, every job
             supervised by ``parallel.launch``): GPT_SMALL at full width
             and 2 of its 12 layers (depth the one cut, to keep the
             script's time; it runs in the background, started before
             phase 11 and checked after phase 13, beside those phases'
             gangs) with phase 7b's levers (bf16, flash, fused LN,
             vocab chunk 1024, dots remat, the flat AdamW sweep, bf16
             moments), batch 16 x 1024, lr 1e-4, 6 steps saving every 3,
             one rank an NCCL world of one. Scenarios: baseline; aa (a
             second uninterrupted run, bitwise equal: the step's
             determinism); sigkill_midstep (restart cause crash, restore
             step 3; its ``GOODPUT.json`` a gang goodput fraction in (0,
             1] with ``restart_downtime`` the supervisor's
             ``restart_history`` window within 1 s); sigterm_preempt
             (SIGTERM on the launcher CLI, forwarded; launcher exit 0,
             the relaunch restores step 4); corrupt_shard (a truncated
             leaf and a planted uncommitted step; restore step 3); hang
             (the watchdog fires past its 10 s deadline, exit 43, cause
             hang; the bundle holds the flight ring); sigstop_blame (two
             ranks at GPT_SMALL's width, 1 layer, batch 2 x 8, lock-
             stepped by a flight-stamped barrier; rank 1 SIGSTOPs before
             step 3's; rank 0's 4 s watchdog fires; the blame pass names
             rank 1, never_entered, seq 3 ``allreduce_grads``, 0 gaps,
             ``paddle_blamed_rank`` 1; no process of the gangs is left
             after the phase); dp_reshard (a dp-2 save by two gloo ranks
             sharing the card, restored at dp 1: the params' crc32 and
             every moment leaf's equal to the save's, the loss within 5%
             of the baseline's). Each recovery ends on the
             baseline's params crc32 bit for bit; every completed
             incarnation's launches are exactly its steps x its path's
             (phase 11's counts); the save (snapshot and write apart),
             bytes, restore, reshard and recovery times are printed.
12r. ring  — ring attention at cp 2 over gloo on the card (two ranks
             sharing cuda:0) at GPT_SMALL's attention shape [16, 1024,
             12, 64], float32, causal: the output within 1e-5 and the
             gradients through the reverse ring within 1e-4 of plain
             full-sequence attention (|a - b| <= tol + tol·|b|).

13k. sharded-kernels — the kernels at the per-rank shapes phase 13 adds,
             against their plain versions (bf16_check; lse and D within
             2e-5): the flash bias forms at ERNIE-base tp 2's [48, 512, 6,
             64] with a padding bias [48, 1, 1, 512], the fused-LN pair in
             ERNIE's post-LN form (residual, eps 1e-12; s bitwise, the
             backward without dsx: dscale / dbias within 2^-18 x sum
             |term|) on a tp-2 rank's 12,288 rows; GPT fsdp at dp 2 runs
             11k's dp-2 shapes. Each largest error goes into its record as
             ``sharded_max_abs_err``.
13. train-sharded — two ``parallel.launch`` gangs of two gloo ranks
             sharing the card, ``train_bench``'s parallel lane, 1 warm-up
             + 3 timed steps (a nonzero exit fails the run): (a) GPT_SMALL
             at full width and 6 of its 12 layers under ``--sharding
             fsdp`` at dp 2
             with 7b's levers (bf16, flash, fused LN, vocab chunk 1024,
             dots remat; bf16 moments), global batch 16 x 1024: launches a
             step exactly flash 2L / L / L, fused LN 4L + 1 and its
             backward 2L + 1, ce_fwd once a 2048-row chunk and no
             optimizer kernel (the per-leaf AdamW, as the reference's
             GSPMD step); each rank's param and moment bytes exactly the
             plan's shards (half the sharded leaves plus the replicated
             tail); wire bytes the ring model's all-gather and
             reduce-scatter of every sharded leaf and psum of the rest;
             then in the same gang the same step under ``--sharding
             dp`` (every leaf whole, psum'd), so that each rank's peak
             memory stands beside fsdp's; (b)
             ERNIE-base at full width and 6 of its 12 layers at tp 2 (dp
             1), batch
             48 x 512, flash with the padding bias, fused LN, remat off:
             launches a step exactly 3 flash bias kernels and 2 + 2 fused
             LN a layer, wire bytes the psum of every replicated leaf and
             the sequence collectives of [48, 512, 768] bf16 (4L + 1
             all-gathers and as many sum-scatters). Losses finite and
             falling. 13p, first in each layout: (a) 3
             float32 steps of a 2-layer GPT_SMALL against the world-1 run
             (11p's ``parity_ok``), (b) 3 float32 steps of a 2-layer
             ERNIE_BASE (batch 4 x 512, padded lengths) against the
             one-device step in the same process (``ernie_parity_ok``).
             Depth is the one cut (12 -> 6 layers in (a) and (b), to keep
             the script inside its limit since the tp serving phases;
             each step's time is gloo staging and scales with the
             layers); the exact-bytes gates are computed at that depth.
             13c: (a)'s dp-2 state, saved after its timed
             steps by ``ShardedCheckpointer`` (async, then ``wait``), is
             restored whole at dp 1 on the card in this process: every
             rank's saved param and moment leaf has the crc32 of its
             block of the restore; save, wait and restore ms printed.

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

B, S = 8, 1024           # the serving path's batch and max_seq
PAGE = 16                # the paged serving path's page size


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from paddle_tpu_torch.ops import _build

    info = _build.build()
    print(f"[build] {info.path} in {info.seconds:.2f} s "
          f"(cached={info.cached})")
    for src, log in info.logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "error", "warning")):
                print(f"[build] {src}: {line.strip()}")
    _build.load()
    return info


def _time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_SIDE = None     # the stream _time_graph_ms warms up on


def _time_graph_ms(fn, calls: int, replays: int = 20) -> float:
    """ms a call of ``fn`` on the device alone: ``calls`` calls captured
    into one CUDA graph, replayed ``replays`` times between two CUDA
    events. Eager back-to-back calls of a kernel shorter than its
    wrapper's host cost time the host's enqueue, not the kernel."""
    global _SIDE
    if _SIDE is None:
        _SIDE = torch.cuda.Stream()
    side = _SIDE
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def _over_layers(fn, n: int):
    """A thunk calling fn(0), fn(1), ..., fn(n-1), fn(0), ... — timed
    launches walk the layers' slabs as a decode tick does, so the caches
    come from HBM, not from L2."""
    layers = itertools.cycle(range(n))
    return lambda: fn(next(layers))


def _check_close(name: str, got, want, dtype, tol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{name} {dtype}: {m}")
    return err


def _check_out(name: str, got, want, dtype) -> float:
    """A serving kernel's output against its plain version: per element
    (:func:`bf16_check`) in bf16, within 1e-5 in float32."""
    if dtype == torch.bfloat16:
        return bf16_check(f"{name} bf16", got, want)
    return _check_close(name, got, want, dtype, 1e-5)


def _bound(cost):
    """(bound ms, by) on this card of work whose operations and bytes are
    ``cost`` (``ops/kernel_costs.py``, the formulas the attribution sums)."""
    from paddle_tpu_torch.observability.hw import bound_ms

    return bound_ms(cost.nbytes, cost.flops, cost.flop_dtype,
                    torch.cuda.get_device_name(0))


def phase_kernels(dtype, time_it: bool):
    """Each kernel vs its plain version at the path's shapes; returns one
    record per kernel (errors, and times when ``time_it``)."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import kernel_costs as KC

    cfg = GPT_SMALL
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    nh, hd = cfg.num_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape, dt=dtype, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    esz = torch.empty((), dtype=dtype).element_size()
    scale = 1.0 + randn(D, dt=torch.float32, s=0.1)
    bias = randn(D, dt=torch.float32, s=0.1)
    recs = {}

    # -- fused_ln: x [B, D] -------------------------------------------------
    x = randn(B, D)
    got, want = CK.fused_ln(x, scale, bias), CK.fused_ln_plain(x, scale, bias)
    torch.cuda.synchronize()
    rec = {"max_abs_err": _check_out("fused_ln", got, want, dtype)}
    if time_it:
        # a decode tick launches it 2L times: device time by graph replay,
        # the eager loop (the wrapper's host cost) beside
        kern = lambda: CK.fused_ln(x, scale, bias)  # noqa: E731
        rec["ms"] = _time_graph_ms(kern, 2 * L)
        rec["eager_ms"] = _time_ms(kern)
        rec["plain_ms"] = _time_graph_ms(
            lambda: CK.fused_ln_plain(x, scale, bias), 2 * L)
        # the same work on x's rows; PyTorch takes the weight and bias in
        # x's dtype only, so they are rounded to it
        s16, b16 = scale.to(dtype), bias.to(dtype)
        rec["library_ms"] = _time_graph_ms(
            lambda: F.layer_norm(x, (D,), s16, b16, 1e-5), 2 * L)
        rec["bound_ms"], rec["bound_by"] = _bound(
            KC.fused_ln(B, D, esz, stats=False))
    recs["fused_ln"] = rec

    # -- decode_slab: q/k/v as the engine slices them out of one qkv ------
    qkv = randn(B, 3, nh, hd)
    q, nk, nv = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    kc = randn(L, B, S, nh, hd)
    vc = randn(L, B, S, nh, hd)
    pos_np = np.random.default_rng(7).integers(0, S, size=B).astype(np.int32)
    act_np = np.ones(B, np.int32)
    act_np[3] = 0                      # one masked lane: its row must stay
    positions = torch.from_numpy(pos_np).to(dev)
    active = torch.from_numpy(act_np).to(dev)
    k1, v1, k2, v2 = kc[0].clone(), vc[0].clone(), kc[0].clone(), vc[0].clone()
    got, _, _ = CK.fused_decode_attention(q, k1, v1, nk, nv, positions, active)
    want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv,
                                                 positions, active)
    torch.cuda.synchronize()
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        raise AssertionError(f"decode_slab {dtype}: updated caches differ "
                             "from the plain version's")
    if not (torch.equal(k1[3], kc[0][3]) and torch.equal(v1[3], vc[0][3])):
        raise AssertionError(f"decode_slab {dtype}: masked lane was written")
    rec = {"max_abs_err": _check_out("decode_slab", got, want, dtype)}
    if time_it:
        kern = _over_layers(
            lambda i: CK.fused_decode_attention(q, kc[i], vc[i], nk, nv,
                                                positions, active), L)
        rec["ms"] = _time_graph_ms(kern, 2 * L)
        rec["eager_ms"] = _time_ms(kern)
        rec["plain_ms"] = _time_graph_ms(_over_layers(
            lambda i: CK.fused_decode_attention_plain(
                q, kc[i], vc[i], nk, nv, positions, active), L), 2 * L)
        rec["library_ms"] = _time_graph_ms(_over_layers(
            _slab_sdpa(q, kc, vc, positions), L), 2 * L)
        rec["bound_ms"], rec["bound_by"] = _slab_bound(pos_np, act_np,
                                                       nh, hd, esz, name)
        sweep = {}
        for p in SWEEP:
            pos_p = np.full(B, p, np.int32)
            pos_t = torch.from_numpy(pos_p).to(dev)
            # the boundary row: every lane at pos p, kernel vs plain
            k1, v1, k2, v2 = (t.clone() for t in (kc[0], vc[0], kc[0], vc[0]))
            got, _, _ = CK.fused_decode_attention(q, k1, v1, nk, nv, pos_t)
            want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv,
                                                         pos_t)
            torch.cuda.synchronize()
            if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                raise AssertionError(f"decode_slab {dtype} pos {p}: caches "
                                     "differ from the plain version's")
            _check_out(f"decode_slab pos {p}", got, want, dtype)
            sweep[p] = (_time_graph_ms(_over_layers(
                lambda i: CK.fused_decode_attention(q, kc[i], vc[i], nk, nv,
                                                    pos_t), L), 2 * L),
                        _time_graph_ms(_over_layers(
                            _slab_sdpa(q, kc, vc, pos_t), L), 2 * L),
                        _slab_bound(pos_p, np.ones(B, np.int32), nh, hd,
                                    esz, name)[0])
        rec["sweep"] = _sweep_line("decode_slab", dtype, sweep, "sdpa_ms")
    recs["decode_slab"] = rec
    del kc, vc, k1, v1, k2, v2
    recs["decode_paged"] = _paged_kernel_check(q, nk, nv, pos_np, dtype,
                                               time_it, randn)

    # -- logits_head: x [B, D] x lm_head [D, V]; also at batch 96 -----------
    w = randn(D, V, s=0.02)
    rec = _logits_head_check(x, scale, bias, w, time_it)
    rec["b96"] = _logits_head_check(randn(96, D), scale, bias, w, time_it)
    recs["logits_head"] = rec
    for k, r in recs.items():
        print(f"[kernels] {k} {dtype}: " + ", ".join(
            f"{a}={b:.6g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()))
    return recs


def _logits_head_check(x, scale, bias, w, time_it: bool):
    """logits_head vs its plain version for x [nb, D] and w [D, V]: bf16
    per element (:func:`bf16_check`), float32 within 1e-5. Timed: the
    kernel, its plain version and the torch.matmul yardstick (on the
    normed rows) by CUDA-graph replay — at ~0.03 ms the kernel is shorter
    than its wrapper's host cost — with ``eager_ms`` beside; the bound
    reads the weight once, though past one batch group of the kernel's
    plan (``groups``) each group reads it, the later ones mostly from L2."""
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import kernel_costs as KC

    dtype = x.dtype
    nb, D = x.shape
    V = w.shape[1]
    got = CK.fused_logits_head(x, scale, bias, w)
    want = CK.fused_logits_head_plain(x, scale, bias, w)
    torch.cuda.synchronize()
    rec = {"max_abs_err": _check_out(f"logits_head B {nb}", got, want,
                                     dtype)}
    if not torch.equal(got.float().argmax(-1), want.float().argmax(-1)):
        print(f"[kernels] logits_head B {nb} {dtype}: argmax differs on a "
              "tie-level logit (within tolerance)")
    if time_it:
        esz = x.element_size()
        kern = lambda: CK.fused_logits_head(x, scale, bias, w)  # noqa: E731
        rec["ms"] = _time_graph_ms(kern, 20)
        rec["eager_ms"] = _time_ms(kern)
        rec["plain_ms"] = _time_graph_ms(
            lambda: CK.fused_logits_head_plain(x, scale, bias, w), 20)
        y = CK.fused_ln_plain(x, scale, bias)
        rec["library_ms"] = _time_graph_ms(lambda: torch.matmul(y, w), 20)
        rec["library_eager_ms"] = _time_ms(lambda: torch.matmul(y, w))
        rec["bound_ms"], rec["bound_by"] = _bound(
            KC.logits_head(nb, D, V, esz))
        rec["groups"] = CK.logits_head_plan(nb, D, V, esz,
                                           CK._num_sms(x.device))["groups"]
    return rec


def _paged_kernel_check(q, nk, nv, pos_np, dtype, time_it: bool, randn):
    """decode_paged vs its plain version at the paged serving path's
    shapes: the slab check's q/k/v and positions, pools [L, 513, 16, nh,
    hd], tables [8, 64] from a seeded permutation of pages 1..512; lane 3
    is dead (zeroed table row) and lanes 0 and 1 share their first 4
    pages."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.ops import cuda_kernels as CK

    L, hd = GPT_SMALL.num_layers, GPT_SMALL.head_dim
    nh = q.shape[1]                 # a tp rank's heads in phase 4tk
    dev = q.device
    M = S // PAGE
    P = B * M + 1
    perm = np.random.default_rng(8).permutation(np.arange(1, P)).astype(
        np.int32).reshape(B, M)
    tab_np = perm.copy()
    tab_np[1, :4] = tab_np[0, :4]              # shared prefix pages
    tab_np[3] = 0                              # dead lane: scratch page 0
    tables = torch.from_numpy(tab_np).to(dev)
    positions = torch.from_numpy(pos_np).to(dev)
    kp = randn(L, P, PAGE, nh, hd)
    vp = randn(L, P, PAGE, nh, hd)
    k1, v1, k2, v2 = kp[0].clone(), vp[0].clone(), kp[0].clone(), vp[0].clone()
    got, _, _ = CK.fused_paged_decode_attention(q, k1, v1, nk, nv, tables,
                                                positions)
    want, _, _ = CK.fused_paged_decode_attention_plain(q, k2, v2, nk, nv,
                                                       tables, positions)
    torch.cuda.synchronize()
    # page 0 is scratch: dead lanes write it, no valid row reads it
    if not (torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])):
        raise AssertionError(f"decode_paged {dtype}: pages 1..{P - 1} "
                             "differ from the plain version's")
    keep = torch.from_numpy(np.concatenate([tab_np[0, :4], perm[3]])).to(
        dev).long()
    if not (torch.equal(k1[keep], kp[0][keep])
            and torch.equal(v1[keep], vp[0][keep])):
        raise AssertionError(f"decode_paged {dtype}: a shared prefix page "
                             "or a dead lane's page was written")
    rec = {"max_abs_err": _check_out("decode_paged", got, want, dtype)}
    if time_it:
        from paddle_tpu_torch.ops.decode_attention import paged_gather

        name = torch.cuda.get_device_name(0)
        esz = q.element_size()
        kern = _over_layers(
            lambda i: CK.fused_paged_decode_attention(
                q, kp[i], vp[i], nk, nv, tables, positions), L)
        rec["ms"] = _time_graph_ms(kern, 2 * L)
        rec["eager_ms"] = _time_ms(kern)
        rec["plain_ms"] = _time_graph_ms(_over_layers(
            lambda i: CK.fused_paged_decode_attention_plain(
                q, kp[i], vp[i], nk, nv, tables, positions), L), 2 * L)
        # SDPA over the pre-gathered view: no table walk, no row write
        gk = [paged_gather(kp[i], tables).transpose(1, 2) for i in range(L)]
        gv = [paged_gather(vp[i], tables).transpose(1, 2) for i in range(L)]
        rec["library_ms"] = _time_graph_ms(_over_layers(
            _slab_sdpa(q, gk, gv, positions, heads_first=True), L), 2 * L)
        del gk, gv
        # the gathers and SDPA together: the table walk as a copy, no write
        rec["gather_sdpa_ms"] = _time_graph_ms(_over_layers(
            _gather_sdpa(q, kp, vp, tables, positions), L), 2 * L)
        rec["bound_ms"], rec["bound_by"] = _paged_bound(
            tab_np, pos_np, nh, hd, esz, name)
        sweep = {}
        tab_all = torch.from_numpy(perm).to(dev)      # 8 live lanes, no sharing
        for p in SWEEP:
            pos_p = np.full(B, p, np.int32)
            pos_t = torch.from_numpy(pos_p).to(dev)
            k1, v1, k2, v2 = (t.clone() for t in (kp[0], vp[0], kp[0], vp[0]))
            got, _, _ = CK.fused_paged_decode_attention(q, k1, v1, nk, nv,
                                                        tab_all, pos_t)
            want, _, _ = CK.fused_paged_decode_attention_plain(
                q, k2, v2, nk, nv, tab_all, pos_t)
            torch.cuda.synchronize()
            if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                raise AssertionError(f"decode_paged {dtype} pos {p}: pools "
                                     "differ from the plain version's")
            _check_out(f"decode_paged pos {p}", got, want, dtype)
            sweep[p] = (_time_graph_ms(_over_layers(
                lambda i: CK.fused_paged_decode_attention(
                    q, kp[i], vp[i], nk, nv, tab_all, pos_t), L), 2 * L),
                        _time_graph_ms(_over_layers(
                            _gather_sdpa(q, kp, vp, tab_all, pos_t), L),
                            2 * L),
                        _paged_bound(perm, pos_p, nh, hd, esz, name)[0])
        rec["sweep"] = _sweep_line("decode_paged", dtype, sweep,
                                   "gather_sdpa_ms")
    return rec


SWEEP = (15, 511, 1023)     # the length sweep: every lane at this position


def _slab_sdpa(q, kc, vc, positions, heads_first: bool = False):
    """fn(i): SDPA of q over layer i's [B, S, nh, hd] caches (or
    [B, nh, S, hd] views with ``heads_first``) under the length mask of
    ``positions`` — the library yardstick, with no row write."""
    S = kc[0].shape[2 if heads_first else 1]
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            <= positions.long()[:, None, None, None])
    q4 = q.unsqueeze(2)
    if heads_first:
        return lambda i: F.scaled_dot_product_attention(
            q4, kc[i], vc[i], attn_mask=mask)
    return lambda i: F.scaled_dot_product_attention(
        q4, kc[i].transpose(1, 2), vc[i].transpose(1, 2), attn_mask=mask)


def _gather_sdpa(q, kp, vp, tables, positions):
    """fn(i): layer i's pools gathered through the table (two copies of
    [B, M * page, nh, hd]), then SDPA under the length mask."""
    from paddle_tpu_torch.ops.decode_attention import paged_gather

    S = tables.shape[1] * kp.shape[2]
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            <= positions.long()[:, None, None, None])
    q4 = q.unsqueeze(2)
    return lambda i: F.scaled_dot_product_attention(
        q4, paged_gather(kp[i], tables).transpose(1, 2),
        paged_gather(vp[i], tables).transpose(1, 2), attn_mask=mask)


def _slab_bound(pos_np, act_np, nh, hd, esz, name):
    """(bound ms, by) of one slab decode call (``kernel_costs.decode_slab``:
    q and the new rows read, rows 0..pos of K and V read, the active
    lanes' rows written, out written, positions and active read; 4 hd + 3
    operations a row)."""
    from paddle_tpu_torch.ops import kernel_costs as KC

    return _bound(KC.decode_slab(pos_np, act_np, nh, hd, esz))


def _paged_bound(tab_np, pos_np, nh, hd, esz, name):
    """(bound ms, by) of one paged decode call
    (``kernel_costs.decode_paged``: as the slab's, with each distinct
    (page, row) read once and the table entries 0..pos / page of each
    lane)."""
    from paddle_tpu_torch.ops import kernel_costs as KC

    return _bound(KC.decode_paged(tab_np, pos_np, nh, hd, esz, PAGE))


def _sweep_line(kname, dtype, sweep, lib_key):
    """Print the length sweep (kernel ms, yardstick ms, bound ms at each
    position) and return it keyed by the rows a lane reads."""
    print(f"[kernels] {kname} {dtype} sweep: " + "; ".join(
        f"pos {p}: ms={k:.6g} {lib_key}={lib:.6g} bound_ms={bd:.6g}"
        for p, (k, lib, bd) in sweep.items()))
    return {str(p + 1): {"ms": k, lib_key: lib, "bound_ms": bd}
            for p, (k, lib, bd) in sweep.items()}


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q))


def _serve(eng, prompts, tag: str, ticker=None):
    """Serve ``prompts`` (64 greedy tokens each) through Scheduler +
    EngineLoop with every launch count zeroed just before; check that each
    request finished "done" with 64 in-vocabulary tokens and that the
    launches are exactly what the decode ticks of ``ticker`` (the engine
    whose ticks run the kernels: ``eng``, or a speculative engine's draft)
    imply (fused_ln 2L, decode_slab or decode_paged L, logits_head 1 a
    tick, L its layers). Returns (the launch counts, the requests, the
    end-to-end numbers)."""
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.serving import EngineLoop, Scheduler

    cfg = eng.cfg
    ticker = ticker or eng
    sched = Scheduler(eng, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks0 = ticker.decode_ticks
    CK.reset_launches()
    loop = EngineLoop(sched).start()
    t0 = time.perf_counter()
    try:
        reqs = [sched.submit(p, max_new_tokens=64, timeout_s=300.0)
                for p in prompts]
        loop.wake()
        for r in reqs:
            if not r.wait(timeout=600.0):
                raise AssertionError(f"request {r.id} did not finish")
    finally:
        loop.stop()
    wall = time.perf_counter() - t0
    launches = dict(CK.LAUNCHES)
    ticks = ticker.decode_ticks - ticks0
    bad = [(r.id, r.state, r.error) for r in reqs if r.state != "done"]
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    if loop.faults:
        raise AssertionError(f"engine loop faults: {loop.last_fault}")
    L = ticker.cfg.num_layers
    want = dict.fromkeys(CK.LAUNCHES, 0)
    want.update({"fused_ln": 2 * L * ticks, "logits_head": ticks,
                 ("decode_paged" if eng.paged else "decode_slab"): L * ticks})
    if ticks <= 0 or launches != want:
        raise AssertionError(f"launch counts {launches} != {want} for "
                             f"{ticks} decode ticks")
    n = len(prompts)
    ntok = sum(len(r.tokens) for r in reqs)
    if ntok != n * 64:
        raise AssertionError(f"{ntok} tokens generated, expected {n * 64}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise AssertionError("a generated token lies outside the vocabulary")
    ttft = [r.ttft_ms for r in reqs]
    tpot = [r.tpot_ms for r in reqs]
    e2e = {"tok_s": ntok / wall, "ttft_ms_p50": _pct(ttft, 50),
           "ttft_ms_p99": _pct(ttft, 99), "tpot_ms_p50": _pct(tpot, 50)}
    print(f"[{tag}] {n} requests done, {ntok} tokens in {wall:.3f} s "
          f"({ntok / wall:.1f} tok/s), {ticks} decode ticks")
    print(f"[{tag}] ttft_ms p50={e2e['ttft_ms_p50']:.3f} "
          f"p99={e2e['ttft_ms_p99']:.3f}; tpot_ms "
          f"p50={e2e['tpot_ms_p50']:.3f}; "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated()}")
    print(f"[{tag}] launches {launches}")
    return launches, reqs, e2e


def _serving_engine(kv_layout: str, weight_dtype: str = "bf16",
                    cfg=None, seed: int = 0, warm: bool = True,
                    engine_kw=None, **kw):
    """A GPT_SMALL (or ``cfg``) serving engine from seed weights: 8 slots,
    max_seq 1024, buckets 64-512, the kernel tick; its float32 truth
    dropped; ``kw`` more EngineConfig fields, ``engine_kw`` more
    DecodeEngine arguments."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig

    cfg = cfg or GPT_SMALL
    params = init_params(cfg, seed=seed, device="cuda")
    ecfg = EngineConfig(max_batch=B, max_seq=S,
                        prefill_buckets=(64, 128, 256, 512),
                        weight_dtype=weight_dtype, fused_decode=True,
                        kv_layout=kv_layout, page_size=PAGE, **kw)
    eng = DecodeEngine(params, cfg, ecfg, device="cuda", **(engine_kw or {}))
    del params
    eng.drop_reference_params()
    if warm:
        times = eng.warmup()
        print(f"[{kv_layout} {weight_dtype}] warmup ms: " + ", ".join(
            f"{k}={v:.1f}" for k, v in times.items()))
    return eng


def _phase4_prompts(V: int):
    """Phase 4's 16 seeded prompts of 16-400 tokens."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 401, size=16)
    return [rng.integers(0, V, size=int(n)).tolist() for n in lens]


def phase_serving():
    """GPT_SMALL bf16, slab layout, through Scheduler + EngineLoop; returns
    the launch counts and the end-to-end numbers of the run, and the
    engine and requests (for 4m and the tick's overhead pairs)."""
    eng = _serving_engine("slab")
    launches, reqs, e2e = _serve(eng, _phase4_prompts(eng.cfg.vocab_size),
                                 "serving")
    return launches, e2e, eng, reqs


def _trace_dir() -> str:
    import os

    from paddle_tpu_torch.ops import _build

    return os.path.join(str(_build.BUILD_DIR), "trace")


def _tick_want(eng, ticks: int) -> dict:
    """The launches ``ticks`` decode ticks of ``eng`` imply."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    L = eng.cfg.num_layers
    want = dict.fromkeys(CK.LAUNCHES, 0)
    want.update({"fused_ln": 2 * L * ticks, "logits_head": ticks,
                 ("decode_paged" if eng.paged else "decode_slab"):
                 L * ticks})
    return want


def _check_request_traces(tag, reqs, spans, ticks):
    """Each request one trace: one finished ``serve/request`` root, one
    ``queue_wait`` and one ``prefill`` under it, a ``decode_tick`` for
    each token after the first, one ``evict``; the decode ticks' spans,
    grouped by their start, are the engine's ``ticks`` ticks, each group
    its batch. Returns the span counts by name."""
    import collections

    ids = {r.trace_id: r for r in reqs}
    mine = [s for s in spans if s["trace"] in ids
            and not (s.get("attrs") or {}).get("open")]
    counts = collections.Counter(s["name"] for s in mine)
    for tid, r in ids.items():
        got = collections.Counter(
            (s["name"], s["parent"]) for s in mine if s["trace"] == tid)
        want = collections.Counter({
            ("serve/request", None): 1,
            ("serve/queue_wait", r.root_span): 1,
            ("serve/prefill", r.root_span): 1,
            ("serve/decode_tick", r.root_span): len(r.tokens) - 1,
            ("serve/evict", r.root_span): 1})
        if got != want:
            raise AssertionError(f"{tag}: request {r.id}'s spans {got} != "
                                 f"{want}")
    groups = collections.Counter(s["start_ns"] for s in mine
                                 if s["name"] == "serve/decode_tick")
    batch = {s["start_ns"]: s["attrs"]["batch"] for s in mine
             if s["name"] == "serve/decode_tick"}
    if len(groups) != ticks or any(n != batch[t] for t, n in groups.items()):
        raise AssertionError(f"{tag}: {len(groups)} decode-tick span groups "
                             f"for {ticks} ticks, or a group not its batch")
    print(f"[{tag}] spans: {dict(sorted(counts.items()))} over "
          f"{len(ids)} traces; {ticks} ticks, one decode_tick span a rider")
    return dict(counts)


def phase_front_door(eng, reqs4) -> dict:
    """Phase 4m: a ``FrontDoor`` over phase 4's engine on an ephemeral
    port. 4 ``/generate`` requests, each carrying a trace context in its
    body, and one migrated request through ``/prefill`` (pushed to the
    front door's own ``KVTransferServer``) and ``/resume``; every request
    done, its root span under the caller's span, the migration's
    ``serve/kv_send`` and ``serve/kv_adopt`` in its trace; launches exactly
    the decode ticks'. ``GET /metrics`` parses and its ``paddle_serve_*``
    counters equal the registry's; ``GET /health`` carries
    ``span_rollups_ms``; a ``FleetPoller`` over this one replica writes a
    ``FLEET.json`` whose rollup counts the requests the registry counted;
    an ``SLOEngine`` fed phase 4's TTFTs and TPOTs prints ``slo_status()``
    (not a gate: random weights, a shared card). Returns the launches."""
    import os
    import urllib.request

    from paddle_tpu_torch.observability import default_registry, fleet
    from paddle_tpu_torch.observability import slo as obs_slo
    from paddle_tpu_torch.observability import spans as obs_spans
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.serving import FrontDoor, Scheduler
    from paddle_tpu_torch.serving.kv_transfer import KVTransferServer

    def call(front, path, body=None):
        url = f"http://127.0.0.1:{front.port}{path}"
        req = (urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
            if body is not None else url)
        with urllib.request.urlopen(req, timeout=300) as r:
            raw = r.read().decode()
            return r.status, r.headers, raw

    def serve_counters():
        snap = default_registry().snapshot()
        return {(name, tuple(s["labels"])): s["value"]
                for name, fam in snap.items()
                if name.startswith("paddle_serve_")
                and fam["type"] == "counter" for s in fam["series"]}

    V = eng.cfg.vocab_size
    prompts = _phase4_prompts(V)[:5]
    srv = KVTransferServer().start()
    front = FrontDoor(Scheduler(eng, device="cuda"), kv_server=srv).start()
    ticks0 = eng.decode_ticks
    torch.cuda.synchronize()
    CK.reset_launches()
    ctxs = [(obs_spans.gen_id(), obs_spans.gen_id()) for _ in range(5)]
    try:
        outs = []
        for p, ctx in zip(prompts[:4], ctxs):
            code, _, raw = call(front, "/generate", {
                "prompt": p, "max_new_tokens": 32, "timeout_s": 300,
                "trace": obs_spans.inject(ctx)})
            outs.append((code, json.loads(raw)))
        code, _, raw = call(front, "/prefill", {
            "prompt": prompts[4], "max_new_tokens": 32, "timeout_s": 300,
            "trace": obs_spans.inject(ctxs[4]),
            "kv_target": {"host": srv.host, "port": srv.port,
                          "transfer_id": "4m-0"}})
        pre = json.loads(raw)
        if code != 200 or not pre.get("transferred"):
            raise AssertionError(f"front door /prefill: {code} {pre}")
        code, _, raw = call(front, "/resume", {
            "transfer_id": "4m-0", "first_token": pre["first_token"],
            "prompt": prompts[4], "max_new_tokens": 32, "timeout_s": 300})
        outs.append((code, json.loads(raw)))
        launches = dict(CK.LAUNCHES)
        ticks = eng.decode_ticks - ticks0
        _, _, health = call(front, "/health")
        health = json.loads(health)
        before = serve_counters()
        code, headers, text = call(front, "/metrics")
        metrics_ctype = headers["Content-Type"]
        scraped = []

        def collect():
            reg = sum(v for (n, _), v in serve_counters().items()
                      if n == "paddle_serve_requests_total")
            _, _, t = call(front, "/metrics")
            scraped.append(reg)
            return [fleet.ReplicaSample(0, "colocated", True, 0.0, t, 0,
                                        front.scheduler.pending())]

        fleet_path = os.path.join(_trace_dir(), "FLEET.json")
        os.makedirs(_trace_dir(), exist_ok=True)
        doc = fleet.FleetPoller(collect, out_path=fleet_path).tick()
    finally:
        front.stop()
        srv.close()
    bad = [(c, o) for c, o in outs if c != 200 or len(o["tokens"]) != 32]
    if bad:
        raise AssertionError(f"front door requests: {bad}")
    if launches != _tick_want(eng, ticks) or ticks <= 0:
        raise AssertionError(f"front door launches {launches} != "
                             f"{_tick_want(eng, ticks)} for {ticks} ticks")
    # /metrics: every sample line parses; the serve counters are the
    # registry's as they stood just before the scrape
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    if not metrics_ctype.startswith("text/plain; version=0.0.4"):
        raise AssertionError(f"/metrics content type {metrics_ctype!r}")
    for (name, labels), value in before.items():
        fam = default_registry().snapshot()[name]
        lab = ",".join(f'{k}="{v}"' for k, v in zip(fam["labelnames"],
                                                     labels))
        key = f"{name}{{{lab}}}" if lab else name
        if samples.get(key) != value:
            raise AssertionError(f"/metrics {key} = {samples.get(key)}, "
                                 f"the registry's {value}")
    roll = doc["roles"]["colocated"]["sums"].get(
        "paddle_serve_requests_total")
    if roll != scraped[0]:
        raise AssertionError(f"FLEET.json requests {roll} != the "
                             f"registry's {scraped[0]}")
    rollups = health.get("span_rollups_ms") or {}
    if not {"serve/request", "serve/prefill", "serve/decode_tick",
            "serve/queue_wait", "serve/evict"} <= set(rollups):
        raise AssertionError(f"/health span_rollups_ms {sorted(rollups)}")
    spans = obs_spans.default_tracer().spans()
    for ctx in ctxs:
        roots = [s for s in spans if s["trace"] == ctx[0]
                 and s["name"] == "serve/request"
                 and not s["attrs"].get("open")]
        if not any(s["parent"] == ctx[1] for s in roots):
            raise AssertionError(f"trace {ctx[0]:x}: no serve/request "
                                 "under the caller's span")
    moved = {s["name"] for s in spans if s["trace"] == ctxs[4][0]}
    if not {"serve/kv_send", "serve/kv_adopt"} <= moved:
        raise AssertionError(f"the migrated request's trace has {moved}")
    engine = obs_slo.SLOEngine()
    for r in reqs4:
        engine.note_request(ttft_ms=r.ttft_ms, tpot_ms=r.tpot_ms)
    for _, o in outs[:4]:
        engine.note_request(ttft_ms=o["ttft_ms"], tpot_ms=o["tpot_ms"])
    status = engine.slo_status()
    print(f"[front-door] 4 /generate + /prefill -> /resume over the KV "
          f"socket done, {ticks} ticks, launches exact; /metrics "
          f"{len(samples)} samples, serve counters = registry; FLEET.json "
          f"requests {roll}; /health span rollups "
          + json.dumps({k: v["p50_ms"] for k, v in rollups.items()}))
    print("[front-door] slo_status (printed only): " + json.dumps({
        k: {"measured": v["measured"], "meets": v["meets_target"],
            "burn": v["burn_rate"]}
        for k, v in status["objectives"].items()}))
    return launches


def _overhead_text(rec) -> str:
    return (f"{rec['paired_overhead_pct']:+.2f}% by the pairs' median "
            f"difference (on slower in {rec['on_slower_share']:.2f} of the "
            f"pairs), {rec['overhead_pct']:+.2f}% by the mins; the off "
            f"arm's own spread {rec['off_spread_pct']:.1f}% (printed, not "
            "gated)")


def phase_tick_overhead(eng, pairs: int = 12, ticks: int = 16) -> dict:
    """The decode tick's host ms with span tracing on and off, in turns
    (on, off, off, on, ...: each pair's order flipped), ``ticks`` ticks an
    arm run, on phase 4's engine with 8 requests resident:
    ``Scheduler.step`` as the engine loop calls it (the tick syncs on its
    sampled tokens), summed up by ``train_bench.overhead_record``.
    Printed, not gated: the tick's host time varies from run to run more
    than the difference it measures."""
    from paddle_tpu_torch.observability import spans as obs_spans
    from paddle_tpu_torch.serving import Scheduler
    from paddle_tpu_torch.tools.train_bench import overhead_record

    sched = Scheduler(eng, device="cuda")
    for p in _phase4_prompts(eng.cfg.vocab_size)[:B]:
        sched.submit(p, max_new_tokens=2 * pairs * ticks + 8,
                     timeout_s=600.0)
    while sched.queue_depth():
        sched.step()
    arms = {True: [], False: []}
    try:
        for i in range(pairs):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                obs_spans.set_tracing_enabled(on)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ticks):
                    sched.step()
                arms[on].append((time.perf_counter() - t0) * 1e3 / ticks)
    finally:
        obs_spans.set_tracing_enabled(True)
        sched.abort_all("overhead pairs measured")
    rec = overhead_record(arms[True], arms[False])
    print(f"[tick-overhead] host ms a tick, tracing on "
          f"{[round(x, 3) for x in arms[True]]}, off "
          f"{[round(x, 3) for x in arms[False]]}: " + _overhead_text(rec))
    return rec


def _phase4b_prompts(V: int):
    """Phase 4b's 16 prompts in their seeded order: 8 behind one 256-token
    system prompt (tails of 16-144 tokens), 8 unique (16-400 tokens); the
    serving gang's card lane (4g) serves the same."""
    from paddle_tpu_torch.tools import serve_fault_bench

    return serve_fault_bench.paged_prompts(V)[1]


def phase_serving_paged():
    """GPT_SMALL bf16, paged layout with the prefix cache, through
    Scheduler + EngineLoop: 8 requests behind one 256-token system prompt
    and 8 unique ones, in a seeded order. Admissions run one at a time on
    the loop thread and each prefill publishes its pages before the next
    lookup, so any order gives exactly 7 hits; the default pool (512
    usable pages) holds the cache (under 300 pages) and the live slots
    without a reclaim. Returns the launch counts of the run and its
    end-to-end numbers and token streams (``{"e2e", "tokens"}``)."""
    from paddle_tpu_torch.observability import spans as obs_spans
    from paddle_tpu_torch.serving import metrics as smetrics
    from paddle_tpu_torch.tools import trace_assemble

    eng = _serving_engine("paged")
    prompts = _phase4b_prompts(eng.cfg.vocab_size)
    hits0, tok0 = eng.prefix.hits, smetrics.m_prefill_tokens.value
    # the process's span sink, for this phase and 4d
    obs_spans.attach_process_sink(_trace_dir(), "chip_smoke")
    ticks0 = eng.decode_ticks
    try:
        launches, reqs, e2e = _serve(eng, prompts, "serve-paged")
    finally:
        obs_spans.default_tracer().set_sink(None)
    report = trace_assemble.assemble_dir(_trace_dir())
    spans = [s for recs in trace_assemble.load_span_files(
        _trace_dir()).values() for s in recs]
    counts = _check_request_traces("serve-paged", reqs, spans,
                                   eng.decode_ticks - ticks0)
    if report["n_orphans"] or report["n_duplicates"]:
        raise AssertionError(f"trace assembly: {report['n_orphans']} "
                             f"orphans, {report['n_duplicates']} duplicates")
    hits = eng.prefix.hits - hits0
    prefilled = int(smetrics.m_prefill_tokens.value - tok0)
    want = sum(len(p) for p in prompts) - 7 * 256
    if hits != 7 or prefilled != want:
        raise AssertionError(f"prefix cache: {hits} hits (want 7), "
                             f"{prefilled} tokens prefilled (want {want})")
    held = eng.prefix.held_page_count()
    eng.prefix.clear()
    free = eng.cache.free_page_count()
    if eng.cache.live_slots() or free != eng.cache.num_pages - 1:
        raise AssertionError(f"page pool not returned: {free} of "
                             f"{eng.cache.num_pages - 1} pages free, live "
                             f"slots {eng.cache.live_slots()}")
    print(f"[serve-paged] prefix hits {hits}, prompt tokens prefilled "
          f"{prefilled} of {want + 7 * 256}, cache held {held} pages; all "
          f"{free} pages free after clear()")
    return launches, {"e2e": e2e, "tokens": [list(r.tokens) for r in reqs],
                      "spans": counts}


def phase_serving_disagg(colocated: dict):
    """Phase 4d: phase 4b's 16 requests through a prefill and a decode
    replica (GPT_SMALL bf16, paged, each engine phase 4b's) behind a
    ``DisaggRouter`` with a ``SharedPrefixIndex``, one thread a request,
    every launch count zeroed just before. Gates: every request done, 16
    migrated, no fallback; both pools whole after the prefix caches are
    cleared; ``paddle_kv_transfer_bytes_total`` out == in == the handoffs'
    page bytes from ``pages_for(len)``; the prefill engine ran no decode
    tick (so launched no kernel of the tick) and the launches are exactly
    fused_ln 2L, decode_paged L, logits_head 1 a tick of the decode
    engine. Printed beside phase 4b's numbers (``colocated``): TTFT
    p50/p99, TPOT p50, tokens/s, handoff ms p50/p99, export and adopt ms
    a handoff and the prefix index's publish exports (``prefix_export``,
    on the prefill loop after each prefill) with their CRC and copy
    shares, the prefix index's and the
    prefill engine's prefix counts, and the token agreement with 4b (not
    gated: which requests hit the prefix cache depends on the threads'
    order, and a hit prefills its suffix in another bucket shape). Returns
    the launch counts."""
    import threading

    from paddle_tpu_torch.observability import spans as obs_spans
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.serving import kv_transfer
    from paddle_tpu_torch.serving import metrics as smetrics
    from paddle_tpu_torch.serving.disagg import (DisaggRouter, LocalReplica,
                                                 SharedPrefixIndex)
    from paddle_tpu_torch.tools import trace_assemble

    pre = _serving_engine("paged", role="prefill")
    dec = _serving_engine("paged", role="decode")
    cfg = dec.cfg
    prompts = _phase4b_prompts(cfg.vocab_size)
    index = SharedPrefixIndex()
    out0 = smetrics.m_kv_transfer_bytes.labels("out").value
    in0 = smetrics.m_kv_transfer_bytes.labels("in").value
    ticks0, pre_ticks0, hits0 = dec.decode_ticks, pre.decode_ticks, \
        pre.prefix.hits
    results = [None] * len(prompts)
    obs_spans.attach_process_sink(_trace_dir(), "chip_smoke")
    torch.cuda.synchronize()
    kv_transfer.transfer_history(clear=True)
    CK.reset_launches()
    reps = [LocalReplica(pre, prefix_index=index),
            LocalReplica(dec, prefix_index=index)]
    router = DisaggRouter(reps, prefix_index=index)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(
            target=lambda i=i, p=p: results.__setitem__(
                i, router.generate(p, max_new_tokens=64, timeout_s=300.0)),
            daemon=True) for i, p in enumerate(prompts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600.0)
    finally:
        for r in reps:
            r.stop()
        obs_spans.default_tracer().set_sink(None)
    wall = time.perf_counter() - t0
    launches = dict(CK.LAUNCHES)
    ticks = dec.decode_ticks - ticks0
    bad = [(i, r and r.state, r and r.error) for i, r in enumerate(results)
           if r is None or r.state != "done" or len(r.tokens) != 64]
    if bad or router.migrated != 16 or router.fallbacks:
        raise AssertionError(f"disagg: not done {bad}, migrated "
                             f"{router.migrated}, fallbacks "
                             f"{router.fallbacks}")
    if not all(0 <= t < cfg.vocab_size for r in results for t in r.tokens):
        raise AssertionError("a generated token lies outside the vocabulary")
    L = cfg.num_layers
    want = dict.fromkeys(CK.LAUNCHES, 0)
    want.update({"fused_ln": 2 * L * ticks, "decode_paged": L * ticks,
                 "logits_head": ticks})
    if pre.decode_ticks != pre_ticks0 or ticks <= 0 or launches != want:
        raise AssertionError(
            f"launch counts {launches} != {want} for {ticks} decode ticks "
            f"of the decode engine; the prefill engine ran "
            f"{pre.decode_ticks - pre_ticks0} ticks (want 0)")
    page_bytes = (2 * L * PAGE * cfg.num_heads * cfg.head_dim
                  * dec.cache.k.element_size())
    want_bytes = sum(dec.cache.pages_for(len(p)) for p in prompts) \
        * page_bytes
    moved = (smetrics.m_kv_transfer_bytes.labels("out").value - out0,
             smetrics.m_kv_transfer_bytes.labels("in").value - in0)
    if moved != (want_bytes, want_bytes):
        raise AssertionError(f"kv transfer bytes out/in {moved} != "
                             f"{want_bytes} each")
    pre_hits = pre.prefix.hits - hits0
    # one trace a routed request, across both replicas: the route, the
    # prefill replica's request and the decode replica's (on another loop
    # thread), its adoption; stitched with no orphan
    files = trace_assemble.load_span_files(_trace_dir())
    traces = trace_assemble.assemble(files)
    check = trace_assemble.check_assembly(
        {r.trace_id: traces.get(r.trace_id, []) for r in results})
    for r in results:
        sp = traces.get(r.trace_id, [])
        names = {s["name"] for s in sp}
        roots = [s for s in sp if s["name"] == "serve/request"]
        if not {"serve/route", "serve/prefill", "serve/kv_adopt",
                "serve/decode_tick"} <= names or len(roots) != 2 or \
                len({s["tid"] for s in roots}) != 2:
            raise AssertionError(f"disagg trace {r.trace_id:x}: "
                                 f"{sorted(names)}, {len(roots)} roots")
    if check["n_orphans"] or check["n_duplicates"] or any(
            t["roots"] != ["serve/route"] for t in check["traces"]):
        raise AssertionError(f"disagg traces: {check['n_orphans']} orphans, "
                             f"{check['n_duplicates']} duplicates")
    print(f"[serve-disagg] {check['n_traces']} traces, {check['n_spans']} "
          "spans, each a tree under serve/route spanning both replicas' "
          "loop threads (kv_adopt on the decode side; the in-process "
          "handoff has no socket hop: kv_send is 4m's); 0 orphans")
    for eng in (pre, dec):
        eng.prefix.clear()
        free = eng.cache.free_page_count()
        if eng.cache.live_slots() or free != eng.cache.num_pages - 1:
            raise AssertionError(
                f"{eng.role} pool not returned: {free} of "
                f"{eng.cache.num_pages - 1} pages free, live slots "
                f"{eng.cache.live_slots()}")
    ntok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_ms for r in results]
    tpot = [r.tpot_ms for r in results]
    hand = [r.handoff_ms for r in results]
    e2e = {"tok_s": ntok / wall, "ttft_ms_p50": _pct(ttft, 50),
           "ttft_ms_p99": _pct(ttft, 99), "tpot_ms_p50": _pct(tpot, 50)}
    same = sum(r.tokens == t for r, t in zip(results, colocated["tokens"]))
    same_tok = sum(a == b for r, t in zip(results, colocated["tokens"])
                   for a, b in zip(r.tokens, t))
    hs = kv_transfer.summarize_stats(kv_transfer.transfer_history())
    print(f"[serve-disagg] {len(prompts)} requests done, {ntok} tokens in "
          f"{wall:.3f} s, 16 migrated, 0 fallbacks, {ticks} decode ticks "
          f"(all on the decode engine); both replicas on one card")
    for tag, d in (("disagg", e2e), ("colocated 4b", colocated["e2e"])):
        print(f"[serve-disagg] {tag}: tok/s={d['tok_s']:.1f} ttft_ms "
              f"p50={d['ttft_ms_p50']:.3f} p99={d['ttft_ms_p99']:.3f} "
              f"tpot_ms p50={d['tpot_ms_p50']:.3f}")
    print(f"[serve-disagg] handoff_ms p50={_pct(hand, 50):.3f} "
          f"p99={_pct(hand, 99):.3f}; kv bytes out=in={want_bytes}")
    for kind in ("export", "adopt", "prefix_export"):
        h = hs[kind]
        print(f"[serve-disagg] {kind}: n={h['n']} ms p50={h['ms_p50']:.3f} "
              f"p99={h['ms_p99']:.3f} crc p50={h['crc_ms_p50']:.3f} "
              f"(share {h['crc_share']:.3f}) copy p50="
              f"{h['copy_ms_p50']:.3f} (share {h['copy_share']:.3f}) "
              f"bytes mean={h['bytes_mean']:.0f}")
    print(f"[serve-disagg] prefix index hits={index.hits} misses="
          f"{index.misses} published={index.published}; prefill engine "
          f"prefix hits {pre_hits}; streams equal to 4b's: {same} of 16, "
          f"tokens {same_tok} of {ntok}")
    print(json.dumps({"serve_disagg": {
        "e2e": e2e, "colocated_4b": colocated["e2e"],
        "handoff_ms_p50": _pct(hand, 50), "handoff_ms_p99": _pct(hand, 99),
        "handoff_stats": hs, "kv_transfer_bytes": want_bytes,
        "decode_ticks": ticks, "launches": launches,
        "pool_prefix": {"hits": index.hits, "misses": index.misses,
                        "published": index.published},
        "prefill_prefix_hits": pre_hits, "streams_equal_4b": same,
        "tokens_equal_4b": same_tok}}))
    return launches


# phase 4g: serve_fault_bench's card lane, in the order it runs
GANG_SCENARIOS = ("replica_sigkill", "engine_poisoned", "warm_restart_prefix",
                  "disagg_gang", "engine_hang", "overload_storm")


def _fmt(v, nd=3):
    return "n/a" if v is None else f"{v:.{nd}f}"


def phase_serve_gang(paged: dict, timeout_s: float = 600.0) -> dict:
    """Phase 4g (see the module docstring); returns the kernels' launches
    summed over the surviving replica incarnations (each counted from its
    warmup on, in its own process)."""
    import os
    import shutil
    import signal

    from paddle_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(str(_build.BUILD_DIR), "serve_gang")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = os.path.join(work, "serve_fault_bench.json")
    # this process's cached blocks back to the card for the replicas
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serve_fault_bench",
         "--device", "cuda", "--out", out], cwd=root,
        start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
    wall = time.perf_counter() - t0
    if not os.path.exists(out):
        print(log[-8000:])
        raise RuntimeError(f"serve-gang: serve_fault_bench exited "
                           f"{proc.returncode} without a record")
    with open(out) as f:
        rec = json.load(f)
    sc = rec["scenarios"]
    for name in GANG_SCENARIOS:
        s = sc.get(name, {"pass": False})
        show = {k: s.get(k) for k in (
            "lost_responses", "duplicated_responses", "non_200",
            "failovers", "failed_over_requests", "restarts",
            "idempotent_retry_ok", "retry_same_trace",
            "killed_trace_stitchable", "trace_orphans",
            "restored_prefix_records", "prefill_tokens_first",
            "prefill_tokens_repeat", "prefill_tokens_post_restart",
            "migrated", "fallbacks", "kv_bytes_out", "kv_bytes_in",
            "kv_bytes_want", "prefill_decode_ticks", "codes",
            "shed_by_reason", "preemptions_pool_phase",
            "p99_completed_latency_s", "elapsed_s") if s.get(k) is not None}
        print(f"[serve-gang] {name}: pass={s['pass']} {json.dumps(show)}")
    if proc.returncode != 0 or not rec["pass"] or \
            set(sc) != set(GANG_SCENARIOS):
        print(log[-8000:])
        raise AssertionError("serve-gang: "
                             + ", ".join(n for n in GANG_SCENARIOS
                                         if not sc.get(n, {}).get("pass"))
                             + " failed")
    # the gates again, here, off the record
    for name in ("replica_sigkill", "engine_poisoned", "engine_hang",
                 "disagg_gang"):
        s = sc[name]
        if s["lost_responses"] or s["duplicated_responses"] or \
                s["non_200"] or s["answered"] != s["sent"]:
            raise AssertionError(f"serve-gang {name}: lost "
                                 f"{s['lost_responses']}, non-200 "
                                 f"{s['non_200']}")
    for name, cause in (("replica_sigkill", "crash"),
                        ("engine_poisoned", "poisoned"),
                        ("engine_hang", "hang"),
                        ("warm_restart_prefix", "crash")):
        if sc[name]["restarts"].get(cause, 0) < 1:
            raise AssertionError(f"serve-gang {name}: restarts "
                                 f"{sc[name]['restarts']}, no {cause}")
    sk, wr, dg = (sc["replica_sigkill"], sc["warm_restart_prefix"],
                  sc["disagg_gang"])
    if not (sk["idempotent_retry_ok"] and sk["retry_same_trace"]):
        raise AssertionError("serve-gang: the idempotent retry failed")
    if wr["restored_prefix_records"] < 1 or \
            wr["prefill_tokens_post_restart"] != wr["suffix_len"]:
        raise AssertionError(f"serve-gang warm restart: {wr}")
    if dg["migrated"] != 16 or dg["fallbacks"] or \
            dg["kv_bytes_out"] != dg["kv_bytes_in"] or \
            dg["kv_bytes_in"] != dg["kv_bytes_want"]:
        raise AssertionError(f"serve-gang disagg: {dg}")
    L = rec["model"]["num_layers"]
    launches = {}
    for name in GANG_SCENARIOS:
        for x in sc[name].get("survivors", []):
            t = x["decode_ticks"]
            want = {k: 0 for k in x["launches"]}
            want.update({"fused_ln": 2 * L * t, "decode_paged": L * t,
                         "logits_head": t})
            if x["launches"] != want:
                raise AssertionError(
                    f"serve-gang {name} replica {x['index']} (incarnation "
                    f"{x['incarnation']}): launches {x['launches']} != "
                    f"{want} for {t} decode ticks")
            for k, v in x["launches"].items():
                launches[k] = launches.get(k, 0) + v
    print(f"[serve-gang] device {rec['device']}; {sum(len(sc[n].get('survivors', [])) for n in GANG_SCENARIOS)} "
          "surviving incarnations, launches exact a tick; "
          f"launches {launches}")
    # the numbers: start-up, failover, latency beside 4b, restarts, prefix
    # store, token agreement
    for name in ("replica_sigkill", "engine_poisoned", "warm_restart_prefix"):
        s = sc[name]
        for i, st in enumerate(s.get("startup") or []):
            print(f"[serve-gang] {name} replica {i} start-up s: "
                  + json.dumps(st))
        if s.get("respawn_startup"):
            print(f"[serve-gang] {name} respawn start-up s: "
                  + json.dumps(s["respawn_startup"])
                  + f"; restart downtime s {_fmt(s.get('restart_downtime_s'))}")
    print(f"[serve-gang] replica_sigkill: killed {sk['killed_replica']}; "
          f"{sk['failed_over_requests']} requests failed over, failover "
          f"latency s p50 {_fmt(sk['failover_latency_s_p50'])} max "
          f"{_fmt(sk['failover_latency_s_max'])}")
    b4 = paged["e2e"]
    for name in ("replica_sigkill", "disagg_gang"):
        s = sc[name]
        print(f"[serve-gang] {name}: ttft_ms p50={_fmt(s['ttft_ms_p50'])} "
              f"p99={_fmt(s['ttft_ms_p99'])} tpot_ms "
              f"p50={_fmt(s['tpot_ms_p50'])} p99={_fmt(s['tpot_ms_p99'])}; "
              f"4b in-process: ttft_ms p50={_fmt(b4['ttft_ms_p50'])} "
              f"p99={_fmt(b4['ttft_ms_p99'])} tpot_ms "
              f"p50={_fmt(b4['tpot_ms_p50'])}")
    same = sum(a == b for a, b in zip(sk["tokens"], paged["tokens"]))
    same_tok = sum(x == y for a, b in zip(sk["tokens"], paged["tokens"])
                   for x, y in zip(a, b))
    print(f"[serve-gang] replica_sigkill streams equal to 4b's: {same} of "
          f"16, tokens {same_tok} of {16 * 64}; equal to the harness's "
          f"in-process engine: {sk['streams_equal_reference']} of 16, "
          f"tokens {sk['tokens_equal_reference']} of {sk['tokens_total']} "
          "(not gated)")
    pub = [v for x in wr.get("survivors", [])
           for v in x.get("prefix_publish_ms", [])] + \
        list(wr.get("prefix_publish_ms") or [])
    print(f"[serve-gang] prefix store: {wr['restored_prefix_records']} "
          f"records restored; publish ms (page gather + one copy to the "
          f"host + snapshot, on the engine loop) {[round(v, 3) for v in pub]}"
          f"; prompt {wr['prompt_len']} tokens, prefilled "
          f"{wr['prefill_tokens_first']} / {wr['prefill_tokens_repeat']} / "
          f"{wr['prefill_tokens_post_restart']} (first / repeat / after "
          "the restart)")
    print(f"[serve-gang] serve_fault_bench {rec['elapsed_s']:.1f} s "
          f"(reference engine {rec['reference_engine_s']:.1f} s), phase "
          f"wall {wall:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def phase_parity():
    """Kernel engines vs plain-PyTorch engines, slab and paged, float32, on
    the card; the prefix cache's continuation prefill; preemption."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import (DecodeEngine, EngineConfig,
                                          Scheduler)
    from paddle_tpu_torch.serving import metrics as smetrics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT_SMALL.scaled(num_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cuda")
    ekw = dict(max_batch=4, max_seq=256, prefill_buckets=(64, 128),
               page_size=PAGE)
    arms = {f"{layout} {'kernel' if f else 'plain'}": DecodeEngine(
        params, cfg, EngineConfig(fused_decode=f, kv_layout=layout, **ekw),
        device="cuda") for layout in ("slab", "paged") for f in (True, False)}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 17, 40, 100)]
    runs = {}
    for arm, eng in arms.items():
        slots, cur, toks = {}, {}, {}
        for p_i, p in enumerate(prompts):
            slot, logits = eng.start_sequence(p)
            ref = eng.reference_logits(p)[-1]
            if not np.allclose(logits, ref, atol=1e-4, rtol=1e-4):
                raise AssertionError(
                    f"{arm} prompt {p_i}: prefill logits differ from the "
                    f"full forward by {np.abs(logits - ref).max()}")
            slots[p_i] = slot
            cur[p_i] = int(np.argmax(logits))
            toks[p_i] = [cur[p_i]]
        steps = []
        for _ in range(31):
            out = eng.decode_step({slots[i]: cur[i] for i in slots})
            steps.append({i: out[slots[i]] for i in slots})
            for i in slots:
                cur[i] = int(np.argmax(out[slots[i]]))
                toks[i].append(cur[i])
        for slot in slots.values():
            eng.free_sequence(slot)
        runs[arm] = (toks, steps)
    base_toks, base_steps = runs["slab kernel"]
    worst = 0.0
    for arm, (toks, steps) in runs.items():
        if toks != base_toks:
            raise AssertionError(f"{arm} tokens {toks} != slab kernel "
                                 f"tokens {base_toks}")
        for a, b in zip(steps, base_steps):
            for i in a:
                worst = max(worst, float(np.abs(a[i] - b[i]).max()))
    if not worst <= 1e-4:
        raise AssertionError(f"per-step logits differ by {worst} > 1e-4")
    print(f"[parity] 4 prompts x 32 greedy tokens identical across "
          f"{', '.join(runs)} (f32, 2 layers); prefill logits match the "
          f"full forward; max per-step logit diff {worst:.3g}")

    # the prefix cache: the second prefill covers the last 16 tokens only
    eng = arms["paged kernel"]
    prompt = rng.integers(0, cfg.vocab_size, size=80).tolist()
    tok0 = smetrics.m_prefill_tokens.value
    s1, l1 = eng.start_sequence(prompt)
    d1 = smetrics.m_prefill_tokens.value - tok0
    s2, l2 = eng.start_sequence(prompt)
    d2 = smetrics.m_prefill_tokens.value - tok0 - d1
    diff = float(np.abs(l1 - l2).max())
    if (d1, d2) != (80, 16) or not diff <= 1e-4:
        raise AssertionError(f"prefix cache: prefilled {d1} then {d2} "
                             f"tokens (want 80, 16), logit diff {diff}")
    eng.free_sequence(s1)
    eng.free_sequence(s2)
    print(f"[parity] repeated 80-token prompt: prefilled 80 then 16 tokens "
          f"(64 from the cache), logit diff {diff:.3g}")

    # preemption: 2 x 7 pages wanted, 10 usable
    eng = DecodeEngine(params, cfg, EngineConfig(
        max_batch=2, max_seq=256, prefill_buckets=(64, 128),
        kv_layout="paged", page_size=PAGE, num_pages=11, prefix_cache=False),
        device="cuda")
    sched = Scheduler(eng, device="cuda")
    pair = [rng.integers(0, cfg.vocab_size, size=40).tolist()
            for _ in range(2)]
    reqs = [sched.submit(p, max_new_tokens=64, timeout_s=300.0)
            for p in pair]
    for _ in range(1000):
        if not sched.pending():
            break
        sched.step()
    slab = arms["slab kernel"]
    for r, p in zip(reqs, pair):
        slot, logits = slab.start_sequence(p)
        want = [int(np.argmax(logits))]
        for _ in range(63):
            want.append(int(np.argmax(slab.decode_step(
                {slot: want[-1]})[slot])))
        slab.free_sequence(slot)
        if r.state != "done" or r.tokens != want:
            raise AssertionError(f"preempted request {r.id} ({r.state}) "
                                 "tokens differ from the slab engine's")
    if sched.preemptions < 1:
        raise AssertionError("the 10-page pool never preempted")
    print(f"[parity] 10-page pool: {sched.preemptions} preemption(s), both "
          "64-token streams equal the slab engine's")


def _greedy_tokens(eng, prompt, n: int):
    """``n`` greedy tokens of ``prompt`` on one engine, one request."""
    slot, logits = eng.start_sequence(prompt)
    toks = [int(np.argmax(logits))]
    for _ in range(n - 1):
        toks.append(int(np.argmax(eng.decode_step({slot: toks[-1]})[slot])))
    eng.free_sequence(slot)
    return toks


def concurrent_greedy(engines, prompts, n: int):
    """Each engine on a thread of its own serves ``prompts`` one at a time
    (``n`` greedy tokens each), all threads at once, engine i starting at
    prompt i: their decode calls interleave on the card's default stream,
    different prompts side by side. Returns each engine's streams in the
    order of ``prompts`` (None for an engine whose thread raised)."""
    import threading

    out = [None] * len(engines)

    def run(i):
        order = [(i + j) % len(prompts) for j in range(len(prompts))]
        got = {j: _greedy_tokens(engines[i], prompts[j], n) for j in order}
        out[i] = [got[j] for j in range(len(prompts))]

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(engines))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600.0)
    return out


def phase_disagg_parity():
    """Phase 5d: the KV handoff and the router on the card, a 2-layer
    GPT_SMALL in float32 (TF32 off), slab and paged, requests one at a
    time: the router's greedy tokens equal the colocated kernel engine's,
    token for token; three kernel engines decoding at once, each on a
    thread of its own (as two replicas' loop threads do), emit those same
    tokens; a slot exported and adopted reads back bitwise from both pools
    (before the prefill slot is freed); a page_size mismatch raises
    ``CacheConfigMismatch`` naming the field; a router with no decode
    replica degrades with ``no_phase_fleet`` and emits the same tokens."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import (CacheConfigMismatch, DecodeEngine,
                                          EngineConfig)
    from paddle_tpu_torch.serving.disagg import DisaggRouter, LocalReplica

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT_SMALL.scaled(num_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cuda")
    ekw = dict(max_batch=4, max_seq=256, prefill_buckets=(64, 128),
               page_size=PAGE)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 17, 40, 100)]

    def engine(layout, **kw):
        return DecodeEngine(params, cfg, EngineConfig(
            kv_layout=layout, **{**ekw, **kw}), device="cuda")

    for layout in ("slab", "paged"):
        colo = engine(layout)
        want = [_greedy_tokens(colo, p, 32) for p in prompts]
        # the decode kernels' workspace is one a stream: engines ticking on
        # threads of their own must not read each other's partials
        side = concurrent_greedy([colo, engine(layout), engine(layout)],
                                 prompts, 32)
        for i, got in enumerate(side):
            if got != want:
                raise AssertionError(f"{layout}: engine {i} decoding beside "
                                     f"two others: {got} != one at a time "
                                     f"{want}")
        # the handoff itself: pages or rows read back bitwise
        src, dst = engine(layout, role="prefill"), engine(layout,
                                                         role="decode")
        for p in prompts:
            slot, _ = src.start_sequence(p)
            dslot = dst.adopt_request_kv(src.export_request_kv(slot,
                                                               tokens=p))
            for a, b in ((src, slot), (dst, dslot)):
                if a.cache.length(b) != len(p):
                    raise AssertionError(f"{layout}: length "
                                         f"{a.cache.length(b)} != {len(p)}")
            if layout == "paged":
                n = src.cache.pages_for(len(p))
                got = dst.cache.read_pages(dst.cache.table_row(dslot)[:n])
                exp = src.cache.read_pages(src.cache.table_row(slot)[:n])
            else:
                got = dst.cache.read_rows(dslot, 0, len(p))
                exp = src.cache.read_rows(slot, 0, len(p))
            if not all(torch.equal(g, e) for g, e in zip(got, exp)):
                raise AssertionError(f"{layout}: adopted KV of a "
                                     f"{len(p)}-token prompt not bitwise")
            src.free_sequence(slot)
            dst.free_sequence(dslot)
        reps = [LocalReplica(src), LocalReplica(dst)]
        router = DisaggRouter(reps)
        try:
            got = [router.generate(p, max_new_tokens=32, timeout_s=300.0)
                   for p in prompts]
        finally:
            for r in reps:
                r.stop()
        for r, w in zip(got, want):
            if r.state != "done" or not r.migrated or r.tokens != w:
                raise AssertionError(
                    f"{layout} router ({r.state}, migrated {r.migrated}, "
                    f"{r.error}): {r.tokens} != colocated {w}")
        # an empty decode fleet: colocated dispatch on the prefill engine
        alone = LocalReplica(engine(layout, role="prefill"))
        try:
            router = DisaggRouter([alone])
            got = [router.generate(p, max_new_tokens=32, timeout_s=300.0)
                   for p in prompts]
        finally:
            alone.stop()
        if any(r.fallback_reason != "no_phase_fleet" or r.tokens != w
               for r, w in zip(got, want)):
            raise AssertionError(f"{layout}: the empty decode fleet did not "
                                 "degrade to the same tokens")
        print(f"[disagg-parity] {layout}: 4 prompts x 32 greedy tokens "
              f"through prefill -> decode equal the colocated kernel "
              f"engine's (f32, 2 layers), and so do 3 engines decoding at "
              f"once on 3 threads; adopted KV bitwise; no decode fleet -> "
              f"no_phase_fleet, same tokens")
    src = engine("paged", role="prefill")
    dst = engine("paged", role="decode", page_size=2 * PAGE)
    slot, _ = src.start_sequence(prompts[2])
    try:
        dst.adopt_request_kv(src.export_request_kv(slot))
    except CacheConfigMismatch as e:
        if "page_size" not in str(e):
            raise AssertionError(f"mismatch names no page_size: {e}")
        print(f"[disagg-parity] page {PAGE} -> {2 * PAGE}: {e}")
    else:
        raise AssertionError("a page_size mismatch was adopted")
    if dst.cache.free_page_count() != dst.cache.num_pages - 1:
        raise AssertionError("a refused adoption kept pages")


# the tensor-parallel phases (4tk, 4t, 5t): two ranks sharing the one card
# over gloo (every all-reduce staged through host memory)
TP = 2
TP_DEVICES = ("cuda:0", "cuda:0")
TP_TICKS = 16            # 4t's timed ticks (and as many traced)


def phase_tp_kernels() -> dict:
    """Phase 4tk: the four kernels of the tp decode tick at a rank's
    shapes against their plain versions, bf16 (:func:`bf16_check`) and
    float32 (1e-5), caches and pools bitwise: ``fused_ln`` on [8, 768]
    (every rank), ``decode_slab`` at nh / tp = 6 heads (q [8, 6, 64],
    slab [8, 1024, 6, 64], one masked lane), ``decode_paged`` on pools
    [513, 16, 6, 64] (phase 3's tables: a dead lane, two lanes sharing
    their first 4 pages), ``logits_head`` [8, 768] x [768, 50257] (the
    driver). Returns {kernel: largest |kernel - plain|}."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.ops import cuda_kernels as CK

    cfg = GPT_SMALL
    D, V, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim
    nh = cfg.num_heads // TP
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1904)
    err: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        def randn(*shape, dt=dtype, s=1.0):
            return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

        scale = 1.0 + randn(D, dt=torch.float32, s=0.1)
        bias = randn(D, dt=torch.float32, s=0.1)
        x = randn(B, D)
        e = {"fused_ln": _check_out(f"tp fused_ln [{B}, {D}]",
                                    CK.fused_ln(x, scale, bias),
                                    CK.fused_ln_plain(x, scale, bias),
                                    dtype)}
        qkv = randn(B, 3, nh, hd)
        q, nk, nv = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        kc, vc = randn(B, S, nh, hd), randn(B, S, nh, hd)
        pos_np = np.random.default_rng(7).integers(0, S, size=B).astype(
            np.int32)
        act_np = np.ones(B, np.int32)
        act_np[3] = 0
        positions = torch.from_numpy(pos_np).to(dev)
        active = torch.from_numpy(act_np).to(dev)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got, _, _ = CK.fused_decode_attention(q, k1, v1, nk, nv, positions,
                                              active)
        want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv,
                                                     positions, active)
        torch.cuda.synchronize()
        if not (torch.equal(k1, k2) and torch.equal(v1, v2)
                and torch.equal(k1[3], kc[3])):
            raise AssertionError(f"tp decode_slab {dtype}: caches differ "
                                 "from the plain version's")
        e["decode_slab"] = _check_out(f"tp decode_slab [{B}, {S}, {nh}, "
                                      f"{hd}]", got, want, dtype)
        del kc, vc, k1, v1, k2, v2
        e["decode_paged"] = _paged_kernel_check(q, nk, nv, pos_np, dtype,
                                                False, randn)["max_abs_err"]
        e["logits_head"] = _logits_head_check(
            x, scale, bias, randn(D, V, s=0.02), False)["max_abs_err"]
        for k, v in e.items():
            err[k] = max(err.get(k, 0.0), v)
        print(f"[tp-kernels] {dtype}: " + ", ".join(
            f"{k}={v:.4g}" for k, v in e.items()))
    torch.cuda.empty_cache()
    return err


def _tp_weight_want(cfg, rank: int):
    """(storage bytes, resident bytes) of a tp rank's weights at bf16: the
    replicated leaves whole and Megatron's split leaves 1/TP each
    (``models/gpt.param_specs``); a follower holds no head; resident, the
    layernorm parameters are float32."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.serving.tp import HEAD_LEAVES
    from paddle_tpu_torch.sharding.plan import _flatten

    specs = dict(_flatten(G.param_specs(cfg, pp=None, tp="tp")))
    store = resident = 0
    for path, shape in _flatten(G.param_shapes(cfg)):
        if rank and path in HEAD_LEAVES:
            continue
        n = int(np.prod(shape)) // (TP if "tp" in specs[path] else 1)
        store += 2 * n
        resident += (4 if path.split("/")[-1].startswith("ln") else 2) * n
    return store, resident


def _gone(pids) -> bool:
    """Every pid exited (our children: reaped by ``close()``'s join)."""
    import os

    for pid in pids:
        try:
            os.kill(pid, 0)
            return False
        except ProcessLookupError:
            pass
    return True


def _print_startup(tag, eng) -> None:
    """A tp engine's start-up split, seconds after the driver's spawn."""
    st = eng.tp_startup
    t0 = st[0]["spawn"]
    for r, stamps in enumerate(st):
        print(f"[{tag}] rank {r} start-up s: " + ", ".join(
            f"{k} {v - t0:.2f}" for k, v in stamps.items()))


def _rank_launch_want(eng, ticks: int, rank: int) -> dict:
    want = _tick_want(eng, ticks)
    if rank:
        want["logits_head"] = 0            # the driver alone runs the head
    return want


def phase_tp(paged: dict):
    """Phases 4tk, 4t and 5t (see the module docstring). The three tp
    engines (4t's, 5t's slab and paged) start at once, on threads, so
    their followers' imports overlap, while 4tk checks the kernels.
    Returns (4tk's {kernel: largest error}, each kernel's launches summed
    over both of 4t's ranks)."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig

    t_phase = time.perf_counter()
    # 5t's float32 parity: no TF32 in the driver (a follower's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg5 = GPT_SMALL.scaled(num_layers=2, dtype=torch.float32)
    params5 = init_params(cfg5, seed=1, device="cuda")
    ekw5 = dict(max_batch=4, max_seq=256, prefill_buckets=(64, 128),
                page_size=PAGE)
    makers = {"4t": lambda: _serving_engine(
        "paged", warm=False, sharding="tp", tp=TP,
        engine_kw={"tp_devices": TP_DEVICES})}
    for lay in ("slab", "paged"):
        makers[f"5t {lay}"] = lambda lay=lay: DecodeEngine(
            params5, cfg5, EngineConfig(kv_layout=lay, sharding="tp", tp=TP,
                                        **ekw5),
            device="cuda", tp_devices=TP_DEVICES)
    join = _build_all(makers)
    tp_err = phase_tp_kernels()
    engs = join()
    built_s = time.perf_counter() - t_phase
    pids = [p for e in engs.values() for p in e.follower_pids]
    print(f"[tp] 3 tp engines built at once in {built_s:.1f} s (4tk "
          f"checked meanwhile); followers {pids}")
    for tag, e in engs.items():
        _print_startup(f"tp {tag}", e)
    try:
        launches = phase_serving_tp(paged, engs["4t"])
        phase_tp_parity(engs["5t slab"], engs["5t paged"], params5, cfg5,
                        ekw5)
    finally:
        for e in engs.values():
            e.close()
    if not _gone(pids):
        raise AssertionError(f"tp followers {pids} alive after close()")
    print(f"[tp] every follower gone after close(); 4tk + 4t + 5t wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return tp_err, launches


def phase_serving_tp(paged: dict, eng) -> dict:
    """Phase 4t on its engine (see the module docstring); returns each
    kernel's launches summed over both ranks' serving and timed ticks."""
    from paddle_tpu_torch.parallel import comm_opt as C
    from paddle_tpu_torch.serving import metrics as smetrics
    from paddle_tpu_torch.tools.profile_decode import _step, trace_summary

    t_phase = time.perf_counter()
    total: dict = {}
    times = eng.warmup()
    cfg = eng.cfg
    L, D = cfg.num_layers, cfg.d_model
    print(f"[serve-tp2] {TP} ranks on {TP_DEVICES} over gloo; driver "
          "warmup ms: "
          + ", ".join(f"{k}={v:.1f}" for k, v in times.items()))
    # resident weights and pools, every rank (the f32 truth dropped)
    pool_1 = (2 * L * eng.cache.num_pages * PAGE * cfg.num_heads
              * cfg.head_dim * 2)             # phase 4b's pool, bf16
    for st in eng.rank_stats():
        want = _tp_weight_want(cfg, st["rank"])
        got = (st["weight_nbytes"], st["resident_weight_bytes"])
        if got != want or st["cache_nbytes"] * TP != pool_1:
            raise AssertionError(
                f"tp rank {st['rank']}: weight bytes (storage, "
                f"resident) {got} != {want}, or pool bytes "
                f"{st['cache_nbytes']} != {pool_1} / {TP}")
        print(f"[serve-tp2] rank {st['rank']} ({st['device']}): "
              f"weights {got[1]} resident bytes ({got[0]} storage) "
              f"exact, pool {st['cache_nbytes']} bytes = 4b's / {TP}, "
              f"memory_allocated {st['memory_allocated']}")
    # phase 4b's traffic, both ranks' counts zeroed just before
    prompts = _phase4b_prompts(cfg.vocab_size)
    hits0, tok0 = eng.prefix.hits, smetrics.m_prefill_tokens.value
    eng.rank_stats(reset_launches=True)
    ticks0 = eng.decode_ticks
    _, reqs, e2e = _serve(eng, prompts, "serve-tp2")
    ticks = eng.decode_ticks - ticks0
    for st in eng.rank_stats():
        want = _rank_launch_want(eng, ticks, st["rank"])
        if st["launches"] != want:
            raise AssertionError(f"tp rank {st['rank']} launches "
                                 f"{st['launches']} != {want} for "
                                 f"{ticks} ticks")
        for k, v in st["launches"].items():
            total[k] = total.get(k, 0) + v
    hits = eng.prefix.hits - hits0
    prefilled = int(smetrics.m_prefill_tokens.value - tok0)
    want_tok = sum(len(p) for p in prompts) - 7 * 256
    if hits != 7 or prefilled != want_tok:
        raise AssertionError(f"tp prefix cache: {hits} hits (want 7), "
                             f"{prefilled} tokens prefilled (want "
                             f"{want_tok})")
    eng.prefix.clear()
    if eng.cache.free_page_count() != eng.cache.num_pages - 1:
        raise AssertionError("tp page pool not returned")
    same = sum(list(r.tokens) == t
               for r, t in zip(reqs, paged["tokens"]))
    for tag, d in (("tp2", e2e), ("4b tp1", paged["e2e"])):
        print(f"[serve-tp2] {tag}: tok/s={d['tok_s']:.1f} ttft_ms "
              f"p50={d['ttft_ms_p50']:.3f} p99={d['ttft_ms_p99']:.3f} "
              f"tpot_ms p50={d['tpot_ms_p50']:.3f}")
    print(f"[serve-tp2] every rank's launches exact for {ticks} ticks "
          f"(fused_ln 2L, decode_paged L a rank, logits_head 1 on the "
          f"driver); prefix hits 7, {prefilled} tokens prefilled; "
          f"streams equal to 4b's: {same} of 16 (not gated)")
    # the tick alone: 8 slots live, TP_TICKS ticks timed, then traced
    rng = np.random.default_rng(0)
    feed = {}
    for n in rng.integers(16, 401, size=B):
        slot, logits = eng.start_sequence(
            rng.integers(0, cfg.vocab_size, size=int(n)).tolist())
        feed[slot] = int(np.argmax(logits))
    for _ in range(3):
        _step(eng, feed)
    s0 = eng.rank_stats()
    t0 = time.perf_counter()
    for _ in range(TP_TICKS):
        _step(eng, feed)
    wall = time.perf_counter() - t0
    s1 = eng.rank_stats()
    wire = TP_TICKS * 2 * L * C.wire_bytes("psum", B * D * 2, TP)
    for a, b in zip(s0, s1):
        dl = {k: b["launches"][k] - a["launches"][k]
              for k in a["launches"]}
        want = _rank_launch_want(eng, TP_TICKS, a["rank"])
        if b["wire_bytes"] - a["wire_bytes"] != wire or dl != want:
            raise AssertionError(
                f"tp rank {a['rank']}: {TP_TICKS} ticks moved "
                f"{b['wire_bytes'] - a['wire_bytes']} wire bytes (want "
                f"{wire}: 2L psums of [{B}, {D}] bf16 a tick) and "
                f"launched {dl} (want {want})")
        for k, v in dl.items():
            total[k] = total.get(k, 0) + v
    staged = [(b["staged_s"] - a["staged_s"]) * 1e3 / TP_TICKS
              for a, b in zip(s0, s1)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(TP_TICKS):
            _step(eng, feed)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = trace_summary(prof, wall_us, TP_TICKS)
    tick_ms = wall * 1e3 / TP_TICKS
    split = {"tick_ms": tick_ms, "staged_allreduce_ms": staged,
             "staged_share": staged[0] / tick_ms,
             "driver_device_busy_ms": dev["device_busy_ms_per_tick"],
             "driver_idle_share": dev["idle_share"],
             "wire_bytes_per_tick_per_rank": wire // TP_TICKS}
    print(f"[serve-tp2] tick split, 8 lanes live: {tick_ms:.3f} ms a "
          f"tick on the host clock; the staged all-reduces (2L = "
          f"{2 * L} a tick) {staged[0]:.3f} ms on the driver, "
          f"{staged[1]:.3f} ms on the follower (share "
          f"{split['staged_share']:.3f}); the driver's device busy "
          f"{split['driver_device_busy_ms']:.3f} ms a tick (idle share "
          f"{split['driver_idle_share']}); wire bytes a tick a rank "
          f"{wire // TP_TICKS} exact")
    for slot in feed:
        eng.free_sequence(slot)
    bf16 = _tp_bf16_check(eng)
    print(json.dumps({"serve_tp2": {
        "e2e": e2e, "colocated_4b": paged["e2e"], "ticks": ticks,
        "streams_equal_4b": same, "tick_split": split,
        "device_trace": dev, "startup": eng.tp_startup, "bf16": bf16}}))
    print(f"[serve-tp2] phase wall {time.perf_counter() - t_phase:.1f} s "
          "(the build apart)")
    return total


TP_BF16_TICKS = 4        # 4t's bf16 check: ticks after the prefill


def _forced_logits(eng, prompts, feed):
    """Prefill logits of ``prompts`` in one batch, then one tick's logits
    for every token list of ``feed`` (the same tokens for every engine);
    rows [prefill of each prompt, tick 1 of each, ...], float32."""
    slots, rows = [], []
    for p in prompts:
        slot, lg = eng.start_sequence(p)
        slots.append(slot)
        rows.append(lg)
    for toks in feed:
        out = eng.decode_step(dict(zip(slots, toks)))
        rows.extend(out[slot] for slot in slots)
    for slot in slots:
        eng.free_sequence(slot)
    return np.stack(rows).astype(np.float32)


def _tp_bf16_check(eng) -> dict:
    """4t's numbers at bf16: the tp=2 engine ``eng`` against tp=1 paged
    engines with the same seed weights, bf16 and float32 (TF32 off), on
    8 prompts of 16-400 tokens: the prefill logits, then TP_BF16_TICKS
    ticks where every engine is fed the bf16 tp=1 engine's greedy
    tokens.
    Gates: the tp=2 logits stray from the float32 engine's at most twice
    as far as the bf16 tp=1 engine's do (the bf16 sum of the ranks'
    partials costs about one rounding more than one card's matmul; a lost
    or doubled partial costs the logits' scale), and the prefill's greedy
    tokens equal the bf16 tp=1 engine's. Returns the readings."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL

    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, eng.cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(16, 401, size=B)]
    one = _serving_engine("paged", warm=False)
    try:
        feed = []
        for _ in range(TP_BF16_TICKS):     # the bf16 tp=1 greedy path
            lg = _forced_logits(one, prompts, feed)
            feed.append([int(t) for t in lg[-B:].argmax(-1)])
        l1 = _forced_logits(one, prompts, feed)
    finally:
        del one
    l2 = _forced_logits(eng, prompts, feed)
    f32 = _serving_engine("paged", "f32", warm=False,
                          cfg=GPT_SMALL.scaled(dtype=torch.float32))
    try:
        want = _forced_logits(f32, prompts, feed)
    finally:
        del f32
        torch.cuda.empty_cache()
    top2 = np.sort(want[:B], -1)[:, -2:]
    out = {"rows": int(l2.shape[0]),
           "tp2_vs_f32": float(np.abs(l2 - want).max()),
           "tp1_vs_f32": float(np.abs(l1 - want).max()),
           "tp2_vs_tp1": float(np.abs(l2 - l1).max()),
           "logit_scale": float(np.abs(want).max()),
           "first_tokens_equal": int((l2[:B].argmax(-1)
                                      == l1[:B].argmax(-1)).sum()),
           "argmax_equal_rows": int((l2.argmax(-1) == l1.argmax(-1)).sum()),
           "f32_top2_margin_min": float((top2[:, 1] - top2[:, 0]).min()),
           "s": time.perf_counter() - t0}
    print(f"[serve-tp2] bf16 against float32, {out['rows']} logit rows "
          f"({B} prompts, prefill + {TP_BF16_TICKS} forced ticks): "
          f"max |tp2 - f32| {out['tp2_vs_f32']:.6g}, |tp1 - f32| "
          f"{out['tp1_vs_f32']:.6g} (gate: tp2's <= 2x tp1's), |tp2 - "
          f"tp1| {out['tp2_vs_tp1']:.6g}, logits up to "
          f"{out['logit_scale']:.4g}; first tokens equal "
          f"{out['first_tokens_equal']} of {B} (gate: all), argmax equal "
          f"on {out['argmax_equal_rows']} of {out['rows']} rows; the f32 "
          f"prefill's least top-2 margin {out['f32_top2_margin_min']:.4g}; "
          f"{out['s']:.1f} s")
    if not (0 < out["tp2_vs_f32"] <= 2 * out["tp1_vs_f32"]):
        raise AssertionError(f"4t bf16: tp2 strays {out['tp2_vs_f32']} "
                             f"from float32, over twice tp1's "
                             f"{out['tp1_vs_f32']}")
    if out["first_tokens_equal"] != B:
        raise AssertionError(f"4t bf16: the prefill's greedy tokens equal "
                             f"tp1's on {out['first_tokens_equal']} of {B}")
    return out


def _build_all(makers: dict):
    """Start building every engine of ``makers`` ({name: thunk}) at
    once, a thread each, so the tp engines' followers start together;
    returns ``join()``, which waits for them all and returns {name:
    engine} (a failure closes the others and raises)."""
    import threading

    out, errs = {}, {}

    def run(name, fn):
        try:
            out[name] = fn()
        except BaseException as e:       # re-raised on the caller's thread
            errs[name] = e

    threads = [threading.Thread(target=run, args=kv, daemon=True)
               for kv in makers.items()]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()
        if errs:
            for eng in out.values():
                eng.close()
            name, e = next(iter(errs.items()))
            raise RuntimeError(f"building {name} failed: {e}") from e
        return out

    return join


def phase_tp_parity(slab, paged, params, cfg, ekw):
    """Phase 5t on its tp=2 engines (``slab``, ``paged``): tp=2 against
    tp=1, a 2-layer GPT_SMALL in float32 (TF32 off), the kernel engines:
    4 prompts (5, 17, 40, 100 tokens) x 16 greedy tokens in one batch,
    prefill and per-step logits within 1e-4 and tokens equal; then a paged
    tp=2 -> tp=1 handoff of the 100-token prompt: two frames a projection
    a chunk, the adopted pages bitwise the source's, and the adopted
    slot's 16 greedy tokens the tp=1 engine's own."""
    from paddle_tpu_torch.serving import DecodeEngine, EngineConfig

    t_phase = time.perf_counter()
    layouts = ("slab", "paged")
    engs = {"slab": slab, "paged": paged}
    one = {lay: DecodeEngine(params, cfg, EngineConfig(kv_layout=lay,
                                                       **ekw),
                             device="cuda") for lay in layouts}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 17, 40, 100)]
    worst = 0.0
    for lay in layouts:
        runs = []
        for eng in (engs[lay], one[lay]):
            slots, cur, logs = {}, {}, []
            for i, p in enumerate(prompts):
                slots[i], lg = eng.start_sequence(p)
                cur[i] = int(np.argmax(lg))
                logs.append(lg)
            toks = {i: [cur[i]] for i in slots}
            for _ in range(15):
                out = eng.decode_step({slots[i]: cur[i] for i in slots})
                for i in slots:
                    logs.append(out[slots[i]])
                    cur[i] = int(np.argmax(out[slots[i]]))
                    toks[i].append(cur[i])
            for s in slots.values():
                eng.free_sequence(s)
            runs.append((toks, logs))
        (t2, l2), (t1, l1) = runs
        diff = max(float(np.abs(a - b).max()) for a, b in zip(l2, l1))
        worst = max(worst, diff)
        if t2 != t1 or not diff <= 1e-4:
            raise AssertionError(f"5t {lay}: tp2 tokens equal tp1's: "
                                 f"{t2 == t1}; max logit diff {diff}")
    print(f"[tp-parity] slab and paged: 4 prompts x 16 greedy tokens, "
          f"tp2 == tp1 token for token (f32, 2 layers), prefill and "
          f"per-step logits within {worst:.3g} (gate 1e-4)")
    # the handoff: tp2 paged -> tp1 paged
    src, dst = engs["paged"], one["paged"]
    prompt = prompts[-1]
    want = _greedy_tokens(dst, prompt, 17)
    slot, logits = src.start_sequence(prompt)
    n_pages = src.cache.pages_for(len(prompt))
    k_src, v_src = src.cache.read_pages(
        [int(p) for p in src.cache.table_row(slot)[:n_pages]])
    handoff = src.export_request_kv(slot, tokens=prompt)
    if any(sorted(f["shard"] for f in ch["shards"] if f["proj"] == "k")
           != list(range(TP)) for ch in handoff["chunks"]):
        raise AssertionError("5t: the tp2 export is not one frame a "
                             "rank a projection a chunk")
    dslot = dst.adopt_request_kv(handoff)
    k_dst, v_dst = dst.cache.read_pages(
        [int(p) for p in dst.cache.table_row(dslot)[:n_pages]])
    if not (torch.equal(k_dst, k_src) and torch.equal(v_dst, v_src)):
        raise AssertionError("5t: adopted pages differ from the tp2 "
                             "source's")
    toks = [int(np.argmax(logits))]
    for _ in range(16):
        toks.append(int(np.argmax(dst.decode_step(
            {dslot: toks[-1]})[dslot])))
    src.free_sequence(slot)
    dst.free_sequence(dslot)
    if toks != want:
        raise AssertionError(f"5t: the adopted slot's tokens {toks} != "
                             f"tp1's {want}")
    print(f"[tp-parity] tp2 -> tp1 handoff: {len(handoff['chunks'])} "
          f"chunk(s) x {TP} frames a projection, {n_pages} pages "
          f"bitwise, the adopted slot's 17 tokens == tp1's own")
    print(f"[tp-parity] phase wall {time.perf_counter() - t_phase:.1f} s "
          "(the build apart)")


SPEC_K = 3               # the spec lanes' proposals a window (W = 4)


def phase_serving_spec(alone: dict):
    """Phase 4s: speculative decoding at full width. Target GPT_SMALL bf16
    (verify window 4), draft GPT_SMALL at 3 layers from seed 1 (the
    reference's spec lane, tools/serve_bench.py:173-183), phase 4's 16
    prompts x 64 greedy tokens through Scheduler + EngineLoop. Gates: every
    request done with 64 in-vocabulary tokens; the kernels launch exactly
    as the draft's ticks imply (fused_ln 2 x 3, decode_slab 3, logits_head
    1 a tick) and the target's verify launches none of them; the spec
    histogram's count moves by ``stats.windows``. Prints the end-to-end
    numbers beside phase 4's (``alone``), the acceptance rate, tokens a
    window, the verify step's ms and the draft tick's ms. Returns the
    launch counts."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.serving import SpecDecodeEngine
    from paddle_tpu_torch.serving import metrics as smetrics
    from paddle_tpu_torch.tools.profile_decode import _Clock

    target = _serving_engine("slab", warm=False, verify_window=SPEC_K + 1)
    draft = _serving_engine("slab", cfg=GPT_SMALL.scaled(num_layers=3),
                            seed=1, warm=False)
    spec = SpecDecodeEngine(target, draft)
    spec.warmup()
    hist0 = smetrics.m_spec_accepted._unlabeled().count
    ticks0, verify0 = target.decode_ticks, target.verify_steps
    dclock = _Clock(draft, "decode_step_sampled")
    vclock = _Clock(target, "verify_step")
    launches, _, e2e = _serve(spec, _phase4_prompts(GPT_SMALL.vocab_size),
                              "serve-spec", ticker=draft)
    st = spec.stats
    dticks = draft.decode_ticks
    nver = target.verify_steps - verify0
    hist = smetrics.m_spec_accepted._unlabeled().count - hist0
    if target.decode_ticks != ticks0 or nver <= 0 or hist != st.windows:
        raise AssertionError(
            f"spec: target ticks {target.decode_ticks - ticks0} (want 0), "
            f"verify steps {nver}, histogram count {hist} != windows "
            f"{st.windows}")
    rec = {**e2e, "acceptance_rate": st.acceptance_rate,
           "tokens_per_window": st.tokens_per_window,
           "verify_ms": vclock.ms / nver,
           "draft_tick_ms": dclock.ms / max(dticks, 1),
           "verify_steps": nver, "draft_ticks": dticks}
    print("[serve-spec] " + ", ".join(f"{k}={v:.6g}" for k, v in
                                      rec.items()))
    print("[serve-spec] target alone (phase 4): " + ", ".join(
        f"{k}={v:.6g}" for k, v in alone.items()))
    print(json.dumps({"serve_spec": rec, "serve_alone": alone}))
    return launches


def _teacher_stream(eng, seq):
    """Decode logits [len(seq), V] of a teacher-forced token stream."""
    slot, l0 = eng.start_sequence(seq[:1])
    rows = [l0]
    for t in seq[1:]:
        rows.append(eng.decode_step({slot: t})[slot])
    eng.free_sequence(slot)
    return np.stack(rows)


def _resident_weights(weight_dtype: str):
    """(engine, weight_nbytes, growth of torch.cuda.memory_allocated()
    across the construction of a GPT_SMALL slab engine with its float32
    truth dropped, less its KV cache's bytes)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    eng = _serving_engine("slab", weight_dtype, warm=False)
    gc.collect()
    torch.cuda.synchronize()
    kv = eng.cache.k.nbytes + eng.cache.v.nbytes
    return eng, eng.weight_nbytes, torch.cuda.memory_allocated() - m0 - kv


def phase_serving_int8():
    """Phase 4q: int8 serving weights at full width. Residency: the
    weight_nbytes and the resident bytes (memory_allocated growth across
    construction, f32 truth dropped, KV cache excluded) of GPT_SMALL at
    int8 below bf16's / 1.9. Phase 4's traffic through an int8 slab
    engine: every request done, phase 4's launch counts. Quality: a
    256-token teacher-forced stream of decode logits against the f32
    engine: max_rel_err < INT8_LOGIT_TOL (0.06), perplexity drift <
    INT8_PPL_REL_TOL (0.02); top-1 agreement printed. Returns the launch
    counts."""
    from paddle_tpu_torch.serving import quant

    bf16, b_nbytes, b_res = _resident_weights("bf16")
    del bf16
    eng, q_nbytes, q_res = _resident_weights("int8")
    print(f"[serve-int8] weights: bf16 weight_nbytes={b_nbytes} resident="
          f"{b_res}; int8 weight_nbytes={q_nbytes} resident={q_res}")
    if not (q_nbytes < b_nbytes / 1.9 and q_res < b_res / 1.9):
        raise AssertionError(f"int8 residency {q_nbytes} / {q_res} not "
                             f"below bf16's {b_nbytes} / {b_res} / 1.9")
    # the forward's dequantization into bf16 (one product a leaf) is the
    # float32 dequantization rounded once, bit for bit, on the card
    for name, leaf in eng.qparams["blocks"].items():
        if not torch.equal(leaf.layer(0, torch.bfloat16),
                           leaf.layer(0).to(torch.bfloat16)):
            raise AssertionError(f"int8 {name}: the bf16 dequantization is "
                                 "not the float32 one rounded once")
    times = eng.warmup()
    print("[serve-int8] warmup ms: " + ", ".join(
        f"{k}={v:.1f}" for k, v in times.items()))
    V = eng.cfg.vocab_size
    launches, _, e2e = _serve(eng, _phase4_prompts(V), "serve-int8")
    seq = np.random.default_rng(7).integers(0, V, size=256).tolist()
    s8 = _teacher_stream(eng, seq)
    del eng
    f32 = _serving_engine("slab", "f32", warm=False)
    ref = _teacher_stream(f32, seq)
    del f32
    stats = quant.logit_error_stats(ref, s8)
    drift = abs(quant.perplexity(s8[:-1], seq[1:])
                / quant.perplexity(ref[:-1], seq[1:]) - 1.0)
    rec = {**e2e, **stats, "ppl_drift": drift, "weight_nbytes": q_nbytes,
           "resident_bytes": q_res, "bf16_weight_nbytes": b_nbytes,
           "bf16_resident_bytes": b_res}
    print("[serve-int8] " + ", ".join(f"{k}={v:.6g}" for k, v in
                                      rec.items()))
    print(json.dumps({"serve_int8": rec}))
    if not (stats["max_rel_err"] < quant.INT8_LOGIT_TOL
            and drift < quant.INT8_PPL_REL_TOL):
        raise AssertionError(f"int8 quality: {stats}, ppl drift {drift}")
    return launches


def phase_spec_parity():
    """Phase 5s: a 2-layer GPT_SMALL in float32 (TF32 off), slab and
    paged. A self-draft spec engine (draft = target) emits the target-
    alone kernel engine's greedy tokens, accepts every proposal (rate
    exactly 1.0) and emits k + 1 tokens a window; the kernel spec engine
    with a 1-layer draft (seed 2) emits the plain spec engine's tokens
    (``fused_decode=False``), token for token, and the target's."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL, init_params
    from paddle_tpu_torch.serving import (GREEDY, DecodeEngine,
                                          EngineConfig, SpecDecodeEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT_SMALL.scaled(num_layers=2, dtype=torch.float32)
    dcfg = cfg.scaled(num_layers=1)
    params = init_params(cfg, seed=1, device="cuda")
    dparams = init_params(dcfg, seed=2, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 17, 40, 100)]
    n_tok = 32

    def engine(p, c, layout, fused, **kw):
        return DecodeEngine(p, c, EngineConfig(
            max_batch=4, max_seq=256, prefill_buckets=(64, 128),
            kv_layout=layout, page_size=PAGE, fused_decode=fused, **kw),
            device="cuda")

    def streams(eng):
        slots, toks = {}, {}
        for i, p in enumerate(prompts):
            slots[i], _l, tok = eng.start_sequence_sampled(p, GREEDY)
            toks[i] = [tok]
        while any(len(t) < n_tok for t in toks.values()):
            live = {i: s for i, s in slots.items() if len(toks[i]) < n_tok}
            out = eng.generate_step({s: toks[i][-1]
                                     for i, s in live.items()})
            for i, s in live.items():
                toks[i].extend(out[s])
        for s in slots.values():
            eng.free_sequence(s)
        return {i: t[:n_tok] for i, t in toks.items()}

    W = SPEC_K + 1
    for layout in ("slab", "paged"):
        alone = streams(engine(params, cfg, layout, True))
        self_spec = SpecDecodeEngine(
            engine(params, cfg, layout, True, verify_window=W),
            engine(params, cfg, layout, True))
        got = streams(self_spec)
        st = self_spec.stats
        if (got != alone or st.acceptance_rate != 1.0
                or st.tokens_per_window != W):
            raise AssertionError(
                f"spec parity {layout}: self-draft tokens equal "
                f"{got == alone}, acceptance {st.acceptance_rate}, tokens "
                f"a window {st.tokens_per_window} (want {W})")
        runs = {}
        for fused in (True, False):
            spec = SpecDecodeEngine(
                engine(params, cfg, layout, fused, verify_window=W),
                engine(dparams, dcfg, layout, fused))
            runs[fused] = (streams(spec), spec.stats.acceptance_rate)
        if not runs[True][0] == runs[False][0] == alone:
            raise AssertionError(f"spec parity {layout}: kernel spec, plain "
                                 "spec and target-alone tokens differ")
        print(f"[spec-parity] {layout}: self-draft acceptance 1.0, {W} "
              f"tokens a window, tokens = target alone; 1-layer draft "
              f"(acceptance {runs[True][1]:.3f}): kernel spec = plain spec "
              f"= target alone, 4 prompts x {n_tok} tokens (f32)")


def bf16_check(name, got, want) -> float:
    """Each element of a bf16 [..., hd] output against its plain version:
    |got - want| <= 2^-7 (|want| + max |want| over the element's row)
    + 1e-5, that is 1-2 bf16 ulps of the element plus 1-2 of its row's
    largest (2^-7 is one bf16 ulp at 1.0). Every query or key row is held
    at its own scale, late rows as tightly as early ones; the 1e-5 covers
    rows whose exact value is zero (dq's first causal row, where dP - D
    cancels), which hold float32 rounding noise only. Prints the worst
    ratio of diff to bound, raises when it exceeds 1, and returns the max
    abs diff."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = (2.0 ** -7 * (want.abs() + want.abs().amax(-1, keepdim=True))
             + 1e-5)
    worst = (err / bound).max().item()
    print(f"[check] {name}: worst diff/bound {worst:.4g}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: {int((err > bound).sum())} elements "
                             f"over the bound, worst diff/bound {worst:.4g}")
    return err.max().item()


def _bwd_bitwise(tag, dtype, FA, ins, causal, bias, outs, di):
    """Two more launches of each backward kernel on the same inputs give
    dq, dk and dv bitwise equal to ``outs`` (each block owns its rows, no
    atomics); dK/dV without ``di`` (its wrapper takes D from a dQ launch)
    equals dK/dV with dQ's D, bitwise."""
    q, k, v, o, lse, do = ins
    again = (FA.flash_bwd_dq(q, k, v, o, lse, do, causal, bias=bias),
             *FA.flash_bwd_dkv(q, k, v, o, lse, do, causal, bias=bias,
                               di=di),
             *FA.flash_bwd_dkv(q, k, v, o, lse, do, causal, bias=bias))
    torch.cuda.synchronize()
    for what, got, want in zip(("dq", "dk", "dv", "dk (no di)",
                                "dv (no di)"), again, outs + outs[1:]):
        if not torch.equal(got, want):
            raise AssertionError(f"{tag} {dtype} {what}: a second launch "
                                 "differs")
    print(f"[{tag}] {dtype} dq, dk, dv bitwise equal across launches")


def _sdpa_bwd_ms(qt, kt, vt, dot, causal, mask) -> float:
    """ms of one SDPA backward (dq, dk and dv together), eager."""
    ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                        is_causal=causal)
    return _time_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), dot, retain_graph=True), iters=20, warmup=3)


def _pair_record(FA, ins, causal, bias, dq_rec, dkv_rec, sdpa_ms) -> dict:
    """dQ then dK/dV with dQ's D, as ``_Flash.backward`` launches them,
    timed by CUDA-graph replay beside one SDPA backward and the two
    kernels' summed bound."""
    q, k, v, o, lse, do = ins

    def pair():
        _dq, di = FA.flash_bwd_dq(q, k, v, o, lse, do, causal, bias=bias,
                                  return_di=True)
        return FA.flash_bwd_dkv(q, k, v, o, lse, do, causal, bias=bias,
                                di=di)

    ms = _time_graph_ms(pair, 10)
    return {"ms": ms, "library_ms": sdpa_ms, "x_library": ms / sdpa_ms,
            "bound_ms": dq_rec["bound_ms"] + dkv_rec["bound_ms"],
            "kernels_ms": dq_rec["ms"] + dkv_rec["ms"]}


def phase_train_kernels(dtype, time_it: bool):
    """The training kernels vs their plain versions at the training path's
    shapes; one record per kernel (errors, and times when ``time_it``)."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import kernel_costs as KC

    bf16 = dtype == torch.bfloat16
    # the float32 plain versions must run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    nh, hd = GPT_SMALL.num_heads, GPT_SMALL.head_dim
    Bt, Tt = (16 if bf16 else 2), 1024
    g = torch.Generator(device=dev)
    g.manual_seed(4321)

    def randn(*shape, dt=dtype, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    def check(kname, got, want, f32_tol):
        if bf16:
            return bf16_check(f"{kname} bf16", got, want)
        return _check_close(kname, got, want, dtype, f32_tol)

    qkv = randn(Bt, Tt, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = randn(Bt, Tt, nh, hd)
    recs = {}
    o, lse = FA.flash_fwd(q, k, v)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    # lse is float32 in both dtypes: the f32 tolerance
    recs["flash_fwd"] = {"max_abs_err": max(
        check("flash_fwd o", o, o_p, 2e-5),
        _check_close("flash_fwd lse", lse, lse_p, torch.float32, 2e-5))}
    dq, di = FA.flash_bwd_dq(q, k, v, o_p, lse_p, do, return_di=True)
    dq_p, di_p = FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                       return_di=True)
    torch.cuda.synchronize()
    recs["flash_bwd_dq"] = {"max_abs_err": check("flash_bwd_dq", dq, dq_p,
                                                 3e-4)}
    # D = rowsum(dO * o): float32 in both dtypes, summed in another order
    _check_close("flash_bwd_dq D", di, di_p, torch.float32, 2e-5)
    dk, dv = FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do, di=di)
    dk_p, dv_p = FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do)
    torch.cuda.synchronize()
    recs["flash_bwd_dkv"] = {"max_abs_err": max(
        check("flash_bwd_dkv dk", dk, dk_p, 3e-4),
        check("flash_bwd_dkv dv", dv, dv_p, 3e-4))}
    _bwd_bitwise("train-kernels", dtype, FA, (q, k, v, o_p, lse_p, do),
                 True, None, (dq, dk, dv), di)
    del dq_p, dk_p, dv_p, di_p
    if time_it:
        esz = q.element_size()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # bytes: inputs read once, outputs written once; dK/dV reads D
        # (from dQ) where the reference's form reads o (kernel_costs)
        for kname, fn, plain in (
                ("flash_fwd", lambda: FA.flash_fwd(q, k, v),
                 lambda: FA.flash_fwd_plain(q, k, v)),
                ("flash_bwd_dq",
                 lambda: FA.flash_bwd_dq(q, k, v, o_p, lse_p, do),
                 lambda: FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do)),
                ("flash_bwd_dkv",
                 lambda: FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do, di=di),
                 lambda: FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do,
                                                di=di))):
            r = recs[kname]
            # near or under their wrappers' host cost: device time by
            # graph replay, eager beside
            r["ms"] = _time_graph_ms(fn, 10)
            r["eager_ms"] = _time_ms(fn, iters=20, warmup=3)
            r["plain_ms"] = _time_ms(plain, iters=3, warmup=1)
            r["bound_ms"], r["bound_by"] = _bound(
                getattr(KC, kname)(Bt, Tt, nh, hd, esz, True))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
        recs["flash_fwd"]["library_ms"] = _time_graph_ms(sdpa, 10)
        recs["flash_fwd"]["library_eager_ms"] = _time_ms(sdpa, iters=20,
                                                         warmup=3)
        bwd_ms = _sdpa_bwd_ms(qt, kt, vt, do.transpose(1, 2), True, None)
        # one SDPA backward computes dq, dk and dv together
        recs["flash_bwd_dq"]["library_ms"] = bwd_ms
        recs["flash_bwd_dkv"]["library_ms"] = bwd_ms
        pair = _pair_record(FA, (q, k, v, o_p, lse_p, do), True, None,
                            recs["flash_bwd_dq"], recs["flash_bwd_dkv"],
                            bwd_ms)
        recs["flash_bwd_dq"]["pair"] = recs["flash_bwd_dkv"]["pair"] = pair
        print(f"[train-kernels] flash_bwd_pair bf16 [{Bt}, {Tt}, {nh}, "
              f"{hd}] causal: " + ", ".join(f"{a}={b:.6g}" if isinstance(
                  b, float) else f"{a}={b}" for a, b in pair.items()))
    del qkv, q, k, v, do, o, lse, o_p, lse_p, dq, dk, dv, di
    recs["opt_adamw_flat"] = _sweep_check(torch.float32 if not bf16
                                          else torch.bfloat16, time_it)
    recs.update(_ln_check(dtype, time_it))
    recs["ce_fwd"] = _ce_check(dtype, time_it)
    for kname, r in recs.items():
        print(f"[train-kernels] {kname} {dtype}: " + ", ".join(
            f"{a}={b:.6g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()))
    torch.cuda.empty_cache()
    return recs


# the fused-LN small cases (R, D): R = 1 and R not a multiple of a block's
# 4 rows; D not a multiple of the 16-byte vector (770); the backward's
# register path at its cap (1024) and past it (1032, a block a row); the
# forward's at its cap (2048) and past it (2056, 12,288: a block a row;
# the backward's looped block a row past 2048)
LN_CASES = ((1, 64), (150, 80), (5, 770), (33, 1024), (33, 1032),
            (37, 2048), (9, 2056), (3, 12288))


def ln_small_case(dtype, R: int, D: int, offset: int, dtol: float) -> float:
    """Every forward form (bits: residual, bias_add, mask) and every
    backward form (dsx, mask) of the fused-LN kernels against their plain
    versions at rows [R, D], each [R, D] operand a view ``offset``
    elements into a larger buffer (1: not 16-byte aligned, so the scalar
    instances run): s bitwise; y, ds, dx per element (bf16_check; float32
    1e-5); mu and rstd within 1e-5; dscale and dbias within ``dtol`` x the
    column's sum of |term|; a second backward launch bitwise equal. Every
    D runs on a kernel (past 2048 columns the backward's looped block a
    row; past a block's shared memory the forward's two-pass block a
    row). Returns the largest |kernel - plain|."""
    from paddle_tpu_torch.ops import fused_ln as FL

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(R * 100003 + D + offset)

    def rows(dt=dtype):
        buf = (torch.rand(R * D + offset, generator=g, device=dev) < 0.8
               if dt == torch.bool else
               torch.randn(R * D + offset, generator=g, device=dev).to(dt))
        return buf[offset:].view(R, D)

    def close(what, got, want):
        if dtype == torch.bfloat16:
            return bf16_check(f"{what} [{R}, {D}]+{offset}", got, want)
        return _check_close(what, got, want, dtype, 1e-5)

    x, res, dy, dsx, mask = (rows(), rows(), rows(), rows(),
                             rows(torch.bool))
    badd = torch.randn(D, generator=g, device=dev).to(dtype)
    scale = torch.randn(D, generator=g, device=dev)
    bias = torch.randn(D, generator=g, device=dev)
    inv = FL._round_to(1 / 0.8, dtype)
    err = 0.0
    for form in range(8):
        kw = {}
        if form & 1:
            kw["residual"] = res
        if form & 2:
            kw["bias_add"] = badd
        if form & 4:
            kw.update(mask=mask, inv_keep=inv)
        got = FL.fused_ln_fwd(x, scale, bias, **kw)
        want = FL.fused_ln_fwd_plain(x, scale, bias, **kw)
        torch.cuda.synchronize()
        if (got[1] is None) != (form == 0) or (
                form and not torch.equal(got[1], want[1])):
            raise AssertionError(f"fused_ln form {form} [{R}, {D}]+{offset} "
                                 f"{dtype}: s differs from the plain one's")
        err = max(err, close(f"fused_ln form {form} y", got[0], want[0]))
        for i, stat in ((2, "mu"), (3, "rstd")):
            _check_close(f"fused_ln form {form} {stat}", got[i], want[i],
                         torch.float32, 1e-5)
    _y, s, mu, rstd = want
    s = rows().copy_(s)                 # the backward's s, offset too
    xhat = (s.float() - mu[:, None]) * rstd[:, None]
    tot = ((dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0))
    inv32 = FL._round_to(1 / 0.8, torch.float32)
    for kw in ({}, dict(dsx=dsx), dict(mask=mask, inv_keep=inv32),
               dict(dsx=dsx, mask=mask, inv_keep=inv32)):
        got = FL.fused_ln_bwd(s, mu, rstd, scale, dy, **kw)
        want = FL.fused_ln_bwd_plain(s, mu, rstd, scale, dy, **kw)
        again = FL.fused_ln_bwd(s, mu, rstd, scale, dy, **kw)
        torch.cuda.synchronize()
        form = "+".join(kw) or "plain"
        err = max(err, close(f"fused_ln_bwd {form} ds", got[0], want[0]))
        if "mask" in kw:
            err = max(err, close(f"fused_ln_bwd {form} dx", got[1],
                                 want[1]))
        for i, what in ((2, "dscale"), (3, "dbias")):
            diff = (got[i] - want[i]).abs()
            if not (diff <= dtol * tot[i - 2] + 1e-30).all():
                raise AssertionError(
                    f"fused_ln_bwd {form} {what} [{R}, {D}]+{offset} "
                    f"{dtype}: worst diff/bound "
                    f"{(diff / (dtol * tot[i - 2] + 1e-30)).max().item():.4g}")
            err = max(err, diff.max().item())
        if not all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(got, again)):
            raise AssertionError(f"fused_ln_bwd {form} [{R}, {D}]+{offset} "
                                 f"{dtype}: a second launch differs")
    return err


def _ln_check(dtype, time_it: bool):
    """The fused-LN forward (ln2 form: residual + bias_add, emitting s;
    plain form; dropout-mask form) and backward (with dsx; with dsx and
    the mask) against their plain versions, at the training path's rows
    [16 x 1024, 768] in bf16 or [256, 768] in float32: s and the mask
    form's s bitwise, y, ds and dx per element (bf16_check; f32 1e-5), mu
    and rstd within 1e-5, dscale and dbias per column within 2^-18 x the
    column's sum of |term| over the rows (float32 sums of 16,384 terms in
    another order), two launches of each backward form bitwise equal;
    then every form and instance at the LN_CASES shapes, aligned and one
    element off (:func:`ln_small_case`, 2^-18). Timed by CUDA-graph
    replay over three copies of the inputs: the ln2 form (``ms``; no one
    PyTorch call computes it: ``library_ms`` null), the plain form beside
    ``F.layer_norm`` on the same rows (the same function), the mask form,
    ``F.layer_norm`` on s (half the ln2 form's bytes); the dsx backward
    (``ms``) and the backward without dsx beside
    ``aten.native_layer_norm_backward`` (the same function)."""
    from paddle_tpu_torch.ops import fused_ln as FL
    from paddle_tpu_torch.ops import kernel_costs as KC

    bf16 = dtype == torch.bfloat16
    dev = torch.device("cuda")
    R, D = (16 * 1024 if bf16 else 256), 768
    g = torch.Generator(device=dev)
    g.manual_seed(77)

    def randn(*shape, dt=dtype, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    def check(what, got, want):
        if bf16:
            return bf16_check(f"{what} bf16", got, want)
        return _check_close(what, got, want, dtype, 1e-5)

    x, res, dy, dsx = randn(R, D), randn(R, D), randn(R, D), randn(R, D)
    badd = randn(D, s=0.1)
    scale = 1.0 + randn(D, dt=torch.float32, s=0.1)
    bias = randn(D, dt=torch.float32, s=0.1)
    keep = 0.9
    mask = torch.rand((R, D), generator=g, device=dev) < keep
    forms = {"ln2": dict(residual=res, bias_add=badd), "plain": {},
             "mask": dict(residual=res, mask=mask,
                          inv_keep=FL._round_to(1 / keep, dtype))}
    err = 0.0
    for form, kw in forms.items():
        got = FL.fused_ln_fwd(x, scale, bias, eps=1e-5, **kw)
        want = FL.fused_ln_fwd_plain(x, scale, bias, eps=1e-5, **kw)
        torch.cuda.synchronize()
        if (got[1] is None) != (want[1] is None) or (
                got[1] is not None and not torch.equal(got[1], want[1])):
            raise AssertionError(f"fused_ln {form} {dtype}: s differs from "
                                 "the plain version's")
        err = max(err, check(f"fused_ln {form} y", got[0], want[0]))
        for i, stat in ((2, "mu"), (3, "rstd")):
            _check_close(f"fused_ln {form} {stat}", got[i], want[i],
                         torch.float32, 1e-5)
        if form == "ln2":
            _y, s, mu, rstd = want
    recs = {"fused_ln": {"max_abs_err": err}}
    err = 0.0
    xhat = (s.float() - mu[:, None]) * rstd[:, None]
    sums = ((dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0))
    for form, kw in (("dsx", dict(dsx=dsx)),
                     ("dsx+mask", dict(dsx=dsx, mask=mask,
                                       inv_keep=FL._round_to(
                                           1 / keep, torch.float32)))):
        got = FL.fused_ln_bwd(s, mu, rstd, scale, dy, **kw)
        want = FL.fused_ln_bwd_plain(s, mu, rstd, scale, dy, **kw)
        again = FL.fused_ln_bwd(s, mu, rstd, scale, dy, **kw)
        torch.cuda.synchronize()
        err = max(err, check(f"fused_ln_bwd {form} ds", got[0], want[0]))
        if "mask" in kw:
            err = max(err, check(f"fused_ln_bwd {form} dx", got[1], want[1]))
        for i, what, tot in ((2, "dscale", sums[0]), (3, "dbias", sums[1])):
            ratio = ((got[i] - want[i]).abs() / (2.0 ** -18 * tot + 1e-30)
                     ).max().item()
            print(f"[check] fused_ln_bwd {form} {what} {dtype}: worst "
                  f"diff/bound {ratio:.4g} (bound 2^-18 x sum |term|)")
            if not ratio <= 1.0:
                raise AssertionError(f"fused_ln_bwd {form} {what}: worst "
                                     f"diff/bound {ratio:.4g}")
            err = max(err, (got[i] - want[i]).abs().max().item())
        if not all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(got, again)):
            raise AssertionError(f"fused_ln_bwd {form} {dtype}: a second "
                                 "launch differs")
    print(f"[check] fused_ln_bwd {dtype}: a second launch bitwise equal")
    recs["fused_ln_bwd"] = {"max_abs_err": err}
    small = max(ln_small_case(dtype, r, d, off, 2.0 ** -18)
                for (r, d), off in itertools.product(LN_CASES, (0, 1)))
    print(f"[check] fused_ln {dtype}: {2 * len(LN_CASES)} small cases, "
          f"every form, max |kernel - plain| {small:.4g}")
    recs["fused_ln"]["small_max_abs_err"] = small
    if time_it:
        esz = x.element_size()
        fwd, bwd = recs["fused_ln"], recs["fused_ln_bwd"]
        # three copies of every [R, D] operand (x, res, dy, dsx, s: 25 MB
        # each in bf16), walked in turn, so the timed launches read HBM
        # and not the 50 MB L2
        xs, rs_, dys, dsxs, ss = ([t] + [t.clone() for _ in range(2)]
                                  for t in (x, res, dy, dsx, s))

        def graph_ms(fn, calls=12):
            return _time_graph_ms(_over_layers(fn, 3), calls)

        # PyTorch's layernorm takes its weight and bias in x's dtype only
        w16, b16 = scale.to(dtype), bias.to(dtype)

        def ln2(i):
            return FL.fused_ln_fwd(xs[i], scale, bias, rs_[i], badd,
                                   eps=1e-5)

        fwd["ms"] = graph_ms(ln2)
        fwd["eager_ms"] = _time_ms(_over_layers(ln2, 3), iters=21,
                                   warmup=3)
        fwd["plain_ms"] = graph_ms(lambda i: FL.fused_ln_fwd_plain(
            xs[i], scale, bias, rs_[i], badd, eps=1e-5), 3)
        fwd["library_ms"] = None        # no one PyTorch call computes it
        # reads x, res, badd, scale, bias; writes y, s, mu, rstd
        fwd["bound_ms"], fwd["bound_by"] = _bound(
            KC.fused_ln(R, D, esz, residual=True, bias_add=True))
        fwd["plain_form_ms"] = graph_ms(
            lambda i: FL.fused_ln_fwd(xs[i], scale, bias, eps=1e-5))
        fwd["plain_form_library_ms"] = graph_ms(
            lambda i: F.layer_norm(xs[i], (D,), w16, b16, 1e-5))
        # reads x, scale, bias; writes y, mu, rstd
        fwd["plain_form_bound_ms"] = _bound(KC.fused_ln(R, D, esz))[0]
        fwd["mask_form_ms"] = graph_ms(lambda i: FL.fused_ln_fwd(
            xs[i], scale, bias, rs_[i], mask=mask, eps=1e-5,
            inv_keep=forms["mask"]["inv_keep"]))
        # half the ln2 form's bytes: not the same function
        fwd["layer_norm_on_s_ms"] = graph_ms(
            lambda i: F.layer_norm(ss[i], (D,), w16, b16, 1e-5))
        bwd["ms"] = graph_ms(lambda i: FL.fused_ln_bwd(
            ss[i], mu, rstd, scale, dys[i], dsxs[i]))
        bwd["plain_ms"] = graph_ms(lambda i: FL.fused_ln_bwd_plain(
            ss[i], mu, rstd, scale, dys[i], dsxs[i]), 3)
        bwd["library_ms"] = None        # no one PyTorch call computes it
        # reads s, dy, dsx, mu, rstd, scale; writes ds, dscale, dbias
        bwd["bound_ms"], bwd["bound_by"] = _bound(
            KC.fused_ln_bwd(R, D, esz, dsx=True))
        bwd["no_dsx_ms"] = graph_ms(lambda i: FL.fused_ln_bwd(
            ss[i], mu, rstd, scale, dys[i]))
        _o, mean, rstd_l = torch.ops.aten.native_layer_norm(s, [D], w16,
                                                            b16, 1e-5)
        bwd["no_dsx_library_ms"] = graph_ms(
            lambda i: torch.ops.aten.native_layer_norm_backward(
                dys[i], ss[i], [D], mean, rstd_l, w16, b16,
                [True, True, True]))
        # reads s, dy, mu, rstd, scale; writes ds, dscale, dbias
        bwd["no_dsx_bound_ms"] = _bound(KC.fused_ln_bwd(R, D, esz))[0]
    return recs


# the CE forward's calls on the main paths: (n, D, vocab, layout, bias,
# vocab chunk) — phase 7b's 2048-row chunk of GPT_SMALL's head [768,
# 50304 -> 51200], and ERNIE-base's MLM rows (48 x 20 masked positions)
# against its tied table [30522 -> 30720, 768] with the decoder bias
CE_CALLS = {"gpt": (2048, 768, 50304, "dv", False, 1024),
            "ernie": (960, 768, 30522, "vd", True, 1024)}
# small cases (n, D, vp, vocab, extra head row stride): n = 1 and n not a
# multiple of the 128-row tile, a vocab ending inside a tile and tiles
# wholly past it, D = 772 (rows not 16-byte aligned at bf16: element
# copies), a head whose rows are padded (stride past the width) and an
# odd stride (no row 16-byte aligned)
CE_SMALL = ((1, 8, 128, 1, 0), (70, 64, 384, 301, 0),
            (300, 96, 1024, 1000, 0), (200, 772, 700, 650, 0),
            (130, 768, 1000, 999, 24), (129, 100, 600, 555, 3))


def _ce_inputs(dtype, n, D, vp, vocab, layout, with_bias, extra, seed):
    """x [n, D], a head of vp columns in ``layout`` whose rows lie
    ``extra`` elements apart past their width, a float32 bias [vp] or
    None, int32 labels in [0, vocab): seeded, on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((n, D), generator=g, device=dev).to(dtype)
    rows, width = (D, vp) if layout == "dv" else (vp, D)
    buf = (torch.randn((rows, width + extra), generator=g, device=dev)
           * 0.3).to(dtype)
    head = buf[:, :width]
    bias = (torch.randn(vp, generator=g, device=dev) * 0.5 if with_bias
            else None)
    labels = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, n).astype(np.int32)).to(dev)
    return x, head, bias, labels


def _ce_close(tag, got, want) -> float:
    """lse and gold within 1e-4 absolute (the Pallas-vs-lax tolerance of
    tests/test_memory_levers.py:57-58), every value finite."""
    err = 0.0
    for what, a, b in zip(("lse", "gold"), got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag} {what}: non-finite values")
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0,
                                   msg=lambda m: f"{tag} {what}: {m}")
        err = max(err, (a - b).abs().max().item())
    return err


def ce_small_case(dtype, layout, n, D, vp, vocab, extra) -> float:
    """The CE forward against its plain sweep at one small shape, with and
    without the bias: :func:`_ce_close`. Returns the max abs error."""
    from paddle_tpu_torch.ops import chunked_ce as CE

    err = 0.0
    for with_bias in (False, True):
        x, head, bias, labels = _ce_inputs(dtype, n, D, vp, vocab, layout,
                                           with_bias, extra, n + D + vp)
        want = CE.ce_fwd_plain(x, head, bias, labels, vp, vocab, layout)
        got = CE.ce_fwd(x, head, bias, labels, vp, vocab, layout)
        torch.cuda.synchronize()
        err = max(err, _ce_close(
            f"ce_fwd {dtype} {layout} n {n} D {D} vp {vp} vocab {vocab} "
            f"stride +{extra} bias {with_bias}", got, want))
    return err


def _ce_check(dtype, time_it: bool):
    """The CE forward kernel against its plain sweep at the main paths'
    calls (:data:`CE_CALLS`; bf16 at their shapes, float32 at 256 rows)
    and at every :data:`CE_SMALL` shape in both layouts with and without
    the bias: :func:`_ce_close`. Timed at bf16 by CUDA-graph replay: the
    GPT call (``ms``) and
    ERNIE's (``ernie_*``), each beside its plain sweep, its bound (the
    ``2 n D vocab`` operations at the bf16 peak, or the bytes) and the
    cuBLAS product of its logits (``matmul_ms``, the floor of its work: no
    single PyTorch call computes linear + CE, so ``library_ms`` is
    null)."""
    from paddle_tpu_torch.ops import chunked_ce as CE
    from paddle_tpu_torch.ops import kernel_costs as KC

    bf16 = dtype == torch.bfloat16
    rec = {}
    err = 0.0
    calls = {}
    for call, (n, D, V, layout, with_bias, vc) in CE_CALLS.items():
        n = n if bf16 else 256
        vp = -(-V // vc) * vc
        ins = _ce_inputs(dtype, n, D, vp, V, layout, with_bias, 0, 91)
        want = CE.ce_fwd_plain(*ins, vc, V, layout)
        got = CE.ce_fwd(*ins, vc, V, layout)
        torch.cuda.synchronize()
        err = max(err, _ce_close(f"ce_fwd {dtype} {call} call", got, want))
        calls[call] = (ins, n, D, V, layout, vc)
    rec["max_abs_err"] = err
    rec["small_max_abs_err"] = max(
        ce_small_case(dtype, layout, *case)
        for case in CE_SMALL for layout in ("dv", "vd"))
    print(f"[check] ce_fwd {dtype}: {len(CE_CALLS)} path calls and "
          f"{4 * len(CE_SMALL)} small cases, max |kernel - plain| "
          f"{err:.4g} / {rec['small_max_abs_err']:.4g}")
    if time_it:
        esz = torch.empty((), dtype=dtype).element_size()
        for call, (ins, n, D, V, layout, vc) in calls.items():
            x, head, bias, labels = ins
            key = "" if call == "gpt" else f"{call}_"
            rec[f"{key}ms"] = _time_graph_ms(
                lambda: CE.ce_fwd(*ins, vc, V, layout), 10)
            if call == "gpt":
                rec["eager_ms"] = _time_ms(
                    lambda: CE.ce_fwd(*ins, vc, V, layout), iters=20,
                    warmup=3)
            rec[f"{key}plain_ms"] = _time_ms(
                lambda: CE.ce_fwd_plain(*ins, vc, V, layout), iters=5,
                warmup=1)
            hm = head if layout == "dv" else head.t()
            rec[f"{key}matmul_ms"] = _time_graph_ms(
                lambda: torch.matmul(x, hm), 10)
            # the vocab's real columns: x, those head columns (and bias)
            # and the labels read, lse and gold written; 2 n D V operations
            b, b_by = _bound(KC.ce_fwd(n, D, V, esz, bias is not None))
            rec[f"{key}bound_ms"], rec[f"{key}bound_by"] = b, b_by
        rec["library_ms"] = None
    return rec


N_PARAMS = 163_109_376      # GPT_SMALL's parameter count: the sweep's n
# the sweep's edge cases (n, offset): a whole number of vectors plus a
# scalar tail of 3, and an odd n one element into its buffers (no operand
# 16-byte aligned: the scalar instance)
SWEEP_EDGES = ((100_003, 0), (1001, 1))


def _sweep_inputs(n, mdt, offset, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def buf(make, dt=torch.float32):
        return make(n + offset).to(dt)[offset:]

    p = buf(lambda k: torch.randn(k, generator=g, device=dev))
    grad = buf(lambda k: torch.randn(k, generator=g, device=dev) * 1e-2)
    m = buf(lambda k: torch.randn(k, generator=g, device=dev) * 1e-3, mdt)
    v = buf(lambda k: torch.rand(k, generator=g, device=dev) * 1e-5, mdt)
    mask = buf(lambda k: (torch.rand(k, generator=g, device=dev) < 0.9)
               .float())
    return p, grad, m, v, mask


def _sweep_bitwise(tag, ins, sc, hp):
    from paddle_tpu_torch.ops import cuda_kernels as CK

    p, grad, m, v, mask = ins
    outs = []
    for fn in (CK.megakernel_adamw_flat, CK.megakernel_adamw_flat_plain):
        pc, mc, vc = p.clone(), m.clone(), v.clone()
        fn(pc, grad, mc, vc, mask, *sc, **hp)
        outs.append((pc, mc, vc))
    torch.cuda.synchronize()
    for got, want, what in zip(outs[0], outs[1], ("p", "m", "v")):
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"opt_adamw_flat {tag}: {what} differs "
                                 f"from the plain version in {bad} elements")


def _sweep_check(mdt, time_it: bool):
    """The AdamW sweep over GPT_SMALL's flat buffers vs its plain version,
    bitwise for p, m and v, and at :data:`SWEEP_EDGES` (a vector tail; an
    odd n off alignment); timed with bf16 moments by CUDA-graph replay
    (the five buffers hold 2.6 GB, so no launch finds them in L2)."""
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import kernel_costs as KC

    dev = torch.device("cuda")
    n = N_PARAMS
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (1e-4, 0.7, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    for en, off in SWEEP_EDGES:
        _sweep_bitwise(f"{mdt} n {en} offset {off}",
                       _sweep_inputs(en, mdt, off, en), sc, hp)
    ins = _sweep_inputs(n, mdt, 0, 99)
    _sweep_bitwise(f"{mdt} n {n}", ins, sc, hp)
    rec = {"max_abs_err": 0.0}
    if time_it:
        p, grad, m, v, mask = ins
        rec["ms"] = _time_graph_ms(lambda: CK.megakernel_adamw_flat(
            p, grad, m, v, mask, *sc, **hp), 4, replays=5)
        rec["eager_ms"] = _time_ms(lambda: CK.megakernel_adamw_flat(
            p, grad, m, v, mask, *sc, **hp), iters=20, warmup=3)
        rec["plain_ms"] = _time_ms(lambda: CK.megakernel_adamw_flat_plain(
            p, grad, m, v, mask, *sc, **hp), iters=5, warmup=1)
        # no single PyTorch call computes the masked flat AdamW sweep
        rec["library_ms"] = None
        rec["bound_ms"], rec["bound_by"] = _bound(
            KC.opt_adamw_flat(n, m.element_size()))
    return rec


# widths the reference takes and the parent port raised on (ROADMAP C4,
# C5), one small case each: flash at head dims without an instance
# (padded), decode at hd 8 and 96 (the next power-of-two instance; 96 is
# whole 16-byte vectors, and hd 20 is not), the LN forward past its 48 KB
# row buffer (and past a block's shared memory: the two-pass instance),
# the LN backward past 2048 columns, logits_head past its shared-memory
# plan (the streamed instance)
WIDTH_FLASH_HDS = (24, 48, 80, 96)
WIDTH_DECODE_HDS = (8, 20, 96)
# head dims past 128 (what was left of ROADMAP C4): the split route of the
# flash and decode kernels, at T 200 (flash) and the decode shapes above
WIDE_HDS = (160, 256, 320)
WIDTH_LN = ((3, 16384), (2, 20000), (2, 65536), (5, 2560), (4, 4096))
WIDTH_LH_D = 8192


def decode_width_case(dtype, hd) -> float:
    """The slab and the paged decode kernels at head_dim ``hd`` against
    their plain versions: slab [3, 200, 2, hd] with one inactive lane,
    pools [13, 16, 2, hd] with permuted tables; outputs per element
    (:func:`_check_out`), the caches bitwise."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(hd)
    B, S, nh, page, M = 3, 200, 2, 16, 4
    P = B * M + 1

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    qkv = randn(B, 3, nh, hd)
    q, nk, nv = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    kc, vc = randn(B, S, nh, hd), randn(B, S, nh, hd)
    pos = torch.tensor([0, 77, S - 1], dtype=torch.int32, device=dev)
    act = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got, _, _ = CK.fused_decode_attention(q, k1, v1, nk, nv, pos, act)
    want, _, _ = CK.fused_decode_attention_plain(q, k2, v2, nk, nv, pos, act)
    torch.cuda.synchronize()
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        raise AssertionError(f"decode_slab {dtype} hd {hd}: caches differ "
                             "from the plain version's")
    err = _check_out(f"decode_slab hd {hd}", got, want, dtype)
    kp, vp = randn(P, page, nh, hd), randn(P, page, nh, hd)
    tab = np.random.default_rng(hd).permutation(np.arange(1, P)).astype(
        np.int32).reshape(B, M)
    tables = torch.from_numpy(tab).to(dev)
    pos = torch.tensor([0, 33, M * page - 1], dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    got, _, _ = CK.fused_paged_decode_attention(q, k1, v1, nk, nv, tables,
                                                pos)
    want, _, _ = CK.fused_paged_decode_attention_plain(q, k2, v2, nk, nv,
                                                       tables, pos)
    torch.cuda.synchronize()
    if not (torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])):
        raise AssertionError(f"decode_paged {dtype} hd {hd}: pools differ "
                             "from the plain version's")
    return max(err, _check_out(f"decode_paged hd {hd}", got, want, dtype))


def logits_head_width_case(dtype, D, nb=8, V=4000) -> float:
    """logits_head at rows of D too wide for the shared-memory plan (the
    streamed instance: the rows normalised by the fused-LN kernel and
    streamed with the weight) against its plain version: bf16 per element
    (:func:`bf16_check`); float32 per element within 2^-18 x the sum of
    |y w| over its D terms (float32 sums of 8,192 terms in another order
    than cuBLAS's: the 1e-5 of the D = 768 checks does not scale)."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(D)
    esz = torch.empty((), dtype=dtype).element_size()
    if not CK.logits_head_plan(nb, D, V, esz, CK._num_sms(dev))[
            "stream_rows"]:
        raise AssertionError(f"logits_head D {D}: expected the streamed "
                             "instance")
    x = torch.randn((nb, D), generator=g, device=dev).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
    bias = 0.1 * torch.randn(D, generator=g, device=dev)
    w = (0.02 * torch.randn((D, V), generator=g, device=dev)).to(dtype)
    got = CK.fused_logits_head(x, scale, bias, w)
    want = CK.fused_logits_head_plain(x, scale, bias, w)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        return bf16_check(f"logits_head D {D} bf16", got, want)
    y = CK.fused_ln_plain(x, scale, bias)
    tot = torch.matmul(y.abs(), w.abs())
    err = (got - want).abs()
    worst = (err / (2.0 ** -18 * tot + 1e-30)).max().item()
    print(f"[check] logits_head D {D} f32: worst diff/bound {worst:.4g} "
          "(bound 2^-18 x sum |term|)")
    if not worst <= 1.0:
        raise AssertionError(f"logits_head D {D} f32: worst diff/bound "
                             f"{worst:.4g}")
    return err.max().item()


def wide_flash_bias_cases(dtype, hd, g) -> float:
    """The flash split route's bias forms at ``hd``: a random bias a head
    with SQ = T, causal, and a padding bias a batch row with SQ = 1, full
    (:func:`_flash_case`, T 200). Returns the max abs error."""
    return max(_flash_case(dtype, hd, 200, True, False, True, "random", g),
               _flash_case(dtype, hd, 200, False, True, False, "pad", g))


WIDE_SHAPE = (16, 1024, 8, 256)      # causal GPT-style, hd 256
WIDE_DECODE = (8, 1024, 4, 256, 4)   # B, max_seq, nh, hd, layers


def wide_decode_timing() -> dict:
    """The decode split route at hd 256: slab caches [8, 1024, 4, 256]
    and pools [513, 16, 4, 256] (tables a seeded permutation of pages
    1..512) over 4 layers, bf16, every lane at position 1023, graph-timed
    beside SDPA on the slab (and the paged view gathered, and SDPA), with
    each call's bound. Returns the record."""
    from paddle_tpu_torch.ops import cuda_kernels as CK

    Bd, Sd, nh, hd, L = WIDE_DECODE
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(257)
    name = torch.cuda.get_device_name(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    qkv = randn(Bd, 3, nh, hd)
    q, nk, nv = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    pos_np = np.full(Bd, Sd - 1, np.int32)
    act_np = np.ones(Bd, np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    act = torch.from_numpy(act_np).to(dev)
    kc, vc = randn(L, Bd, Sd, nh, hd), randn(L, Bd, Sd, nh, hd)
    M = Sd // PAGE
    tab_np = (1 + np.random.default_rng(257).permutation(Bd * M)).astype(
        np.int32).reshape(Bd, M)
    tables = torch.from_numpy(tab_np).to(dev)
    kp, vp = (randn(L, Bd * M + 1, PAGE, nh, hd) for _ in range(2))
    rec = {"decode_slab": {
        "ms": _time_graph_ms(_over_layers(
            lambda i: CK.fused_decode_attention(q, kc[i], vc[i], nk, nv, pos,
                                                act), L), 2 * L),
        "library_ms": _time_graph_ms(_over_layers(
            _slab_sdpa(q, kc, vc, pos), L), 2 * L)},
        "decode_paged": {
        "ms": _time_graph_ms(_over_layers(
            lambda i: CK.fused_paged_decode_attention(
                q, kp[i], vp[i], nk, nv, tables, pos), L), 2 * L),
        "library_ms": _time_graph_ms(_over_layers(
            _gather_sdpa(q, kp, vp, tables, pos), L), 2 * L)}}
    for kname, (b, by) in (
            ("decode_slab", _slab_bound(pos_np, act_np, nh, hd, 2, name)),
            ("decode_paged", _paged_bound(tab_np, pos_np, nh, hd, 2, name))):
        rec[kname].update(bound_ms=b, bound_by=by)
    print(f"[widths] decode split route hd 256 {list(WIDE_DECODE[:4])} "
          f"pos {Sd - 1} bf16: " + json.dumps(rec))
    return rec


def wide_flash_timing() -> dict:
    """The flash split route at hd 256, [16, 1024, 8, 256] causal bf16:
    the forward, dQ and dK/dV (eager: each runs for milliseconds) beside
    SDPA's forward and backward on the same inputs, with each kernel's
    bound. Returns the record."""
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import kernel_costs as KC

    Bw, Tw, nh, hd = WIDE_SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(256)
    q, k, v, do = (torch.randn(WIDE_SHAPE, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = FA.flash_fwd(q, k, v)
    _dq, di = FA.flash_bwd_dq(q, k, v, o, lse, do, return_di=True)
    rec = {}
    for kname, fn in (
            ("flash_fwd", lambda: FA.flash_fwd(q, k, v)),
            ("flash_bwd_dq", lambda: FA.flash_bwd_dq(q, k, v, o, lse, do)),
            ("flash_bwd_dkv",
             lambda: FA.flash_bwd_dkv(q, k, v, o, lse, do, di=di))):
        b, by = _bound(getattr(KC, kname)(Bw, Tw, nh, hd, 2, True))
        rec[kname] = {"ms": _time_ms(fn, iters=5, warmup=1),
                      "bound_ms": b, "bound_by": by}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec["sdpa_fwd_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=10, warmup=2)
    rec["sdpa_bwd_ms"] = _sdpa_bwd_ms(qt, kt, vt, do.transpose(1, 2), True,
                                      None)
    print(f"[widths] flash split route hd 256 {list(WIDE_SHAPE)} causal "
          f"bf16: " + json.dumps(rec))
    return rec


def phase_widths(dtype) -> float:
    """Phase 3w: every :data:`WIDTH_FLASH_HDS` / :data:`WIDTH_DECODE_HDS`
    / :data:`WIDTH_LN` / :data:`WIDTH_LH_D` case runs on a hand kernel and
    matches its plain version (flash: every form at T 200, causal;
    :func:`decode_width_case`; :func:`ln_small_case` with dscale/dbias
    within 1e-5 x sum |term|; :func:`logits_head_width_case`). Returns
    the max abs error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=torch.device("cuda"))
    g.manual_seed(31)
    err = {"flash": max(_flash_case(dtype, hd, 200, False, False, True, None,
                                    g) for hd in WIDTH_FLASH_HDS + WIDE_HDS),
           "flash_bias_wide": max(wide_flash_bias_cases(dtype, hd, g)
                                  for hd in WIDE_HDS),
           "decode": max(decode_width_case(dtype, hd)
                         for hd in WIDTH_DECODE_HDS + WIDE_HDS),
           "fused_ln": max(ln_small_case(dtype, R, D, 0, 1e-5)
                           for R, D in WIDTH_LN),
           "logits_head": logits_head_width_case(dtype, WIDTH_LH_D)}
    print(f"[widths] {dtype}: max |kernel - plain| " + ", ".join(
        f"{k} {v:.4g}" for k, v in err.items()))
    return max(err.values())


def phase_training(fused: bool = False):
    """GPT_SMALL training through tools/train_bench.py — phase 7 (direct
    CE, plain layernorm) or, with ``fused``, phase 7b (the fused-layernorm
    block and the vocab-chunked CE, vchunk 1024); returns its record
    (launches_per_step from the timed steps only)."""
    from paddle_tpu_torch.tools import train_bench

    cfg = train_bench.bench_config(fused_ln=fused,
                                   ce_vchunk=1024 if fused else 0)
    tag = "training-fln-vchunk" if fused else "training"
    rec = train_bench.run(cfg)
    losses = rec["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "opt_adamw_flat": 1}
    if fused:
        # the LN forward: 2L in the blocks, 2L recomputed under dots, the
        # final LN; its backward once each; the CE forward once a row chunk
        want.update({"fused_ln": 4 * L + 1, "fused_ln_bwd": 2 * L + 1,
                     "ce_fwd": rec["batch"] * rec["seq_len"] // cfg.ce_chunk})
    if rec["launches_per_step"] != want:
        raise AssertionError(f"launches per step {rec['launches_per_step']}"
                             f" != {want}")
    print(f"[{tag}] {rec['config']} {rec['model_params']} params: "
          f"{rec['tokens_per_s']:.1f} tok/s, mfu={rec['mfu']:.4f}, "
          f"ms/step={rec['ms_per_step']:.3f}, peak_mem_bytes="
          f"{rec['peak_mem_bytes']}, warmup_s={rec['warmup_s']:.2f}")
    print(f"[{tag}] loss first={losses[0]:.6f} last={losses[-1]:.6f} "
          f"({len(losses)} steps); launches/step {rec['launches_per_step']}")
    return rec


ATTR_STEPS = 2          # 7a's captured train steps a capture
ATTR_TICKS = 16         # 7a's captured decode ticks, 8 slots resident


def _attr_kernel_gates(tag, rec, want_per_step) -> dict:
    """7a's per-capture gates: the document passes ``validate`` and its
    rows are the device streams' (not the CPU lane's); each
    hand kernel's device events a step equal its launches a step, which
    equal ``want_per_step``; each hand kernel row's flops and bytes add
    up to its recorded launches' costs exactly; the busy union is at most
    the wall and the rows add up to it within 1 µs a step. Returns each
    hand kernel's {events a step, ms a step, bound ms a step, fraction of
    bound}."""
    from paddle_tpu_torch.observability import attribution as ATT

    doc, steps = rec["attribution"], rec["steps"]
    ATT.validate(doc, require_residue=True)
    if doc["source"] != "device_streams" or doc["degraded"]:
        raise AssertionError(f"[{tag}] the capture holds no device plane: "
                             f"source {doc['source']!r}")
    events, ns, flops, nbytes = {}, {}, {}, {}
    for r in rec["rows"]:
        k = r["kernel"]
        if not k:
            continue
        events[k] = events.get(k, 0) + r["events"]
        ns[k] = ns.get(k, 0.0) + r["ns"]
        flops[k] = flops.get(k, 0.0) + r["flops_total"]
        nbytes[k] = nbytes.get(k, 0.0) + r["bytes_total"]
    per_step = {k: v / steps for k, v in events.items()}
    launches = {k: v / steps for k, v in rec["launches"].items()}
    if per_step != launches or launches != want_per_step:
        raise AssertionError(f"[{tag}] device events a step {per_step}, "
                             f"launches a step {launches}, want "
                             f"{want_per_step}")
    for k, c in rec["costs"].items():
        if (flops.get(k), nbytes.get(k)) != (c["flops"], c["bytes"]):
            raise AssertionError(
                f"[{tag}] {k}: rows carry {flops.get(k)} flops / "
                f"{nbytes.get(k)} bytes, its launches' costs "
                f"{c['flops']} / {c['bytes']}")
    busy = rec["busy_union_ns"]
    wall = rec["capture_wall_ms_per_step"] * 1e6 * steps
    rows_ns = sum(r["ns"] for r in rec["rows"])
    if not (busy <= wall and abs(rows_ns - busy) <= 1e3 * steps):
        raise AssertionError(f"[{tag}] busy union {busy} ns, wall {wall} "
                             f"ns, rows {rows_ns} ns over {steps} steps")
    return {k: {"events_per_step": per_step[k],
                "ms_per_step": ns[k] / 1e6 / steps,
                "bound_ms_per_step": rec["bound_ms"][k] / steps,
                "fraction_of_bound": rec["bound_ms"][k] / (ns[k] / 1e6)}
            for k in sorted(per_step)}


def _attr_print(tag, rec, kern) -> None:
    doc = rec["attribution"]
    res = doc["residue"]
    print(f"[{tag}] {doc['device_kind']}: wall "
          f"{doc['wall_ms_per_step']:.3f} ms a step (under the profiler "
          f"{rec['capture_wall_ms_per_step']:.3f}), device busy "
          f"{doc['device_busy_ms_per_step']:.3f} ms, gap share "
          f"{doc['gap_share']:.4f}, {doc['fusion_count']} rows, residue "
          f"{res['count']} rows {res['share_of_busy']:.4f} of busy "
          f"({res['ms_per_step']:.3f} ms); step flops "
          f"{doc['step']['flops']}; launch calls the profiler left "
          f"unanswered {rec['unanswered_launches']}; host s "
          f"{ {k: round(v, 1) for k, v in rec['host_s'].items()} }")
    print(f"[{tag}] top rows: " + "; ".join(
        f"{f['key']} ({f['label']}) {f['ms_per_step']:.4f} ms "
        f"x{f['events'] / doc['steps']:g}" for f in doc["fusions"][:8]))
    print(f"[{tag}] residue top groups: " + "; ".join(
        f"{g['label']} {g['ms_per_step']:.4f} ms x{g['events_per_step']}"
        for g in res["groups"][:10]))
    print(f"[{tag}] hand kernels: " + "; ".join(
        f"{k} {v['events_per_step']:g}/step {v['ms_per_step']:.4f} ms, "
        f"bound {v['bound_ms_per_step']:.4f} ms, "
        f"{v['fraction_of_bound']:.3f} of bound" for k, v in kern.items()))


def phase_attribution() -> dict:
    """Phase 7a: the device-side observability on the main paths
    (``tools/profile_step.py``, ``observability/attribution.py``).

    Train: phase 7b's configuration (``train_bench``'s 7b: GPT_SMALL 16 x
    1024 bf16, flash, dots remat, fused LN, vocab chunk 1024, the flat
    AdamW sweep), 2 warm-up steps, then two captures of ``ATTR_STEPS``
    steps each; each passes :func:`_attr_kernel_gates` with 7b's launches
    a step. Serve: phase 4b's engine configuration (paged, page 16, 8
    slots resident, GPT_SMALL bf16), ``ATTR_TICKS`` ticks captured: the
    tick's events exactly fused_ln 2L, decode_paged L, logits_head 1.
    Seeded regression: the train step again with ``remat="full"`` (one
    step captured), diffed by ``tools/perf_diff.py`` against a baseline
    made from the first capture: the diff fails, a ``config_lever`` cause names remat,
    ``attribution.step.flops`` is out of band. Printed, not gated: the
    A/A diff of the two plain captures, each kernel's fraction of its
    bound, the gap share, the top residue groups. Returns {"launches":
    the captures' hand-kernel launches, "kernels": {kernel: per-step
    numbers}, "serve": the tick's}."""
    import os
    import shutil

    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.observability import attribution as ATT
    from paddle_tpu_torch.tools import perf_diff
    from paddle_tpu_torch.tools import profile_step as PS

    t0 = time.perf_counter()
    root = os.path.join(_trace_dir(), "attribution")
    shutil.rmtree(root, ignore_errors=True)
    L = GPT_SMALL.num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "opt_adamw_flat": 1, "fused_ln": 4 * L + 1,
            "fused_ln_bwd": 2 * L + 1, "ce_fwd": 8}
    launches: dict = {}

    def count(rec):
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v

    recs = PS.train_profile(None, os.path.join(root, "train"),
                            steps=ATTR_STEPS, runs=2)
    kern = {}
    for i, rec in enumerate(recs):
        kern = _attr_kernel_gates(f"attribution-train {i}", rec, want)
        count(rec)
    _attr_print("attribution-train", recs[0], kern)
    t_train = time.perf_counter()
    dots = recs[0]["attribution"]
    full = PS.train_profile(None, os.path.join(root, "train_full"),
                            steps=1, remat="full")
    count(full)
    ATT.validate(full["attribution"], require_residue=True)
    # the sentinel through its CLI: a baseline from the dots capture, the
    # A/A diff (printed) and the seeded remat regression (gated)
    run_dir = os.path.join(root, "sentinel")
    os.makedirs(run_dir, exist_ok=True)
    for name, doc in (("A.json", dots), ("B.json", recs[1]["attribution"]),
                      ("FULL.json", full["attribution"])):
        ATT.write(doc, os.path.join(run_dir, name))
    base = os.path.join(run_dir, "PERF_BASELINE.json")
    if perf_diff.main(["--dir", run_dir, "--attribution",
                       os.path.join(run_dir, "A.json"), "--baseline", base,
                       "--update-baseline", "--lane", "gpu"]) != 0:
        raise AssertionError("perf_diff --update-baseline failed")
    rc_aa = perf_diff.main(["--dir", run_dir, "--baseline", base,
                            "--attribution",
                            os.path.join(run_dir, "B.json"), "--out",
                            os.path.join(run_dir, "AA.json")])
    with open(os.path.join(run_dir, "AA.json")) as f:
        aa = json.load(f)
    print(f"[attribution-sentinel] A/A: rc {rc_aa}, "
          f"{len(aa['out_of_band'])} out of band "
          f"{[b['metric'] for b in aa['out_of_band']][:6]} (not gated: "
          "timing bands on two short captures)")
    rc = perf_diff.main(["--dir", run_dir, "--baseline", base,
                         "--attribution", os.path.join(run_dir, "FULL.json"),
                         "--out", os.path.join(run_dir, "REMAT.json")])
    with open(os.path.join(run_dir, "REMAT.json")) as f:
        rep = json.load(f)
    oob = {b["metric"]: b for b in rep["out_of_band"]}
    lever = [b for b in rep["out_of_band"] + rep["structural_failures"]
             if b["cause"]["kind"] == "config_lever"
             and "remat" in b["cause"]["detail"]]
    if rc != 1 or rep["ok"] or not lever \
            or "attribution.step.flops" not in oob:
        raise AssertionError(f"seeded remat regression: rc {rc}, ok "
                             f"{rep['ok']}, lever causes {len(lever)}, "
                             f"out of band {sorted(oob)}")
    print(f"[attribution-sentinel] the remat-full capture (1 step): host s "
          f"{ {k: round(v, 1) for k, v in full['host_s'].items()} }")
    print(f"[attribution-sentinel] remat dots -> full: rc {rc}, step "
          f"flops {oob['attribution.step.flops']['baseline']:.6g} -> "
          f"{oob['attribution.step.flops']['value']:.6g}, cause "
          f"{oob['attribution.step.flops']['cause']['detail']!r}; "
          f"{len(rep['out_of_band'])} out of band")
    del recs, full
    torch.cuda.empty_cache()
    t_sentinel = time.perf_counter()
    # serve: phase 4b's engine configuration, 8 slots resident
    eng, feed = PS.serve_engine("cuda", "paged", "bf16", 8, True)
    PS.decode_tick(eng, feed)
    srec = PS.profile_ticks(eng, feed, os.path.join(root, "serve"),
                            ATTR_TICKS, {"mode": "decode",
                                         "kv_layout": "paged"},
                            "serve:4b", {})
    count(srec)
    skern = _attr_kernel_gates(
        "attribution-serve", srec,
        {"fused_ln": 2 * L, "decode_paged": L, "logits_head": 1})
    _attr_print("attribution-serve", srec, skern)
    del eng
    torch.cuda.empty_cache()
    print(f"[attribution] phase {time.perf_counter() - t0:.1f} s (train "
          f"{t_train - t0:.1f}, sentinel {t_sentinel - t_train:.1f}, serve "
          f"{time.perf_counter() - t_sentinel:.1f})")
    out = {"launches": launches, "kernels": kern, "serve": skern}
    print(json.dumps({"attribution": {"train": kern, "serve": skern}}))
    return out


def bookkeeping_cost(work: str, n: int = 20000) -> dict:
    """The observability's own host µs, apart from any step: one flight
    fingerprint stamp (``record_collective``'s per-call cost of the
    recorder) with the ring alone, with a sidecar attached (one flushed
    line an event) and with the recorder off, over ``n`` stamps; and one
    ``train_bench.monitored_steps`` step around a step that only returns
    its (card-resident) loss and grad norm: the row, its file line, two
    flight events with the sidecar, the goodput timers and the two
    copies to the host; and a decode tick's spans (one ``serve/decode_tick``
    record a rider, 8 riders) without a sink."""
    import os

    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.observability import spans as obs_spans
    from paddle_tpu_torch.observability.monitor import TrainMonitor
    from paddle_tpu_torch.tools import train_bench

    def per_stamp():
        t0 = time.perf_counter()
        for _ in range(n):
            flight.stamp_collective("psum_scatter", "bfloat16", 1 << 24, 2)
        return (time.perf_counter() - t0) / n * 1e6

    tracer = obs_spans.SpanTracer()
    t0 = time.perf_counter()
    for i in range(n // B):
        for slot in range(B):
            tracer.record("serve/decode_tick", i, 5000000, trace=slot,
                          parent=slot, attrs={"batch": B, "emitted": 1,
                                              "token_index": i})
    rec = flight.default_recorder()
    out = {"tick_spans_us": (time.perf_counter() - t0) / (n // B) * 1e6,
           "ring_us": per_stamp()}
    rec.set_sink(os.path.join(work, "stamp_cost_flight.jsonl"))
    try:
        out["sidecar_us"] = per_stamp()
    finally:
        rec.set_sink(None)
    flight.set_flight_enabled(False)
    try:
        out["off_us"] = per_stamp()
    finally:
        flight.set_flight_enabled(True)
    flight.reset()
    fixed = (None, None, torch.tensor(3.0, device="cuda"),
             torch.tensor(1.0, device="cuda", dtype=torch.bfloat16))
    mon = TrainMonitor(path=os.path.join(work, "cost_rows.jsonl"),
                       peak_flops=1.0)
    rec.set_sink(os.path.join(work, "cost_flight.jsonl"))
    try:
        steps = 2000
        t0 = time.perf_counter()
        train_bench.monitored_steps(lambda: fixed, mon, steps)
        out["monitor_step_us"] = (time.perf_counter() - t0) / steps * 1e6
        t0 = time.perf_counter()
        for _ in range(steps):
            float(fixed[2])
            float(fixed[3])
        out["bare_sync_us"] = (time.perf_counter() - t0) / steps * 1e6
    finally:
        rec.set_sink(None)
        mon.close()
        flight.reset()
    return out


def phase_train_monitor() -> dict:
    """Phase 7m: phase 7's run again with ``train_bench --monitor``: one
    ``TrainMonitor`` row a timed step (each step then syncs on its loss),
    launches a step as phase 7's. Every row has the ``STEP_RECORD_KEYS``
    with finite values, the rows' MFU is train_bench's own within 10%, the
    timed window's goodput is mostly ``productive_step``; then the
    observability's cost on the step, on against off in turns
    (``train_bench.observability_overhead``: printed, not gated). Returns
    the record."""
    import os

    from paddle_tpu_torch.observability.monitor import STEP_RECORD_KEYS
    from paddle_tpu_torch.tools import train_bench

    cfg = train_bench.bench_config()
    work = _trace_dir()
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "monitor.jsonl")
    if os.path.exists(path):
        os.remove(path)
    rec = train_bench.run(cfg, monitor=path, overhead_dir=work)
    with open(path) as f:
        rows = [json.loads(ln) for ln in f]
    if len(rows) != rec["steps"] or rec["monitor"]["rows"] != rec["steps"]:
        raise AssertionError(f"{len(rows)} monitor rows for "
                             f"{rec['steps']} timed steps")
    for r in rows:
        bad = [k for k in STEP_RECORD_KEYS
               if k not in r or not (isinstance(r[k], bool)
                                     or np.isfinite(r[k]))]
        if bad or r["nan_inf"] or "peak_hbm_bytes" not in r:
            raise AssertionError(f"monitor row {r.get('step')}: {bad}")
    row_mfu = float(np.mean([r["mfu"] for r in rows]))
    if abs(row_mfu - rec["mfu"]) > 0.10 * rec["mfu"]:
        raise AssertionError(f"monitor MFU {row_mfu:.4f} vs train_bench's "
                             f"{rec['mfu']:.4f}")
    gp = rec["monitor"]["goodput"]
    share = gp["categories"]["productive_step"] / gp["wall_s"]
    if share <= 0.5:
        raise AssertionError(f"goodput: productive_step {share:.3f} of the "
                             f"timed window {gp['categories']}")
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "opt_adamw_flat": 1}
    if rec["launches_per_step"] != want:
        raise AssertionError(f"monitored launches per step "
                             f"{rec['launches_per_step']} != {want}")
    ov = rec["obs_overhead"]
    stamp = bookkeeping_cost(work)
    ov["bookkeeping_us"] = stamp
    # ERNIE-base tp 2's collective calls a step, as phase 13's wire gate
    # counts them: the loss's psum, one a replicated leaf, 4L + 1
    # all-gathers and as many sum-scatters
    from paddle_tpu_torch.models import ernie as E
    from paddle_tpu_torch.parallel import parallelize as PZ

    calls = 1 + sum("tp" not in sp for sp in PZ.flat_leaves(
        E.param_specs(E.ERNIE_BASE))) + 2 * (4 * E.ERNIE_BASE.num_layers + 1)
    print(f"[train-monitor] flight stamp host us: ring "
          f"{stamp['ring_us']:.2f}, with the sidecar "
          f"{stamp['sidecar_us']:.2f}, recorder off {stamp['off_us']:.3f}; "
          f"at ~{calls} stamps a step (ERNIE tp2) "
          f"{calls * stamp['sidecar_us'] / 1e3:.3f} ms a step with the "
          f"sidecar; a monitored step's own cost "
          f"{stamp['monitor_step_us']:.1f} us against "
          f"{stamp['bare_sync_us']:.1f} for the bare syncs; a decode tick's "
          f"8 spans {stamp['tick_spans_us']:.1f} us (printed, not gated)")
    print(f"[train-monitor] {len(rows)} rows; step ms "
          f"{[r['step_time_ms'] for r in rows]}; dispatch ms p50 "
          f"{np.median([r['host_dispatch_ms'] for r in rows]):.3f}, device "
          f"wait ms p50 {np.median([r['device_wait_ms'] for r in rows]):.3f}"
          f"; row MFU {row_mfu:.4f} vs train_bench {rec['mfu']:.4f} "
          f"({rec['ms_per_step']:.3f} ms/step synced each step); peak "
          f"{rows[-1]['peak_hbm_bytes']} bytes")
    print(f"[train-monitor] goodput of the timed window: productive_step "
          f"{share:.4f} of {gp['wall_s']:.3f} s; " + json.dumps(
              {k: v for k, v in gp["categories"].items() if v}))
    print(f"[train-monitor] step ms with the observability on "
          f"{[round(x, 3) for x in ov['on_ms']]}, off "
          f"{[round(x, 3) for x in ov['off_ms']]}: " + _overhead_text(ov))
    return rec


def phase_train_parity():
    """Kernel train step vs plain train step, float32, on the card: the
    flash arm, and the fused arm (flash, the fused-layernorm block and the
    vocab-chunked CE in row chunks of 256, so two row chunks run and the
    vocab pads) against every lever off."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.tools.train_bench import plain_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = G.GPT_SMALL.scaled(num_layers=2, dtype=torch.float32, remat=True,
                              remat_policy="dots")
    fused = base.scaled(use_flash=True, fused_ln=True, ce_vocab_chunk=1024,
                        ce_chunk=256)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (1, 2, 256))
                            ).cuda()
    labs = torch.from_numpy(rng.integers(0, base.vocab_size, (1, 2, 256))
                            ).cuda()
    for tag, kcfg in (("flash", base.scaled(use_flash=True)),
                      ("fused", fused)):
        arms = {"kernel": (kcfg, None), "plain": (plain_config(kcfg), False)}
        grads, losses = {}, {}
        for arm, (cfg, kern) in arms.items():
            params, opt = PZ.init_sharded(cfg, seed=2, fused_opt=True,
                                          device="cuda")
            live = [p.detach().requires_grad_()
                    for p in PZ.flat_leaves(params)]
            loss = G.loss_fn(PZ._unflatten(params, live), toks[0], labs[0],
                             cfg)
            grads[arm] = torch.autograd.grad(loss, live)
            step = PZ.make_train_step(cfg, lr=1e-4, fused_opt=True,
                                      fused_opt_kernel=kern, device="cuda")
            losses[arm] = []
            for _ in range(3):
                params, opt, loss, _g = step(params, opt, toks, labs)
                losses[arm].append(loss.item())
        worst = 0.0
        for a, b in zip(grads["kernel"], grads["plain"]):
            torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)
            worst = max(worst, (a - b).abs().max().item())
        np.testing.assert_allclose(losses["kernel"], losses["plain"],
                                   rtol=1e-5)
        print(f"[train-parity] {tag}: f32 2 layers, 3 steps of 2x256: "
              f"losses kernel {losses['kernel']} plain {losses['plain']}; "
              f"step-1 grad max diff {worst:.3g}")


ERNIE_SHAPE = (48, 512, 12, 64)     # ERNIE-base's flash call: B, T, nh, hd


def _pad_bias(BB: int, SQ: int, T: int, dev):
    """A padding bias [BB, SQ, T]: 0 at real keys, -0.5 f32 max at padded
    ones — batch row 0 pads keys 0..63 (a whole first key tile), batch
    row 1 keys 64..127 and the tail from 180; by head when BB = B·nh, the
    same for every query row when SQ = T."""
    B = 2
    pad = torch.zeros((B, T), dtype=torch.bool, device=dev)
    pad[0, :64] = True
    pad[1, 64:128] = True
    pad[1, 180:] = True
    bias = torch.where(pad, -0.5 * torch.finfo(torch.float32).max, 0.0)
    bias = bias.float()[:, None, None, :].expand(B, BB // B, SQ, T)
    return bias.reshape(BB, SQ, T).contiguous()


def _flash_case(dtype, hd, T, per_head, sq1, causal, kind, g):
    """One bias case: forward (o, lse), dQ and dK/dV of the bias form
    against their plain versions on the same inputs, float32 within 1e-5,
    bf16 per element (:func:`bf16_check`), every output finite; returns
    the max abs error. ``kind`` None: the bias-free form."""
    from paddle_tpu_torch.ops import flash_attention as FA

    B, nh = 2, 3
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn((B, T, nh, hd), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    BB, SQ = (B * nh if per_head else B), (1 if sq1 else T)
    if kind is None:
        bias = None
    elif kind == "random":
        bias = torch.randn((BB, SQ, T), generator=g, device=dev)
    else:
        bias = _pad_bias(BB, SQ, T, dev)
    tag = (f"flash {dtype} hd {hd} {'causal' if causal else 'full'}"
           if bias is None else
           f"flash bias {dtype} hd {hd} BB {'B*nh' if per_head else 'B'} "
           f"SQ {SQ} {'causal' if causal else 'full'} {kind}")

    def check(what, got, want):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{tag} {what}: non-finite values")
        if dtype == torch.bfloat16:
            return bf16_check(f"{tag} {what}", got, want)
        return _check_close(f"{tag} {what}", got, want, dtype, 1e-5)

    o, lse = FA.flash_fwd(q, k, v, causal, bias=bias)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, bias=bias)
    err = max(check("o", o, o_p),
              _check_close(f"{tag} lse", lse, lse_p, torch.float32, 1e-5))
    err = max(err, check("dq", FA.flash_bwd_dq(q, k, v, o_p, lse_p, do,
                                               causal, bias=bias),
                         FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                               causal, bias=bias)))
    for what, got, want in zip(
            ("dk", "dv"),
            FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do, causal, bias=bias),
            FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do, causal,
                                   bias=bias)):
        err = max(err, check(what, got, want))
    return err


def phase_flash_bias():
    """Phase 8: the bias forms of the three flash kernels against their
    plain versions — BB in {B, B·nh} x SQ in {1, T} x causal in {False,
    True}, float32 and bf16, head_dim 64 and 8 (padded to 16), T 200 (not
    a multiple of a tile), a random bias and a padding bias with a whole
    key tile padded: float32 within 1e-5 (o and lse also for the padded
    rows, whose lse is -0.5 f32 max), bf16 per element
    (:func:`bf16_check`), every output finite.
    Then, at ERNIE-base's call ([48, 512, 12, 64] bf16, full attention, a
    [48, 1, 1, 512] padding bias with lengths 128-512), every output of the
    three bias kernels (o, lse, dq, dk, dv) against its plain version on
    the same inputs (:func:`bf16_check`; lse float32 within 2e-5), and
    each bias kernel, the same kernel without the bias, its plain version
    and SDPA with the same float ``attn_mask`` timed (the kernels and the
    SDPA forward by CUDA-graph replay; the backward kernels beside one SDPA
    backward, which computes dq, dk and dv together); bounds from
    ``observability/hw.py``. Returns one record per bias kernel: its max
    abs error at ERNIE's shape, and over the small cases as extra keys."""
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import kernel_costs as KC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(808)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype, hd, per_head, sq1, causal, kind in itertools.product(
            (torch.float32, torch.bfloat16), (64, 8), (False, True),
            (True, False), (False, True), ("random", "padding")):
        err[dtype] = max(err[dtype], _flash_case(
            dtype, hd, 200, per_head, sq1, causal, kind, g))
        n += 1
    torch.cuda.synchronize()
    print(f"[flash-bias] {n} cases pass: max abs err f32 "
          f"{err[torch.float32]:.3g}, bf16 {err[torch.bfloat16]:.3g}")
    names = ("flash_fwd_bias", "flash_bwd_dq_bias", "flash_bwd_dkv_bias")
    recs = {k: {"small_max_abs_err": err[torch.bfloat16],
                "small_max_abs_err_f32": err[torch.float32]} for k in names}
    B, T, nh, hd = ERNIE_SHAPE
    gq = torch.Generator(device=dev)
    gq.manual_seed(809)
    qkv = torch.randn((B, T, 3, nh, hd), generator=gq, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, T, nh, hd), generator=gq, device=dev).to(
        torch.bfloat16)
    lens = np.random.default_rng(0).integers(128, T + 1, size=B)
    pad = torch.from_numpy(np.arange(T)[None, :] < lens[:, None]).to(dev)
    mask = torch.where(pad, 0.0, -0.5 * torch.finfo(torch.float32).max
                       ).float()[:, None, None, :]       # [B, 1, 1, T]
    bias = mask.reshape(B, 1, T)                          # kernel form
    tag = f"ERNIE-base {list(ERNIE_SHAPE)}"
    o, lse = FA.flash_fwd(q, k, v, False, bias=bias)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, False, bias=bias)
    recs["flash_fwd_bias"]["max_abs_err"] = max(
        bf16_check(f"flash_fwd_bias {tag} o", o, o_p),
        _check_close(f"flash_fwd_bias {tag} lse", lse, lse_p,
                     torch.float32, 2e-5))
    dq, di = FA.flash_bwd_dq(q, k, v, o_p, lse_p, do, False, bias=bias,
                             return_di=True)
    recs["flash_bwd_dq_bias"]["max_abs_err"] = bf16_check(
        f"flash_bwd_dq_bias {tag} dq", dq,
        FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, False, bias=bias))
    dkv = FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do, False, bias=bias, di=di)
    recs["flash_bwd_dkv_bias"]["max_abs_err"] = max(
        bf16_check(f"flash_bwd_dkv_bias {tag} {what}", got, want)
        for what, got, want in zip(
            ("dk", "dv"), dkv,
            FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do, False,
                                   bias=bias)))
    _bwd_bitwise("flash-bias", f"bf16 {tag}", FA, (q, k, v, o_p, lse_p, do),
                 False, bias, (dq, *dkv), di)
    del dq, dkv
    torch.cuda.empty_cache()
    esz = 2
    di0 = FA.flash_bwd_dq(q, k, v, o, lse, do, False, return_di=True)[1]
    # bytes: inputs read once, outputs written once, the [B, T] bias; dK/dV
    # reads D (from dQ) where the reference's form reads o (kernel_costs)
    for kname, fn, bare, plain in (
            ("flash_fwd_bias",
             lambda: FA.flash_fwd(q, k, v, False, bias=bias),
             lambda: FA.flash_fwd(q, k, v, False),
             lambda: FA.flash_fwd_plain(q, k, v, False, bias=bias)),
            ("flash_bwd_dq_bias",
             lambda: FA.flash_bwd_dq(q, k, v, o, lse, do, False, bias=bias),
             lambda: FA.flash_bwd_dq(q, k, v, o, lse, do, False),
             lambda: FA.flash_bwd_dq_plain(q, k, v, o, lse, do, False,
                                           bias=bias)),
            ("flash_bwd_dkv_bias",
             lambda: FA.flash_bwd_dkv(q, k, v, o, lse, do, False, bias=bias,
                                      di=di),
             lambda: FA.flash_bwd_dkv(q, k, v, o, lse, do, False, di=di0),
             lambda: FA.flash_bwd_dkv_plain(q, k, v, o, lse, do, False,
                                            bias=bias, di=di))):
        r = recs[kname]
        r["ms"] = _time_graph_ms(fn, 10)
        r["eager_ms"] = _time_ms(fn, iters=20, warmup=3)
        r["bias_free_ms"] = _time_graph_ms(bare, 10)
        r["plain_ms"] = _time_ms(plain, iters=3, warmup=1)
        r["bound_ms"], r["bound_by"] = _bound(getattr(
            KC, kname[:-len("_bias")])(B, T, nh, hd, esz, False,
                                       bias.numel()))
        r["shape"] = list(ERNIE_SHAPE)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask16 = mask.to(torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask16)
    recs["flash_fwd_bias"]["library_ms"] = _time_graph_ms(sdpa, 10)
    recs["flash_fwd_bias"]["library_eager_ms"] = _time_ms(sdpa, iters=20,
                                                          warmup=3)
    bwd_ms = _sdpa_bwd_ms(qt, kt, vt, do.transpose(1, 2), False, mask16)
    recs["flash_bwd_dq_bias"]["library_ms"] = bwd_ms
    recs["flash_bwd_dkv_bias"]["library_ms"] = bwd_ms
    pair = _pair_record(FA, (q, k, v, o, lse, do), False, bias,
                        recs["flash_bwd_dq_bias"], recs["flash_bwd_dkv_bias"],
                        bwd_ms)
    recs["flash_bwd_dq_bias"]["pair"] = pair
    recs["flash_bwd_dkv_bias"]["pair"] = pair
    for kname, r in recs.items():
        print(f"[flash-bias] {kname} bf16 {list(ERNIE_SHAPE)}: " + ", ".join(
            f"{a}={b:.6g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()))
    del qkv, q, k, v, do, o, lse, o_p, lse_p, di, di0
    torch.cuda.empty_cache()
    return recs


def phase_ernie(pad: bool = False):
    """Phase 9: ERNIE-base pretraining through ``train_bench --model
    ernie`` (batch 48 x 512, bf16, flash with the padding bias, remat
    off): every loss finite, the last below the first, and per step
    exactly L launches of each bias kernel and nothing else; returns the
    record."""
    from paddle_tpu_torch.tools import train_bench

    cfg = train_bench.ernie_config()
    rec = train_bench.run_ernie(cfg, pad=pad)
    losses = rec["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite pretraining loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    L = cfg.num_layers
    want = {"flash_fwd_bias": L, "flash_bwd_dq_bias": L,
            "flash_bwd_dkv_bias": L}
    if rec["launches_per_step"] != want:
        raise AssertionError(f"launches per step {rec['launches_per_step']}"
                             f" != {want}")
    print(f"[ernie] {rec['config']} {rec['model_params']} params: "
          f"{rec['samples_per_s']:.2f} samples/s, mfu={rec['mfu']:.4f}, "
          f"ms/step={rec['ms_per_step']:.3f}, peak GB="
          f"{rec['peak_mem_bytes'] / 1e9:.3f}, warmup_s="
          f"{rec['warmup_s']:.2f}")
    print(f"[ernie] loss first={losses[0]:.6f} last={losses[-1]:.6f} "
          f"({len(losses)} steps); launches/step {rec['launches_per_step']}")
    return rec


def phase_ernie_parity():
    """Phase 9p: a 2-layer ERNIE_BASE in float32 (TF32 off), batch 4 x 512
    with lengths drawn from 128-512 as ``train_bench --pad`` draws them: 3
    pretrain steps of each kernel arm against the plain arm (plain
    attention under the ``where`` mask, plain LN, direct CE) from the same
    seeded params — the flash arm, and the fused arm (flash, fused_ln,
    the vocab-chunked CE through ``ce_fwd``'s "vd" layout with the decoder
    bias, vocab chunk 1024). Losses within 1e-5 relative; every updated
    leaf within 1e-5 of its largest |value|."""
    from paddle_tpu_torch.models import ernie as E
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.parallel.parallelize import flat_leaves
    from paddle_tpu_torch.tools.train_bench import ernie_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = E.ERNIE_BASE.scaled(num_layers=2, dtype=torch.float32,
                               remat=False)
    data = E.batch_to_device(ernie_batch(base, 4, 512, pad=True), "cuda")
    arms = {"plain": base,
            "flash": base.scaled(use_flash=True),
            "fused": base.scaled(use_flash=True, fused_ln=True,
                                 ce_vocab_chunk=1024)}
    out = {}
    for arm, cfg in arms.items():
        params = E.init_params(cfg, seed=3, device="cuda")
        opt = E.init_opt(params)
        step = E.make_pretrain_step(cfg, lr=1e-4, device="cuda")
        CK.reset_launches()
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, data)
            losses.append(loss.item())
        out[arm] = (losses, flat_leaves(params),
                    {k: v for k, v in CK.LAUNCHES.items() if v})
    want_l, want_p, none = out["plain"]
    if none:
        raise AssertionError(f"the plain arm launched kernels: {none}")
    for arm in ("flash", "fused"):
        losses, leaves, launches = out[arm]
        np.testing.assert_allclose(losses, want_l, rtol=1e-5)
        worst = 0.0
        for a, b in zip(leaves, want_p):
            ratio = ((a - b).abs().max() / b.abs().max()).item()
            worst = max(worst, ratio)
            if not ratio <= 1e-5:
                raise AssertionError(f"ernie parity {arm}: a leaf differs "
                                     f"by {ratio:.3g} of its scale")
        print(f"[ernie-parity] {arm}: f32 2 layers, 3 steps of 4x512 "
              f"(padded): losses {losses} plain {want_l}; worst leaf "
              f"diff {worst:.3g} of its scale; launches {launches}")
    for name in ("flash_fwd_bias", "flash_bwd_dq_bias",
                 "flash_bwd_dkv_bias", "fused_ln", "fused_ln_bwd",
                 "ce_fwd"):
        if not out["fused"][2].get(name):
            raise AssertionError(f"the fused arm never launched {name}")


def _resnet50_group_size() -> int:
    """The element count of ResNet-50's one fused f32 group: its fluid
    program's trainable parameters (25,557,032)."""
    from paddle_tpu_torch.tools.train_bench import resnet_program

    main, _startup, _loss = resnet_program()
    return sum(int(np.prod(p.shape))
               for p in main.global_block().all_parameters() if p.trainable)


def _opt_inputs(kind, n, dtype, gen, dev, offset=0):
    """Flat buffers for one kind (views at ``offset`` elements into their
    allocations: offset 1 makes them unaligned, for the scalar path)."""
    def buf(scale=1.0, positive=False, dt=torch.float32):
        t = torch.randn(n + offset, generator=gen, device=dev)
        t = (t.abs() if positive else t) * scale
        return t.to(dt)[offset:]

    if kind == "sgd":
        return [buf(dt=dtype), buf(1e-2, dt=dtype)]
    if kind == "momentum":
        return [buf(), buf(1e-2), buf(1e-2)]
    return [buf(), buf(1e-2), buf(1e-3), buf(1e-5, positive=True)]


def _opt_call(kind, fn, bufs, lr, b1p, b2p, nesterov=False, coeff=0.0):
    if kind == "sgd":
        return [fn(bufs[0], bufs[1], lr)]
    if kind == "momentum":
        return list(fn(bufs[0], bufs[1], bufs[2], lr, mu=0.9,
                       nesterov=nesterov))
    return list(fn(bufs[0], bufs[1], bufs[2], bufs[3], lr, b1p, b2p,
                   b1=0.9, b2=0.999, eps=1e-8, coeff=coeff))


def phase_opt_kernels(time_it: bool):
    """Phase 10k: the sgd, momentum and adam kinds of the optimizer sweep
    against their plain versions, bitwise: at ResNet-50's group size
    (25,557,032 float32), at n 1, 7, 1001 and 4099, and unaligned (views
    one element in); sgd in float32 and bf16, momentum with Nesterov off
    and on, adam with coeff 0 and 0.01 (AdamW). Then, at ResNet-50's size
    in float32, each kernel, its plain version and the PyTorch library
    call (``torch._fused_sgd_`` with momentum 0 / 0.9, dampening 0: the
    same functions; ``torch._fused_adam_`` / ``_fused_adamw_``, which put
    eps inside the bias correction: not the same function, timed anyway)
    are timed with CUDA events over back-to-back calls (each call is one
    or a few kernels of 0.1 ms or more, well above the host's enqueue).
    Returns one record a kernel name."""
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.ops import kernel_costs as KC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    lr = torch.tensor(0.01, device=dev)
    b1p = torch.tensor(0.9 ** 3, device=dev)
    b2p = torch.tensor(0.999 ** 3, device=dev)
    variants = {"opt_sgd": [("sgd", torch.float32, {}),
                            ("sgd", torch.bfloat16, {})],
                "opt_momentum": [("momentum", torch.float32,
                                  {"nesterov": False}),
                                 ("momentum", torch.float32,
                                  {"nesterov": True})],
                "opt_adam": [("adam", torch.float32, {"coeff": 0.0})],
                "opt_adamw": [("adam", torch.float32, {"coeff": 0.01})]}
    plain = {"sgd": CK.megakernel_sgd_plain,
             "momentum": CK.megakernel_momentum_plain,
             "adam": CK.megakernel_adam_plain}
    kern = {"sgd": CK.megakernel_sgd, "momentum": CK.megakernel_momentum,
            "adam": CK.megakernel_adam}
    n_resnet = _resnet50_group_size()
    cases = 0
    for name, vs in variants.items():
        for kind, dtype, kw in vs:
            for n, offset in ((n_resnet, 0), (1, 0), (7, 0),
                              (1001, 0), (4099, 0), (4099, 1)):
                bufs = _opt_inputs(kind, n, dtype, gen, dev, offset)
                outs = []
                for fn in (kern[kind], plain[kind]):
                    # fresh copies at the same offset (g is only read)
                    mine = [b if i == 1 else torch.empty(
                        n + offset, dtype=b.dtype, device=dev)[offset:]
                        .copy_(b) for i, b in enumerate(bufs)]
                    outs.append(_opt_call(kind, fn, mine, lr, b1p, b2p, **kw))
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(*outs)):
                    if not torch.equal(a, b):
                        bad = int((a != b).sum())
                        raise AssertionError(
                            f"{name} {dtype} n={n} offset={offset} {kw}: "
                            f"output {i} differs from the plain version in "
                            f"{bad} elements")
                cases += 1
    print(f"[opt-kernels] {cases} cases bitwise against the plain versions "
          f"(n up to {n_resnet:,}; float32 and bf16 sgd; Nesterov; AdamW)")
    recs = {name: {"max_abs_err": 0.0} for name in variants}
    if not time_it:
        return recs
    n = n_resnet
    step = torch.tensor(3.0, device=dev)
    for name, (kind, dtype, kw) in (
            ("opt_sgd", variants["opt_sgd"][0]),
            ("opt_momentum", variants["opt_momentum"][0]),
            ("opt_adam", variants["opt_adam"][0]),
            ("opt_adamw", variants["opt_adamw"][0])):
        bufs = _opt_inputs(kind, n, dtype, gen, dev)
        rec = recs[name]
        rec["ms"] = _time_ms(lambda: _opt_call(
            kind, kern[kind], bufs, lr, b1p, b2p, **kw), iters=20, warmup=3)
        rec["plain_ms"] = _time_ms(lambda: _opt_call(
            kind, plain[kind], bufs, lr, b1p, b2p, **kw), iters=10, warmup=2)
        p, g = bufs[0], bufs[1]
        if kind == "sgd":
            lib = (lambda: torch._fused_sgd_(
                [p], [g], [], weight_decay=0.0, momentum=0.0, lr=0.01,
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False))
            rec["library_call"] = "torch._fused_sgd_ momentum 0 (same function)"
            cost = KC.opt_sgd(n, p.element_size())
        elif kind == "momentum":
            vel = bufs[2]
            lib = (lambda: torch._fused_sgd_(
                [p], [g], [vel], weight_decay=0.0, momentum=0.9, lr=0.01,
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False))
            rec["library_call"] = ("torch._fused_sgd_ momentum 0.9, dampening "
                                   "0 (same function)")
            cost = KC.opt_momentum(n)
        else:
            m, v = bufs[2], bufs[3]
            fused = torch._fused_adamw_ if kw["coeff"] else torch._fused_adam_
            lib = (lambda: fused(
                [p], [g], [m], [v], [], [step], lr=0.01, beta1=0.9,
                beta2=0.999, weight_decay=kw["coeff"], eps=1e-8,
                amsgrad=False, maximize=False))
            rec["library_call"] = (
                f"torch.{fused.__name__} (eps inside the bias correction: "
                "not the same function)")
            cost = KC.opt_adam(n, bool(kw["coeff"]))
        rec["library_ms"] = _time_ms(lib, iters=20, warmup=3)
        rec["bound_ms"], rec["bound_by"] = _bound(cost)
        rec["n"] = n
        print(f"[opt-kernels] {name} n={n}: {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})")
    return recs


FLUID_OPTS = ("sgd", "momentum", "adam", "adamw")
FLUID_KERNEL = {"sgd": "opt_sgd", "momentum": "opt_momentum",
                "adam": "opt_adam", "adamw": "opt_adamw"}


def _fluid_program(kind: str):
    """(main, startup, loss, feed) of a fluid training case on the card:
    the MLP of ``tests/test_pallas_fused.py`` under each fused optimizer,
    or ResNet-18 at 32², batch 4, class 4 with Momentum(0.01, 0.9,
    fuse=True) (``kind`` "resnet18")."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.tools.train_bench import resnet_program

    rng = np.random.default_rng(0)
    with unique_name.guard():
        if kind == "resnet18":
            main, startup, loss = resnet_program(batch=4, hw=32, classes=4,
                                                 depth=18, synthetic=False)
            feed = {"img": rng.standard_normal((4, 3, 32, 32)).astype(
                np.float32), "label": rng.integers(0, 4, (4, 1))}
            return main, startup, loss, feed
        main, startup = T.Program(), T.Program()
        main.random_seed = startup.random_seed = 7
        with T.program_guard(main, startup):
            x = T.layers.data(name="x", shape=[8], dtype="float32")
            h = T.layers.fc(x, size=16, act="relu")
            y = T.layers.fc(h, size=1)
            label = T.layers.data(name="y", shape=[1], dtype="float32")
            loss = T.layers.reduce_mean(T.layers.square(y - label))
            opt = {"sgd": lambda: T.optimizer.SGD(0.05, fuse=True),
                   "momentum": lambda: T.optimizer.Momentum(0.05, 0.9,
                                                            fuse=True),
                   "adam": lambda: T.optimizer.Adam(0.01, fuse=True),
                   "adamw": lambda: T.optimizer.AdamW(
                       0.01, weight_decay=0.1, fuse=True)}[kind]
            opt().minimize(loss)
    feed = {"x": rng.standard_normal((4, 8)).astype(np.float32),
            "y": rng.standard_normal((4, 1)).astype(np.float32)}
    return main, startup, loss, feed


def phase_fluid_parity():
    """Phase 10p: the fluid MLP under each fused optimizer (5 steps) and
    ResNet-18 at 32² (3 steps) train on the card through the kernel route
    and through ``FLAGS_fuse_optimizer_pallas=False`` (the unfused
    expression) from the same scope: float32 (TF32 off, cuDNN
    deterministic), losses and every persistable bitwise. The kernel
    route's launch counts are zeroed just before its steps and read just
    after: one launch of the optimizer's kernel a step, none on the other
    route. Returns the kernel route's launches."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.ops import cuda_kernels as CK

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    try:
        for kind in FLUID_OPTS + ("resnet18",):
            main, startup, loss, feed = _fluid_program(kind)
            steps = 3 if kind == "resnet18" else 5
            kname = FLUID_KERNEL.get(kind, "opt_momentum")
            exe = T.Executor(T.CUDAPlace(0))
            scope0 = T.Scope()
            exe.run(startup, scope=scope0)
            names = [n for n, v in main.global_block().vars.items()
                     if v.persistable]
            out = {}
            for route, flag in (("kernel", None), ("plain", False)):
                T.set_flags({"FLAGS_fuse_optimizer_pallas": flag})
                scope = T.Scope()
                for n in names:
                    scope.set_var(n, scope0.find_var(n).clone())
                CK.reset_launches()
                losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0])
                          for _ in range(steps)]
                counts = {k: v for k, v in CK.LAUNCHES.items() if v}
                out[route] = (losses, scope, counts)
            T.set_flags({"FLAGS_fuse_optimizer_pallas": None})
            (kl, ks, kc), (pl_, ps, pc) = out["kernel"], out["plain"]
            if kc != {kname: steps} or pc:
                raise AssertionError(f"fluid {kind}: launches kernel route "
                                     f"{kc}, plain route {pc}")
            if kl != pl_ or not all(np.isfinite(kl)):
                raise AssertionError(f"fluid {kind}: losses kernel {kl} "
                                     f"plain {pl_}")
            for n in names:
                if not torch.equal(ks.find_var(n), ps.find_var(n)):
                    raise AssertionError(f"fluid {kind}: {n} differs "
                                         "between the routes")
            launches[kname] = launches.get(kname, 0) + kc[kname]
            print(f"[fluid-parity] {kind}: {steps} steps f32, kernel route "
                  f"== plain route bitwise ({len(names)} persistables); "
                  f"losses {kl}; launches {kc}")
    finally:
        T.set_flags({"FLAGS_fuse_optimizer_pallas": None})
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return launches


def phase_resnet50():
    """Phase 10: ResNet-50 (batch 128, 224², class 1000, float32) trains
    through the fluid surface — ``Program`` → ``Momentum(0.01, 0.9,
    fuse=True).minimize`` → ``Executor(CUDAPlace(0)).run`` — via
    ``train_bench --model resnet50``: 6 steps on one fixed fed batch, whose
    loss must fall; then the synthetic-data lane, 1 warm-up + 10 timed
    steps (counts zeroed just before them): every loss finite and exactly
    one ``opt_momentum`` launch a step; then the same for the ``--no-fuse``
    arm (one ``momentum`` op a parameter, no kernel launch). Returns the
    fused arm's record."""
    from paddle_tpu_torch.tools import train_bench

    fixed = train_bench.resnet_fixed_batch(steps=6)
    if not all(np.isfinite(fixed)) or not fixed[-1] < fixed[0]:
        raise AssertionError(f"ResNet-50 fixed-batch losses {fixed}")
    print(f"[resnet50] fixed batch of 128: losses {fixed}")
    recs = {}
    for fuse in (True, False):
        rec = train_bench.run_resnet(fuse=fuse)
        if not all(np.isfinite(rec["losses"])):
            raise AssertionError(f"non-finite ResNet-50 loss: "
                                 f"{rec['losses']}")
        want = {"opt_momentum": 1} if fuse else {}
        if rec["launches_per_step"] != want:
            raise AssertionError(f"launches per step "
                                 f"{rec['launches_per_step']} != {want}")
        print(f"[resnet50] {rec['config']} {rec['model_params']} params: "
              f"{rec['images_per_s']:.2f} img/s, ms/step="
              f"{rec['ms_per_step']:.3f}, mfu={rec['mfu']:.4f} (bf16 peak), "
              f"peak GB={rec['peak_mem_bytes'] / 1e9:.3f}, warmup_s="
              f"{rec['warmup_s']:.2f}, tf32 cudnn={rec['tf32_cudnn']}; "
              f"loss first={rec['loss_first']:.4f} last="
              f"{rec['loss_last']:.4f}; launches/step "
              f"{rec['launches_per_step']}")
        recs[fuse] = rec
    return recs[True]


# phase 11: gangs of ranks (name, ranks, backend), each running its
# layouts (tag, train_bench --layout spec) in turn
TRAIN_PARALLEL = (
    ("two", 2, "gloo", (
        ("dp2", "dp=2,layers=6"),
        ("dp2-rs", "dp=2,grad_reduce=reduce_scatter,comm_dtype=bf16,"
                   "layers=6"),
        ("tp2", "tp=2,layers=3"),
        ("pp2", "pp=2,microbatches=4,layers=6"))),
    ("eight", 8, "gloo", (
        ("3d", "dp=2,pp=2,tp=2,microbatches=2,layers=2"),)),
    ("nccl1", 1, "nccl", (("nccl1", ""),)),
)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _parallel_shapes() -> dict:
    """The per-rank shapes phase 11's gloo layouts give the kernels:
    flash (batch, heads), LN rows, the CE call's rows and the dp-2
    reduce-scatter shard's length, each set sorted."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.tools import train_bench as TB

    cfg = TB.bench_config(fused_ln=True, ce_vchunk=1024)
    flash, rows, ce, sweep = set(), set(), set(), set()
    for _gang, _n, backend, layouts in TRAIN_PARALLEL:
        if backend != "gloo":
            continue
        for _tag, spec in layouts:
            lay = TB.layout_dict(spec)
            dp, tp, M = lay["dp"], lay["tp"], lay["microbatches"]
            mb = TB.BATCH // M // dp
            flash.add((mb, GPT_SMALL.num_heads // tp))
            rows.add(mb * TB.SEQ // tp)
            ce.add(min(cfg.ce_chunk, mb * TB.SEQ // tp))
            if lay["grad_reduce"] == "reduce_scatter":
                pcfg = PZ.ParallelConfig(dp=dp, pp=lay["pp"], tp=tp,
                                         microbatches=M)
                layout, _ = PZ.rs_param_layout(
                    cfg.scaled(num_layers=lay["layers"] or cfg.num_layers),
                    pcfg, comm_dtype=lay["comm_dtype"])
                sweep.add(layout.shard_len)
    return {k: sorted(v) for k, v in (("flash", flash), ("rows", rows),
                                      ("ce", ce), ("sweep", sweep))}


def phase_parallel_kernels() -> dict:
    """Phase 11k (see the module docstring): each kernel of phase 11's
    path at the gloo layouts' per-rank shapes against its plain version;
    returns {kernel: largest |kernel - plain|}."""
    from paddle_tpu_torch.models.gpt import GPT_SMALL
    from paddle_tpu_torch.ops import chunked_ce as CE
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import fused_ln as FL
    from paddle_tpu_torch.tools import train_bench as TB

    shapes = _parallel_shapes()
    print(f"[parallel-kernels] per-rank shapes: {shapes}")
    dev = torch.device("cuda")
    dt = torch.bfloat16
    hd, D, V = GPT_SMALL.head_dim, GPT_SMALL.d_model, GPT_SMALL.vocab_size
    g = torch.Generator(device=dev)
    g.manual_seed(1114)

    def randn(*shape, d=dt, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(d)

    def f32(what, got, want):
        return _check_close(what, got, want, torch.float32, 2e-5)

    err = {}

    def keep(name, e):
        err[name] = max(err.get(name, 0.0), e)

    for Bm, nh in shapes["flash"]:
        tag = f"[{Bm}, {TB.SEQ}, {nh}, {hd}]"
        qkv = randn(Bm, TB.SEQ, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = randn(Bm, TB.SEQ, nh, hd)
        o, lse = FA.flash_fwd(q, k, v)
        o_p, lse_p = FA.flash_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        keep("flash_fwd", max(bf16_check(f"flash_fwd o {tag}", o, o_p),
                              f32(f"flash_fwd lse {tag}", lse, lse_p)))
        dq, di = FA.flash_bwd_dq(q, k, v, o_p, lse_p, do, return_di=True)
        dq_p, di_p = FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                           return_di=True)
        torch.cuda.synchronize()
        keep("flash_bwd_dq", bf16_check(f"flash_bwd_dq {tag}", dq, dq_p))
        f32(f"flash_bwd_dq D {tag}", di, di_p)
        dk, dv = FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do, di=di)
        dk_p, dv_p = FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do)
        torch.cuda.synchronize()
        keep("flash_bwd_dkv", max(
            bf16_check(f"flash_bwd_dkv dk {tag}", dk, dk_p),
            bf16_check(f"flash_bwd_dkv dv {tag}", dv, dv_p)))
        del qkv, q, k, v, do, o, lse, o_p, lse_p, dq, di, dq_p, di_p
        del dk, dv, dk_p, dv_p
    for R in shapes["rows"]:
        x, res, dy, dsx = randn(R, D), randn(R, D), randn(R, D), randn(R, D)
        badd = randn(D, s=0.1)
        scale = 1.0 + randn(D, d=torch.float32, s=0.1)
        bias = randn(D, d=torch.float32, s=0.1)
        for form, kw in (("ln2", dict(residual=res, bias_add=badd)),
                         ("plain", {})):
            got = FL.fused_ln_fwd(x, scale, bias, eps=1e-5, **kw)
            want = FL.fused_ln_fwd_plain(x, scale, bias, eps=1e-5, **kw)
            torch.cuda.synchronize()
            if form == "ln2" and not torch.equal(got[1], want[1]):
                raise AssertionError(f"fused_ln ln2 [{R}, {D}]: s differs")
            keep("fused_ln", bf16_check(f"fused_ln {form} y [{R}, {D}]",
                                        got[0], want[0]))
            for i, stat in ((2, "mu"), (3, "rstd")):
                _check_close(f"fused_ln {form} {stat} [{R}, {D}]", got[i],
                             want[i], torch.float32, 1e-5)
            if form == "ln2":
                s_, mu, rstd = want[1], want[2], want[3]
        xhat = (s_.float() - mu[:, None]) * rstd[:, None]
        sums = ((dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0))
        for form, kw in (("dsx", dict(dsx=dsx)), ("plain", {})):
            got = FL.fused_ln_bwd(s_, mu, rstd, scale, dy, **kw)
            want = FL.fused_ln_bwd_plain(s_, mu, rstd, scale, dy, **kw)
            torch.cuda.synchronize()
            keep("fused_ln_bwd", bf16_check(
                f"fused_ln_bwd {form} ds [{R}, {D}]", got[0], want[0]))
            for i, what, tot in ((2, "dscale", sums[0]),
                                 (3, "dbias", sums[1])):
                diff = (got[i] - want[i]).abs()
                ratio = (diff / (2.0 ** -18 * tot + 1e-30)).max().item()
                if not ratio <= 1.0:
                    raise AssertionError(f"fused_ln_bwd {form} {what} "
                                         f"[{R}, {D}]: worst diff/bound "
                                         f"{ratio:.4g}")
                keep("fused_ln_bwd", diff.max().item())
    for n in shapes["ce"]:
        vc = 1024
        vp = -(-V // vc) * vc
        ins = _ce_inputs(dt, n, D, vp, V, "dv", False, 0, 1114 + n)
        want = CE.ce_fwd_plain(*ins, vc, V, "dv")
        got = CE.ce_fwd(*ins, vc, V, "dv")
        torch.cuda.synchronize()
        keep("ce_fwd", _ce_close(f"ce_fwd [{n}, {D}] x [{D}, {vp}]", got,
                                 want))
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (1e-4, 0.7, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    for n in shapes["sweep"]:
        for mdt in (torch.bfloat16, torch.float32):
            _sweep_bitwise(f"{mdt} dp shard n {n}",
                           _sweep_inputs(n, mdt, 0, n), sc, hp)
            torch.cuda.empty_cache()
        keep("opt_adamw_flat", 0.0)
    print("[parallel-kernels] every kernel at every per-rank shape within "
          "its tolerance: " + ", ".join(f"{k}={v:.4g}"
                                        for k, v in err.items()))
    torch.cuda.empty_cache()
    return err


def _parallel_want(cfg, lay, coords, batch, T):
    """(launches a step, wire bytes a step by "op/dtype") that one rank of
    a phase-11 layout must show, from the layout alone."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import comm_opt as C
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel import parallelize as PZ

    dp, pp, tp, M = lay["dp"], lay["pp"], lay["tp"], lay["microbatches"]
    rs = lay["grad_reduce"] == "reduce_scatter"
    wire_dt = C.normalize_comm_dtype(lay["comm_dtype"])
    pcfg = PZ.ParallelConfig(dp=dp, pp=pp, tp=tp, microbatches=M)
    sizes = {"dp": dp, "pp": pp, "tp": tp}
    Ll, last = cfg.num_layers // pp, coords["pp"] == pp - 1
    mb, Ts = batch // M // dp, T // tp
    launches = {"flash_fwd": 2 * Ll * M, "flash_bwd_dq": Ll * M,
                "flash_bwd_dkv": Ll * M,
                "fused_ln": 4 * Ll * M + (M if last else 0),
                "fused_ln_bwd": 2 * Ll * M + (M if last else 0)}
    if last:
        launches["ce_fwd"] = M * -(-mb * Ts // cfg.ce_chunk)
    if rs or pcfg.n_devices == 1:
        launches["opt_adamw_flat"] = 1
    wire = {}

    def add(op, dtype, payload, ranks):
        b = C.wire_bytes(op, payload, ranks)
        if b:
            wire[f"{op}/{dtype}"] = wire.get(f"{op}/{dtype}", 0) + b

    add("psum", "float32", 4, pcfg.n_devices)          # the loss
    for shape, spec in zip(PZ.flat_leaves(G.param_shapes(cfg)),
                           PZ.flat_specs(cfg, pcfg)):
        used = mesh_mod.spec_axes(spec)
        n = int(np.prod(mesh_mod.local_shape(shape, spec, sizes)))
        ranks = int(np.prod([sizes[a] for a in sizes if a not in used
                             and not (rs and a == "dp")]))
        add("psum", "float32", 4 * n, ranks)
    if rs:
        layout, _ = PZ.rs_param_layout(cfg, pcfg, comm_dtype=wire_dt)
        for b in layout.buckets:
            if wire_dt == "bf16":
                add("all_to_all", "bfloat16", 2 * b.size, dp)
            else:
                add("psum_scatter", "float32", 4 * b.size, dp)
            add("all_gather", "float32", 4 * b.size, dp)
    # tp's sequence collectives of [mb, T, D] bf16, a layer a microbatch:
    # 2 all-gathers and 2 sum-scatters forward, their transposes backward,
    # and under remat the recompute's 2 all-gathers and first sum-scatter
    # (the checkpoint stops recomputing at the last tensor it saved)
    seq = mb * T * cfg.d_model * 2
    for _ in range(Ll * M):
        for _ in range(4 + 2 * cfg.remat):
            add("all_gather", "bfloat16", seq, tp)
        for _ in range(4 + cfg.remat):
            add("psum_scatter", "bfloat16", seq, tp)
    act = M * mb * Ts * cfg.d_model * 2                # bf16 activations
    for sends in (coords["pp"] < pp - 1, coords["pp"] > 0):
        if sends:
            add("ppermute", "bfloat16", act, pp)
    return launches, wire


def _check_parallel_rank(tag, rec, cfg, lay):
    """11p, the losses, the launches and the wire bytes of one rank's
    record; returns the launches of its timed steps."""
    from paddle_tpu_torch.tools import train_bench as TB

    par, losses = rec["parity"], rec["losses"]
    if not TB.parity_ok(par):
        raise AssertionError(f"11p {tag} rank {rec['rank']}: {par}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{tag} rank {rec['rank']} losses {losses}")
    want_l, want_w = _parallel_want(
        cfg.scaled(num_layers=lay["layers"] or cfg.num_layers), lay,
        rec["coords"], TB.BATCH, TB.SEQ)
    if rec["launches_per_step"] != want_l:
        raise AssertionError(f"{tag} rank {rec['rank']} launches "
                             f"{rec['launches_per_step']} != {want_l}")
    if rec["wire_bytes_per_step"] != want_w:
        raise AssertionError(f"{tag} rank {rec['rank']} wire bytes "
                             f"{rec['wire_bytes_per_step']} != {want_w}")
    return {k: round(v * rec["steps"])
            for k, v in rec["launches_per_step"].items()}


def phase_train_parallel(timeout_s: float = 600.0) -> dict:
    """Phase 11 and 11p (see the module docstring); returns each kernel's
    launches summed over every rank's timed steps."""
    import os
    import shutil
    import signal

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.tools import train_bench as TB

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(str(_build.BUILD_DIR), "train_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    cfg = TB.bench_config(fused_ln=True, ce_vchunk=1024)
    launches: dict = {}
    for gang, n, backend, layouts in TRAIN_PARALLEL:
        out = os.path.join(work, gang)
        cmd = [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
               "--nproc_per_node", str(n), "--backend", backend,
               "--started_port", str(_free_port()), "--grace_period",
               "10", "-m", "paddle_tpu_torch.tools.train_bench",
               "--fused-ln", "--ce-vchunk", "1024", "--steps", "3",
               "--warmup", "1", "--out-dir", out, "--parity"]
        for tag, spec in layouts:
            if tag == "dp2":
                # one more step traced a rank: the collectives' overlap
                spec += f",overlap_dir={os.path.join(work, 'overlap')}"
            cmd += ["--layout", spec]
        if backend == "gloo":
            cmd += ["--device", "cuda:0"]        # every rank on the card
        where = ("ranks share one card over gloo" if backend == "gloo"
                 else "one rank, NCCL world of one")
        t0 = time.time()
        # its own session: a gang that outlives the timeout is killed whole
        proc = subprocess.Popen(cmd, cwd=root, start_new_session=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            log, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
        if proc.returncode != 0:
            print(log[-6000:])
            raise RuntimeError(f"train-parallel gang {gang}: launch exited "
                               f"{proc.returncode}")
        print(f"[train-parallel] gang {gang}: {n} rank(s), {backend}, "
              f"launch wall {time.time() - t0:.1f} s ({where})")
        for i, (tag, spec) in enumerate(layouts):
            lay = TB.layout_dict(spec)
            recs = []
            for r in range(n):
                with open(os.path.join(out, f"layout{i}.rank{r}.json")) as f:
                    recs.append(json.load(f))
            for rec in recs:
                for k, v in _check_parallel_rank(tag, rec, cfg, lay).items():
                    launches[k] = launches.get(k, 0) + v
            st = recs[0]["stamps"]
            print(f"[train-parallel] {tag} ({where}): {recs[0]['config']}: "
                  f"ms/step {max(r['ms_per_step'] for r in recs):.3f}, "
                  f"tokens/s {min(r['tokens_per_s'] for r in recs):.1f} "
                  f"({min(r['tokens_per_s_per_rank'] for r in recs):.1f} a "
                  f"rank); rank 0 s after launch: init "
                  f"{st['init'] - t0:.1f}, mesh {st['mesh'] - t0:.1f}, "
                  f"11p {st['parity'] - t0:.1f}, warm-up "
                  f"{st['warmup'] - t0:.1f}, timed {st['timed'] - t0:.1f}")
            for rec in recs:
                if rec.get("overlap") is not None:
                    print(f"[train-parallel] {tag} rank {rec['rank']}: "
                          "comm_opt.measure_overlap_fraction over one "
                          f"traced step: {rec['overlap']} (not gated)")
                par = dict(rec["parity"])
                leaf = par.pop("leaf_update_rel_err")
                worst = max(leaf, key=leaf.get)
                par["worst_leaf_update_rel_err"] = (worst, leaf[worst])
                print(f"[train-parallel] {tag} rank {rec['rank']} "
                      f"{rec['coords']}: ms/step {rec['ms_per_step']:.3f}, "
                      f"wire bytes/step {rec['wire_bytes_per_step']}, "
                      f"staged ms/step {rec['staged_ms_per_step']}, losses "
                      f"{[round(x, 5) for x in rec['losses']]}, 11p "
                      f"{par}, peak GB "
                      f"{rec['peak_mem_bytes'] / 1e9:.2f} ({where})")
    shutil.rmtree(work, ignore_errors=True)
    print(f"[train-parallel] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 12: the fault bench's card subset, in the order it runs
ELASTIC_SCENARIOS = ("baseline", "aa", "sigkill_midstep", "sigterm_preempt",
                     "corrupt_shard", "hang", "sigstop_blame", "dp_reshard")


def start_elastic() -> dict:
    """Start phase 12's ``fault_bench`` in a session of its own, in the
    background, its log into a file (nothing reads a pipe meanwhile);
    ``finish_elastic`` waits for it and checks its record."""
    import os
    import shutil

    from paddle_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(str(_build.BUILD_DIR), "elastic")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    run = {"work": work, "out": os.path.join(work, "fault_bench.json"),
           "log": os.path.join(work, "fault_bench.log"),
           "t0": time.perf_counter()}
    with open(run["log"], "w") as log:
        run["proc"] = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.tools.fault_bench",
             "--device", "cuda", "--out", run["out"]], cwd=root,
            start_new_session=True, stdout=log, stderr=subprocess.STDOUT)
    return run


def stop_elastic(run: dict) -> None:
    """Kill a started phase 12's process group if it still runs (the
    script failed elsewhere, or its time is up)."""
    import os
    import signal

    if run["proc"].poll() is None:
        try:
            os.killpg(run["proc"].pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        run["proc"].wait()


def phase_elastic(timeout_s: float = 600.0) -> dict:
    """Phase 12 alone (see the module docstring)."""
    return finish_elastic(start_elastic(), timeout_s)


def finish_elastic(run: dict, timeout_s: float = 600.0) -> dict:
    """Phase 12 (see the module docstring): wait for the started
    ``fault_bench``, at most ``timeout_s`` from its start, and check its
    record; returns each kernel's launches summed over the completed
    incarnations (rank 0's)."""
    import os
    import shutil

    from paddle_tpu_torch.tools import fault_bench as FB
    from paddle_tpu_torch.tools import train_bench as TB

    proc, work, out = run["proc"], run["work"], run["out"]
    try:
        proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter()
                                                 - run["t0"])))
    except subprocess.TimeoutExpired:
        stop_elastic(run)
    wall = time.perf_counter() - run["t0"]
    with open(run["log"]) as f:
        log = f.read()
    if not os.path.exists(out):
        print(log[-8000:])
        raise RuntimeError(f"elastic: fault_bench exited {proc.returncode} "
                           "without a record")
    with open(out) as f:
        rec = json.load(f)
    sc = rec["scenarios"]
    for name in ELASTIC_SCENARIOS:
        s = sc.get(name, {"pass": False})
        show = {k: s.get(k) for k in (
            "rc", "rc_preempted", "rc_resumed", "match_baseline",
            "params_match", "restored_from", "expected_restore",
            "restarts", "detection_s", "last_progress_age_s", "deadline_s",
            "reshard", "save", "restore_ms", "restore",
            "recovery", "startup", "step_s", "loss_rel_diff_by_step",
            "exits", "gang_goodput_fraction", "goodput_downtime_s",
            "history_downtime_s", "flight_dumps", "blamed_ranks",
            "blame_mode", "missed_seq", "missed_name", "seq_gaps_total",
            "paddle_blamed_rank", "step_skew_ms", "hang_restarts")
            if s.get(k) is not None}
        print(f"[elastic] {name}: pass={s['pass']} {json.dumps(show)}")
    if proc.returncode != 0 or not rec["pass"] or \
            set(sc) != set(ELASTIC_SCENARIOS):
        print(log[-8000:])
        raise AssertionError("elastic: "
                             + ", ".join(n for n in ELASTIC_SCENARIOS
                                         if not sc.get(n, {}).get("pass"))
                             + " failed")
    gp = sc["sigkill_midstep"]["goodput"]
    print("[elastic] sigkill_midstep GOODPUT.json: " + json.dumps(
        {k: gp[k] for k in ("nranks", "rank_reports", "wall_s",
                            "restart_downtime_s", "gang_goodput_fraction",
                            "unaccounted_fraction", "categories")}))
    # the workers of every gang (sigstop_blame's SIGSTOPped rank too) are
    # gone with the harness: no process is left in its process group
    try:
        os.killpg(proc.pid, 0)
    except ProcessLookupError:
        pass
    else:
        raise AssertionError("elastic: a process of the harness's gangs "
                             "outlived it")
    print("[elastic] no process of the gangs is left; compute apps on the "
          "card: " + " ".join(subprocess.run(
              ["nvidia-smi", "--query-compute-apps=pid,used_memory",
               "--format=csv,noheader"], capture_output=True,
              text=True).stdout.split()))
    cfg = TB.bench_config(fused_ln=True, ce_vchunk=1024).scaled(
        num_layers=FB.CUDA_LAYERS)
    for inc in rec["incarnations"]:
        lay = TB.layout_dict(f"dp={inc['dp']},grad_reduce=reduce_scatter")
        want, _ = _parallel_want(cfg, lay, {"dp": 0, "pp": 0, "tp": 0},
                                 TB.BATCH, TB.SEQ)
        want = {k: v * inc["steps"] for k, v in want.items()}
        if inc["launches"] != want:
            raise AssertionError(f"elastic {inc['scenario']} (dp "
                                 f"{inc['dp']}, {inc['steps']} steps): "
                                 f"launches {inc['launches']} != {want}")
    print(f"[elastic] {len(rec['incarnations'])} completed incarnations, "
          f"launches exact; launches {rec['launches']}; fault_bench "
          f"{rec['elapsed_s']} s, phase wall {wall:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return rec["launches"]


RING_SHAPE = (16, 1024, 12, 64)     # GPT_SMALL's attention, [B, T, nh, hd]


def _ring_inputs(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(1215)
    return [torch.randn(RING_SHAPE, generator=g, device=dev)
            for _ in range(4)]


def _ring_rank(rank, world, store, out_dir):
    """One rank of 12r: its sequence chunk through ``ring_attention`` and
    the chunks' gradients of sum(out · w), saved for the parent."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.parallel import env
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(world)})
    dev = env.init_distributed_env(backend="gloo", device="cuda:0",
                                   timeout_s=300, init_method=store)
    tl = RING_SHAPE[1] // world
    q, k, v, w = (t[:, rank * tl:(rank + 1) * tl].contiguous()
                  for t in _ring_inputs(dev))
    for t in (q, k, v):
        t.requires_grad_()
    t0 = time.perf_counter()
    o = ring_attention(q, k, v, causal=True)
    (o * w).sum().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    torch.save({"o": o.detach().cpu(), "grads": [t.grad.cpu()
                                                 for t in (q, k, v)],
                "ms": ms}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_ring(world: int = 2) -> dict:
    """Phase 12r (see the module docstring): the largest |ring - plain| of
    the output and of the gradients."""
    import os
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="ring_")
    store = "file://" + os.path.join(work, "store")
    t0 = time.perf_counter()
    mp.start_processes(_ring_rank, args=(world, store, work), nprocs=world,
                       join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
             for r in range(world)]
    shutil.rmtree(work, ignore_errors=True)
    dev = torch.device("cuda")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, w = _ring_inputs(dev)
    for t in (q, k, v):
        t.requires_grad_()
    T = RING_SHAPE[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / RING_SHAPE[3] ** 0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool,
                                  device=dev).tril(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    (o * w).sum().backward()
    torch.backends.cuda.matmul.allow_tf32 = allow

    def worst(got, want, tol):
        got = got.to(dev)
        ratio = ((got - want).abs() / (tol + tol * want.abs())).max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"ring: |ring - plain| over {tol} + "
                                 f"{tol}·|plain| by {ratio:.3g}x")
        return (got - want).abs().max().item()

    err = worst(torch.cat([r["o"] for r in ranks], 1), o.detach(), 1e-5)
    gerr = max(worst(torch.cat([r["grads"][i] for r in ranks], 1),
                     t.grad, 1e-4) for i, t in enumerate((q, k, v)))
    rec = {"max_abs_err": err, "grad_max_abs_err": gerr,
           "rank_ms": [round(r["ms"], 3) for r in ranks], "wall_s": wall}
    print(f"[ring] cp {world} over gloo on one card at {list(RING_SHAPE)} "
          f"causal f32: max |ring - plain| out {err:.3g} (1e-5), grads "
          f"{gerr:.3g} (1e-4); forward + backward ms a rank "
          f"{rec['rank_ms']}; wall {wall:.1f} s")
    del q, k, v, w, s, o
    torch.cuda.empty_cache()
    return rec


# phase 13: the sharded training path's gangs of two gloo ranks sharing
# the card (name, flags, layouts (tag, --layout spec) run in turn): (a) GPT
# fsdp at dp 2 with 7b's levers, its state saved, then the same step
# under the dp plan (its peak memory beside fsdp's); (b) ERNIE-base at tp 2
TRAIN_SHARDED = (
    ("gpt", ["--fused-ln", "--ce-vchunk", "1024", "--parity"],
     (("fsdp2", "sharding=fsdp,dp=2,layers=6,ckpt_dir={ckpt}"),
      ("dp2", "sharding=dp,dp=2,layers=6"))),
    ("ernie", ["--model", "ernie", "--fused-ln", "--parity"],
     (("ernie-tp2", "tp=2,layers=6"),)),
)
ERNIE_TP = 2                       # (b)'s tp: flash at nh / tp heads a rank


def phase_sharded_kernels() -> dict:
    """Phase 13k: the kernels at the per-rank shapes phase 13 gives them
    that no earlier phase checks, each against its plain version (bf16):
    the flash bias forms (forward, dQ with its D, dK/dV fed that D) at
    ERNIE-base tp 2's [48, 512, 6, 64] with the padding bias
    [48, 1, 1, 512], and the fused-LN pair in ERNIE's post-LN form
    (residual, eps 1e-12; the backward without dsx) on a tp-2 rank's
    48·512/2 rows. GPT fsdp at dp 2 runs phase 11k's dp-2 shapes. Returns
    {kernel: largest |kernel - plain|}."""
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import fused_ln as FL

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1316)
    B, T, nh, hd = ERNIE_SHAPE
    nh //= ERNIE_TP
    tag = f"[{B}, {T}, {nh}, {hd}]"
    qkv = torch.randn((B, T, 3, nh, hd), generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, T, nh, hd), generator=g, device=dev).to(
        torch.bfloat16)
    lens = np.random.default_rng(13).integers(128, T + 1, size=B)
    pad = torch.from_numpy(np.arange(T)[None, :] < lens[:, None]).to(dev)
    bias = torch.where(pad, 0.0, -0.5 * torch.finfo(torch.float32).max
                       ).float().reshape(B, 1, T)
    err = {}
    o, lse = FA.flash_fwd(q, k, v, False, bias=bias)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, False, bias=bias)
    torch.cuda.synchronize()
    err["flash_fwd_bias"] = max(
        bf16_check(f"flash_fwd_bias {tag} o", o, o_p),
        _check_close(f"flash_fwd_bias {tag} lse", lse, lse_p,
                     torch.float32, 2e-5))
    dq, di = FA.flash_bwd_dq(q, k, v, o_p, lse_p, do, False, bias=bias,
                             return_di=True)
    dq_p, di_p = FA.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, False,
                                       bias=bias, return_di=True)
    torch.cuda.synchronize()
    err["flash_bwd_dq_bias"] = bf16_check(f"flash_bwd_dq_bias {tag} dq", dq,
                                          dq_p)
    _check_close(f"flash_bwd_dq_bias {tag} D", di, di_p, torch.float32, 2e-5)
    dkv = FA.flash_bwd_dkv(q, k, v, o_p, lse_p, do, False, bias=bias, di=di)
    dkv_p = FA.flash_bwd_dkv_plain(q, k, v, o_p, lse_p, do, False, bias=bias)
    torch.cuda.synchronize()
    err["flash_bwd_dkv_bias"] = max(
        bf16_check(f"flash_bwd_dkv_bias {tag} {w}", a, b)
        for w, a, b in zip(("dk", "dv"), dkv, dkv_p))
    del qkv, q, k, v, do, o, lse, o_p, lse_p, dq, di, dq_p, di_p, dkv, dkv_p
    R, D = B * T // ERNIE_TP, ERNIE_SHAPE[2] * hd

    def randn(*shape, d=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(d)

    x, res, dy = randn(R, D), randn(R, D), randn(R, D)
    scale = 1.0 + randn(D, d=torch.float32, s=0.1)
    lnb = randn(D, d=torch.float32, s=0.1)
    got = FL.fused_ln_fwd(x, scale, lnb, residual=res, eps=1e-12)
    want = FL.fused_ln_fwd_plain(x, scale, lnb, residual=res, eps=1e-12)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"fused_ln post-LN [{R}, {D}]: s differs")
    err["fused_ln"] = bf16_check(f"fused_ln post-LN y [{R}, {D}]", got[0],
                                 want[0])
    for i, stat in ((2, "mu"), (3, "rstd")):
        _check_close(f"fused_ln post-LN {stat} [{R}, {D}]", got[i], want[i],
                     torch.float32, 1e-5)
    s_, mu, rstd = want[1], want[2], want[3]
    gb = FL.fused_ln_bwd(s_, mu, rstd, scale, dy)
    wb = FL.fused_ln_bwd_plain(s_, mu, rstd, scale, dy)
    torch.cuda.synchronize()
    err["fused_ln_bwd"] = bf16_check(f"fused_ln_bwd ds [{R}, {D}]", gb[0],
                                     wb[0])
    xhat = (s_.float() - mu[:, None]) * rstd[:, None]
    for i, what, tot in ((2, "dscale", (dy.float() * xhat).abs().sum(0)),
                         (3, "dbias", dy.float().abs().sum(0))):
        diff = (gb[i] - wb[i]).abs()
        ratio = (diff / (2.0 ** -18 * tot + 1e-30)).max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"fused_ln_bwd {what} [{R}, {D}]: worst "
                                 f"diff/bound {ratio:.4g}")
        err["fused_ln_bwd"] = max(err["fused_ln_bwd"], diff.max().item())
    print("[sharded-kernels] every kernel at phase 13's new per-rank shapes "
          "within its tolerance: " + ", ".join(f"{k}={v:.4g}"
                                               for k, v in err.items()))
    del x, res, dy, got, want, gb, wb, xhat
    torch.cuda.empty_cache()
    return err


def _plan_want(cfg, T, mode):
    """(launches a step, wire bytes a step by "op/dtype", param bytes,
    moment bytes, plan) of one rank of (a): GPT at dp 2 under the
    ``mode`` plan, bf16 moments."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import comm_opt as C
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.sharding import make_gpt_plan
    from paddle_tpu_torch.tools import train_bench as TB

    dp, L = 2, cfg.num_layers
    rows = TB.BATCH // dp * T
    launches = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "fused_ln": 4 * L + 1, "fused_ln_bwd": 2 * L + 1,
                "ce_fwd": -(-rows // cfg.ce_chunk)}
    plan = make_gpt_plan(cfg, PZ.ParallelConfig(dp=dp), mode)
    wire, n_local = {}, 0

    def add(op, payload):
        b = C.wire_bytes(op, payload, dp)
        wire[f"{op}/float32"] = wire.get(f"{op}/float32", 0) + b

    add("psum", 4)                                       # the loss
    for shape, spec in zip(PZ.flat_leaves(G.param_shapes(cfg)),
                           PZ.flat_leaves(plan.param_specs)):
        nbytes = 4 * int(np.prod(shape))
        n_local += int(np.prod(mesh_mod.local_shape(shape, spec,
                                                    {"dp": dp, "pp": 1,
                                                     "tp": 1})))
        if "dp" in spec:
            add("all_gather", nbytes)
            add("psum_scatter", nbytes)
        else:
            add("psum", nbytes)
    return launches, wire, 4 * n_local, 2 * 2 * n_local, plan


def _ernie_want(cfg):
    """(launches a step, wire bytes a step) of one rank of (b): ERNIE-base
    at tp 2, flash with the padding bias, fused LN, remat off: the loss's
    psum, one of every leaf the tp split replicates, and the sequence
    collectives of [48, 512, 768] bf16 — 2 all-gathers and 2
    sum-scatters a layer forward, their transposes backward, and the
    encoder's last all-gather and its transpose."""
    from paddle_tpu_torch.models import ernie as E
    from paddle_tpu_torch.parallel import comm_opt as C
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.tools import train_bench as TB

    L = cfg.num_layers
    launches = {"flash_fwd_bias": L, "flash_bwd_dq_bias": L,
                "flash_bwd_dkv_bias": L, "fused_ln": 2 * L,
                "fused_ln_bwd": 2 * L}
    wire = C.wire_bytes("psum", 4, ERNIE_TP)
    for shape, spec in zip(PZ.flat_leaves(E.param_shapes(cfg)),
                           PZ.flat_leaves(E.param_specs(cfg))):
        if "tp" not in spec:
            wire += C.wire_bytes("psum", 4 * int(np.prod(shape)), ERNIE_TP)
    seq = (4 * L + 1) * C.wire_bytes(
        "all_gather", TB.ERNIE_BATCH * TB.ERNIE_SEQ * cfg.d_model * 2,
        ERNIE_TP)
    return launches, {"psum/float32": wire, "all_gather/bfloat16": seq,
                      "psum_scatter/bfloat16": seq}


def _gang(tag, args, n_layouts, work, timeout_s):
    """One phase-13 gang: two ranks of ``train_bench``'s parallel lane
    sharing the card over gloo under ``parallel.launch``; returns, a
    layout each, the two ranks' records, and the launch wall seconds."""
    import os
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(work, tag)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
           "--nproc_per_node", "2", "--backend", "gloo", "--started_port",
           str(_free_port()), "--grace_period", "10", "-m",
           "paddle_tpu_torch.tools.train_bench", "--steps", "3",
           "--warmup", "1", "--device", "cuda:0", "--out-dir", out] + args
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=root, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        log, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    if proc.returncode != 0:
        print(log[-6000:])
        raise RuntimeError(f"train-sharded {tag}: launch exited "
                           f"{proc.returncode}")
    recs = []
    for i in range(n_layouts):
        recs.append([])
        for r in range(2):
            with open(os.path.join(out, f"layout{i}.rank{r}.json")) as f:
                recs[i].append(json.load(f))
    return recs, time.time() - t0


def _print_rank(tag, rec, extra=""):
    par = dict(rec["parity"])
    leaf = par.pop("leaf_update_rel_err")
    worst = max(leaf, key=leaf.get)
    par["worst_leaf_update_rel_err"] = (worst, leaf[worst])
    rate = (f"tokens/s {rec['tokens_per_s']:.1f}" if "samples_per_s" not in
            rec else f"samples/s {rec['samples_per_s']:.2f}")
    print(f"[train-sharded] {tag} rank {rec['rank']} {rec['coords']}: "
          f"{rec['config']}: ms/step {rec['ms_per_step']:.3f}, {rate}, "
          f"param bytes {rec['param_bytes']}, moment bytes "
          f"{rec['moment_bytes']}, wire bytes/step "
          f"{rec['wire_bytes_per_step']}, staged ms/step "
          f"{rec['staged_ms_per_step']}, peak GB "
          f"{rec['peak_mem_bytes'] / 1e9:.2f}, losses "
          f"{[round(x, 5) for x in rec['losses']]}, 13p {par}{extra} "
          "(ranks share one card over gloo)")


def _restore_dp1(work, cfg, plan, recs) -> dict:
    """13c: (a)'s dp-2 save restored whole at dp 1 on the card, in this
    process: every rank's saved local leaf (params and each moment) must
    have the crc32 of its block of the restored leaf. Returns the
    restore ms and the params' crc32."""
    import os
    import zlib

    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import checkpoint as C
    from paddle_tpu_torch.parallel import parallelize as PZ

    def abstract(tree, dtype):
        return {k: abstract(v, dtype) if isinstance(v, dict) else
                C.AbstractLeaf(tuple(v), dtype, device="cuda")
                for k, v in tree.items()}

    shapes = G.param_shapes(cfg)
    mdt = getattr(torch, recs[0]["ckpt"]["dtypes"]["['opt']['m']['wte']"])
    target = {"params": abstract(shapes, torch.float32),
              "opt": {"m": abstract(shapes, mdt), "v": abstract(shapes, mdt),
                      "step": C.AbstractLeaf((), torch.int32,
                                             device="cuda")}}
    ck = C.ShardedCheckpointer(os.path.join(work, "ckpt"), use_async=False)
    step = recs[0]["ckpt"]["step"]
    if ck.all_steps() != [step]:
        raise AssertionError(f"13c: committed steps {ck.all_steps()}, "
                             f"saved {step}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ck.restore(step, target)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    spec_of = dict(C.flatten_with_keys(
        {"params": plan.param_specs, "opt": {"m": plan.param_specs,
                                             "v": plan.param_specs}},
        is_leaf=lambda x: isinstance(x, tuple)))

    def crc(t):
        return zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8)
                          .cpu().numpy().tobytes())

    full = dict(C.flatten_with_keys(got))
    sizes = {"dp": 2, "pp": 1, "tp": 1}
    for rec in recs:
        coords = rec["coords"]
        for key, want in rec["ckpt"]["crc32"].items():
            t = full[key]
            spec = spec_of.get(key, ())
            for d, e in enumerate(spec):
                if e is not None and sizes[e] > 1:
                    n = t.shape[d] // sizes[e]
                    t = t.narrow(d, coords[e] * n, n)
            if crc(t) != want:
                raise AssertionError(f"13c: rank {rec['rank']} {key}: crc32 "
                                     "of the restore != the save's")
    params_crc = 0
    for t in PZ.flat_leaves(got["params"]):
        params_crc = zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8)
                                .cpu().numpy().tobytes(), params_crc)
    nbytes = sum(t.numel() * t.element_size() for t in full.values())
    del got, full
    torch.cuda.empty_cache()
    return {"restore_ms": restore_ms, "params_crc32": params_crc,
            "bytes": nbytes}


def phase_train_sharded(timeout_s: float = 600.0) -> dict:
    """Phases 13, 13p and 13c (see the module docstring); returns each
    kernel's launches summed over both gangs' ranks' timed steps."""
    import os
    import shutil

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.tools import train_bench as TB

    work = os.path.join(str(_build.BUILD_DIR), "train_sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_phase = time.perf_counter()
    launches: dict = {}
    peaks = {}
    for gang, flags, layouts in TRAIN_SHARDED:
        for tag, spec in layouts:
            flags = flags + ["--layout", spec.format(
                ckpt=os.path.join(work, "ckpt"))]
        by_layout, wall = _gang(gang, flags, len(layouts), work, timeout_s)
        print(f"[train-sharded] gang {gang}: launch wall {wall:.1f} s")
        for (tag, spec), recs in zip(layouts, by_layout):
            _check_sharded(tag, recs, work, launches, peaks,
                           TB.layout_dict(spec)["layers"])
    print(f"[train-sharded] peak GB a rank, the same step and batch: "
          f"fsdp2 {peaks['fsdp2'] / 1e9:.3f}, dp2 {peaks['dp2'] / 1e9:.3f} "
          "(fsdp gathers every sharded leaf once a step, up front)")
    shutil.rmtree(work, ignore_errors=True)
    print(f"[train-sharded] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def _check_sharded(tag, recs, work, launches, peaks, layers: int):
    """13 and 13p on the two ranks' records of one layout (``layers`` its
    depth; 0 the model's own), and 13c after fsdp2's; adds the timed
    steps' launches to ``launches`` and the layout's peak to ``peaks``."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.tools import train_bench as TB

    peaks[tag] = max(r["peak_mem_bytes"] for r in recs)
    if tag != "ernie-tp2":
        cfg = TB.bench_config(fused_ln=True, ce_vchunk=1024)
        cfg = cfg.scaled(num_layers=layers or cfg.num_layers)
        want_l, want_w, p_bytes, m_bytes, plan = _plan_want(
            cfg, TB.SEQ, tag[:-1])
        ok = TB.parity_ok
    else:
        cfg = TB.ernie_config(fused_ln=True)
        cfg = cfg.scaled(num_layers=layers or cfg.num_layers)
        want_l, want_w = _ernie_want(cfg)
        p_bytes = m_bytes = None
        ok = TB.ernie_parity_ok
    for rec in recs:
        if not ok(rec["parity"]):
            raise AssertionError(f"13p {tag} rank {rec['rank']}: "
                                 f"{rec['parity']}")
        losses = rec["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{tag} rank {rec['rank']} losses "
                                 f"{losses}")
        if rec["launches_per_step"] != want_l:
            raise AssertionError(f"{tag} rank {rec['rank']} launches "
                                 f"{rec['launches_per_step']} != "
                                 f"{want_l}")
        if rec["wire_bytes_per_step"] != want_w:
            raise AssertionError(f"{tag} rank {rec['rank']} wire bytes "
                                 f"{rec['wire_bytes_per_step']} != "
                                 f"{want_w}")
        if p_bytes is not None and (rec["param_bytes"], rec[
                "moment_bytes"]) != (p_bytes, m_bytes):
            raise AssertionError(
                f"{tag} rank {rec['rank']} resident bytes "
                f"{rec['param_bytes']} / {rec['moment_bytes']} != the "
                f"plan's {p_bytes} / {m_bytes}")
        for k, v in rec["launches_per_step"].items():
            launches[k] = launches.get(k, 0) + round(v * rec["steps"])
        extra = ""
        if "ckpt" in rec:
            extra = (f", 13c save ms {rec['ckpt']['save_ms']:.1f}, wait "
                     f"ms {rec['ckpt']['wait_ms']:.1f}")
        _print_rank(tag, rec, extra)
    print(f"[train-sharded] {tag}: launches a step exact {want_l}, wire "
          f"bytes a step exact")
    if tag == "fsdp2":
        full = 4 * sum(int(np.prod(s)) for s in PZ.flat_leaves(
            G.param_shapes(cfg)))
        print(f"[train-sharded] fsdp2: a rank holds {p_bytes} param "
              f"bytes and {m_bytes} moment bytes (bf16 m + v) of the "
              f"full tree's {full} f32 param bytes")
        rc = _restore_dp1(work, cfg, plan, recs)
        print(f"[train-sharded] 13c: the dp-2 save restored at dp 1: "
              f"every rank's params and moment leaves' crc32 = the "
              f"save's; params crc32 {rc['params_crc32']}, "
              f"{rc['bytes']} bytes, restore ms "
              f"{rc['restore_ms']:.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from paddle_tpu_torch.ops import cuda_kernels as CK

    # each stretch's wall seconds, printed before the kernels line
    walls, t_lap = {}, [t_start]

    def lap(name):
        now = time.perf_counter()
        walls[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    smi = phase_device()
    phase_build()
    lap("1-2 device, build")
    recs = phase_kernels(torch.bfloat16, time_it=True)
    f32 = phase_kernels(torch.float32, time_it=True)
    widths = {str(dt): phase_widths(dt)
              for dt in (torch.bfloat16, torch.float32)}
    wide = {**wide_flash_timing(), **wide_decode_timing()}
    lap("3, 3w kernels, widths")
    # each kernel's launches summed over the serving paths (slab, paged,
    # speculative, int8); each path printed and asserted its own counts
    launches, alone, eng4, reqs4 = phase_serving()
    # the front door over phase 4's engine (4m), then the tick's host cost
    # with tracing on and off
    for k, v in phase_front_door(eng4, reqs4).items():
        launches[k] += v
    tick_overhead = phase_tick_overhead(eng4)
    del eng4, reqs4
    lap("4, 4m serving, front door")
    paged_launches, paged = phase_serving_paged()
    for path in (lambda: paged_launches, lambda: phase_serving_spec(alone),
                 phase_serving_int8, lambda: phase_serving_disagg(paged),
                 lambda: phase_serve_gang(paged)):
        for k, v in path().items():
            launches[k] += v
    lap("4b, 4s, 4q, 4d, 4g paths")
    phase_parity()
    phase_spec_parity()
    phase_disagg_parity()
    lap("5, 5s, 5d parity")
    # tensor-parallel serving, two ranks sharing the card: the tick's
    # kernels at a rank's shapes (4tk), phase 4b's traffic (4t, every
    # rank's launches into the kernels line), tp2 against tp1 (5t)
    tp_err, tp_launches = phase_tp(paged)
    for k, v in tp_launches.items():
        launches[k] += v
    lap("4tk, 4t, 5t tp")
    decode_ln = recs["fused_ln"]
    recs.update(phase_train_kernels(torch.bfloat16, time_it=True))
    # the decode tick's plain form [8, 768] beside the training shapes
    recs["fused_ln"]["decode"] = decode_ln
    phase_train_kernels(torch.float32, time_it=False)
    # each kernel's launches summed over the main paths' runs: serving
    # (above), training (phase 7), the same monitored (7m, the
    # observability's cost on the step beside it) and the fused-LN /
    # vocab-chunked lane (7b)
    train_obs = None
    for run in (lambda: phase_training(False), phase_train_monitor,
                lambda: phase_training(True)):
        train = run()
        train_obs = train.get("obs_overhead", train_obs)
        for k, v in train["launches_per_step"].items():
            launches[k] = launches.get(k, 0) + round(v * train["steps"])
    phase_train_parity()
    lap("6, 7, 7m, 7b training")
    # the roofline attribution of 7b's step and 4b's tick (7a)
    for k, v in phase_attribution()["launches"].items():
        launches[k] = launches.get(k, 0) + v
    lap("7a attribution")
    recs.update(phase_flash_bias())
    # ERNIE-base pretraining (phase 9), then with padded lengths (9b):
    # each zeroes the counts just before its timed steps
    for pad in (False, True):
        ernie = phase_ernie(pad)
        for k, v in ernie["launches_per_step"].items():
            launches[k] = launches.get(k, 0) + round(v * ernie["steps"])
    phase_ernie_parity()
    lap("8, 9, 9b, 9p ERNIE")
    # the fluid path: the optimizer kinds (10k), the fused routes against
    # the unfused ones on the MLP and ResNet-18 (10p: the sgd / adam /
    # adamw kernels' main path), ResNet-50 (10: opt_momentum's)
    recs.update(phase_opt_kernels(time_it=True))
    for k, v in phase_fluid_parity().items():
        launches[k] = launches.get(k, 0) + v
    resnet = phase_resnet50()
    for k, v in resnet["launches_per_step"].items():
        launches[k] = launches.get(k, 0) + round(v * resnet["steps"])
    lap("10k, 10p, 10 fluid")
    # fault-tolerant training (phase 12) runs in the background beside the
    # gangs of phases 11, 12r and 13 (its counts zeroed in each worker
    # just before its steps); it is checked after phase 13
    elastic = start_elastic()
    try:
        # GPT training over ranks: the kernels at the ranks' shapes (11k),
        # then every rank's timed steps (phase 11)
        for k, v in phase_parallel_kernels().items():
            recs[k]["parallel_max_abs_err"] = v
        for k, v in phase_train_parallel().items():
            launches[k] = launches.get(k, 0) + v
        phase_ring()            # ring attention (12r, no kernel)
        # sharded training (phase 13): the kernels at its new per-rank
        # shapes (13k), then the fsdp and ERNIE tp gangs' timed steps
        for k, v in phase_sharded_kernels().items():
            recs[k]["sharded_max_abs_err"] = v
        for k, v in phase_train_sharded().items():
            launches[k] = launches.get(k, 0) + v
        lap("11k, 11, 12r, 13k, 13 (12 beside them)")
        for k, v in finish_elastic(elastic).items():
            launches[k] = launches.get(k, 0) + v
        lap("12 elastic, after 13")
    finally:
        stop_elastic(elastic)
    kernels = []
    for name, meta in CK.KERNELS.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        # the rest as measured: ce_fwd's cuBLAS floor (matmul_ms), the
        # decode kernels' gather + SDPA yardstick, length sweep and f32 run
        kernels[-1].update({k: v for k, v in r.items()
                            if k not in kernels[-1]})
        if name in ("decode_slab", "decode_paged"):
            kernels[-1]["f32"] = {k: v for k, v in f32[name].items()
                                  if k != "sweep"}
        if name in tp_err:
            kernels[-1]["tp_max_abs_err"] = tp_err[name]
    print(f"[chip_smoke] wall {time.perf_counter() - t_start:.1f} s, the "
          "build included")
    print(json.dumps({"wall_s": walls}))
    print(json.dumps({"widths_max_abs_err": widths, "wide_hd256": wide}))
    print(json.dumps({"observability_overhead": {
        "decode_tick_host_ms": tick_overhead,
        "train_step_ms": train_obs}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
