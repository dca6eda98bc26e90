#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build:  compile the port's CUDA sources (flash_attention.cu, fused.cu)
   with nvcc for sm_90a, one nvcc per source, all started together.
2. kernels: hold each kernel against its plain PyTorch version on the
   card. The flash kernels (forward, dq, dk/dv and the single-pass
   backward, the latter also against dq + dk/dv) at the main path's shape
   in bf16 and on small cases that reach the edges of both designs (bf16
   and fp16 at head_dim 64 and 128, S = 129, 255 and 300, a window across a
   128-row tile and across dq's 64-row kv tiles, kv lengths with an empty
   row, one and four query heads a kv head, kv longer or shorter than q,
   non-causal, head_dim 96 on the wmma design, fp32 at a tight tolerance,
   bert_base's shape: B 4, S 512, 12 heads of 64, non-causal, lengths
   512/300/129/0, bf16 and fp16, and NaN rows on both designs, causal and
   not: an all-NaN query row and rows with one NaN score must give NaN,
   a fully masked row zeros, with every output's NaN mask equal to the plain
   version's exactly), each case's launches of all four counted
   by design (``kernel_design``'s
   answer at the launch, first held against the C launcher's own rule);
   where dk/dv and the single pass both take the wgmma design, dk/dv's dk
   and dv must equal the single pass's bit for bit, and dq and dk/dv,
   launched again into outputs filled with NaN, must give the same bits; the fused prologue at
   the main shape and on cases that reach the edges of both designs (D 64
   in 64-, 128-, 192- and 256-column tiles, D 128 in 128- and 256-column
   tiles, with and without a bias, rows that fill no 128-row tile or end
   past a tile edge, E = 320 and 64, fp16; D 96 and fp32 on the wmma
   design), each counted by design (first held against the C launcher's
   rule), launched twice for the same bits and into outputs followed by
   guard rows that must stay as they were; the AdamW epilogue BIT
   FOR BIT on the main path's 39 leaf shapes plus an odd-sized and a 0-d
   leaf, finite and held. Time kernel, plain version and, where one
   PyTorch call computes the same function (SDPA's forward for B1,
   PyTorch's flash-attention backward op for B4, ``torch._fused_adamw_``
   for the epilogue), that call; else a named yardstick. B1-B3 also at the
   BERT phase's shape (B 32, S 512, seeded lengths), SDPA with the key
   mask as B1's library call.
3. small models: a tiny CausalLM through the kernels on the card against
   the same weights through the plain path on the CPU; then a tiny
   ``fused_kernels=True`` CausalLM with ``fused_adamw`` and the single-pass
   backward trained 3 steps on the card against the CPU, from three seeds.
4. main path: a Llama-3-8B-width CausalLM (4 layers) trained for a few
   ``Accelerator.unified_step``s in bf16 with AdamW and clipping, with
   every kernel launch counter set to 0 just before and read just after;
   then one profiled step, whose kernel names must be the path's kernels.
5. fused path: the same model with ``fused_kernels=True``, ``fused_adamw``
   and ``flash_attention.FUSED_BWD = True``, counters and profiled step
   read the same way; its loss curve must stay within PATH_LOSS_TOL of the
   main path's.
6. BERT phase: the bert_base ``SequenceClassifier`` (full width and depth)
   at B 32, S 512, where auto-dispatch itself takes B1-B3 non-causal with
   ``kv_lengths``: 6 ``unified_step``s and an eval pass with exact launch
   counts and one profiled step; then 3 steps, ``save_state``, a fresh
   accelerator and model, ``load_state``, ``skip_first_batches(3)`` and 3
   steps, which must equal the uninterrupted run bit for bit.
7. example: ``accelerate_tpu_torch/examples/checkpointing.py`` for one
   bert_base epoch (S 128: no kernel of the port), its ``epoch_0``
   re-evaluated in a fresh accelerator to the same accuracy, and one
   profiled step of its shape.
8. serving: ``generate``, ``make_generate_fn`` and the continuous-batching
   ``ServingEngine`` (``max_slots`` 4, ``block_size`` 16) on the reference's
   5.5 B ``decode`` config at full width and depth (24 layers), bf16
   weights made on the card from a seed. Checks: the engine's decode step
   replayed as a CUDA graph equals the eager step bit for bit (logits and
   pools, 8 steps of a 4-slot batch at mixed depths), and so does
   ``make_generate_fn``'s; a 2-layer fp32 model's greedy tokens are the
   same through the engine and ``generate`` on the card and on the CPU,
   and through the engine with the prefix cache cold and warm (a
   full-prompt hit and its copy included); paged and dense prefill give
   the same first-token logits within SERVE_PREFILL_TOL; blocks no table
   held keep the sentinel the pools were filled with, and the trace's
   tokens do not change between its warm and timed runs; the decode step
   is built once and prefill buckets stay within log2(max_seq_len); no
   kernel of the port launches. Prints s/token of ``make_generate_fn`` (B
   1, prompt 128, 64 new tokens) and of the eager ``generate`` beside the
   weights-read bound, the engine's useful tokens/s on the 8-request
   long-tailed trace of ``benchmarks/measure.py:_run_serve`` against fixed
   batches of ``make_generate_fn``, peak memory, KV bytes per token and the
   device's busy share of one profiled decode step and one engine step.
   Then the reference's three further parts of its ``serve`` variant
   (``measure.py:705-952``): the observability A/B on the same warm engine
   (the trace with telemetry, gauges, SLO and spans off, then on, in
   OBS_ROUNDS interleaved rounds; tokens unchanged, the decode step built
   once, ``serve_gauge`` and ``slo`` lines in the scrape text); the prefix
   A/B on it (a 24-block template, PREFIX_COHORT (6) prompts with 8-token
   suffixes drained one at a time, cold then warm: TTFT, exactly 6 x 384
   prefill tokens
   saved, no new build, first-token logits warm against cold within
   PREFIX_LOGITS_TOL); and the speculation A/B with the target in fp32 at
   the decode config (o_proj and down_proj of layers >= 1 at zero) and a
   1-layer draft holding its layer 0: off, n-gram and draft model at k 4 on
   8 prompts of SPEC_NEW (90) new tokens, each a fresh engine, warm then timed
   (n-gram and draft outputs equal off's token for token, nothing rebuilt
   after warmup, one verify and one draft-step build, the draft's accept
   rate at least SPEC_ACCEPT_MIN).
9. moe: the reference benchmark's ``moe`` config (registry.py:214-258,
   656,453,632 params: 1 layer, 8 experts of Mixtral width, top-2, ragged
   dispatch) at B 16, S 1024: B1-B4 against their plain versions at its
   attention shape (``check_case``, gated), B1-B3 timed there; a
   2-layer fp32 tiny MoE model on the card against the CPU (1e-4); one
   full-width MoE layer's output and grads (x, router, the three stacks)
   by the grouped GEMM and by capacity at the no-drop factor against the
   dense oracle, row by row (MOE_ORACLE_TOL); capacity 1.25's drops equal
   to the plain version's on the CPU, and fully dropped tokens read zeros;
   5 unified_steps (AdamW, clip 1.0) with exact B1-B3 launches and none of
   B4-B6; a profiled step whose kernels include the grouped GEMM; a step
   and its gradients repeated from one copy of the state, bit for bit.
10. dense and fp8: the ``dense`` config (registry.py:205-213, 3 layers at
   Llama-8B width, ``remat="dots"``) at B 8, S 1024, 5 steps in bf16, then
   again under ``mixed_precision="fp8"`` (prepare converts the 21
   projections): ``fp8_matmul`` by ``torch._scaled_mm`` against its plain
   version at the config's projection shapes (forward, dx, dw row by row,
   FP8_PRODUCT_TOL); exact launches (the "dots" recompute replays the
   flash forward) and exact fp8 products (the wrapper's calls, and the
   fp8 GEMM kernels of a profiled step: 63); "dots" against no remat bit
   for bit; then bf16 and fp8 again from each further seed of FP8_SEEDS,
   and on every seed the fp8 losses within FP8_LOSS_TOL of the bf16 ones
   (the gap over the bf16 run's first loss).
11. longseq: the ``longseq`` config (registry.py:259-288, 2 layers, S 8192,
   B 1, flash): B1-B4 against their plain versions at its attention shape
   (gated), B1-B3 timed there, then 4 steps each under
   ``"save_mlp"``, ``"full"`` and no remat, whose gradients must be the same
   bit for bit, each with exact launches.
12. serve_soak: the reference benchmark's ``serve_soak`` variant
   (``measure.py:_run_serve_soak`` at ``(decode, 4, 16, 64, 0)``,
   registry.py:329-330) on phase 8's ``decode`` model (built once for
   both). First a 2-layer fp32 model on the card against the CPU: an
   engine with chunked prefill, preemption and int8 KV on the reference's
   ``test_all_three_features_compose`` prompts gives the CPU's greedy
   tokens and the int8-only engine's, and a priority preemption resumes bit
   for bit. Then the main soak on the wall clock through ``SoakHarness``:
   the closed-loop capacity probe (run twice, the second timed), the TTFT
   objective (2x its p95) and ``max_queue_delay_s``, and the nine phases
   (warmup, four ramps to 2x capacity, cooldown, soak, fault with
   ``stall_decode``, recovery); it prints goodput at the SLO,
   ``vs_baseline``, capacity at the breach point, sheds, arrival lag and the
   fault window's damage and recovery. Then the A/B arms on the virtual
   clock (``soak_ab_arms``, each phase and the fault at SOAK_ARM_SCALE of
   the reference's length): chunked prefill off and on over the
   long-prompt burst on a constrained pool with the work-weighted step cost
   (on's soak p95 TTFT strictly below off's, chunks > 0), and shed-only
   against preemption under ``pool_pressure`` (fewer fault-window sheds,
   at least one preemption, every preempted request's tokens equal to the
   shed-only control's bit for bit, the pool drained). Then int8 KV: census
   ``kv_cache`` bytes of bf16 and int8 engines and the seats they fund at
   the bf16 pool's bytes (both ratios >= 1.8); ``quantize_kv`` on the card
   against the CPU on one prefill's K and V (bit for bit); int8
   ``paged_attention`` in bf16 against its fp32 computation
   (INT8_ATTN_TOL). Then one chunked step, one swap-out and its swap-in
   under the profiler. Every engine builds its decode step once and no
   kernel of the port launches. Readings, not gated: ``slo_ok``, ``recovered``,
   the goodput, int8 against bf16 greedy agreement and first-token logits.
13. accum and the long-sequence pair: the reference benchmark's ``accum``
   variant (``measure.py:_run_accum`` at ``(small, 4, 512, 8, 2)``, K 8,
   bf16, adamw, clip 1.0, telemetry on): B1-B4 against their plain versions
   at its attention shape (B 4, S 512, 16/8 heads of 64; gated) and B1-B3
   timed there; the unfused and the fused step from one seeded init and
   batch, run unfused then fused (once each), each for 2 + 8 optimizer
   steps: the step records must read 1 microbatch and 8 calls an optimizer
   step (unfused) and 8 and 1 (fused), B1-B3 launch exactly 2 x 8 x 10
   times, every loss is finite, and the fused params and losses equal the
   unfused ones bit for bit; prints each mode's optimizer-step seconds and
   ``vs_baseline`` (unfused / fused), a profiled optimizer step of each and
   the kernels whose launch counts differ. Then ``longseq4k`` and
   ``longseq_xla4k`` (``longseq`` at S 4096, ``"full"``, sgd, B 1): B1-B4
   against their plain versions at S 4096 (gated) and B1-B3 timed there,
   one step's grads of the flash and the plain path from one init held
   row by row (LONGSEQ_GRAD_TOL), then LONGSEQ4K_STEPS steps of each with
   exact launches (none on the plain path), peak memory, a profiled step
   and ``flash_speedup_vs_xla`` (plain / flash step seconds). Then
   ``longseq_xla`` (S 8192, ``"save_mlp"``, adamw) on the plain path,
   against phase 11's flash step. Last, a real CUDA out-of-memory error:
   ``find_executable_batch_size`` around two ``longseq_xla`` steps from
   B 4 must catch one, halve the batch, settle on a batch with finite
   losses, and leave the allocated bytes where they were before the first
   attempt once ``free_memory`` has run.
14. ckpt: the reference benchmark's ``ckpt`` variant (``measure.py:_run_ckpt``
   at ``(small, 8, 512, 16, 3)``, registry.py:400, nothing cut): B1-B3 against
   their plain versions at its attention shape (B 8, S 512, 16/8 heads of
   64; gated, check (f)) and timed there; then the sync and the async arm,
   each from one seeded init: 3 warmup steps, 16 steps with a
   ``CheckpointManager`` saving every 4 (bf16, adamw, telemetry on,
   ``total_limit`` 2), B1-B3 launching exactly 2 x 16 times; it prints each
   arm's saves, mean ``blocked_s`` and ``background_s``, ``bytes_written``,
   write GiB/s, save, quiet and after-save step seconds, the pinned bytes
   and host RSS, and ``vs_baseline`` (sync blocked_s / async blocked_s).
   Hard checks: (a) the async save at step 12 against a host clone taken
   right after its submit, while steps 13-16 update the same tensors in
   place, bit for bit, and its recorded step, iteration and loader cursor;
   (a2) the same for a ``save_state(block=False)`` made with no synchronise
   after its step; (b) every directory left is committed, none is a
   ``.tmp``, the newest is step 16's; (c) each arm's newest checkpoint
   equals its live carry bit for bit, and the two arms' shards have one
   sha256; (d) ``restore_or_init`` on a fresh accelerator resumes at step
   16 and its step 17 equals the live one bit for bit; (e) SIGTERM with an
   async save in flight: the next ``step`` drains it, writes the final
   checkpoint synchronously and sets ``should_stop``, and a restore resumes
   from it bit for bit. Last, a pinned buffer set's allocation and the copy
   into it timed apart.
15. diag: the reference benchmark's ``overhead`` variant
   (``measure.py:_run_overhead`` at ``(TransformerConfig.tiny(), 8, 256, 30,
   3)``, registry.py:366-368, nothing cut) as arm A, and the same A/B at
   llama3_8b widths cut to 2 layers (B 2, S 2048, 3 + 12 steps) as arm B:
   two Accelerators in bf16 from one seed (adamw 3e-4, clip 1.0), the "on"
   one with telemetry and ``DiagnosticsConfig(anomaly_sample_every=8)``,
   timed in interleaved rounds of ``max(1, min(3, iters // 6))`` steps with
   the same synchronise in both; prints ``harness_overhead_pct`` (the
   median of the rounds' deltas over the median "off" step; not gated),
   ``vs_baseline`` = 2 / pct, the medians, the records, peak memory, and
   each "on" step's host time by telemetry hook. Hard checks: (a) losses,
   params and moments on = off bit for bit in both arms; (b) the step
   records, a goodput record every ``goodput_interval`` whose buckets sum
   to its ``wall_s`` (GOODPUT_SUM_TOL), ``summary()``'s ``goodput_pct``;
   (e) a ``CheckpointManager`` commits one save, then (c) a NaN in one
   weight of arm A's "on" arm fires exactly one ``nan_grad`` and a
   ``torch.profiler`` capture of ``capture_steps`` steps whose trace holds
   B1-B3 by kernel name as often as the counters say, and the next record's
   ``top_ops`` name its device kernels; then ``end_training`` and ``python
   -m accelerate_tpu_torch.commands.accelerate_cli diagnose`` (text and
   ``--json``), which must name the shutdown dump at the last step,
   ``nan_grad=1``, the goodput and the committed checkpoint; (d) a touched
   ``trigger_file`` on arm B's "on" arm starts one capture at full width,
   held the same way; (f) B1-B3 at the variant's attention shape in bf16 and
   in the path's dtype (``tiny``'s activations are fp32), whose rows go
   into the kernels line.
16. fleet: the reference benchmark's ``fleet_soak`` and ``disagg_soak``
   variants (``measure.py:_run_fleet_soak`` at ``(decode, 2, 16, 48, 0)``
   and ``_run_disagg_soak`` at ``(decode, 2, 16, 32, 0)``, registry.py:335-342,
   each with half its offered requests since PR 22) on phase 8's ``decode``
   model, every arm on the virtual clock (``step_dt_s`` 0.01) through
   ``SoakHarness`` and a ``FleetRouter`` over
   fresh replicas, each primed colocated (every prefill bucket and the
   decode step) and then given its role: round robin, least loaded and
   prefix affinity on one templated-cohort trace and prefix affinity under
   ``replica_kill@0:replica=1`` (four replicas); four colocated replicas,
   two prefill and two decode (``placement="disagg"``, a ``host_buffer``
   ``TransferPlane``) and the latter under ``transfer_stall@0:secs=1``; and
   the closed-loop probe. Prints each arm's goodput, p95 ITL, warm hit rate,
   counts, dedup ratio, bytes moved, transfer p95 and the hand-offs' wall
   time, ``vs_baseline`` for both (readings), the phase's wall and peak
   memory. Hard checks: (a) the probe's greedy tokens across the hand-off
   equal the colocated engine's; (b) no decode rebuild on any replica and no
   prefill build on a decode replica after priming; (c) affinity's warm hits
   above round robin's; (d) the kill's ``requests_lost`` equals the seats
   replica 1 held, every request it had queued re-queued and ended; (e) the
   stall loses nothing and every hand-off seen stalled is delivered and
   finishes; (f) the counts (finished, shed, routed by replica, warm
   lookups and hits, requeued, lost, transfers, blocks moved and deduped)
   equal a run of the same plans on a 1-layer fp32 model on the CPU with the
   decode config's vocab and ``max_seq_len`` (the arms read no token
   value); no kernel of the port launches.
17. lora: first an ``Accelerator()`` on the card prints its repr,
   ``mixed_precision``, ``distributed_type`` and a ``JSONLTracker`` round
   trip of a value on the card. Then the reference benchmark's ``lora``
   variant (``measure.py:_run_lora`` at ``(small, 4, 512, 8, 2)``,
   registry.py:406, nothing cut): B1-B3 against their plain versions at its
   attention shape (gated) and timed there; phase 1, the full fine-tune
   (bf16, adamw 3e-4, clip 1.0, 2 + 8 steps) and phase 2, a rank-8, alpha-16
   adapter on q_proj/v_proj over the int8 base through ``lora_loss_fn``,
   each with B1-B3 launching exactly 2 x 10 times and one profiled step;
   phase 3, the reference's mixed-tenant trace on a 4-slot engine over the
   bf16 base. Prints ``full_step_s``, ``lora_step_s``, ``step_speedup``,
   both param byte counts, peak memory, busy shares and
   ``lora_param_bytes_ratio``. Hard checks: the carry adapter-only, no base
   parameter with a gradient (nor the int8 base's scales), the QLoRA loss
   finite and falling and its first step within QLORA_LOSS_TOL of the bf16
   base's loss; (a) no decode rebuild over the trace; (b) three tenants
   (nonzero B) and the base in one batch give each one's tokens of a
   single-tenant engine of the same width; (c) a tenant loaded after the
   decode graph's capture decodes as in an engine where it was loaded
   before, and not as the base, and the stacks keep their addresses; (d) a
   tiny fp32 engine with three tenants gives the CPU's tokens; the serving
   part launches no kernel of the port.
18. decode_load: the reference benchmark's ``decode_load`` variant
   (``measure.py:_run_decode_load`` at ``(decode, 1, 0, 0, 0)``,
   registry.py:396-397, nothing cut) on phase 8's ``decode`` model. First B1-B4
   against their plain versions at the decode forward's attention shape (B 1,
   S 512, 32/8 heads of 128; gated) and B1 timed there. The disk: the larger
   of the temp dir and the repository's gitignored ``dev/`` must hold 1.2 x
   the checkpoint, else the phase fails. (a) ``save_model_weights`` in 2 GB
   shards (files, bytes, seconds); ``POSIX_FADV_DONTNEED`` on those files;
   the reference's attribution leg, every tensor read to the host
   (``disk_to_host_s``), then again with the pages kept (its warm time
   says whether the advice took effect); the files' pages dropped again; then
   ``init_empty_weights`` to a model on the card through
   ``load_checkpoint_and_dispatch(device_map={"": 0})``, ending in a
   synchronise (``checkpoint_load_seconds``, ``host_to_device_s`` = load -
   disk_to_host, GiB/s, ``vs_baseline`` = 8.7 / load, the host's VmRSS rise
   sampled over the load beside its peak RSS's rise (VmHWM, or getrusage's
   ru_maxrss where /proc has no VmHWM), the device peak). Hard: every
   tensor equal to the live one, ``make_generate_fn``'s greedy tokens on the
   serve trace's first prompt the live model's, and one forward at B 1, S 512
   bitwise the live model's with exactly 24 B1 launches (one a layer) and
   none of B2-B6. (b) With (a)'s directory deleted, ``save_hf_checkpoint``
   of the live model through the port's own writer, ``infer_config_from_hf``
   equal to ``decode`` in every field that shapes a weight, and the detected
   HF load equal tensor for tensor (its seconds). (d) ``load_and_quantize_model``
   (int8) of (b)'s checkpoint: codes and scales bitwise those of
   ``quantize_params`` of the live weights (its seconds, the int8 bytes).
   (c), after (d) with (b)'s directory deleted, so that the disk holds one
   checkpoint at a time: ``infer_auto_device_map`` with ``{0: 5GB, "cpu":
   3GB}`` over all three tiers (the bytes of each), ``dispatch_params`` then
   ``materialize_offloaded`` equal to the live tensors, and layers 0-3 stacked
   on the disk tier through ``streamed_apply`` two at a time, their hidden
   states those of the four Blocks applied densely (STREAM_TOL).
19. processes and data: (a) phase 4's main path twice, first without a
   process group, then with ``ACCELERATE_TPU_NUM_PROCESSES=1``,
   ``_PROCESS_ID=0`` and ``_COORDINATOR_ADDRESS=127.0.0.1:<free port>``, so
   that the Accelerator brings up a real NCCL group (of one: the machine has
   one card) and every optimizer step's gradient mean and every loss go
   through it, the loader prepared through ``BatchSamplerShard``. Hard: the
   losses, the grad norms and every final param bitwise the run without a
   group, B1-B3 exactly 20 launches each and B4-B6 none in both runs, and
   one profiled step of the grouped run making one host all-reduce a
   gradient leaf and two more (the mask counts, the loss). It prints the
   median step of steps 2-5 of each run and that step's NCCL kernels'
   device ms (or a note that none launched), then ends the group and
   resets the singletons; B1-B3 are
   checked and timed at the main shape for their rows. (b) LAUNCH_WORLD CPU
   processes over gloo on the host through the port's ``debug_launcher``:
   the collectives, training and local-SGD workers and the whole assertion
   script (``test_utils/scripts``); any failure fails the run. (c) Those
   processes train the 2-layer fp32 tiny CausalLM 3 steps on global batches
   whose processes hold different mask counts and ``save_state`` through the
   done-marker commit; at world 1 on the CPU and then on the card,
   ``load_state`` without ``allow_reshape`` raises the reference's error
   and writes nothing, with it every param is bitwise process 0's, and two
   more steps on the card agree with two on the CPU (losses and grad norms
   RESTORE_TOL relative, params SMALL_UPDATE_TOL of the update).
20. sharding (``--shard-only``), in an NCCL group of one brought up as in
   19 (a): (a) the main path without a plugin, then under a
   ``ParallelismPlugin`` with NO_SHARD, SHARD_OPT and FULL_SHARD (every
   degree 1 at world 1: the params DTensors on a one-card mesh, the step's
   sharded path over their local tensors), and SHARD_GRAD_OP at unfused
   accumulation K 2 against a no-plugin K 2 run; (b) the fused path
   (``fused_kernels=True``, ``fused_adamw``) under FULL_SHARD against the
   fused path without a plugin. Hard: every run's losses, grad norms and
   final params bitwise its no-plugin run's; B1-B3 20 launches in each run,
   and on the fused path B5 20 and B6 5 (over the local shards). Each run
   prints its median step of steps 2-5, its peak memory and one profiled
   step's NCCL kernels and host all-reduce calls. B1-B3 are checked and
   timed at the main shape, B5 checked and timed at the main path's
   prologue shape, B6 checked bit for bit on the first layer's leaves and
   timed over all 39, for their rows. (c) SHARD_WORLD CPU processes over
   gloo train the tiny CausalLM under FULL_SHARD at fsdp 2 x tp 2 in fp32
   and ``save_state`` through the multi-process commit, each process
   writing only its own chunks (``validate_coverage`` passes, each chunk's
   file its writer's); at world 1 on the CPU, on the card without a plugin
   and on the card under FULL_SHARD, ``load_state(allow_reshape=True)``
   gives every param bitwise, and two more steps on the card agree with two
   on the CPU (RESTORE_TOL, SMALL_UPDATE_TOL). (d)-(f), in an NCCL group of
   one, each on FULL_SHARD DTensor params against its run without a plugin:
   (d) the main path's model decoded greedily, ``make_generate_fn`` and
   ``generate`` of SHARD_DECODE["new"] tokens from a seeded (2, 512) prompt
   (the forward inside the model's sharded context); (e) the raw loop over
   the main path's model, ``accumulate`` at K 2 over MAIN's batch for 2
   optimizer steps with ``backward``, the gradients' sum, ``clip_grad_norm_``
   and adamw's ``step``; (f) phase 17's adapter step over the bf16 base (an
   adapter whose B is not zero). Hard: (d)'s tokens bitwise, ``generate``'s
   equal to ``make_generate_fn``'s and its decode step one CUDA graph; (e)'s
   losses, grad norms and params bitwise, B1-B3 exactly the run without a
   plugin's launches (16 each); (f)'s losses and adapter bitwise, B1-B3 20
   each. Each prints its s/token or median step and its peak. (g) the
   serving engine over the main path's model (SHARD_ENGINE: prefix caching
   with a copy on write, n-gram speculation at k 2, a priority preemption
   swapped out and back in), with bf16 and with int8 KV; hard: the tokens
   bitwise, ``trace_counts`` equal with one decode graph, each lever taken,
   the int8 scale arrays bitwise; printed: s/token, tokens/s, the peak and
   a profiled decode step's busy share. (h) phase 17's QLoRA step over the
   int8 base placed by ``Accelerator.prepare``; hard: losses and adapter
   bitwise, B1-B3 20 each; printed: the step and the peak.
21. pipelines, sequence and expert parallelism (``--pipe-only``). One card
   holds one rank, so each mechanism's rank bodies run in one process
   (``test_utils/pipeline_runner.py``, through the library's tick table,
   ring order and shard window) at llama3_8b widths in bf16: (a)
   ``unified_pipeline_step`` at pp 1 in an NCCL group of one (NUM_LAYERS
   stacked as the block, the embedding an input, the final norm and lm_head
   a frozen loss; MAIN's batch in 2 microbatches, STEPS steps) against
   ``unified_step`` over the same microbatch loop, with adamw and with
   fused_adamw: bit for bit, B1-B3 40 launches a run, B6 5 on the fused
   runs; (b) 1F1B at 2 stages (layers 0-1 and 2-3, 8 microbatches of B 1
   x S 2048) and GPipe with autograd against the sequential autograd run
   (PIPE_LOSS_TOL, PIPE_GRAD_TOL), launches exactly 64/32/32 and 32/32/32,
   the 1F1B peak below GPipe's; (c) the 4 ranks' ring bodies at
   LONGSEQ_CFG's attention against the flash kernels (RING_TOL), the ring's
   and dense attention's peaks; (d) the ep 2 and ep 4 shard windows summed
   at MOE_CFG's MoE against ``moe_ragged`` (EP_TOL, no drop), and the drop
   share at capacity_factor 1.25. B1-B3 checked and timed at the main
   shape and B6 over the main path's leaves for their rows, with (a)'s
   launches.
22. the model zoo (``--zoo-only``): (a) B1-B4 at head_dim 256 (Gemma's, the
   wmma design's short tiles) against their plain versions in bf16, fp16
   and fp32: causal GQA 8/1 at (1, 2048), non-causal with kv lengths (one
   of 129), a window of 300, NaN rows causal and not; the C launcher's
   shared-memory carve of every wmma kernel against the host's
   (``wmma_smem_bytes``) at every head_dim up to 256; one B5 case at
   Gemma-2B's widths with ``norm_offset``. (b) Gemma-2B (GEMMA_2B, nothing
   cut) at B 1, S 2048, bf16 compute and fp32 masters, plain AdamW, clip
   1.0, ZOO_STEPS ``unified_step``s: B1-B3 exactly 18 a step each on the
   wmma design, the step-1 loss and grad norm against a run of the same
   weights with ``attention_impl="xla"`` (GEMMA_XLA_TOL), step time, peak
   and a profiled step whose port kernels must be the wmma ones. (c) GPT-2
   at ``TransformerConfig.gpt2()`` (124M, nothing cut), B 8, S 1024: steps
   with B1-B3 exactly 12 a step; ``make_generate_fn`` at B 1 (128-token
   prompt, 32 new) equal to the eager loop bit for bit; a tiny fp32 GPT2LM
   through the kernels against the CPU (1e-4). (d) ``Seq2SeqLM`` at
   ``t5_base()`` (12 + 12 layers, nothing cut), B 8, source and target S
   512: steps with B1-B3 exactly 24 a step (the encoder non-causal, the
   decoder causal, cross-attention none), then one step with a right-padded
   source mask, 12 each (the masked encoder takes the plain path); a tiny
   fp32 model's greedy tokens on the card equal the CPU's. (e) a tiny fp32
   Gemma-2 ``CausalLM`` (every switch) on the card against the CPU: logits,
   loss, grads, greedy tokens, and a 4-slot engine's tokens. B1-B4 timed at
   Gemma-2B's shape, B1-B3 at GPT-2's and T5's (D 64) for their rows.
23. A8's remainder (``--a8-only``): (a) B5 at bert_base's layout (B 32, S
   512, E 768, 12/12 heads of 64: ``H == Hkv``) and a multi-head case with
   bias on rows that fill no tile, each against its plain version row by
   row at the prologue TOL, repeated bit for bit into guarded outputs and
   counted under ``prologue_kernel_design``'s design; B5 timed at
   bert_base's shape beside its plain version and ``F.linear`` of x with
   the q/k/v weight. (b) bert_base's ``SequenceClassifier`` with
   ``fused_kernels=True`` against the unfused one (phase 7's run in the
   whole script, its own with ``--a8-only``), from one seed on
   ``bert_phase``'s data: 6 ``unified_step``s each (and the fused run's eval
   pass) with the counters set to 0 just before: B5 12 a forward, B1 the same, B2 and B3 12 a step,
   all wgmma; step 1's loss and grad norm within A8_LOSS_TOL/A8_GNORM_TOL
   of the unfused run's; step time, busy share and peak side by side. (c)
   ``examples/cv_example.py``, ``seq2seq_example.py`` and
   ``schedule_free.py`` on the card at their own widths and data, their
   epochs cut (A8_EXAMPLES' comment), each at least its reference test's
   bound. (d) ``grad_dtype=bfloat16`` at accum's config, fused and unfused,
   against the fp32 buffer: the carried buffer bf16 at half the bytes, the
   peaks, the last optimizer step's losses within A8_GRAD_DTYPE_LOSS_TOL
   and, in both modes, not all equal to the fp32 run's.

Prints one JSON line describing the kernels (each with the shape it was
timed at), then the card's name and power limit, then ``{"ok": true, "device": {...}}`` as the last line. Needs one
CUDA device; exits non-zero without one.

    python3 chip_smoke.py --check-only

runs phases 1 and 2 without the timings, and

    python3 chip_smoke.py --small-only

phases 1 and 3 (both for tools/flash_mutants.py), and

    python3 chip_smoke.py --bert-only

phase 1, the BERT-shape kernel cases and timings, and phases 6 and 7, and

    python3 chip_smoke.py --serve-only

phase 8 alone (the serving path runs no kernel of the port, so nothing is
built), ending with the card's line and the ``{"ok": true, ...}`` line,

    python3 chip_smoke.py --soak-only

phase 12 alone, ending the same way, and

    python3 chip_smoke.py --fleet-only

phase 16 alone, ending the same way, and

    python3 chip_smoke.py --variants-only

phases 1 and 9-11, and

    python3 chip_smoke.py --accum-only

phases 1 and 13 (phase 13 then runs the flash side of its S 8192 ratio
itself), and

    python3 chip_smoke.py --ckpt-only

phases 1 and 14, and

    python3 chip_smoke.py --diag-only

phases 1 and 15, and

    python3 chip_smoke.py --lora-only

phases 1 and 17, and

    python3 chip_smoke.py --load-only

phases 1 and 18 on a ``decode`` model it builds itself, and

    python3 chip_smoke.py --launch-only

phases 1 and 19, and

    python3 chip_smoke.py --shard-only

phases 1 and 20, and

    python3 chip_smoke.py --pipe-only

phases 1 and 21, and

    python3 chip_smoke.py --zoo-only

phases 1 and 22, and

    python3 chip_smoke.py --a8-only

phases 1 and 23, each of the last seven ending with the card's line and the
``{"ok": true, ...}`` line.

Each kernel output is compared row by row: for every row of head_dim
values, max |kernel - plain| over that row's RMS plus 1e-2 of the whole
tensor's RMS (the floor keeps rows the plain version nearly cancels, such
as dq of a query that sees one key, from reading as large), then the
largest over all rows. A global max|err| / max|plain| would let a causal
output pass with most rows wrong: its largest values sit in the first
rows, which see few keys.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import tempfile
import time
from contextlib import contextmanager

MAIN = dict(B=2, S=2048, H=32, Hkv=8, D=128)  # llama3_8b attention at the main path's batch
STEPS = 5
NUM_LAYERS = 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SPIN_CYCLES = 4_000_000  # about 2 ms of the SM clock: longer than a wrapper's host work
# limits about 3x the largest reading of a correct kernel on an H100
# (PERF.md): worst row error, see above, and lse's max abs error
TOL = {"bfloat16": 0.1, "float16": 1e-2, "float32": 1e-5}
LSE_TOL = {"bfloat16": 5e-6, "float16": 5e-6, "float32": 2e-6}
PROLOGUE_TOL = {"bfloat16": 0.05, "float16": 5e-3, "float32": 1e-5}  # the same row error
SMALL_UPDATE_TOL = 3e-4  # |card - CPU| / |CPU update| of the tiny fused model's params
SMALL_SEEDS = (0, 1, 2)  # weights and batches of the tiny fused model
# |fused path loss - main path loss| / main path loss, by step: about 3x the
# largest reading over seeds and repeats of tools/path_bisect.py (PERF.md)
PATH_LOSS_TOL = (5e-5, 3e-4, 2e-3, 3e-3, 1e-2)
FLASH_SRC = "accelerate_tpu_torch/ops/csrc/flash_attention.cu"
FUSED_SRC = "accelerate_tpu_torch/ops/csrc/fused.cu"
# wrapper name -> (kernel name, the Pallas kernel it replaces, source, its
# design; None: two designs, the row says which one the main shape's case
# launched, from the wrapper's per-design counter)
KERNELS = {
    # the wmma design of B1-B4 (fp32, other head dims) launches as
    # flash_fwd_wmma_kernel, flash_bwd_dq_wmma_kernel, ...
    "flash_fwd": ("flash_fwd_kernel", "accelerate_tpu/ops/flash_attention.py:150", FLASH_SRC,
                  None),
    "flash_bwd_dq": ("flash_bwd_dq_kernel", "accelerate_tpu/ops/flash_attention.py:269",
                     FLASH_SRC, None),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel", "accelerate_tpu/ops/flash_attention.py:325",
                      FLASH_SRC, None),
    "flash_bwd_fused": ("flash_bwd_fused_kernel", "accelerate_tpu/ops/flash_attention.py:422",
                        FLASH_SRC, None),
    # the wgmma design launches qkv_prologue_rstd_kernel, then
    # qkv_prologue_kernel; the wmma design (fp32, other head dims)
    # qkv_prologue_wmma_kernel
    "qkv_prologue": ("qkv_prologue_kernel", "accelerate_tpu/ops/fused.py:214", FUSED_SRC,
                     None),
    "adamw_epilogue": ("adamw_kernel", "accelerate_tpu/ops/fused.py:426", FUSED_SRC,
                       "elementwise"),
}
# the BERT phase: bert_base at its max_seq_len, the kernels' BERT shape
BERT = dict(B=32, S=512, H=12, D=64, steps=6, eval_rows=100, eval_batch=32)
BERT_CASES = [  # B1-B3 non-causal, right-padded, G = 1 at head_dim 64; a row of length 0
    ("bert_noncausal_lengths_d64_g1", dict(B=4, S=512, H=12, Hkv=12, D=64, causal=False,
                                           lens=[512, 300, 129, 0])),
    ("bert_noncausal_lengths_d64_g1_fp16", dict(B=4, S=512, H=12, Hkv=12, D=64, causal=False,
                                                lens=[512, 300, 129, 0])),
]
WRAPPER_OF = {spec[0]: wrapper for wrapper, spec in KERNELS.items()}  # kernel -> wrapper
# the reference's ``decode`` config (accelerate_tpu/benchmarks/registry.py:289-297):
# 5,496,836,096 params, 96 KiB of bf16 KV a token
DECODE_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=24,
                  num_heads=32, num_kv_heads=8, max_seq_len=512, dtype="bfloat16")
# the reference's serve and decode variants (registry.py:318-328); generate
# is timed over one rep of the reference's three (cut for phase 23's time:
# the eager loop's 3 reps took 11.1 s, H100 80GB HBM3 at 700 W)
SERVE = dict(max_slots=4, block_size=16, n_requests=8, seed=0, prompt=128, new_tokens=64,
             reps=1, graph_steps=8)
# paged against dense prefill, first-token logits in bf16: worst row's max
# error over its RMS. An H100 read 0.0 on all 8 prompts (the padded and
# unpadded products picked the same cuBLAS kernels), so the limit is not 3x
# the reading but a few bf16 spacings (2^-8) of a logit row (PERF.md)
SERVE_PREFILL_TOL = 0.02
# interleaved off/on rounds of the observability A/B: one of the reference's
# two (measure.py:733; cut for phase 23's time)
OBS_ROUNDS = 1
# the templated cohort: 6 requests of 8 new tokens, half the reference's 12
# (measure.py:758-856; its four passes took 13.6 s, cut for phase 23's time)
PREFIX_COHORT, PREFIX_NEW = 6, 8
# warm against cold first-token logits in bf16 (an M of 8 against a bucket
# of 512), worst row's max error over its RMS: about 3x the largest reading
# on an H100 (0.180 over 12 prompts; PERF.md). The same tail padded to the
# cold bucket is held within SERVE_PREFILL_TOL
PREFIX_LOGITS_TOL = 0.55
SPEC_K, SPEC_PROMPTS = 4, 8  # measure.py:896-897
# new tokens a prompt in the speculation A/B: half the reference's 180 (the
# three arms, each warm then timed, took 37.1 s at 180; cut for phase 23)
SPEC_NEW = 90
# the draft arm's accept rate: an H100 read 1.0 (2,304 of 2,304); the margin
# is for argmax ties that the draft step (M 8) and the verify step (M 20)
# round apart in fp32
SPEC_ACCEPT_MIN = 0.97
SENTINEL = -768.0  # what the pools hold before the trace (exact in bf16)
# phase 6's example trains one epoch over a sixteenth of its 16,384 rows (64
# steps of B 16): the step is host-bound, and the full epoch's ~146 s (H100
# 80GB HBM3, 700 W) took the whole script past its limit on a slower host; a
# quarter (34.6 s) was cut to a sixteenth for phase 23's time
EXAMPLE_ROWS_CUT = 16
CARD = "cuda"  # where the serving phase puts its models
# the reference's serve_soak variant: measure.py:_run_serve_soak(decode, 4, 16, 64, 0)
# (registry.py:329-330)
SOAK = dict(max_slots=4, block_size=16, target_requests=64, seed=0)
# the serve_soak A/B arms (chunked, preempt) on the virtual clock run each
# phase and the pressure fault at a quarter of the reference's length: the
# arms are host-bound (107.9 s of phase 12's 132.3 s on an H100 80GB HBM3 at
# 700 W in full, 48.2 s at half), cut to half when phase 22 came and to a
# quarter when phase 23 came. Every check holds at a quarter, as a CPU run
# of the quartered plans shows (the arms read no token; the same CPU run of
# the halved plans reads the card's numbers exactly): chunked p95 TTFT
# 0.0740 against 0.0818 s with 75 chunks, fault-window sheds 2 against 4,
# 17 preemptions, 11 preempted requests held against the control
SOAK_ARM_SCALE = 0.25
# the reference's fleet variants (registry.py:335-342): (decode, 2, 16, 48, 0)
# and (decode, 2, 16, 32, 0), each with half its offered requests (the arms
# are host-bound: cut for the whole script's time; every check holds, as a
# CPU run of the same plans shows, the arms reading no token)
FLEET = dict(max_slots=2, block_size=16, target_requests=24, seed=0)
DISAGG = dict(max_slots=2, block_size=16, target_requests=16, seed=0)
# int8 paged_attention in bf16 against its fp32 computation from the same
# codes and scales: worst row's max error over its RMS (PERF.md's parity table)
INT8_ATTN_TOL = 0.06  # about 3x the reading 0.0203 on an H100
# the reference benchmark's single-card training variants
# (accelerate_tpu/benchmarks/registry.py:203-406): full width and depth
MOE_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=3584, num_layers=1,
               num_heads=32, num_kv_heads=8, max_seq_len=1024, num_experts=8,
               num_experts_per_tok=2, moe_dispatch="ragged", moe_capacity_factor=1.25,
               dtype="bfloat16", remat=None)  # :214-258, 656,453,632 params
DENSE_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=3,
                 num_heads=32, num_kv_heads=8, max_seq_len=1024, dtype="bfloat16",
                 remat="dots")  # :205-213, 916,484,096 params; fp8 :389-391
LONGSEQ_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=2,
                   num_heads=32, num_kv_heads=8, max_seq_len=8192, dtype="bfloat16",
                   remat="save_mlp", attention_impl="flash")  # :259-288, 698,372,096 params
VARIANT_BATCH = {"moe": 16, "dense": 8}  # the variants' B (registry.py:343, :389); longseq B 1
VARIANT_STEPS = 5
LONGSEQ_STEPS = 4
# limits, worst row's max error over its RMS (bf16): about 3x the largest
# reading on an H100 (PERF.md's parity table)
MOE_ORACLE_TOL = 0.17  # ragged and capacity against the dense oracle (read 0.057)
FP8_PRODUCT_TOL = 0.05  # fp8_matmul by torch._scaled_mm against its plain version (read 0.017)
FP8_SEEDS = (0, 1, 2, 3, 4)  # weights and tokens of the fp8 against bf16 loss comparison
# |fp8 loss - bf16 loss| / the bf16 run's first loss, by step, on every seed
# of FP8_SEEDS. Over the first loss, not each step's own: the repeated batch
# takes the loss from 10.9 to 0.01 in 5 steps, and a gap over a loss that
# vanishes compares noise. About 3x the largest reading over the seeds on an
# H100 (2.5e-4, 4.6e-3, 0.0177, 0.0117, 2.0e-4); tools/fp8_mutants.py's
# planted faults in the fp8 backward read 0.137 or more from step 2 on
FP8_LOSS_TOL = (7.5e-4, 0.014, 0.055, 0.035, 6e-4)
# phase 13: the reference benchmark's accum variant (registry.py:316, measure.py:_run_accum
# :304 at (small, 4, 512, 8, 2), K 8) on its small config (registry.py:298-304, 89 M params)
ACCUM_CFG = dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816, num_layers=2,
                 num_heads=16, num_kv_heads=8, max_seq_len=512, dtype="bfloat16")
ACCUM = dict(B=4, K=8, warmup=2, iters=8)
# longseq4k and longseq_xla4k (registry.py:357-379): longseq at S 4096 under "full", sgd
LONGSEQ4K_CFG = dict(LONGSEQ_CFG, max_seq_len=4096, remat="full")
LONGSEQ4K_STEPS = 6
# flash against plain first-step grads at S 4096 (bf16), worst row's max error
# over its RMS: about 3x the reading 0.348 on an H100 (PERF.md's parity table)
LONGSEQ_GRAD_TOL = 1.0
OOM_START_BATCH = 4  # longseq_xla at S 8192: 4 x 32 heads x 8192^2 fp32 scores = 32 GiB a layer
# phase 14: the reference benchmark's ckpt variant (registry.py:400, measure.py:_run_ckpt
# :175-294 at (small, 8, 512, 16, 3)) on the small config, nothing cut; a loader of 32
# batches repeats the variant's one batch (26 are drawn)
CKPT = dict(B=8, iters=16, warmup=3, total_limit=2, race_step=12, batches=32)
CKPT_EVERY = max(2, CKPT["iters"] // 4)  # measure.py:196
# phase 15: the reference benchmark's ``overhead`` variant at its own arguments,
# (TransformerConfig.tiny(), 8, 256, 30, 3) (registry.py:366-368), diagnostics on
# with anomaly_sample_every 8 (measure.py:2291-2424); arm B is the same A/B at the
# main path's widths, llama3_8b cut to 2 layers
OVERHEAD = dict(B=8, S=256, iters=30, warmup=3, sample_every=8)
OVERHEAD_B = dict(B=2, S=2048, iters=12, warmup=3, num_layers=2)
# the goodput buckets against the wall clock they cover: the tolerance of
# tests/test_diagnostics.py::test_goodput_buckets_sum_to_wall_clock (abs)
GOODPUT_SUM_TOL = 1e-9
HOOK_STEPS = 10  # "on" steps whose telemetry hooks are timed apart
# phase 17: the reference benchmark's lora variant (registry.py:406, measure.py:_run_lora
# :2427 at (small, 4, 512, 8, 2)) on the small config, nothing cut: rank 8, alpha 16 on
# q_proj/v_proj, an int8 base, then the mixed-tenant trace on a 4-slot engine
LORA = dict(B=4, iters=8, warmup=2, rank=8, alpha=16.0, targets=("q_proj", "v_proj"),
            capacity=4, max_slots=4, block_size=16, new_tokens=4, check_tokens=8)
# |QLoRA first-step loss - bf16 base loss| / bf16 base loss, a fresh adapter
# on both (the int8 base's own error): about 3x the reading (PERF.md)
QLORA_LOSS_TOL = 7.5e-5
LORA_B_STD = 0.5  # B of the adapters that must change tokens (checks b-d)
# phase 18: the reference benchmark's decode_load variant (registry.py:396-397,
# measure.py:_run_decode_load :467 at (decode, 1, 0, 0, 0)) on the decode model,
# nothing cut: 2 GB shards, the reference's 8.7 s GPT-J load as the baseline
# (measure.py:548-550), the forward at B 1, S 512, the tiers of (c), and
# layers 0-3 streamed two at a time from the disk tier
LOAD = dict(shard="2GB", baseline_s=8.7, B=1, S=512, margin=1.2, stream_layers=4, group=2,
            tiers={0: "5GB", "cpu": "3GB"})
# streamed against dense hidden states of layers 0-3 (bf16), worst row's max
# error over its RMS: bitwise expected (the same kernels on the same bytes)
STREAM_TOL = 0.0
LLAMA3_ROPE = dict(theta=500000.0, scaling={
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
})


# phase 23 (A8's remainder). (a) B5 at BERT's layout (H == Hkv, E 768) and a
# multi-head case with bias on rows that fill no tile, at the prologue TOL.
# (b) bert_base with fused_kernels=True against the unfused classifier from
# the same weights and batches: step 1's loss and grad norm, relative
# difference, limits about 3x the readings on an H100 80GB HBM3 at 700 W
# (2.43e-4 and 8.4e-5; PERF.md's parity table)
A8_PROLOGUE_CASES = (
    ("bert_mha", dict(B=32, S=512, E=768, H=12, Hkv=12, D=64,
                      rope=dict(theta=500000.0, scaling=None))),
    ("mha_bias_rows", dict(B=1, S=200, E=512, H=8, Hkv=8, D=64, bias=True)),
)
A8_LOSS_TOL = 7.5e-4
A8_GNORM_TOL = 2.5e-4
# (c) the examples at their own widths and data, each held to its reference
# test's bound (tests/test_examples.py), their epochs cut (every step is
# host-bound): cv_example 1 of its 3 epochs (accuracy 1.0 after the first),
# seq2seq_example 14 of its 30 (15 read 0.987 in 66.4-74.5 s, 12 read 0.807,
# under the bound; the 30-epoch run's loss after 14 epochs 0.0188, after 15
# 0.0175; 1.0 in 129.0 s at 30), schedule_free
# one epoch over 1/A8_ROWS_CUT of its rows (bert_base; 0.907 after 256
# steps, 42.2 s; 0.824 after 128, 25.9 s)
A8_EXAMPLES = {"cv_example": 0.70, "seq2seq_example": 0.9, "schedule_free": 0.60}
A8_ROWS_CUT = 8
# (d) grad_dtype bf16 at accum's config, 3 optimizer steps: the last
# optimizer step's microbatch losses against the fp32 buffer's, relative;
# about 3x the reading (7.12e-4, both modes, since AdamW takes a bf16
# gradient times bf16(1-b1) and bf16(1-b2) as optax does; 2.26e-4 before)
A8_ACCUM_STEPS = 3
A8_GRAD_DTYPE_LOSS_TOL = 2.1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


class Report:
    def __init__(self, card_line: str):
        self.card = card_line

    def line(self, text: str) -> None:
        print(f"[{self.card}] {text}", flush=True)


def time_ms(torch, fn, iters: int, flush) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, by CUDA events around the call alone. A spin kernel queued
    between the flush and the start event keeps the card busy while the
    host prepares the call, so the host's time before the first kernel of
    ``fn`` reaches the card is not counted as the card's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-12))


def row_err(torch, got, want) -> float:
    """Worst row of ``got`` against ``want``: max |err| over the row's RMS
    plus 1e-2 of the tensor's RMS, over the elements that are not NaN in
    ``want``. Infinite when the NaN masks differ: a NaN where the plain
    version has none, or a number where it has NaN, never passes."""
    if not torch.equal(got.isnan(), want.isnan()):
        return math.inf
    g, w = got.float().nan_to_num(nan=0.0), want.float().nan_to_num(nan=0.0)
    rms_row = w.square().mean(dim=-1, keepdim=True).sqrt()
    floor = 1e-2 * float(w.square().mean().sqrt()) + 1e-30
    return float(((g - w).abs() / (rms_row + floor)).max())


def make_inputs(torch, B, S, H, Hkv, D, dtype, Skv=None, seed=0):
    Skv = S if Skv is None else Skv
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape_q, shape_kv = (B, S, H, D), (B, Skv, Hkv, D)
    q, k, v, dout = (
        torch.randn(shape, generator=g, device="cuda").to(dtype)
        for shape in (shape_q, shape_kv, shape_kv, shape_q)
    )
    return q, k, v, dout


def same_bits(torch, a, b) -> bool:
    """``torch.equal``, or else the same bits (NaN is not equal to itself)."""
    if torch.equal(a, b):
        return True
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def plant_nans(torch, q, k, S):
    """The NaN cases' inputs (``_nan_inputs`` in tests/test_torch_flash_attention.py):
    batch entry 0's last query row of head 0, which sees every key, all NaN;
    one element of batch entry 1's key 0 in kv head 0 NaN, so every row of
    that kv head's query heads has one NaN score beside finite ones; entry 2
    sees no key (``kv_lengths`` 0). Each NaN reaches the same elements of
    every output however a design tiles the keys. Returns the expected NaN
    rows of O, (B, S, H)."""
    q[0, S - 1, 0] = float("nan")
    k[1, 0, 0, 3] = float("nan")
    rows = torch.zeros(q.shape[:3], dtype=torch.bool, device=q.device)
    rows[0, S - 1, 0] = True
    rows[1, :, :q.shape[2] // k.shape[2]] = True
    return rows


def check_case(torch, fa, name, B, S, H, Hkv, D, dtype, Skv=None, causal=True,
               window=None, lens=None, nan=False, row_limit=None):
    """All four flash kernels against their plain versions on one case, and
    the single-pass backward against dq + dk/dv. Each kernel must count its
    launches under ``fa.kernel_design``'s design alone (the rule's answer at
    the launch; ``check_design_rule`` holds it against the C launcher's).
    On the wgmma design dk/dv's dk and dv must equal the single pass's bit
    for bit (one body, the single pass's dq part compiled out of dk/dv), and
    dq and dk/dv, which use no atomics, must give the same bits when
    launched again on the same inputs. ``row_limit``: this case's own row
    limit in place of TOL's (a case whose reading needs a wider one). Returns
    the case's readings (printed as one JSON line) and the max abs error of
    each kernel's outputs."""
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, dtype, Skv)
    nan_rows = plant_nans(torch, q, k, S) if nan else None
    before = [dict(w.by_design) for w in fa.KERNEL_WRAPPERS]
    kv_lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    args = (scale, causal, kv_lengths, window)
    out, lse = fa.flash_fwd(q, k, v, *args)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, *args)
    delta = fa.attention_delta(ref_out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, ref_lse, delta, *args)
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, dout, ref_lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, ref_lse, delta, *args)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, ref_lse, delta, *args)
    fdq, fdk, fdv = fa.flash_bwd_fused(q, k, v, dout, ref_lse, delta, *args)
    ref_fdq, ref_fdk, ref_fdv = fa.flash_bwd_fused_reference(q, k, v, dout, ref_lse, delta,
                                                             *args)
    # dq and dk/dv once more on the same inputs, into outputs filled with NaN
    # first (the wrappers' outputs start as whatever the memory held): an
    # element a kernel leaves unwritten reads NaN and fails the repeat check
    nan = float("nan")
    dq2, dk2, dv2 = torch.full_like(q, nan), torch.full_like(k, nan), torch.full_like(v, nan)
    fa._launch(fa.flash_bwd_dq, (q, k, v, dout, ref_lse, delta, kv_lengths, dq2), q, k, scale,
               causal, window)
    fa._launch(fa.flash_bwd_dkv, (q, k, v, dout, ref_lse, delta, kv_lengths, dk2, dv2), q, k,
               scale, causal, window)
    torch.cuda.synchronize()
    ran = {w.__name__: [d for d, n in w.by_design.items() if n != b[d]]
           for w, b in zip(fa.KERNEL_WRAPPERS, before)}
    design = fa.kernel_design(dtype, D)
    tag = str(dtype).replace("torch.", "")
    pairs = {"o": (out, ref_out), "dq": (dq, ref_dq), "dk": (dk, ref_dk), "dv": (dv, ref_dv),
             "fused_dq": (fdq, ref_fdq), "fused_dk": (fdk, ref_fdk), "fused_dv": (fdv, ref_fdv)}
    # the single-pass kernel against the two-pass kernels on the same inputs
    two_pass = {"fused_dq": (fdq, dq), "fused_dk": (fdk, dk), "fused_dv": (fdv, dv)}
    errs = {k: row_err(torch, *gw) for k, gw in pairs.items()}
    vs_two_pass = {k: row_err(torch, *gw) for k, gw in two_pass.items()}
    # lse's NaN mask exactly, then its finite entries
    lse_err = (float((lse - ref_lse).nan_to_num(nan=0.0).abs().max())
               if torch.equal(lse.isnan(), ref_lse.isnan()) else math.inf)
    limit = TOL[tag] if row_limit is None else row_limit
    bad = [k for k, e in errs.items() if not e <= limit]
    bad += [f"{k}_vs_two_pass" for k, e in vs_two_pass.items() if not e <= limit]
    if not lse_err <= LSE_TOL[tag]:
        bad.append("lse")
    if nan_rows is not None and not torch.equal(ref_out.isnan().all(dim=-1), nan_rows):
        bad.append("plain_nan_rows")  # the case itself: its NaNs are not where planted
    bad += [f"{w}_design" for w, got in ran.items() if got != [design]]
    # bit for bit: dk/dv against the single pass on the wgmma design (None
    # on the wmma design, whose two kernels differ), dq and dk/dv against
    # their second launch
    eq = lambda a, b: same_bits(torch, a, b)  # noqa: E731
    bitwise = {"dk_equals_fused": eq(dk, fdk) if design == "wgmma" else None,
               "dv_equals_fused": eq(dv, fdv) if design == "wgmma" else None,
               "dq_repeats": eq(dq, dq2), "dk_repeats": eq(dk, dk2), "dv_repeats": eq(dv, dv2)}
    bad += [k for k, same in bitwise.items() if same is False]
    reading = {
        "case": name, "dtype": tag, "design": design, "launched": ran, "row_err": errs,
        "row_err_vs_two_pass": vs_two_pass, "bitwise": bitwise,
        "row_limit": limit, "lse_abs_err": lse_err, "lse_limit": LSE_TOL[tag], "bad": bad,
        # the global max|err| / max|plain|, for comparison only
        "global_rel_err": {k: rel_err(torch, *gw) for k, gw in pairs.items()},
    }
    if nan_rows is not None:
        reading["nan_rows_o"] = int(nan_rows.sum())
        reading["nan_elements"] = {k: int(gw[1].isnan().sum()) for k, gw in pairs.items()}
    absmax = lambda a, b: float((a.float() - b.float()).nan_to_num(nan=0.0).abs().max())  # noqa
    return reading, {
        "flash_fwd": absmax(out, ref_out),
        "flash_bwd_dq": absmax(dq, ref_dq),
        "flash_bwd_dkv": max(absmax(dk, ref_dk), absmax(dv, ref_dv)),
        "flash_bwd_fused": max(absmax(fdq, ref_fdq), absmax(fdk, ref_fdk),
                               absmax(fdv, ref_fdv)),
    }


def prologue_inputs(torch, fused, B, S, E, H, Hkv, D, dtype, bias=False, seed=0,
                    norm_offset=False, rope=None):
    """Raw residual stream, norm scale, (out, in) weights, biases and the
    rope tables (``rope``, by default LLAMA3_ROPE: llama3 scaling, theta
    500000) for the prologue on the card; ``norm_offset``: Gemma's (1 +
    scale) norm, the scale then drawn around 0."""
    rope = LLAMA3_ROPE if rope is None else rope
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape, sd=1.0: torch.randn(*shape, generator=g, device="cuda") * sd  # noqa
    x = randn(B, S, E).to(dtype)
    scale = randn(E, sd=0.1) + (0.0 if norm_offset else 1.0)
    ws = [randn(n * D, E, sd=E ** -0.5).to(dtype) for n in (H, Hkv, Hkv)]
    bs = [randn(n * D, sd=0.5).to(dtype) if bias else None for n in (H, Hkv, Hkv)]
    positions = torch.arange(S, device="cuda")[None].expand(B, S)
    inv = fused.rope_inv_freqs(D, rope["theta"], rope["scaling"], "cuda")
    cosd, sind = fused._rope_tables(positions, inv)
    statics = dict(eps=1e-5, norm_offset=norm_offset, num_heads=H, num_kv_heads=Hkv,
                   head_dim=D, dtype=dtype)
    return (x, scale, *ws, *bs, cosd.contiguous(), sind.contiguous()), statics


GUARD = -768.0  # what the prologue's guard rows hold (exact in bf16 and fp16)


def guarded_outputs(torch, B, S, widths, dtype):
    """q, k and v as (B, S, n, D) views into one buffer, each followed by 128
    rows of GUARD (a tile's rows past the end would land there); returns the
    views and the guards."""
    rows = B * S
    span = [(rows + 128) * n * d for n, d in widths]
    buf = torch.full((sum(span),), GUARD, dtype=dtype, device="cuda")
    views, guards, at = [], [], 0
    for (n, d), size in zip(widths, span):
        views.append(buf[at:at + rows * n * d].view(B, S, n, d))
        guards.append(buf[at + rows * n * d:at + size])
        at += size
    return views, guards


def check_prologue_case(torch, fused, name, **kw):
    """The prologue kernel against its plain version on the card, q, k and
    v row by row, counted under ``prologue_kernel_design``'s design alone.
    Launched again on the same inputs into outputs followed by guard rows,
    it must give the same bits (no atomics) and leave every guard as it
    was (no store past the last row). Returns the reading and the max abs
    error."""
    args, statics = prologue_inputs(torch, fused, **kw)
    before = dict(fused.qkv_prologue.by_design)
    got = fused.qkv_prologue(*args, **statics)
    want = fused._prologue_reference_tables(*args, **statics)
    ran = [d for d, n in fused.qkv_prologue.by_design.items() if n != before[d]]
    widths = [(n, kw["D"]) for n in (kw["H"], kw["Hkv"], kw["Hkv"])]
    again, guards = guarded_outputs(torch, kw["B"], kw["S"], widths, kw["dtype"])
    fused.prologue_launch(*args, *again, **statics)
    torch.cuda.synchronize()
    tag = str(kw["dtype"]).replace("torch.", "")
    design = fused.prologue_kernel_design(kw["dtype"], kw["H"], kw["Hkv"], kw["D"], kw["E"])
    errs = {n: row_err(torch, gt, w) for n, gt, w in zip("qkv", got, want)}
    bitwise = {"repeats": all(torch.equal(a, b) for a, b in zip(got, again)),
               "guards_intact": all(bool((g == GUARD).all()) for g in guards)}
    bad = [n for n, e in errs.items() if not e <= PROLOGUE_TOL[tag]]
    bad += [k for k, same in bitwise.items() if not same]
    if ran != [design]:
        bad.append("design")
    limit = 256 if design == "wgmma" else 512
    reading = {
        "case": f"prologue_{name}", "dtype": tag, "design": design, "launched": ran,
        "col_block": fused._col_block(kw["H"], kw["Hkv"], kw["D"], limit=limit),
        "row_err": errs, "row_limit": PROLOGUE_TOL[tag], "bitwise": bitwise, "bad": bad,
    }
    return reading, max(float((gt.float() - w.float()).abs().max()) for gt, w in zip(got, want))


def main_tree_shapes(cfg) -> list[tuple]:
    """The parameter shapes of the main path's CausalLM, in its order."""
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = [(E,), (q, E), (kv, E), (kv, E), (E, q), (E,), (F, E), (F, E), (E, F)]
    return [(V, E)] + layer * cfg.num_layers + [(E,), (V, E)]


def epilogue_leaf(torch, shape, seed):
    """g, p, mu, nu of one fp32 leaf, made anew from ``seed`` whenever asked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda sd: torch.randn(shape, generator=g, device="cuda") * sd  # noqa: E731
    return make(3.0), make(1.0), make(0.1), make(0.01).abs()


def check_epilogue(torch, port, fused, rep: Report) -> None:
    """The epilogue kernel BIT FOR BIT against its plain version on the main
    path's 39 leaf shapes (1.92e9 values, one launch) plus an odd-sized and
    a 0-d leaf: first held (finite = 0: nothing may change), then finite.
    The plain version runs leaf by leaf on inputs made anew from the same
    seed, so only one copy of the tree is on the card."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS)
    shapes = main_tree_shapes(cfg) + [(1000003,), ()]
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4)
    leaves = [epilogue_leaf(torch, shape, i) for i, shape in enumerate(shapes)]
    cols = [list(c) for c in zip(*leaves)]
    for finite in (False, True):
        row = fused.epilogue_scalars(hp["b1"], hp["b2"], 3, -3e-4, finite, "cuda")
        fused.adamw_epilogue(*cols, row, **hp)
        torch.cuda.synchronize()
        worst, mismatched = 0.0, []
        for i, shape in enumerate(shapes):
            want = list(epilogue_leaf(torch, shape, i))
            fused.adamw_leaf_reference(*want, row, **hp)
            for name, got, w in zip(("p", "mu", "nu"), leaves[i][1:], want[1:]):
                if not torch.equal(got, w):
                    mismatched.append(f"{name} of leaf {i} {shape}")
                    worst = max(worst, float((got - w).abs().max()))
            del want
        rep.line(f"adamw_epilogue {'finite' if finite else 'held'} over {len(shapes)} leaves, "
                 f"{sum(math.prod(s) for s in shapes)} values: "
                 f"{'bitwise' if not mismatched else f'{len(mismatched)} leaves differ'}")
        if mismatched:
            fail(f"adamw_epilogue ({'finite' if finite else 'held'}) is not bitwise its plain "
                 f"version: {mismatched[:6]}, max abs diff {worst}")
    del leaves, cols
    torch.cuda.empty_cache()


def visible_pairs(torch, S, Skv, causal) -> int:
    rows = torch.arange(S)[:, None]
    cols = torch.arange(Skv)[None, :]
    keep = cols <= rows + (Skv - S) if causal else torch.ones(S, Skv, dtype=torch.bool)
    return int(keep.sum())


def check_design_rule(fa, build, rep: Report) -> None:
    """``fa.kernel_design``, by which the wrappers count launches, against
    ``flash_design``, the rule the C launcher takes its design by, for each
    of the four kernels at every dtype and head_dim they take."""
    lib = build.bind("flash_attention", fa._SIGNATURES, "flash_error_string")
    # the launcher's Kind codes
    kinds = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2, "flash_bwd_fused": 3}
    wrong = [(w, str(dtype), D) for w, kind in kinds.items()
             for dtype, code in build.DTYPE_CODES.items() for D in range(16, 129, 16)
             if lib.flash_design(kind, code, D) != (fa.kernel_design(dtype, D) == "wgmma")]
    if wrong:
        fail(f"kernel_design and the C launcher's flash_design disagree on {wrong}")
    rep.line("kernel_design agrees with the C launcher's flash_design for the forward, dq, "
             "dk/dv and the single pass at every dtype and head_dim")


def check_prologue_design_rule(fused, build, rep: Report) -> None:
    """``fused.prologue_kernel_design``, by which the prologue wrapper counts
    launches, against ``prologue_design``, the rule the C launcher takes its
    design by, at every dtype, even head_dim from 16 to 128 and a few head
    counts and hidden sizes."""
    lib = fused._kernels()
    shapes = [(32, 8, 4096), (8, 1, 320), (14, 2, 1024), (6, 3, 512), (4, 2, 96), (8, 8, 64)]
    wrong = [(str(dtype), H, Hkv, D, E) for dtype, code in build.DTYPE_CODES.items()
             for D in range(16, 129, 2) for H, Hkv, E in shapes
             if lib.prologue_design(code, H, Hkv, D, E)
             != (fused.prologue_kernel_design(dtype, H, Hkv, D, E) == "wgmma")]
    if wrong:
        fail(f"prologue_kernel_design and the C launcher's prologue_design disagree on "
             f"{wrong[:8]}")
    rep.line("prologue_kernel_design agrees with the C launcher's prologue_design at every "
             "dtype and even head_dim 16-128")


def kernel_phase(torch, port, fa, fused, build, rep: Report,
                 check_only: bool = False) -> list[dict]:
    import torch.nn.functional as F

    check_design_rule(fa, build, rep)
    check_prologue_design_rule(fused, build, rep)
    bf16, fp16 = torch.bfloat16, torch.float16
    cases = [
        ("noncausal", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16, causal=False)),
        ("mha_g1", dict(B=2, S=200, H=4, Hkv=4, D=128, dtype=bf16)),
        ("gqa_g4", dict(B=2, S=200, H=8, Hkv=2, D=128, dtype=bf16)),
        ("window", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16, window=50)),
        # dq's 64-row kv tiles: a partial last tile, window edges inside tiles, G = 4
        ("gqa_g4_window_d64_s300", dict(B=2, S=300, H=8, Hkv=2, D=64, dtype=bf16, window=100)),
        ("window_across_128_rows", dict(B=2, S=384, H=4, Hkv=2, D=128, dtype=bf16, window=160)),
        ("kv_lengths_zero_row", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16,
                                     causal=False, lens=[0, 130])),
        ("kv_lengths_zero_row_d128", dict(B=2, S=200, H=4, Hkv=2, D=128, dtype=bf16,
                                          lens=[0, 130])),
        ("kv_longer_than_q", dict(B=2, S=64, Skv=200, H=4, Hkv=2, D=64, dtype=bf16)),
        ("q_longer_than_kv", dict(B=2, S=200, Skv=100, H=4, Hkv=2, D=64, dtype=bf16)),
        ("s129_d128", dict(B=2, S=129, H=4, Hkv=2, D=128, dtype=bf16)),
        ("s255_d64", dict(B=2, S=255, H=4, Hkv=2, D=64, dtype=bf16)),
        ("fp16", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=fp16)),
        ("fp16_d128_s255", dict(B=2, S=255, H=4, Hkv=1, D=128, dtype=fp16)),
        ("d96_wmma", dict(B=2, S=200, H=4, Hkv=2, D=96, dtype=bf16)),
        ("fp32", dict(B=2, S=100, H=4, Hkv=2, D=64, dtype=torch.float32)),
        ("fp32_window_lengths", dict(B=2, S=100, H=4, Hkv=2, D=128, dtype=torch.float32,
                                     window=30, lens=[100, 7])),
    ]
    # NaN rows (plant_nans): an all-NaN row and rows with one NaN score must
    # come out NaN as in the plain version, a fully masked row as zeros; the
    # wgmma design (bf16, head_dim 128) and the wmma design (fp32)
    for dt, d in ((bf16, 128), (torch.float32, 64)):
        for causal in (True, False):
            cases.append((f"nan_rows_{str(dt)[6:]}_d{d}_{'causal' if causal else 'noncausal'}",
                          dict(B=3, S=200, H=4, Hkv=2, D=d, dtype=dt, causal=causal,
                               lens=[200, 200, 0], nan=True)))
    cases += bert_cases(torch)
    cases.append(("main_bf16_causal", dict(**MAIN, dtype=bf16)))
    failed, reading, abs_errs = run_cases(torch, fa, cases, rep)
    main_abs_errs, main_launched = abs_errs, dict(reading["launched"])
    pro_main = dict(B=MAIN["B"], S=MAIN["S"], E=4096, H=MAIN["H"], Hkv=MAIN["Hkv"], D=MAIN["D"])
    # wgmma design: bf16/fp16 at D 64 and 128; wmma: fp32 and D 96
    prologue_cases = [
        ("bias", dict(B=1, S=256, E=512, H=8, Hkv=2, D=64, dtype=bf16, bias=True)),
        ("gqa_14_2_tile256", dict(B=1, S=128, E=1024, H=14, Hkv=2, D=128, dtype=bf16)),
        ("rows_not_filling_a_tile", dict(B=1, S=200, E=512, H=8, Hkv=4, D=64, dtype=bf16)),
        ("fp16", dict(B=1, S=256, E=512, H=8, Hkv=2, D=64, dtype=torch.float16, bias=True)),
        ("fp32", dict(B=1, S=200, E=256, H=4, Hkv=2, D=64, dtype=torch.float32, bias=True)),
        # rope's partner 32 columns away, in a 64-column tile and in a 192-column
        # tile (three 64-wide wgmmas)
        ("d64_tile64", dict(B=1, S=256, E=512, H=4, Hkv=1, D=64, dtype=bf16)),
        ("d64_tile192", dict(B=1, S=256, E=512, H=6, Hkv=3, D=64, dtype=bf16, bias=True)),
        ("tile128_h8_hkv1", dict(B=1, S=256, E=512, H=8, Hkv=1, D=128, dtype=bf16)),
        # rows that fill no 128-row tile, and rows past a tile edge
        ("rows_s200", dict(B=1, S=200, E=512, H=8, Hkv=2, D=128, dtype=bf16)),
        ("rows_s300", dict(B=1, S=300, E=1024, H=32, Hkv=8, D=128, dtype=bf16)),
        # E not a multiple of the ring's depth x 64; E of one k-step
        ("e320", dict(B=1, S=256, E=320, H=8, Hkv=2, D=64, dtype=bf16)),
        ("e64_s130", dict(B=1, S=130, E=64, H=4, Hkv=2, D=64, dtype=torch.float16)),
        ("bias_d128", dict(B=2, S=128, E=512, H=8, Hkv=2, D=128, dtype=bf16, bias=True)),
        ("d96_wmma", dict(B=1, S=200, E=512, H=8, Hkv=2, D=96, dtype=bf16, bias=True)),
        ("main_bf16", dict(**pro_main, dtype=bf16)),
    ]
    for name, kw in prologue_cases:
        reading, pro_abs_err = check_prologue_case(torch, fused, name, **kw)
        rep.line(json.dumps(reading))
        if reading["bad"]:
            failed.append(f"prologue {name}: {reading['bad']}")
    main_abs_errs["qkv_prologue"] = pro_abs_err
    main_launched["qkv_prologue"] = reading["launched"]
    # no fallback: a CUDA tensor a kernel does not take is refused, never
    # routed to the plain version
    q, k, v, _ = make_inputs(torch, 1, 64, 2, 1, 64, bf16)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    d40 = tuple(x[..., :40].contiguous() for x in (q, k, v))  # head_dim not a multiple of 16
    pargs, pstat = prologue_inputs(torch, fused, B=1, S=64, E=256, H=4, Hkv=2, D=40, dtype=bf16)
    leaf = [torch.ones(8, device="cuda") for _ in range(4)]
    refusals = (
        ("forward: strided q", lambda: fa.flash_fwd(strided, k, v, 0.125, True)),
        ("forward: head_dim 40", lambda: fa.flash_fwd(*d40, 0.125, True)),
        ("dq: strided q", lambda: fa.flash_bwd_dq(
            strided, k, v, q, *(torch.zeros(1, 2, 64, device="cuda"),) * 2, 0.125)),
        ("dk/dv: head_dim 40", lambda: fa.flash_bwd_dkv(
            *d40, d40[0], *(torch.zeros(1, 2, 64, device="cuda"),) * 2, 0.125)),
        ("single-pass backward: strided q", lambda: fa.flash_bwd_fused(
            strided, k, v, q, *(torch.zeros(1, 2, 64, device="cuda"),) * 2, 0.125)),
        ("prologue: head_dim 40 (an 80-column tile)", lambda: fused.qkv_prologue(*pargs,
                                                                                 **pstat)),
        ("epilogue: a bf16 leaf", lambda: fused.adamw_epilogue(
            [leaf[0].to(bf16)], [leaf[1]], [leaf[2]], [leaf[3]],
            fused.epilogue_scalars(0.9, 0.999, 1, -1e-3, True, "cuda"), b1=0.9, b2=0.999,
            eps=1e-8, eps_root=0.0, weight_decay=1e-4)),
    )
    for name, call in refusals:
        try:
            call()
        except ValueError:
            continue
        fail(f"a kernel wrapper took an input its kernel does not: {name}")
    rep.line(f"kernel wrappers refuse: {'; '.join(n for n, _ in refusals)}")
    if failed:
        fail(f"kernel outputs beyond tolerance: {'; '.join(failed)}")
    check_epilogue(torch, port, fused, rep)
    main_abs_errs["adamw_epilogue"] = 0.0  # bitwise, or the check failed
    if check_only:
        return []

    # times at the main path's shape
    B, S, H, Hkv, D = (MAIN[k] for k in ("B", "S", "H", "Hkv", "D"))
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, bf16, seed=1)
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = fa.attention_delta(out, dout)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB of L2
    flush = scratch.zero_
    kernel_fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                      lambda: fa.flash_fwd_reference(q, k, v, scale, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale, True)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale,
                                                             True)),
        "flash_bwd_fused": (lambda: fa.flash_bwd_fused(q, k, v, dout, lse, delta, scale, True),
                            lambda: fa.flash_bwd_fused_reference(q, k, v, dout, lse, delta,
                                                                 scale, True)),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    library_bwd = time_library_bwd(torch, q, k, v, dout, scale, flush, rep)
    library = {"flash_fwd": library_fwd, "flash_bwd_fused": library_bwd}

    pairs = visible_pairs(torch, S, S, True) * B * H
    e = 2  # bytes per bf16 element
    qo = B * S * H * D * e  # q, o, do or dq
    kv = B * S * Hkv * D * e  # k, v, dk or dv
    stat = B * H * S * 4  # lse or delta
    work = {  # (FLOP, bytes, peak FLOP/s): each input read once, each output written once
        "flash_fwd": (2 * 2 * D * pairs, qo + 2 * kv + qo + stat, PEAK_BF16_FLOPS),
        "flash_bwd_dq": (3 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo, PEAK_BF16_FLOPS),
        "flash_bwd_dkv": (4 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + 2 * kv,
                          PEAK_BF16_FLOPS),
        "flash_bwd_fused": (5 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo + 2 * kv,
                            PEAK_BF16_FLOPS),
    }

    # the prologue at the main path's shape
    pargs, pstat = prologue_inputs(torch, fused, **pro_main, dtype=bf16, seed=2)
    kernel_fns["qkv_prologue"] = (lambda: fused.qkv_prologue(*pargs, **pstat),
                                  lambda: fused._prologue_reference_tables(*pargs, **pstat))
    rows_, E = B * S, pro_main["E"]
    W = (H + 2 * Hkv) * D
    work["qkv_prologue"] = (2 * rows_ * E * W,
                            rows_ * E * e + W * E * e + E * 4 + 2 * rows_ * D * 4 + rows_ * W * e,
                            PEAK_BF16_FLOPS)
    xn = fused.rms_norm_reference(pargs[0], pargs[1], eps=1e-5, norm_offset=False)
    wcat = torch.cat(pargs[2:5])
    linear_ms = time_ms(torch, lambda: F.linear(xn, wcat), 20, flush)
    del xn, wcat

    rows = []
    for wrapper, (kernel_name, _, _, design) in KERNELS.items():
        if wrapper == "adamw_epilogue":
            continue
        kfn, pfn = kernel_fns[wrapper]
        ms = time_ms(torch, kfn, 20, flush)
        plain_ms = time_ms(torch, pfn, 5, flush)
        design = design or "+".join(main_launched[wrapper])
        rows.append(kernel_row(wrapper, design, ms, plain_ms, *work[wrapper],
                               main_abs_errs[wrapper], library.get(wrapper)))
        rep.line(f"{kernel_name} at the main shape (bf16): {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                 f"bound {rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']}, "
                 f"{work[wrapper][0] / ms / 1e9:.1f} TFLOP/s)")
    del pargs
    rep.line(f"yardstick for qkv_prologue_kernel: F.linear of the pre-normed bf16 x "
             f"({rows_}, {E}) against the concatenated ({W}, {E}) weight (cuBLAS alone, no "
             f"norm, bias or rope) {linear_ms:.4f} ms")

    # dq + dk/dv against the single pass and PyTorch's flash backward op (a
    # yardstick: no single PyTorch call computes dq alone or dk/dv alone)
    def two_pass_bwd():
        fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True)
        fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True)

    two_pass_ms = time_ms(torch, two_pass_bwd, 20, flush)
    rep.line(f"flash_bwd_dq_kernel + flash_bwd_dkv_kernel at the main shape (bf16): "
             f"{two_pass_ms:.4f} ms, {(3 + 4) * 2 * D * pairs / two_pass_ms / 1e9:.1f} TFLOP/s; "
             f"yardstick: PyTorch's flash backward op {library_bwd:.4f} ms (all of dq, dk, dv, "
             f"no GQA sum)")

    # the backward as a whole against SDPA's (a yardstick: no single
    # PyTorch call computes dq alone, dk/dv alone or the single pass)
    qg, kg, vg = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    dout_t = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o, (qg, kg, vg), dout_t)

    def port_fwd_bwd():
        o, l = fa.flash_fwd(q, k, v, scale, True)
        d = fa.attention_delta(o, dout)
        fa.flash_bwd_dq(q, k, v, dout, l, d, scale, True)
        fa.flash_bwd_dkv(q, k, v, dout, l, d, scale, True)

    def port_fwd_fused_bwd():
        o, l = fa.flash_fwd(q, k, v, scale, True)
        fa.flash_bwd_fused(q, k, v, dout, l, fa.attention_delta(o, dout), scale, True)

    rep.line(f"fwd+bwd at {MAIN}: port kernels {time_ms(torch, port_fwd_bwd, 10, flush):.4f} ms, "
             f"with the single-pass backward {time_ms(torch, port_fwd_fused_bwd, 10, flush):.4f} "
             f"ms, F.scaled_dot_product_attention {time_ms(torch, sdpa_fwd_bwd, 10, flush):.4f} "
             "ms (yardstick only)")
    del q, k, v, dout, out, lse, delta, qg, kg, vg, dout_t
    rows.append(time_epilogue(torch, port, fused, rep, flush, main_abs_errs["adamw_epilogue"]))
    return rows


def time_library_bwd(torch, q, k, v, dout, scale, flush, rep: Report, shape="the main shape"):
    """One call of PyTorch's flash-attention backward op at the main shape:
    B4's library time. It is fed the output, logsumexp and philox values of
    its own forward op, with k and v expanded to the query heads (the op
    takes no GQA); it returns dq, dk and dv per query head, so the GQA sum
    that B4 also does is not in it."""
    G = q.shape[2] // k.shape[2]
    qt, dt = q.transpose(1, 2), dout.transpose(1, 2)
    ke, ve = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(qt, ke, ve, 0.0, True, False,
                                                             scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    ms = time_ms(torch, lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dt, qt, ke, ve, out, lse, cum_q, cum_k, max_q, max_k, 0.0, True, seed, offset,
        scale=scale), 20, flush)
    rep.line(f"library for flash_bwd_fused_kernel: "
             f"torch.ops.aten._scaled_dot_product_flash_attention_backward at {shape} "
             f"(k, v expanded to {q.shape[2]} heads) {ms:.4f} ms")
    return ms


def time_sdpa_bwd(torch, q, k, v, dout, scale, flush, rep: Report, shape: str) -> float:
    """One call of SDPA's backward through autograd (``torch.autograd.grad``
    on a kept graph) at ``shape``: the library yardstick where the flash
    backward op does not take the dtype (fp32). k and v are expanded to
    the query heads first, so the GQA sum is not in it."""
    import torch.nn.functional as F

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    ke, ve = (x.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_(True)
              for x in (k, v))
    out = F.scaled_dot_product_attention(qt, ke, ve, is_causal=True, scale=scale)
    dt = dout.transpose(1, 2)
    ms = time_ms(torch, lambda: torch.autograd.grad(out, (qt, ke, ve), dt, retain_graph=True),
                 20, flush)
    rep.line(f"library for B2 + B3: SDPA's backward through autograd at {shape} "
             f"({q.dtype}, k, v expanded to {q.shape[2]} heads) {ms:.4f} ms")
    return ms


def kernel_row(wrapper, design, ms, plain_ms, flops, nbytes, peak, max_abs_err,
               library_ms) -> dict:
    kernel_name, replaces, source, _ = KERNELS[wrapper]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {
        "name": kernel_name, "route": "cuda", "design": design, "source": source,
        "replaces": replaces,
        "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def time_epilogue(torch, port, fused, rep: Report, flush, max_abs_err) -> dict:
    """The epilogue kernel, its plain version and the library call
    ``torch._fused_adamw_`` over the main path's 39 leaves. PyTorch's fused
    AdamW (with eps_root 0, as here) computes the same update, p (1 - lr wd)
    - (lr / bc1) mu' / (sqrt(nu') / sqrt(bc2) + eps), and its ``found_inf``
    holds a non-finite step; only the rounding order differs from optax's,
    so it is not bitwise the plain version and the port cannot call it."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS)
    shapes = main_tree_shapes(cfg)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4)
    cols = [list(c) for c in zip(*(epilogue_leaf(torch, s, i) for i, s in enumerate(shapes)))]
    row = fused.epilogue_scalars(hp["b1"], hp["b2"], 3, -3e-4, True, "cuda")
    ms = time_ms(torch, lambda: fused.adamw_epilogue(*cols, row, **hp), 5, flush)

    def plain():
        for leaf in zip(*cols):
            fused.adamw_leaf_reference(*leaf, row, **hp)

    plain_ms = time_ms(torch, plain, 3, flush)
    g, p, mu, nu = cols
    steps = [torch.full((), 3.0, device="cuda") for _ in p]
    found_inf = torch.zeros((), device="cuda")
    library_ms = time_ms(torch, lambda: torch._fused_adamw_(
        p, g, mu, nu, [], steps, lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=1e-4, eps=1e-8,
        amsgrad=False, maximize=False, found_inf=found_inf), 5, flush)
    n = sum(math.prod(s) for s in shapes)
    del cols, g, p, mu, nu
    torch.cuda.empty_cache()
    # 28 B per value: read g, p, mu, nu, write p, mu, nu; ~15 fp32 operations each
    out = kernel_row("adamw_epilogue", KERNELS["adamw_epilogue"][3], ms, plain_ms, 15 * n,
                     28 * n, PEAK_FP32_FLOPS, max_abs_err, library_ms)
    rep.line(f"adamw_kernel over the main path's {len(shapes)} leaves ({n} values, one launch): "
             f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms by "
             f"{out['bound_by']}, {28 * n / ms / 1e6:.1f} GB/s); library "
             f"torch._fused_adamw_ over the same tensors {library_ms:.4f} ms")
    return out


def small_model_phase(torch, port, rep: Report) -> None:
    """A tiny CausalLM forced through the flash kernels on the card in fp32
    against the same weights on the CPU's plain path."""
    cfg = port.TransformerConfig.tiny(vocab_size=512, hidden_size=128, num_heads=4,
                                      num_kv_heads=2, attention_impl="flash")
    cpu_model = port.CausalLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    gpu_model = port.CausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(1))
    results = []
    for model, device in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        params = dict(model.named_parameters())
        loss = port.CausalLM.loss_fn(model)(params, {"input_ids": ids.to(device)})
        grads = torch.autograd.grad(loss, list(params.values()))
        results.append((float(loss.detach()), [g.cpu() for g in grads]))
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
    grad_err = max(rel_err(torch, g, c) for g, c in zip(gpu_grads, cpu_grads))
    rep.line(f"small model fp32 flash kernels vs CPU plain path: loss {gpu_loss:.6f} vs "
             f"{cpu_loss:.6f}, max grad rel err {grad_err:.3g}")
    if not (abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss) and grad_err <= 1e-4):
        fail("small model: the card's kernels disagree with the CPU plain path")


def small_fused_phase(torch, port, fa, fused, rep: Report, seed: int) -> None:
    """A tiny fused_kernels=True CausalLM with fused_adamw and the
    single-pass backward, 3 unified_steps in fp32 on the card (prologue,
    flash forward, single-pass backward and epilogue kernels) against the
    same weights and batches, made from ``seed``, on the CPU's plain path."""
    cfg = port.TransformerConfig.tiny(vocab_size=512, hidden_size=128, num_heads=4,
                                      num_kv_heads=2, attention_impl="flash",
                                      fused_kernels=True)
    init = port.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    ids = torch.randint(0, cfg.vocab_size, (3, 2, 96),
                        generator=torch.Generator().manual_seed(seed + 1)).numpy()
    dataset = [{"input_ids": ids[i // 2][i % 2]} for i in range(6)]
    runs = {}
    wrappers = (*fa.KERNEL_WRAPPERS, *fused.KERNEL_WRAPPERS)
    fa.FUSED_BWD = True
    try:
        for device in ("cpu", "cuda"):
            port.AcceleratorState._reset_state(reset_partial_state=True)
            port.GradientState._reset_state()
            acc = port.Accelerator(cpu=device == "cpu")
            model = port.CausalLM(cfg, device=device)
            model.load_state_dict(init.state_dict())
            model, opt, loader = acc.prepare(model, port.fused_adamw(1e-3),
                                             port.DataLoader(dataset, batch_size=2))
            step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
            carry = acc.init_carry(model, opt)
            reset_counts(wrappers)
            curve = []
            for batch in loader:
                carry, m = step(carry, batch)
                curve.append((float(m["loss"]), float(m["grad_norm"])))
            launches = {w.__name__: w.launches for w in wrappers}
            runs[device] = (curve, {k: t.detach().cpu() for k, t in carry["params"].items()},
                            launches)
    finally:
        fa.FUSED_BWD = False
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
    (cpu_curve, cpu_params, _), (gpu_curve, gpu_params, launches) = runs["cpu"], runs["cuda"]
    curve_err = max(abs(a - b) / abs(b) for ga, gb in zip(gpu_curve, cpu_curve)
                    for a, b in zip(ga, gb))
    # AdamW divides each moment by its root: an element whose gradient is
    # near zero moves by up to lr on a last-bit difference in the gradient,
    # so neither the largest element error nor a small leaf's error says
    # much (final_norm's 128 values read 2.6e-3 of their update on a correct
    # card). A wrong kernel moves many elements; the error's norm over the
    # update's norm, over the whole tree, sees that.
    init_params = init.state_dict()
    diff = math.sqrt(sum(float((gpu_params[k] - cpu_params[k]).square().sum())
                         for k in cpu_params))
    update = math.sqrt(sum(float((cpu_params[k] - init_params[k]).square().sum())
                           for k in cpu_params))
    update_err = diff / (update + 1e-30)
    leaf_err = {k: float((gpu_params[k] - cpu_params[k]).norm()
                         / ((cpu_params[k] - init_params[k]).norm() + 1e-30)) for k in cpu_params}
    worst = max(leaf_err, key=leaf_err.get)
    param_err = max(rel_err(torch, gpu_params[k], cpu_params[k]) for k in cpu_params)
    rep.line(f"small fused model fp32, seed {seed}, 3 steps: losses/grad norms card "
             f"{gpu_curve} vs CPU {cpu_curve} (max rel err {curve_err:.3g}); final params: "
             f"|card - CPU| / |CPU update| {update_err:.3g} over the tree, at most "
             f"{leaf_err[worst]:.3g} in one leaf ({worst}), max element error over the "
             f"tensor's max {param_err:.3g}; card launches {json.dumps(launches)}")
    want = {"flash_fwd": 6, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_fused": 6,
            "qkv_prologue": 6, "adamw_epilogue": 3}  # 2 layers x 3 steps; one epilogue a step
    if launches != want:
        fail(f"small fused model launches {launches}, want {want}")
    if not (len(gpu_curve) == 3 and curve_err <= 1e-4 and update_err <= SMALL_UPDATE_TOL):
        fail(f"small fused model (seed {seed}): the card's kernels disagree with the CPU "
             f"plain path: losses/grad norms {curve_err:.3g} (limit 1e-4), params "
             f"{update_err:.3g} of the update (limit {SMALL_UPDATE_TOL})")


def reset_counts(wrappers) -> None:
    """Every launch counter to 0, the flash wrappers' per-design ones too."""
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "by_design"):
            w.by_design = dict.fromkeys(w.by_design, 0)


@contextmanager
def nccl_group_of_one(port):
    """The launcher's environment for a group of one (NCCL on the card) set
    while inside; on the way out the group is ended, the singletons reset
    and the environment cleared."""
    import torch

    from accelerate_tpu_torch.launchers import _free_port

    os.environ.update({"ACCELERATE_TPU_NUM_PROCESSES": "1", "ACCELERATE_TPU_PROCESS_ID": "0",
                       "ACCELERATE_TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}"})
    try:
        yield
    finally:
        if port.AcceleratorState._shared_state:
            port.AcceleratorState().partial_state.destroy_process_group()
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        for key in ("NUM_PROCESSES", "PROCESS_ID", "COORDINATOR_ADDRESS"):
            os.environ.pop("ACCELERATE_TPU_" + key, None)
        gc.collect()
        torch.cuda.empty_cache()


def fresh_accelerator(torch, port, plugin=None, **kw):
    """A fresh bf16 Accelerator under ``plugin`` (None: none), what earlier
    runs cached handed back first."""
    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    return port.Accelerator(mixed_precision="bf16", parallelism_plugin=plugin, **kw)


def main_model(torch, port, acc, seed: int = 0, fused_kernels: bool = False):
    """The main path's 4-layer llama3_8b-width CausalLM in bf16 on the card,
    its weights from ``seed``."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS, dtype="bfloat16",
                                           max_seq_len=MAIN["S"], fused_kernels=fused_kernels)
    return cfg, port.CausalLM(cfg, device=acc.device,
                              generator=torch.Generator(device=acc.device).manual_seed(seed))


def build_path(torch, port, fused_kernels: bool, fused_optimizer: bool, seed: int = 0,
               plugin=None, accum: int = 1):
    """The 4-layer llama3_8b-width CausalLM in bf16 (``fused_kernels`` as
    given) with ``fused_adamw`` or ``adamw`` (lr 3e-4) and global-norm
    clipping at 1.0, its weights and one batch of synthetic tokens made
    from ``seed``; the batch repeats every step, so the loss must fall.
    ``plugin``: the Accelerator's ``ParallelismPlugin``; ``accum``: its
    gradient accumulation steps (unfused). Returns the step, its carry, the
    loader and the parameter count."""
    acc = fresh_accelerator(torch, port, plugin, gradient_accumulation_steps=accum)
    cfg, model = main_model(torch, port, acc, seed, fused_kernels=fused_kernels)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (MAIN["B"], MAIN["S"]),
                           generator=torch.Generator().manual_seed(seed)).numpy()
    dataset = [{"input_ids": tokens[i % MAIN["B"]]} for i in range(STEPS * MAIN["B"])]
    if [tuple(p.shape) for p in model.parameters()] != main_tree_shapes(cfg):
        fail("the path's parameter shapes are not main_tree_shapes'")
    optimizer = (port.fused_adamw if fused_optimizer else port.adamw)(3e-4)
    model, opt, loader = acc.prepare(model, optimizer,
                                     port.DataLoader(dataset, batch_size=MAIN["B"]))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    torch.cuda.synchronize()
    return step, carry, loader, n_params


def run_steps(torch, step, carry, loader):
    """Every batch of ``loader`` through ``step``. Returns the carry, the
    last batch, the losses, the grad norms and each step's seconds (host
    clock around the step, ending in a synchronise)."""
    losses, norms, times = [], [], []
    for batch in loader:
        t0 = time.perf_counter()
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return carry, batch, losses, norms, times


def main_path_phase(torch, port, wrappers, rep: Report, fused_path: bool = False):
    """The main path (``fused_path`` False: unfused model, adamw, two-pass
    backward) or the fused path (``fused_kernels=True``, ``fused_adamw``,
    ``FUSED_BWD``), trained for STEPS steps with every launch counter in
    ``wrappers`` set to 0 just before and read just after. Returns the
    counts and the losses."""
    name = "fused path" if fused_path else "main path"
    t0 = time.perf_counter()
    step, carry, loader, n_params = build_path(torch, port, fused_path, fused_path)
    rep.line(f"{name} set-up: {n_params} params ({NUM_LAYERS} layers at llama3_8b "
             f"width), {time.perf_counter() - t0:.2f} s")

    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, batch, losses, norms, times = run_steps(torch, step, carry, loader)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    peak = torch.cuda.max_memory_allocated()

    steady = statistics.median(times[1:])  # the first step pays one-time set-up
    tokens_per_step = MAIN["B"] * MAIN["S"]
    rep.line(f"{name} losses {losses}, grad norms {norms}")
    rep.line(f"{name} step seconds {times}; median of steps 2-{STEPS} {steady} s, "
             f"{tokens_per_step / steady} tokens/s; peak memory {peak / 2**30} GiB")
    rep.line(f"{name} kernel launches {json.dumps(launches)}, by design {json.dumps(by_design)}")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{name} losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name} loss did not fall on a repeated batch: {losses}")
    if carry["opt_step"] != STEPS:
        fail(f"{name} took {carry['opt_step']} optimizer steps, not {STEPS}")
    per_layer = NUM_LAYERS * STEPS
    if fused_path:  # one epilogue launch a step, over every leaf
        want = {"flash_fwd": per_layer, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_bwd_fused": per_layer, "qkv_prologue": per_layer, "adamw_epilogue": STEPS}
    else:
        want = {"flash_fwd": per_layer, "flash_bwd_dq": per_layer, "flash_bwd_dkv": per_layer,
                "flash_bwd_fused": 0, "qkv_prologue": 0, "adamw_epilogue": 0}
    if launches != want:
        fail(f"{name} kernel launches {launches}, want {want}")
    # every flash kernel counted under the wgmma design only
    want_design = {w: {"wgmma": want[w], "wmma": 0} for w in by_design}
    if by_design != want_design:
        fail(f"{name} launches by design {by_design}, want {want_design}")
    ran = profile_step(torch, step, carry, batch, rep, name)
    # the profiler names the kernels that ran: the wgmma ones, no wmma twin
    want_ran = {KERNELS[w][0] for w, n in want.items() if n}
    if want["qkv_prologue"]:  # the wgmma design's pre-pass
        want_ran.add("qkv_prologue_rstd_kernel")
    if ran is None:
        rep.line(f"{name} profiled step: kernel names not checked (no device time seen)")
    elif ran != want_ran:
        fail(f"{name} profiled step ran the port's kernels {sorted(ran)}, want {sorted(want_ran)}")
    return launches, losses


def check_path_losses(losses, fused_losses, rep: Report) -> None:
    """The fused path computes the main path's step with other kernels and
    other summation orders: its loss curve stays within PATH_LOSS_TOL of
    the main path's, step by step."""
    rel = [abs(f - m) / abs(m) for f, m in zip(fused_losses, losses)]
    rep.line(f"fused path against main path: relative loss difference by step {rel}, "
             f"limits {list(PATH_LOSS_TOL)}")
    if len(rel) != len(PATH_LOSS_TOL) or any(not r <= lim for r, lim in zip(rel, PATH_LOSS_TOL)):
        fail(f"the fused path's losses {fused_losses} left the main path's {losses}: "
             f"relative differences {rel}, limits {list(PATH_LOSS_TOL)}")


def profile_step(torch, step, carry, batch, rep: Report, name: str,
                 readings: dict | None = None):
    """One more step of the path (after its counts were read) under
    torch.profiler: device time by kernel group, the optimizer epilogue's
    device range, and the device's busy share of the step's wall time (the
    profiler's own cost included; written to ``readings["busy"]`` when
    ``readings`` is given). Returns the names of the port's kernels that
    ran, or None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(carry, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, epilogue_ms = {}, None
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key == "unified_step.sync_apply":  # the range on the device
            epilogue_ms = evt.device_time_total / 1e3
        else:
            kernels[evt.key] = evt.self_device_time_total / 1e3
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        rep.line(f"{name} profiled step: the profiler saw no device time (not measured)")
        return None
    groups = {"flash attention kernels": 0.0, "prologue kernel": 0.0, "epilogue kernel": 0.0,
              "matmul (cuBLAS)": 0.0, "other": 0.0}
    for key, ms in kernels.items():
        if "flash_" in key and "_kernel" in key:
            groups["flash attention kernels"] += ms
        elif "qkv_prologue" in key and "_kernel" in key:  # the pre-pass too
            groups["prologue kernel"] += ms
        elif "adamw_kernel" in key:
            groups["epilogue kernel"] += ms
        elif any(t in key.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["matmul (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    if readings is not None:
        readings["busy"] = busy_ms / wall_ms
    rep.line(f"{name} profiled step: wall {wall_ms} ms, device busy {busy_ms} ms "
             f"({100 * busy_ms / wall_ms} %), by kernel group ms {json.dumps(groups)}, "
             f"optimizer epilogue (unified_step.sync_apply) {epilogue_ms} ms on the device")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        rep.line(f"{name} profiled step: {ms} ms {key[:110]}")
    return {m.group(1) for key in kernels
            for m in [re.search(r"\b((?:flash|qkv|adamw)\w*_kernel)\b", key)] if m}


def bert_cases(torch) -> list:
    dtypes = (torch.bfloat16, torch.float16)
    return [(name, dict(kw, dtype=dt)) for (name, kw), dt in zip(BERT_CASES, dtypes)]


def run_cases(torch, fa, cases, rep: Report):
    """Every flash case through ``check_case``, each reading printed.
    Returns the failures and the last case's reading and max abs errors."""
    failed = []
    for name, kw in cases:  # every case runs; the caller fails after the last
        reading, abs_errs = check_case(torch, fa, name, **kw)
        rep.line(json.dumps(reading))
        if reading["bad"]:
            failed.append(f"{name}: {reading['bad']}")
    return failed, reading, abs_errs


def bert_lengths(B: int, S: int, seed: int):
    """Right-padding lengths drawn from [64, S], seeded; the first is S."""
    import numpy as np

    lens = np.random.default_rng(seed).integers(64, S + 1, size=B)
    lens[0] = S
    return lens


def time_bert_kernels(torch, fa, rep: Report) -> list[dict]:
    """B1-B3 at the BERT phase's shape (B 32, S 512, 12 heads, head_dim 64,
    bf16, non-causal, seeded right-padding lengths): each output's max abs
    error against the plain version on these inputs, and the times of
    kernel, plain version and, for B1, SDPA with the (B, 1, 1, S) key mask.
    Bounds count the visible pairs (every query row against its row's real
    keys) and read k and v up to each row's length."""
    import torch.nn.functional as F

    B, S, H, D = (BERT[k] for k in ("B", "S", "H", "D"))
    lens = bert_lengths(B, S, seed=3)
    q, k, v, dout = make_inputs(torch, B, S, H, H, D, torch.bfloat16, seed=3)
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    args = (scale, False, kvl)
    out, lse = fa.flash_fwd(q, k, v, *args)
    delta = fa.attention_delta(out, dout)
    absmax = lambda a, b: float((a.float() - b.float()).abs().max())  # noqa: E731
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, *args)
    abs_errs = {
        "flash_fwd": absmax(out, ref_out),
        "flash_bwd_dq": absmax(fa.flash_bwd_dq(q, k, v, dout, lse, delta, *args),
                               fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, *args)),
        "flash_bwd_dkv": max(absmax(a, b) for a, b in zip(
            fa.flash_bwd_dkv(q, k, v, dout, lse, delta, *args),
            fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, *args))),
    }
    del ref_out, ref_lse
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB of L2
    flush = scratch.zero_
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args),
                      lambda: fa.flash_fwd_reference(q, k, v, *args)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, *args),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, *args)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, *args),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, *args)),
    }
    keep = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep), 20, flush)
    pairs = int(lens.sum()) * S * H
    e = 2
    qo, kv_full = B * S * H * D * e, B * S * H * D * e
    kv_real, stat = int(lens.sum()) * H * D * e, B * H * S * 4
    work = {  # (FLOP, bytes): inputs read once (k, v up to each length), outputs written once
        "flash_fwd": (2 * 2 * D * pairs, qo + 2 * kv_real + qo + stat),
        "flash_bwd_dq": (3 * 2 * D * pairs, 2 * qo + 2 * kv_real + 2 * stat + qo),
        "flash_bwd_dkv": (4 * 2 * D * pairs, 2 * qo + 2 * kv_real + 2 * stat + 2 * kv_full),
    }
    rows = []
    for wrapper, (kfn, pfn) in fns.items():
        ms = time_ms(torch, kfn, 20, flush)
        plain_ms = time_ms(torch, pfn, 3, flush)
        row = kernel_row(wrapper, fa.kernel_design(torch.bfloat16, D), ms, plain_ms,
                         *work[wrapper], PEAK_BF16_FLOPS, abs_errs[wrapper],
                         library_fwd if wrapper == "flash_fwd" else None)
        row["shape"] = (f"bert_base B{B} S{S} H{H} Hkv{H} D{D} bf16 non-causal, kv_lengths "
                        f"{int(lens.min())}-{int(lens.max())} (mean {float(lens.mean())})")
        rows.append(row)
        rep.line(f"{KERNELS[wrapper][0]} at the BERT shape: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                 f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                 f"{work[wrapper][0] / ms / 1e9:.1f} TFLOP/s of visible pairs)")
    rep.line(f"library for flash_fwd_kernel at the BERT shape: F.scaled_dot_product_attention "
             f"with the (B, 1, 1, S) key mask {library_fwd:.4f} ms")

    qg, kg, vg = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    dout_t = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        torch.autograd.grad(o, (qg, kg, vg), dout_t)

    def port_fwd_bwd():
        o, l = fa.flash_fwd(q, k, v, *args)
        d = fa.attention_delta(o, dout)
        fa.flash_bwd_dq(q, k, v, dout, l, d, *args)
        fa.flash_bwd_dkv(q, k, v, dout, l, d, *args)

    rep.line(f"fwd+bwd at the BERT shape: port kernels {time_ms(torch, port_fwd_bwd, 10, flush):.4f} "
             f"ms, F.scaled_dot_product_attention with the key mask "
             f"{time_ms(torch, sdpa_fwd_bwd, 10, flush):.4f} ms (yardstick only)")
    # B2 + B3's yardstick: the backward alone of SDPA with the same key mask
    # (the memory-efficient backward), on the output of one forward
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(o, (qg, kg, vg), dout_t,
                                                          retain_graph=True), 20, flush)

    def two_pass():
        fa.flash_bwd_dq(q, k, v, dout, lse, delta, *args)
        fa.flash_bwd_dkv(q, k, v, dout, lse, delta, *args)

    rep.line(f"at the BERT shape: B2 + B3 {time_ms(torch, two_pass, 20, flush):.4f} ms against "
             f"the library's backward of F.scaled_dot_product_attention with the key mask "
             f"{sdpa_bwd:.4f} ms (all of dq, dk, dv)")
    del o
    return rows


def bert_rows(n: int, vocab: int, seed: int) -> list[dict]:
    """Right-padded rows of the classifier's batch keys, seeded: lengths in
    [64, S] with the first row at S, ids past a row's length 0."""
    import numpy as np

    S = BERT["S"]
    lens = bert_lengths(n, S, seed)
    rng = np.random.default_rng(seed + 1)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(4, vocab, size=(n, S)).astype(np.int32) * mask
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    return [{"input_ids": ids[i], "attention_mask": mask[i], "labels": labels[i]}
            for i in range(n)]


def bert_trainer(torch, port, seed: int, fused_kernels: bool = False):
    """bert_base at full width and depth (``fused_kernels``: each layer's
    norm -> q/k/v -> rope through B5), bf16 compute with fp32 masters,
    adamw with the examples' warmup-cosine schedule and weight decay 0.01,
    clip 1.0; a shuffled torch loader of the training rows and an eval
    loader whose size is not a multiple of its batch."""
    from torch.utils.data import DataLoader as TorchLoader

    from accelerate_tpu_torch.examples.nlp_example import collate_fn

    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision="bf16")
    cfg = port.TransformerConfig.bert_base(dtype="bfloat16", fused_kernels=fused_kernels)
    model = port.SequenceClassifier(cfg, num_labels=2, device=acc.device,
                                    generator=torch.Generator(acc.device).manual_seed(seed))
    B = BERT["B"]
    train = TorchLoader(bert_rows(BERT["steps"] * B, cfg.vocab_size, seed=11), batch_size=B,
                        shuffle=True, collate_fn=collate_fn)
    evals = TorchLoader(bert_rows(BERT["eval_rows"], cfg.vocab_size, seed=12),
                        batch_size=BERT["eval_batch"], shuffle=False, collate_fn=collate_fn)
    schedule = port.warmup_cosine_decay_schedule(0.0, 2e-4, 2, BERT["steps"])
    model, opt, train, evals = acc.prepare(model, port.adamw(schedule, weight_decay=0.01),
                                           train, evals)
    step = acc.unified_step(port.SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    return acc, model, opt, train, evals, step, acc.init_carry(model, opt)


def train_bert(torch, step, carry, loader, n: int):
    """At most ``n`` batches of ``loader`` through ``step``: the carry, the
    losses, each step's seconds (host clock ending in a synchronise), the
    real tokens (the attention mask's sum) of each batch, the last batch
    and the grad norms."""
    losses, times, real, norms = [], [], [], []
    for i, batch in enumerate(loader):
        if i == n:
            break
        t0 = time.perf_counter()
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        real.append(int(batch["attention_mask"].sum()))
        last = batch
    return carry, losses, times, real, last, norms


def bert_phase(torch, port, wrappers, rep: Report) -> tuple[dict, dict]:
    """The BERT path: bert_base (12 layers, 768 wide, 12 heads of 64) at
    B 32, S 512, where auto-dispatch itself takes B1-B3 (non-causal, the
    mask lowered to kv_lengths): 6 unified_steps and one eval pass, with
    every launch counter set to 0 just before and read just after; then the
    resume: 3 steps, save_state, a fresh accelerator and a model from
    another seed, load_state, skip_first_batches(3), 3 steps, which must
    equal the uninterrupted run bit for bit. Returns the launch counts and
    the readings phase 23 (b) takes as its unfused run (the same seed, data
    and steps): losses, grad norms, median step seconds, peak bytes and the
    profiled step's busy share."""
    import tempfile

    B, S, steps = BERT["B"], BERT["S"], BERT["steps"]
    t0 = time.perf_counter()
    acc, model, opt, train, evals, step, carry = bert_trainer(torch, port, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    rep.line(f"bert phase set-up: {n_params} params (bert_base: 12 layers, hidden 768, 12 heads "
             f"of 64), {time.perf_counter() - t0:.2f} s")
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, losses, times, real, batch, norms = train_bert(torch, step, carry, train, steps)
    peak = torch.cuda.max_memory_allocated()
    correct = total = 0
    with torch.no_grad():
        for batch in evals:
            pred = model(batch["input_ids"], batch["attention_mask"]).argmax(dim=-1)
            pred, ref = acc.gather_for_metrics((pred, batch["labels"]))
            correct += int((pred == ref).sum())
            total += int(ref.shape[0])
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}

    steady = statistics.median(times[1:])
    real_per_step = statistics.mean(real[1:])
    rep.line(f"bert phase losses {losses}")
    rep.line(f"bert phase step seconds {times}; median of steps 2-{steps} {steady} s, "
             f"{B * S / steady} tokens/s padded (B*S), {real_per_step / steady} tokens/s real "
             f"(mask sum, {real_per_step} a step); peak memory {peak / 2**30} GiB")
    rep.line(f"bert phase eval: {total} rows gathered of {BERT['eval_rows']} (batch "
             f"{BERT['eval_batch']}), accuracy {correct / max(total, 1)}")
    rep.line(f"bert phase kernel launches {json.dumps(launches)}, by design {json.dumps(by_design)}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"bert phase losses not finite: {losses}")
    if carry["opt_step"] != steps:
        fail(f"bert phase took {carry['opt_step']} optimizer steps, not {steps}")
    if total != BERT["eval_rows"]:
        fail(f"bert phase: gather_for_metrics returned {total} rows, not {BERT['eval_rows']}")
    n_eval = math.ceil(BERT["eval_rows"] / BERT["eval_batch"])
    layers = model.config.num_layers
    want = {"flash_fwd": layers * (steps + n_eval), "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps, "flash_bwd_fused": 0, "qkv_prologue": 0,
            "adamw_epilogue": 0}
    if launches != want:
        fail(f"bert phase kernel launches {launches}, want {want}")
    want_design = {w: {"wgmma": want[w], "wmma": 0} for w in by_design}
    if by_design != want_design:
        fail(f"bert phase launches by design {by_design}, want {want_design}")
    straight = {k: t.detach().clone() for k, t in carry["params"].items()}
    # one more step under the profiler (after the counts were read): the
    # port's kernels in it must be B1-B3's wgmma ones
    readings = {"losses": losses, "norms": norms, "step_s": steady, "peak": peak, "busy": None}
    ran = profile_step(torch, step, carry, batch, rep, "bert phase", readings)
    want_ran = {KERNELS[w][0] for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if ran is not None and ran != want_ran:
        fail(f"bert phase profiled step ran the port's kernels {sorted(ran)}, want "
             f"{sorted(want_ran)}")
    del acc, model, opt, train, evals, step, carry

    with tempfile.TemporaryDirectory() as tmp:
        acc, _, _, train, _, step, carry = bert_trainer(torch, port, seed=0)
        carry, first, *_ = train_bert(torch, step, carry, train, 3)
        t0 = time.perf_counter()
        out = acc.save_state(os.path.join(tmp, "step_3"), carry=carry)
        save_s = time.perf_counter() - t0
        del acc, train, step, carry
        acc, model, _, train, _, step, carry = bert_trainer(torch, port, seed=1)
        t0 = time.perf_counter()
        carry = acc.load_state(out, carry=carry)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        carry, rest, *_ = train_bert(torch, step, carry, acc.skip_first_batches(train, 3), 3)
    diffs = {k: float((carry["params"][k].detach() - t).abs().max()) for k, t in straight.items()}
    unequal = [k for k, t in straight.items() if not torch.equal(carry["params"][k].detach(), t)]
    rep.line(f"bert resume: save_state {save_s} s, load_state {load_s} s, {size} bytes; losses "
             f"of steps 4-6 resumed {rest} vs straight {losses[3:]}; params bitwise equal "
             f"{len(straight) - len(unequal)} of {len(straight)}, largest difference "
             f"{max(diffs.values())}")
    if first != losses[:3] or rest != losses[3:] or unequal:
        fail(f"bert resume is not bit for bit the uninterrupted run: losses {first + rest} vs "
             f"{losses}, {len(unequal)} params differ ({unequal[:4]}), largest "
             f"{max(diffs.values())}")
    del acc, model, train, step, carry, straight
    return launches, readings


def example_phase(torch, port, wrappers, rep: Report) -> None:
    """``accelerate_tpu_torch/examples/checkpointing.py``'s training function
    at bert_base width, bf16, one epoch (its config's ``num_epochs``; the
    example reads ``TESTING_NUM_EPOCHS`` only with its tiny model) over
    1/EXAMPLE_ROWS_CUT of its dataset's rows (the epoch is host-bound; the
    whole script's time), ``--checkpointing_steps epoch``: step time and
    tokens/s from the train step's calls, the epoch's accuracy; then
    ``epoch_0`` loaded into a fresh accelerator and a model from another
    seed must give the same accuracy. At S 128 both packages take plain
    attention: B1-B3 launch 0 times."""
    import argparse
    import tempfile

    from accelerate_tpu_torch.examples import checkpointing as example
    from accelerate_tpu_torch.examples import nlp_example

    stamps, real = [], []

    class TimedAccelerator(port.Accelerator):
        """Stamps the host clock as each train step is called (the queue of
        launches holds the host back to the card's pace)."""

        def unified_step(self, *a, **kw):
            step = super().unified_step(*a, **kw)

            def timed(carry, batch):
                stamps.append(time.perf_counter())
                real.append(batch["attention_mask"].sum())
                return step(carry, batch)

            return timed

    config = {"lr": 2e-4, "num_epochs": 1, "seed": 42, "batch_size": 16}
    make_dataset = nlp_example.make_paraphrase_dataset
    nlp_example.make_paraphrase_dataset = (  # train and eval sets alike
        lambda n, **kw: make_dataset(n // EXAMPLE_ROWS_CUT, **kw))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            args = argparse.Namespace(cpu=False, mixed_precision="bf16",
                                      gradient_accumulation_steps=1, checkpointing_steps="epoch",
                                      output_dir=tmp, resume_from_checkpoint=None)
            gc.collect()
            torch.cuda.empty_cache()
            port.AcceleratorState._reset_state(reset_partial_state=True)
            port.GradientState._reset_state()
            reset_counts(wrappers)
            example.Accelerator = TimedAccelerator
            try:
                t0 = time.perf_counter()
                metric = example.training_function(config, args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                example.Accelerator = port.Accelerator
            launches = {w.__name__: w.launches for w in wrappers}
            gaps = [b - a for a, b in zip(stamps[10:], stamps[11:])]
            step_s = statistics.median(gaps)
            real_per_step = float(torch.stack(real).float().mean())
            rep.line(f"example checkpointing.py (bert_base, bf16, B 16, S 128, 1 epoch of "
                     f"1/{EXAMPLE_ROWS_CUT} of the rows): "
                     f"{len(stamps)} steps, {wall} s in all (data, set-up, the epoch, eval, "
                     f"save_state), train steps {stamps[-1] - stamps[0]} s from first to last "
                     f"call, step {step_s} s (median gap between calls after the 10th), "
                     f"{16 * 128 / step_s} tokens/s padded, {real_per_step / step_s} tokens/s "
                     f"real; accuracy {metric['accuracy']}; launches {json.dumps(launches)}")
            flash = {w: n for w, n in launches.items() if w.startswith("flash_")}
            if any(flash.values()):
                fail(f"example: the flash kernels launched at S 128: {flash}")

            port.AcceleratorState._reset_state(reset_partial_state=True)
            port.GradientState._reset_state()
            acc = port.Accelerator(mixed_precision="bf16")
            model, cfg = nlp_example.model_and_config(acc, seed=7)
            train, evals = nlp_example.get_dataloaders(acc, config["batch_size"], cfg)
            model, opt, train, evals = acc.prepare(
                model, port.adamw(2e-4, weight_decay=0.01), train, evals)
            carry = acc.load_state(os.path.join(tmp, "epoch_0"),
                                   carry=acc.init_carry(model, opt))
            again = nlp_example.evaluate(acc, model, evals)
            rep.line(f"example epoch_0 loaded into a fresh accelerator: accuracy "
                     f"{again['accuracy']} (trained {metric['accuracy']}), opt_step "
                     f"{carry['opt_step']}")
            if again != metric:
                fail(f"example: epoch_0 re-evaluates to {again}, the epoch gave {metric}")
            # one step of the example's shape under the profiler: device busy share
            step = acc.unified_step(port.SequenceClassifier.loss_fn(model), opt,
                                    max_grad_norm=1.0)
            ran = profile_step(torch, step, carry, next(iter(train)), rep, "example")
            if ran:
                fail(f"example profiled step ran the port's kernels {sorted(ran)}, want none")
            del acc, model, opt, train, evals, carry, step
    finally:
        nlp_example.make_paraphrase_dataset = make_dataset


def decode_model(torch, port, seed: int = 0):
    """The ``decode`` config at full width and depth, built on the meta
    device and given bf16 weights on the card from a seeded generator: std
    0.02 for matrices and 1 for vectors, as ``benchmarks/measure.py:430-437``
    makes them, with no fp32 copy."""
    cfg = port.TransformerConfig(**DECODE_CFG)
    model = port.CausalLM(cfg, device="meta", generator=torch.Generator())
    g = torch.Generator(CARD).manual_seed(seed)
    model.load_state_dict({
        name: torch.empty(p.shape, dtype=torch.bfloat16, device=CARD).normal_(
            0.0, 0.02 if p.ndim > 1 else 1.0, generator=g)
        for name, p in model.named_parameters()}, assign=True)
    return model.requires_grad_(False)


def serve_trace(vocab: int, max_seq_len: int):
    """The long-tailed request trace exactly as ``measure.py:_run_serve``
    (:626-638) draws it: prompts of 4-64 tokens, a quarter of the requests
    with 32-64 new tokens and the rest with 4-8."""
    import numpy as np

    rng = np.random.default_rng(SERVE["seed"])
    max_prompt = max(8, min(max_seq_len // 4, 64))
    long_new = min(64, max_seq_len - max_prompt)
    trace = []
    for _ in range(SERVE["n_requests"]):
        p = int(rng.integers(4, max_prompt + 1))
        if rng.random() < 0.25:
            n = int(rng.integers(long_new // 2, long_new + 1))
        else:
            n = int(rng.integers(4, 9))
        trace.append((rng.integers(0, vocab, p).astype(np.int64), n))
    return trace


def profile_call(torch, fn, rep: Report, name: str) -> None:
    """``fn()`` once under torch.profiler: wall time (host clock, ending in a
    synchronise), device busy time (every CUDA kernel's self time) and their
    share, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {evt.key: evt.self_device_time_total / 1e3 for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA}
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        rep.line(f"{name} profiled: the profiler saw no device time (busy share not measured)")
        return
    matmul_ms = sum(ms for key, ms in kernels.items()
                    if any(t in key.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")))
    rep.line(f"{name} profiled: wall {wall_ms} ms, device busy {busy_ms} ms "
             f"({100 * busy_ms / wall_ms} %): matmul (cuBLAS) {matmul_ms} ms, the other "
             f"{len(kernels)} kernel names {busy_ms - matmul_ms} ms")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        rep.line(f"{name} profiled: {ms} ms {key[:110]}")


def replay_ms(torch, program, n: int = 20) -> float:
    """Device time of one replay of a built step: CUDA events around ``n``
    replays queued back to back, so no host time sits between them."""
    program()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        program()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def replay_against_eager(torch, run_step, state, steps: int):
    """``run_step(eager, prev_logits) -> logits`` ``steps`` times by graph
    replay and again by the eager step, from the same copy of the ``state``
    tensors (caches and input buffers, written in place). Returns whether the logits of every
    step and the final state are equal bit for bit, and the largest
    difference."""
    start = [t.clone() for t in state]
    runs = []
    for eager in (False, True):
        for t, s in zip(state, start):
            t.copy_(s)
        logits, prev = [], None
        for _ in range(steps):
            prev = run_step(eager, prev).clone()
            logits.append(prev)
        runs.append((logits, [t.clone() for t in state]))
    (graph_logits, graph_state), (eager_logits, eager_state) = runs
    pairs = list(zip(graph_logits, eager_logits)) + list(zip(graph_state, eager_state))
    equal = all(torch.equal(a, b) for a, b in pairs)
    worst = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    return equal, worst


def small_serving_check(torch, port, rep: Report) -> None:
    """A 2-layer fp32 model of the tiny widths: greedy tokens through the
    engine and ``generate`` on the card and through both on the CPU must be
    the same (paged against dense, card against CPU)."""
    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.serving import ServingEngine

    cfg = port.TransformerConfig.tiny(num_layers=2, max_seq_len=64, dtype="float32")
    cpu = port.CausalLM(cfg, device="cpu")
    card_model = port.CausalLM(cfg, device=CARD)
    card_model.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    outs = {}
    for length in (5, 13, 29):
        ids = torch.randint(0, cfg.vocab_size, (2, length), generator=g)
        for where, model in (("card", card_model), ("cpu", cpu)):
            engine = ServingEngine(model, max_slots=2, block_size=8)
            outs.setdefault(f"{where} engine", []).append(
                engine.generate(ids, max_new_tokens=12).cpu())
            outs.setdefault(f"{where} generate", []).append(
                generate(model, ids, max_new_tokens=12).cpu())
    want = outs["cpu generate"]
    same = {name: all(torch.equal(a, b) for a, b in zip(got, want)) for name, got in outs.items()}
    rep.line(f"serve small fp32 model (2 layers, tiny widths): greedy tokens equal to the CPU's "
             f"generate {json.dumps(same)}")
    if not all(same.values()):
        fail(f"serve small model: greedy tokens differ from the CPU's generate: {same}")
    # prefix caching: a 3-block template, its cohort cold and warm (the
    # last prompt is the template itself: a full-prompt hit and its copy)
    template = torch.randint(1, cfg.vocab_size, (24,), generator=g).tolist()
    prompts = [template + [7, 8, 9], template + [5], template]
    runs = {}
    for where, model in (("card", card_model), ("cpu", cpu)):
        for warm in (False, True):
            engine = ServingEngine(model, max_slots=2, block_size=8, prefix_cache=warm)
            runs[f"{where} {'warm' if warm else 'cold'}"] = [
                engine.generate([p], max_new_tokens=10)[0].tolist() for p in prompts]
            if warm and where == "card":
                stats = engine.prefix_cache.stats()
    same = {name: got == runs["cpu cold"] for name, got in runs.items()}
    rep.line(f"serve small fp32 model, prefix cache: greedy tokens of 3 templated prompts equal "
             f"to the CPU's cold engine {json.dumps(same)}; card warm hits {stats['hits']}, "
             f"saved {stats['prefill_tokens_saved_total']} tokens, copies "
             f"{stats['cow_copies_total']}")
    if not all(same.values()) or stats["hits"] != 2 or stats["cow_copies_total"] != 1:
        fail(f"serve small model: prefix caching changed tokens or missed: {same}, {stats}")


def paged_against_dense(torch, model, trace, rep: Report) -> None:
    """First-token logits of each trace prompt from a paged prefill (bucket
    padded, through a scattered block table) and from a dense prefill of
    the whole prompt, held by the worst row's max error over its RMS."""
    from accelerate_tpu_torch.models.generation import init_cache
    from accelerate_tpu_torch.ops.attention import PagedKVState

    bs = SERVE["block_size"]
    width = -(-model.config.max_seq_len // bs)
    pools = init_cache(model, num_blocks=9, block_size=bs)
    errs = []
    with torch.no_grad():
        for prompt, _ in trace:
            p = len(prompt)
            bucket = 1 << (p - 1).bit_length()
            ids = torch.zeros((1, bucket), dtype=torch.long, device=CARD)
            ids[0, :p] = torch.from_numpy(prompt)
            table = torch.zeros((1, width), dtype=torch.long, device=CARD)
            table[0, :4] = torch.tensor([7, 2, 5, 3])  # 64 tokens at most
            state = PagedKVState(table, torch.zeros(1, dtype=torch.long, device=CARD),
                                 torch.tensor([p], device=CARD), num_blocks=9, block_size=bs)
            paged = model(ids, decode=True, paged=state, cache=pools)[0, p - 1].float()
            dense = model(ids[:, :p], decode=True, cache=init_cache(model, 1))[0, -1].float()
            rms = dense.square().mean().sqrt()
            errs.append(float((paged - dense).abs().max() / rms))
    rep.line(f"serve paged against dense prefill (bf16, {len(trace)} prompts of "
             f"{[len(p) for p, _ in trace]} tokens): first-token logits max error over RMS "
             f"{errs}, largest {max(errs)}, limit {SERVE_PREFILL_TOL}")
    if not max(errs) <= SERVE_PREFILL_TOL:
        fail(f"serve: paged prefill left dense prefill: {max(errs)} > {SERVE_PREFILL_TOL}")


def build_decode_model(torch, port, rep: Report):
    """The ``decode`` config's model, built once for phases 8 and 12."""
    t0 = time.perf_counter()
    model = decode_model(torch, port)
    torch.cuda.synchronize()
    rep.line(f"decode model set-up: decode config (registry.py:289-297), "
             f"{sum(p.numel() for p in model.parameters())} params, "
             f"{sum(p.nbytes for p in model.parameters())} bytes of bf16 weights, "
             f"{time.perf_counter() - t0:.2f} s")
    return model


def serve_phase(torch, port, wrappers, rep: Report, model) -> None:
    """The serving path on the ``decode`` config (``model``, from
    ``build_decode_model``): see phase 8 in the module docstring. Every
    launch counter is set to 0 before and read after."""
    import numpy as np

    from accelerate_tpu_torch.models.generation import generate, make_generate_fn
    from accelerate_tpu_torch.serving import ServingEngine

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts(wrappers)
    small_serving_check(torch, port, rep)
    cfg = model.config
    weights = sum(p.nbytes for p in model.parameters())
    bound_ms = weights / PEAK_BYTES * 1e3
    trace = serve_trace(cfg.vocab_size, cfg.max_seq_len)
    paged_against_dense(torch, model, trace, rep)

    # generate: B 1, prompt 128, 64 new tokens (registry.py:318)
    B, P, N, reps = 1, SERVE["prompt"], SERVE["new_tokens"], SERVE["reps"]
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)))
    gen = make_generate_fn(model, max_new_tokens=N)
    timings = {}
    for name, call in (("make_generate_fn (decode as one CUDA graph)", lambda: gen(ids)),
                       ("generate (eager)", lambda: generate(model, ids, max_new_tokens=N))):
        if name.startswith("make"):  # warm: builds and captures (the eager loop builds nothing)
            call()[:, -1].cpu()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = call()
            out[:, -1].cpu()
        s_tok = (time.perf_counter() - t0) / (reps * N)
        timings[name] = s_tok
        rep.line(f"serve {name}: B {B}, prompt {P}, {N} new tokens, {reps} reps: {s_tok} s/token "
                 f"({1e3 * s_tok / bound_ms} x the weights-read bound {bound_ms} ms); peak memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    if gen.trace_counts()["decode"] != 1:
        fail(f"serve: make_generate_fn built its decode step {gen.trace_counts()} times")
    cache, token, program = gen.decode_programs[B]
    token.copy_(out[:, -1:].to(token.device))
    profile_call(torch, lambda: program().argmax(-1), rep, "serve make_generate_fn decode step")
    cache.index.fill_(P)
    rep.line(f"serve make_generate_fn decode step, replays back to back (B {B}, cache index "
             f"{P}): {replay_ms(torch, program)} ms each on the device")

    def dense_step(eager, prev):
        if prev is not None:
            token.copy_(prev.argmax(-1)[:, None])
        return program.fn() if eager else program()

    equal, worst = replay_against_eager(torch, dense_step,
                                        [cache.key, cache.value, cache.index, token],
                                        SERVE["graph_steps"])
    rep.line(f"serve make_generate_fn: {SERVE['graph_steps']} decode steps by graph replay "
             f"against the eager step: bit for bit {equal} (largest difference {worst})")
    if not equal:
        fail("serve: make_generate_fn's graph replay is not its eager step bit for bit")
    del gen, cache, token, program

    # the engine over the trace: warm run, timed run
    engine = ServingEngine(model, max_slots=SERVE["max_slots"], block_size=SERVE["block_size"])
    engine.cache.key.fill_(SENTINEL)
    engine.cache.value.fill_(SENTINEL)
    held = set()
    allocate = engine.pool.allocate

    def recorded(n):
        blocks = allocate(n)
        held.update(blocks)
        return blocks

    engine.pool.allocate = recorded
    useful = sum(n for _, n in trace)

    def run_engine():
        rids = [engine.add_request(p, max_new_tokens=n) for p, n in trace]
        for _ in engine.stream():
            pass
        torch.cuda.synchronize()
        return [engine.result(r) for r in rids]

    warm = run_engine()
    warm_counts = engine.trace_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed = run_engine()
    engine_s = time.perf_counter() - t0
    engine_peak = torch.cuda.max_memory_allocated()
    counts = engine.trace_counts()
    headline = engine.summary()  # the SLO objectives come from its p95s
    engine_tps = useful / engine_s
    rep.line(f"serve engine: {len(trace)} requests (prompts {[len(p) for p, _ in trace]}, new "
             f"tokens {[n for _, n in trace]}), {useful} useful new tokens in {engine_s} s: "
             f"{engine_tps} tokens/s; peak memory {engine_peak / 2**30} GiB; kv_bytes_per_token "
             f"{engine.kv_bytes_per_token}; pool {engine.num_blocks} blocks of "
             f"{engine.block_size}; builds after warm {warm_counts}, after timed {counts}")
    if warm_counts["decode"] != 1 or warm_counts["prefill"] > math.log2(cfg.max_seq_len):
        fail(f"serve: after the warm run the engine's builds are {warm_counts}")
    if counts != warm_counts:
        fail(f"serve: the timed run rebuilt programs: {warm_counts} -> {counts}")
    if timed != warm or [len(t) for t in timed] != [n for _, n in trace]:
        fail("serve: the trace's tokens changed between its warm and timed runs")
    unused = sorted(set(range(1, engine.num_blocks)) - held)
    kept = all(bool((pool[:, unused] == SENTINEL).all())
               for pool in (engine.cache.key, engine.cache.value))
    rep.line(f"serve garbage routing: {len(held)} blocks held by a table, the other "
             f"{len(unused)} (block 0 aside) still all sentinel: {kept}")
    if not unused or not kept:
        fail("serve: a block no table held was written")
    engine.pool.allocate = allocate

    # one profiled step() in steady decode: 4 seated slots, no admission
    long = [engine.add_request(p, max_new_tokens=48) for p, _ in trace[:SERVE["max_slots"]]]
    engine.step()
    engine.step()
    profile_call(torch, engine.step, rep, "serve engine step (4 slots decoding)")
    for _ in engine.stream():
        pass
    if any(len(engine.result(r)) != 48 for r in long):
        fail("serve: the profiled requests did not finish")

    # graph replay against the eager step: 4 slots at mixed depths
    prompts = [np.arange(n) % cfg.vocab_size for n in (5, 23, 40, 64)]
    for p in prompts:
        engine.add_request(p, max_new_tokens=64)
    engine.step()  # seats all four: prefill and one decode step
    slots = engine.scheduler.slots
    pending = np.asarray([[s.pending] for s in slots], np.int64)
    start_lens = np.asarray([s.cache_len for s in slots], np.int64)
    ones = np.ones(len(slots), np.int64)
    step_no = [0]

    def engine_step(eager, prev):
        step_no[0] = 0 if prev is None else step_no[0] + 1
        tokens = pending if prev is None else prev.argmax(-1)[:, None].cpu().numpy()
        return engine._decode_logits(tokens, start_lens + step_no[0], ones, eager=eager)

    equal, worst = replay_against_eager(torch, engine_step, [engine.cache.key, engine.cache.value],
                                        SERVE["graph_steps"])
    rep.line(f"serve engine: {SERVE['graph_steps']} decode steps of 4 slots at cache lengths "
             f"{start_lens.tolist()} by graph replay against the eager step: bit for bit {equal} "
             f"(largest difference {worst}); decode builds {engine.trace_counts()['decode']}")
    if not equal:
        fail("serve: the engine's graph replay is not its eager step bit for bit")
    if engine.trace_counts()["decode"] != 1:
        fail(f"serve: the engine's decode step was built {engine.trace_counts()} times")
    rep.line(f"serve engine decode step, replays back to back (4 slots): "
             f"{replay_ms(torch, engine._decode_program)} ms each on the device")
    for _ in engine.stream():  # the four requests of the replay check finish
        pass

    # the reference's baseline: run-to-completion fixed batches of max_slots,
    # each padded to its longest prompt and decoded to its largest budget
    slots_n = SERVE["max_slots"]
    chunks = [trace[i:i + slots_n] for i in range(0, len(trace), slots_n)]
    fns = {}

    def run_baseline():
        for chunk in chunks:
            rows = list(chunk) + [chunk[0]] * (slots_n - len(chunk))
            p_max = max(len(p) for p, _ in rows)
            n_max = max(n for _, n in rows)
            fn = fns.setdefault(n_max, make_generate_fn(model, max_new_tokens=n_max))
            batch = np.zeros((slots_n, p_max), np.int64)
            for j, (p, _) in enumerate(rows):
                batch[j, :len(p)] = p
            fn(torch.from_numpy(batch))[:, -1].cpu()

    run_baseline()
    t0 = time.perf_counter()
    run_baseline()
    baseline_s = time.perf_counter() - t0
    baseline_tps = useful / baseline_s
    rep.line(f"serve baseline (fixed batches of {slots_n} through make_generate_fn): {useful} "
             f"useful new tokens in {baseline_s} s: {baseline_tps} tokens/s; engine against "
             f"baseline {engine_tps / baseline_tps}")
    del fns
    observability_ab(torch, engine, run_engine, headline, timed, rep)
    prefix_ab(torch, engine, model, rep)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    speculation_ab(torch, port, rep)
    launches = {w.__name__: w.launches for w in wrappers}
    rep.line(f"serve kernel launches of the port {json.dumps(launches)}")
    if any(launches.values()):
        fail(f"serve: kernels of the port launched on the serving path: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    rep.line(f"serve phase: {time.perf_counter() - phase_t0} s")


def observability_ab(torch, engine, run_engine, headline: dict, want, rep: Report) -> None:
    """``measure.py:705-756`` on the warm engine: the trace with the
    observability plane off and on, OBS_ROUNDS interleaved rounds; the SLO
    objectives are the headline pass's p95s x 1.5."""
    from accelerate_tpu_torch.serving import SLOConfig, SloTracker
    from accelerate_tpu_torch.telemetry import PrometheusTextSink, StepTelemetry

    tracker = SloTracker(SLOConfig(
        ttft_objective_s=(headline.get("ttft_s_p95") or 0.5) * 1.5,
        e2e_objective_s=(headline.get("e2e_s_p95") or 5.0) * 1.5, target=0.99,
        interval_steps=16))
    tele = StepTelemetry(True)
    prom = tele.add_sink(PrometheusTextSink(path=None))
    walls = {"off": [], "on": []}
    for _ in range(OBS_ROUNDS):
        for arm in ("off", "on"):
            if arm == "off":
                engine.set_observability(telemetry=None, gauge_interval=0, slo=None, spans=False)
            else:
                engine.set_observability(telemetry=tele, gauge_interval=1, slo=tracker, spans=True)
            t0 = time.perf_counter()
            outs = run_engine()
            walls[arm].append(time.perf_counter() - t0)
            if outs != want:
                fail(f"serve observability {arm}: the trace's tokens changed")
    deltas = [on - off for on, off in zip(walls["on"], walls["off"])]
    overhead = statistics.median(deltas) / statistics.median(walls["off"]) * 100.0
    snap = tracker.snapshot()
    text = prom.render()
    kinds = sorted({r["kind"] for r in tele.records})
    tele.close()
    engine.set_observability(telemetry=None, gauge_interval=0, slo=None, spans=False)
    rep.line(f"serve observability A/B ({OBS_ROUNDS} interleaved rounds of the trace): walls off "
             f"{walls['off']} s, on {walls['on']} s; overhead (median on - off over median off) "
             f"{overhead} %; record kinds {kinds}; scrape text {len(text)} bytes")
    rep.line(f"serve SLO snapshot: {json.dumps(snap)}")
    builds = engine.trace_counts()
    if builds["decode"] != 1:
        fail(f"serve observability: the decode step was built {builds} times")
    if "accelerate_tpu_serve_queue_depth" not in text or "accelerate_tpu_slo_" not in text:
        fail("serve observability: the scrape text lacks the serve_gauge or slo lines")


def templated_cohort(vocab: int, block_size: int, max_seq_len: int):
    """``measure.py:771-793``: a template of whole blocks, capped at 24, and
    PREFIX_COHORT prompts of the template and an 8-token unique suffix; the
    seed prompt is the template and its first token again."""
    import numpy as np

    suffix_len = max(2, block_size // 2)
    blocks = max(4, min(24, (max_seq_len - suffix_len - PREFIX_NEW - 4) // block_size))
    rng = np.random.default_rng(SERVE["seed"] + 1)
    template = rng.integers(0, vocab, blocks * block_size)
    prompts = [np.concatenate([template, rng.integers(0, vocab, suffix_len)])
               for _ in range(PREFIX_COHORT)]
    return template, prompts, np.concatenate([template, template[:1]])


def prefix_first_logits(torch, model, template, prompts, seed_prompt, rep: Report):
    """First-token logits of each cohort prompt in bf16, cold (the whole
    prompt prefilled at its bucket) against warm (the seed prompt prefilled
    at its bucket, then the prompt's tail at cache position len(template)
    over the template's blocks): the worst row's max error over its RMS, a
    prompt each, for the tail at its own bucket (the engine's call) and for
    the tail padded to the cold call's bucket (the same GEMM shapes as cold,
    so any difference would be the path's, not rounding's). The engine's
    prefills, on pools of their own; one cold and one warm call profiled."""
    from accelerate_tpu_torch.models.generation import init_cache
    from accelerate_tpu_torch.ops.attention import PagedKVState

    bs = SERVE["block_size"]
    width = -(-model.config.max_seq_len // bs)
    n_tmpl = len(template) // bs
    need = -(-len(prompts[0]) // bs)
    pools = init_cache(model, num_blocks=1 + 2 * need + 1, block_size=bs)
    warm_blocks = list(range(1, need + 1))  # template blocks, then the tail's
    cold_blocks = list(range(need + 1, 2 * need + 1))
    spare = 2 * need + 1  # the seed prompt's partial block
    cold_bucket = 1 << (len(prompts[0]) - 1).bit_length()

    def prefill(tokens, blocks, cache_len, bucket=None):
        n = len(tokens)
        bucket = bucket or 1 << (n - 1).bit_length()
        ids = torch.zeros((1, bucket), dtype=torch.long, device=CARD)
        ids[0, :n] = torch.as_tensor(tokens)
        table = torch.zeros((1, width), dtype=torch.long, device=CARD)
        table[0, :len(blocks)] = torch.as_tensor(blocks)
        state = PagedKVState(table, torch.full((1,), cache_len, device=CARD),
                             torch.full((1,), n, device=CARD), num_blocks=pools.key.shape[1],
                             block_size=bs)
        return model(ids, decode=True, paged=state, cache=pools)[0, n - 1].float()

    def err(got, want):
        return float((got - want).abs().max() / want.square().mean().sqrt())

    errs, same_bucket = [], []
    with torch.no_grad():
        prefill(seed_prompt, warm_blocks[:n_tmpl] + [spare], 0)
        for prompt in prompts:
            cold = prefill(prompt, cold_blocks, 0)
            tail = prompt[len(template):]
            same_bucket.append(err(prefill(tail, warm_blocks, len(template), cold_bucket), cold))
            errs.append(err(prefill(tail, warm_blocks, len(template)), cold))
        prompt = prompts[0]
        profile_call(torch, lambda: prefill(prompt, cold_blocks, 0).argmax(), rep,
                     f"serve prefix cold prefill ({len(prompt)} tokens, bucket {cold_bucket})")
        tail = prompt[len(template):]
        profile_call(torch, lambda: prefill(tail, warm_blocks, len(template)).argmax(), rep,
                     f"serve prefix warm prefill ({len(tail)} tokens at cache position "
                     f"{len(template)})")
    return errs, same_bucket


def prefix_ab(torch, engine, model, rep: Report) -> None:
    """``measure.py:758-856`` on the warm engine: the templated cohort, one
    request at a time, cold (caching off) and warm (the template published
    by one seed request); both arms' prefill buckets built before the timed
    passes."""
    from accelerate_tpu_torch.serving.telemetry import ServeStats

    cfg = model.config
    template, prompts, seed_prompt = templated_cohort(cfg.vocab_size, engine.block_size,
                                                      cfg.max_seq_len)

    def run_cohort():
        outs = []
        for prompt in prompts:
            rid = engine.add_request(prompt, max_new_tokens=PREFIX_NEW)
            for _ in engine.stream():
                pass
            outs.append(engine.result(rid))
        torch.cuda.synchronize()
        return outs

    def seed_cache():
        engine.add_request(seed_prompt, max_new_tokens=1)
        for _ in engine.stream():
            pass

    engine.set_prefix_cache(False)
    run_cohort()
    engine.set_prefix_cache(True)
    seed_cache()
    run_cohort()
    warm_builds = engine.trace_counts()
    arms = {}
    for arm in ("cold", "warm"):
        engine.set_prefix_cache(arm == "warm")
        if arm == "warm":
            seed_cache()
            saved_before = engine.prefix_cache.tokens_saved_total
        engine.stats = ServeStats()
        t0 = time.perf_counter()
        outs = run_cohort()
        wall = time.perf_counter() - t0
        arms[arm] = (outs, wall, engine.stats.summary())
    saved = engine.prefix_cache.tokens_saved_total - saved_before
    stats = engine.prefix_cache.stats()
    engine.set_prefix_cache(False)
    builds = engine.trace_counts()
    errs, same_bucket = prefix_first_logits(torch, model, template, prompts, seed_prompt, rep)
    (cold_out, cold_s, cold_sum), (warm_out, warm_s, warm_sum) = arms["cold"], arms["warm"]
    matched = sum(a == b for a, b in zip(cold_out, warm_out))
    rep.line(f"serve prefix A/B: template {len(template)} tokens ({len(template) // 16} blocks), "
             f"{len(prompts)} prompts of {len(prompts[0])} tokens, {PREFIX_NEW} new tokens each, "
             f"one at a time: cold wall {cold_s} s, TTFT p50 {cold_sum['ttft_s_p50']} s, p95 "
             f"{cold_sum['ttft_s_p95']} s; warm wall {warm_s} s, TTFT p50 "
             f"{warm_sum['ttft_s_p50']} s, p95 {warm_sum['ttft_s_p95']} s; cold over warm TTFT "
             f"p50 {cold_sum['ttft_s_p50'] / warm_sum['ttft_s_p50']}")
    rep.line(f"serve prefix A/B: tokens saved {saved} (want {len(prompts) * len(template)}), "
             f"hit rate {stats['hit_rate']}, hits {stats['hits']} of {stats['lookups']} lookups, "
             f"copies {stats['cow_copies_total']}; builds after the warm-up {warm_builds}, after "
             f"the arms {builds}; greedy outputs equal warm and cold {matched} of {len(prompts)}")
    rep.line(f"serve prefix first-token logits, warm against cold (bf16): max error over RMS "
             f"{errs}, largest {max(errs)}, limit {PREFIX_LOGITS_TOL}; the tail padded to the "
             f"cold bucket {same_bucket}, largest {max(same_bucket)}, limit {SERVE_PREFILL_TOL}")
    if saved != len(prompts) * len(template):
        fail(f"serve prefix: {saved} prefill tokens saved, want {len(prompts) * len(template)}")
    if builds != warm_builds:
        fail(f"serve prefix: the timed arms built programs: {warm_builds} -> {builds}")
    if not max(errs) <= PREFIX_LOGITS_TOL:
        fail(f"serve prefix: warm logits left cold: {max(errs)} > {PREFIX_LOGITS_TOL}")
    if not max(same_bucket) <= SERVE_PREFILL_TOL:
        fail(f"serve prefix: warm logits at the cold bucket left cold: {max(same_bucket)} > "
             f"{SERVE_PREFILL_TOL}")


def spec_models(torch, port):
    """The reference's self-consistent pair at the ``decode`` config in fp32
    (``measure.py:867-892``): the target's layers >= 1 have o_proj and
    down_proj at zero, so they add exact zeros, and the 1-layer draft holds
    the target's layer 0, embedding, final norm and head (the same
    tensors)."""
    cfg = port.TransformerConfig(**{**DECODE_CFG, "dtype": "float32"})
    target = port.CausalLM(cfg, device="meta", generator=torch.Generator())
    g = torch.Generator(CARD).manual_seed(SERVE["seed"])
    weights = {}
    for name, p in target.named_parameters():
        w = torch.empty(p.shape, dtype=torch.float32, device=CARD)
        layer = int(name.split(".")[1]) if name.startswith("layers.") else 0
        if layer >= 1 and name.endswith(("o_proj.weight", "down_proj.weight")):
            w.zero_()
        else:
            w.normal_(0.0, 0.02 if p.ndim > 1 else 1.0, generator=g)
        weights[name] = w
    target.load_state_dict(weights, assign=True)
    draft = port.CausalLM(port.TransformerConfig(**{**DECODE_CFG, "dtype": "float32",
                                                    "num_layers": 1}),
                          device="meta", generator=torch.Generator())
    draft.load_state_dict({name: weights[name] for name, _ in draft.named_parameters()},
                          assign=True)
    return target.requires_grad_(False), draft.requires_grad_(False)


def speculation_ab(torch, port, rep: Report) -> None:
    """``measure.py:858-952`` at the ``decode`` config's widths and depth:
    off, n-gram and draft model, each a fresh engine with a warm pass and a
    timed pass over SPEC_PROMPTS decode-heavy requests."""
    import numpy as np

    from accelerate_tpu_torch.serving import ServingEngine, SpecConfig

    t0 = time.perf_counter()
    target, draft = spec_models(torch, port)
    torch.cuda.synchronize()
    rep.line(f"serve speculation set-up: fp32 target (decode config, o_proj and down_proj of "
             f"layers >= 1 at zero), {sum(p.nbytes for p in target.parameters())} bytes; "
             f"1-layer draft sharing its tensors; {time.perf_counter() - t0} s")
    cfg = target.config
    rng = np.random.default_rng(SERVE["seed"] + 2)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(4, 12)))
               for _ in range(SPEC_PROMPTS)]
    new = min(SPEC_NEW, cfg.max_seq_len - 16 - SPEC_K)
    arms = {}
    for name, spec in (("off", None), ("ngram", SpecConfig(k=SPEC_K)),
                       ("draft", SpecConfig(k=SPEC_K, method="draft_model", draft_model=draft))):
        engine = ServingEngine(target, max_slots=SERVE["max_slots"], block_size=SERVE["block_size"])
        engine.set_speculation(spec)
        for p in prompts:
            engine.add_request(p, max_new_tokens=new)
        for _ in engine.stream():
            pass
        warm = engine.trace_counts()
        rids = [engine.add_request(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in engine.stream():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        outs = [engine.result(r) for r in rids]
        after = engine.trace_counts()
        spec_sum = engine.summary().get("speculation", {})
        arms[name] = dict(outs=outs, tps=sum(len(o) for o in outs) / wall, wall=wall,
                          spec=spec_sum, warm=warm, after=after)
        rep.line(f"serve speculation {name}: {len(prompts)} prompts of "
                 f"{[len(p) for p in prompts]} tokens, {new} new each, k {SPEC_K}: "
                 f"{arms[name]['tps']} tokens/s ({wall} s); rounds {spec_sum.get('rounds')}, "
                 f"proposed {spec_sum.get('proposed')}, accepted {spec_sum.get('accepted')}, "
                 f"accept rate {spec_sum.get('accept_rate')}; builds after the warm pass {warm}, "
                 f"after the timed pass {after}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    off = arms["off"]
    rep.line(f"serve speculation: n-gram over off {arms['ngram']['tps'] / off['tps']}, draft "
             f"over off {arms['draft']['tps'] / off['tps']}; accept-rate limit for the draft "
             f"{SPEC_ACCEPT_MIN}")
    for name in ("ngram", "draft"):
        arm = arms[name]
        if arm["outs"] != off["outs"]:
            diff = sum(a != b for a, b in zip(arm["outs"], off["outs"]))
            fail(f"serve speculation {name}: {diff} outputs differ from speculation off")
        if arm["after"] != arm["warm"]:
            fail(f"serve speculation {name}: rebuilt after warmup: {arm['warm']} -> {arm['after']}")
        want_verify = 1 if name == "draft" or arm["spec"]["proposed"] else 0
        if arm["after"]["verify"] != want_verify or arm["after"]["decode"] > 1:
            fail(f"serve speculation {name}: builds {arm['after']}")
    if arms["draft"]["after"].get("draft_step") != 1:
        fail(f"serve speculation draft: draft step builds {arms['draft']['after']}")
    if not arms["draft"]["spec"]["accept_rate"] >= SPEC_ACCEPT_MIN:
        fail(f"serve speculation draft: accept rate {arms['draft']['spec']['accept_rate']} < "
             f"{SPEC_ACCEPT_MIN}")
    del target, draft


# ---------------------------------------------------------------------- #
# phase 12: the reference benchmark's serve_soak variant
# ---------------------------------------------------------------------- #
def soak_plan(loadgen, cfg, max_slots: int, block_size: int, seed: int) -> dict:
    """``measure.py:_run_serve_soak``'s workload (:1156-1168) and its A/B
    arms' plans (:1337-1500) for a model config, built with ``loadgen``
    (either package's): the long-prompt-burst mix on a pool sized to one
    giant and four median shorts, the chunk budget and the work-weighted
    step cost for the chunked arms; the pressure pool, phases and fault for
    the preemption arms. Pure arithmetic on the config."""
    from dataclasses import replace

    from accelerate_tpu_torch.serving.engine import _next_pow2 as next_pow2

    max_prompt = max(8, min(cfg.max_seq_len // 4, 48))
    workload = loadgen.WorkloadConfig(
        vocab_size=cfg.vocab_size, prompt_tokens_min=4,
        prompt_tokens_median=max(6, max_prompt // 4), prompt_tokens_max=max_prompt,
        output_tokens_min=2, output_tokens_median=6, output_tokens_max=24,
        max_total_tokens=cfg.max_seq_len)
    ab_dt = 0.01  # virtual seconds an engine step
    vcap = max_slots / ((2 + workload.output_tokens_median) * ab_dt)
    long_tokens = max(workload.prompt_tokens_max,
                      workload.max_total_tokens - 2 * workload.output_tokens_max)
    giant_frac, burst_out_median = 0.03, 16
    burst_workload = replace(workload, long_prompt_fraction=giant_frac,
                             long_prompt_tokens=long_tokens,
                             output_tokens_min=burst_out_median // 2,
                             output_tokens_median=burst_out_median)
    giant_fp = -(-(long_tokens + workload.output_tokens_max) // block_size)
    short_fp = -(-(workload.prompt_tokens_median + burst_out_median) // block_size)
    chunk_budget = max(4 * block_size, next_pow2(long_tokens // 4))
    step_base = 0.25
    avg_prompt = ((1.0 - giant_frac) * workload.prompt_tokens_median
                  + giant_frac * long_tokens)
    chunk_quanta = (step_base + avg_prompt / chunk_budget
                    + step_base * burst_out_median / max_slots)
    vcap_chunk = 1.0 / (chunk_quanta * ab_dt)
    median_fp = -(-(workload.prompt_tokens_median + workload.output_tokens_median)
                  // block_size)
    max_fp = -(-(workload.prompt_tokens_max + workload.output_tokens_max) // block_size)
    prime_lens = sorted({4, workload.prompt_tokens_median, workload.prompt_tokens_max,
                         chunk_budget, long_tokens})
    pressure_blocks = 1 + max(3 * median_fp, max_fp + 1)
    return dict(
        workload=workload, seed=seed, ab_dt=ab_dt, step_base=step_base,
        burst_workload=burst_workload, chunk_budget=chunk_budget, long_tokens=long_tokens,
        ab_blocks=1 + giant_fp + 4 * short_fp,
        burst_phases=(loadgen.Phase("warmup", "warmup", 1.0, 0.3 * vcap_chunk),
                      loadgen.Phase("soak", "soak", 3.5, 0.8 * vcap_chunk)),
        prime_lens=prime_lens,
        # the reference primes the pressure arms with every length but the
        # giant's (measure.py:1483), which at the decode config includes the
        # 128-token chunk budget: 130 tokens that its 7-block pool (96
        # tokens) refuses at submit. Only the lengths the pool can seat are
        # primed; the arms' traces reach no longer prompt
        pressure_prime_lens=[n for n in prime_lens[:-1]
                             if -(-(n + 2) // block_size) <= pressure_blocks - 1],
        pressure_blocks=pressure_blocks,
        pressure_phases=(loadgen.Phase("warmup", "warmup", 1.0, 0.35 * vcap),
                         loadgen.Phase("fault", "fault", 2.0, 1.3 * vcap),
                         loadgen.Phase("recovery", "recovery", 1.0, 0.35 * vcap)),
        pressure_fault="pool_pressure@0:secs=1.2", pressure_delay_s=0.3)


def soak_ab_arms(loadgen, make_engine, plan: dict, report_dir=None, telemetry=None) -> dict:
    """The chunked and preemption A/B arms of ``measure.py:1319-1508`` on
    the virtual clock: ``make_engine(clock, **options)`` builds an engine
    (either package's) stamping from ``clock``. Each arm's engine is primed
    over ``plan["prime_lens"]`` (every prefill and chunk bucket the trace
    can reach, and the decode step) before its run, with its stats reset.
    ``telemetry(arm)``, if given, returns the collector the harness tees
    the arm's records into. Returns {arm: (report, engine)} for
    chunked-off, chunked-on, preempt-off and preempt-on."""
    import os

    import numpy as np

    def prime(engine, lens):
        rng = np.random.default_rng(plan["seed"] + 99)
        for n in lens:
            engine.add_request(rng.integers(1, plan["workload"].vocab_size, size=n).tolist(),
                               max_new_tokens=2)
        while engine.has_work:
            engine.step()
        engine.stats = type(engine.stats)()

    def work_cost(engine):
        """A base quantum and one quantum a chunk budget of padded prefill
        tokens the step issued (measure.py:1422-1436)."""
        last = [engine.prefill_bucket_tokens_total]

        def cost(_):
            cur = engine.prefill_bucket_tokens_total
            delta, last[0] = cur - last[0], cur
            return plan["ab_dt"] * (plan["step_base"] + delta / plan["chunk_budget"])
        return cost

    arms = {}
    specs = (
        ("chunked-off", dict(num_blocks=plan["ab_blocks"]), "burst", True),
        ("chunked-on", dict(num_blocks=plan["ab_blocks"],
                            prefill_chunk_tokens=plan["chunk_budget"], preemption=True),
         "burst", True),
        ("preempt-off", dict(num_blocks=plan["pressure_blocks"],
                             max_queue_delay_s=plan["pressure_delay_s"]), "pressure", False),
        ("preempt-on", dict(num_blocks=plan["pressure_blocks"],
                            max_queue_delay_s=plan["pressure_delay_s"], preemption=True),
         "pressure", False),
    )
    for name, options, kind, burst in specs:
        clock = loadgen.SoakClock()
        engine = make_engine(clock, **options)
        prime(engine, plan["prime_lens"] if burst else plan["pressure_prime_lens"])
        config = loadgen.SoakConfig(
            workload=plan["burst_workload"] if burst else plan["workload"],
            phases=plan["burst_phases"] if burst else plan["pressure_phases"],
            seed=plan["seed"] + 17, step_dt_s=plan["ab_dt"],
            step_cost=work_cost(engine) if burst else None,
            fault_specs="" if burst else plan["pressure_fault"],
            report_path=(os.path.join(report_dir, f"soak-report-{name}.json")
                         if report_dir else None),
            drain_grace_s=60.0, label=f"serve_soak_{name}")
        harness = loadgen.SoakHarness(engine, config, clock=clock,
                                      telemetry=telemetry(name) if telemetry else None)
        arms[name] = (harness.run(), engine)
    return arms


def soak_p95(report) -> float:
    return next(p["p95_ttft_s"] for p in report["phases"] if p["phase"] == "soak")


def soak_small_check(torch, port, rep: Report) -> None:
    """A 2-layer fp32 model of the tiny widths on the card against the CPU:
    the engine with chunked prefill, preemption and int8 KV on the
    reference's ``test_all_three_features_compose`` prompts gives the CPU's
    greedy tokens and the card's int8-only engine's; a priority-5 arrival
    swaps a seated request out and it finishes with the uncontended run's
    tokens."""
    import numpy as np

    from accelerate_tpu_torch.serving import ServingEngine

    cfg = port.TransformerConfig.tiny(num_layers=2, max_seq_len=64, dtype="float32")
    cpu = port.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    card_model = port.CausalLM(cfg, device=CARD)
    card_model.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (23, 5, 17, 9)]

    def run_all(engine, ps, **kw):
        ids = [engine.add_request(p, max_new_tokens=6, **kw) for p in ps]
        while engine.has_work:
            engine.step()
        return [engine.result(r) for r in ids], engine

    composed = dict(max_slots=4, block_size=8, num_blocks=24, prefill_chunk_tokens=8,
                    preemption=True, kv_dtype="int8")
    outs = {}
    for where, model in (("card", card_model), ("cpu", cpu)):
        outs[f"{where} composed"], engine = run_all(ServingEngine(model, **composed), prompts)
        if engine.trace_counts()["decode"] != 1:
            fail(f"soak small model: the composed engine's builds {engine.trace_counts()}")
    outs["card int8 only"] = run_all(ServingEngine(card_model, max_slots=4, block_size=8,
                                                   num_blocks=24, kv_dtype="int8"), prompts)[0]
    same = {name: got == outs["cpu composed"] for name, got in outs.items()}
    rep.line(f"soak small fp32 model: chunked + preemption + int8 greedy tokens equal to the "
             f"CPU's {json.dumps(same)}")
    if not all(same.values()):
        fail(f"soak small model: the composed engine's tokens differ: {same}")
    # a priority preemption on the card, resumed from the host images
    ps = [prompts[0], prompts[2], prompts[1]]
    want = run_all(ServingEngine(card_model, max_slots=2, block_size=4, num_blocks=33), ps)[0]
    engine = ServingEngine(card_model, max_slots=2, block_size=4, num_blocks=13, preemption=True)
    victim = engine.add_request(ps[0], max_new_tokens=6)
    engine.step()
    engine.step()
    urgent = engine.add_request(ps[1], max_new_tokens=6, priority=5)
    filler = engine.add_request(ps[2], max_new_tokens=6)
    while engine.has_work:
        engine.step()
    got = [engine.result(r) for r in (victim, urgent, filler)]
    stats = engine.pool.stats()
    rep.line(f"soak small fp32 model: priority preemption on the card: preempts "
             f"{engine._preempt_counts}, resumes {engine._resumes_total}, builds "
             f"{engine.trace_counts()}, tokens equal to the uncontended run {got == want}")
    if (got != want or engine._preempt_counts["priority"] != 1 or engine._resumes_total != 1
            or stats["swapped"] or stats["allocated"]):
        fail(f"soak small model: priority preemption did not resume bit for bit: {got} vs "
             f"{want}, {engine._preempt_counts}, {stats}")


def soak_kv_checks(torch, model, prompt, rep: Report) -> None:
    """On the decode config, one bucketed prefill of ``prompt`` into fresh
    bf16 and int8 pools: ``quantize_kv`` on the card against the CPU on the
    K and V rows the bf16 prefill wrote in every layer (codes and scales
    bit for bit); the int8 ``paged_attention`` of a 4-slot decode query in
    bf16 against its fp32 computation from the same codes and scales, row
    by row (INT8_ATTN_TOL). A reading: the int8 first-token logits against
    the bf16 ones."""
    from accelerate_tpu_torch.models.generation import init_cache
    from accelerate_tpu_torch.ops.attention import PagedKVState, paged_attention, quantize_kv
    from accelerate_tpu_torch.serving.engine import _next_pow2 as next_pow2

    cfg = model.config
    bs = SOAK["block_size"]
    n = len(prompt)
    bucket = next_pow2(n)
    blocks = -(-bucket // bs)
    width = -(-cfg.max_seq_len // bs)
    table = torch.zeros((1, width), dtype=torch.long, device=CARD)
    table[0, :blocks] = torch.arange(1, blocks + 1, device=CARD)
    ids = torch.zeros((1, bucket), dtype=torch.long, device=CARD)
    ids[0, :n] = torch.tensor(prompt, device=CARD)
    caches, firsts = {}, {}
    with torch.no_grad():
        for kv_dtype in ("native", "int8"):
            caches[kv_dtype] = cache = init_cache(model, num_blocks=blocks + 1, block_size=bs,
                                                  kv_dtype=kv_dtype)
            state = PagedKVState(table, torch.zeros(1, dtype=torch.long, device=CARD),
                                 torch.tensor([n], device=CARD), num_blocks=blocks + 1,
                                 block_size=bs, kv_dtype=kv_dtype)
            firsts[kv_dtype] = model(ids, decode=True, paged=state, cache=cache)[0, n - 1].float()
    native = caches["native"]
    same = []
    for pool in (native.key, native.value):
        rows = pool[:, 1:blocks + 1].reshape(cfg.num_layers, blocks * bs, *pool.shape[3:])
        x = rows[:, :n]  # (layers, n, Hkv, D): every layer's rows as a batch
        q_card, s_card = quantize_kv(x)
        q_cpu, s_cpu = quantize_kv(x.cpu())
        same.append(torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu))
    rep.line(f"soak int8: quantize_kv of the K and V rows one {n}-token prefill wrote "
             f"({cfg.num_layers} layers x {n} rows of {tuple(native.key.shape[3:])}, bf16) on "
             f"the card against the CPU: codes and scales bit for bit {same}")
    if not all(same):
        fail("soak int8: quantize_kv on the card differs from the CPU")
    first_err = float((firsts["int8"] - firsts["native"]).abs().max()
                      / firsts["native"].square().mean().sqrt())
    rep.line(f"soak int8: first-token logits, int8 against bf16 pools ({n}-token prompt): max "
             f"error over RMS {first_err}, argmax equal "
             f"{int(firsts['int8'].argmax()) == int(firsts['native'].argmax())} (a reading)")
    i8 = caches["int8"]
    lens = [n - 1, n // 2, 5, 0]
    state = PagedKVState(table.expand(4, -1).contiguous(), torch.tensor(lens, device=CARD),
                         torch.ones(4, dtype=torch.long, device=CARD), num_blocks=blocks + 1,
                         block_size=bs, kv_dtype="int8")
    g = torch.Generator(CARD).manual_seed(5)
    q = torch.randn((4, 1, cfg.num_heads, cfg.head_dim), generator=g, device=CARD)
    errs = []
    with torch.no_grad():
        for layer in (0, cfg.num_layers - 1):
            args = (i8.key[layer], i8.value[layer], state)
            kw = dict(key_scale=i8.key_scale[layer], value_scale=i8.value_scale[layer])
            got = paged_attention(q.to(torch.bfloat16), *args, **kw)
            want = paged_attention(q, *args, **kw)
            errs.append(row_err(torch, got, want))
    rep.line(f"soak int8: paged_attention in bf16 against its fp32 computation from the same "
             f"codes (4 slots at cache lengths {lens}, layers 0 and {cfg.num_layers - 1}): worst "
             f"row error {errs}, limit {INT8_ATTN_TOL}")
    if not max(errs) <= INT8_ATTN_TOL:
        fail(f"soak int8: paged_attention beyond tolerance: {max(errs)} > {INT8_ATTN_TOL}")


def soak_profiles(torch, model, rep: Report) -> None:
    """Where a soak step's time goes on the decode config: one engine step
    with a 128-token chunk of a 464-token prompt in flight beside three
    decoding slots, then one swap-out of a 300-token request's 20 blocks and
    its swap-in, each once under the profiler."""
    from accelerate_tpu_torch.serving import ServingEngine

    import numpy as np

    rng = np.random.default_rng(SOAK["seed"] + 7)
    vocab = model.config.vocab_size
    engine = ServingEngine(model, max_slots=SOAK["max_slots"], block_size=SOAK["block_size"],
                           prefill_chunk_tokens=128, preemption=True)
    for _ in range(3):
        engine.add_request(rng.integers(1, vocab, 12).tolist(), max_new_tokens=64)
    engine.step()
    engine.step()
    engine.add_request(rng.integers(1, vocab, 464).tolist(), max_new_tokens=8)
    engine.step()  # the giant's first chunk
    profile_call(torch, engine.step, rep, "soak chunked step (a 128-token chunk at offset 128 "
                 "and 3 decoding slots)")
    while engine.has_work:
        engine.step()
    engine = ServingEngine(model, max_slots=2, block_size=SOAK["block_size"], preemption=True)
    engine.add_request(rng.integers(1, vocab, 300).tolist(), max_new_tokens=16)
    engine.step()
    engine.step()
    slot = next(s for s in engine.scheduler.slots if s.busy)
    n_blocks = len(slot.blocks)
    nbytes = n_blocks * engine.cache.nbytes // engine.num_blocks
    torch.cuda.synchronize()
    profile_call(torch, lambda: engine._preempt(slot, "priority"), rep,
                 f"soak swap-out ({n_blocks} blocks, {nbytes} bytes to pinned host memory)")
    profile_call(torch, engine._try_resume, rep, f"soak swap-in ({n_blocks} blocks)")
    while engine.has_work:
        engine.step()


def soak_phase(torch, port, wrappers, rep: Report, model) -> None:
    """The reference benchmark's ``serve_soak`` variant on the ``decode``
    config (see phase 12 in the module docstring). Every launch counter is
    set to 0 before and read after."""
    import numpy as np

    from accelerate_tpu_torch import loadgen
    from accelerate_tpu_torch.serving import ServingEngine, SLOConfig
    from accelerate_tpu_torch.serving.telemetry import ServeStats
    from accelerate_tpu_torch.telemetry import StepTelemetry, TelemetryConfig

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts(wrappers)
    soak_small_check(torch, port, rep)
    cfg = model.config
    max_slots, block_size, target, seed = (SOAK[k] for k in ("max_slots", "block_size",
                                                               "target_requests", "seed"))
    plan = soak_plan(loadgen, cfg, max_slots, block_size, seed)
    plan.update(  # the arms at SOAK_ARM_SCALE of their length
        burst_phases=tuple(loadgen.Phase(p.name, p.kind, p.duration_s * SOAK_ARM_SCALE,
                                         p.rate_rps) for p in plan["burst_phases"]),
        pressure_phases=tuple(loadgen.Phase(p.name, p.kind, p.duration_s * SOAK_ARM_SCALE,
                                            p.rate_rps) for p in plan["pressure_phases"]),
        pressure_fault=f"pool_pressure@0:secs={1.2 * SOAK_ARM_SCALE:g}")
    workload = plan["workload"]
    out_dir = tempfile.mkdtemp(prefix="serve_soak-")  # the soak reports, read back below

    # the closed-loop capacity probe, twice: the first pays the builds
    engine = ServingEngine(model, max_slots=max_slots, block_size=block_size)
    calib = loadgen.build_trace(
        workload, (loadgen.Phase("calib", "warmup", 1.0, 16.0, process="uniform"),), seed + 1)

    def drain(eng, reqs):
        ids = [eng.add_request(list(r.prompt), max_new_tokens=r.max_new_tokens) for r in reqs]
        while eng.has_work:
            eng.step()
        torch.cuda.synchronize()
        return [eng.result(r) for r in ids]

    drain(engine, calib)
    engine.stats = ServeStats()
    t0 = time.perf_counter()
    drain(engine, calib)
    calib_s = time.perf_counter() - t0
    capacity = len(calib) / calib_s
    ttft_obj = max(0.02, (engine.summary().get("ttft_s_p95") or 0.1) * 2.0)
    engine.stats = ServeStats()
    engine.scheduler.max_queue_delay_s = 2.5 * ttft_obj
    u = min(3.0, max(0.6, target / (9.1 * capacity)))
    c = capacity
    program = (
        loadgen.Phase("warmup", "warmup", u, max(1.0, 0.25 * c)),
        loadgen.Phase("ramp-1", "ramp", u, 0.5 * c),
        loadgen.Phase("ramp-2", "ramp", u, 1.0 * c),
        loadgen.Phase("ramp-3", "ramp", u, 1.5 * c),
        loadgen.Phase("ramp-4", "ramp", u, 2.0 * c),
        loadgen.Phase("cooldown", "warmup", u, max(1.0, 0.25 * c)),
        loadgen.Phase("soak", "soak", 2 * u, 0.6 * c),
        loadgen.Phase("fault", "fault", u, 0.6 * c),
        loadgen.Phase("recovery", "recovery", 3 * u, 0.6 * c),
    )
    stall_secs = round(min(1.0, u / 2), 2)
    slo = SLOConfig(ttft_objective_s=ttft_obj, e2e_objective_s=ttft_obj * 10, target=0.9,
                    fast_window_s=max(0.2, u / 2), slow_window_s=max(0.4, u),
                    burn_threshold=1.0, interval_steps=8, min_requests=3)
    rep.line(f"soak calibration: {len(calib)} requests drained in {calib_s} s: capacity "
             f"{capacity} requests/s closed loop; TTFT objective {ttft_obj} s (2x the probe's "
             f"p95), max_queue_delay_s {engine.scheduler.max_queue_delay_s}; unit {u} s, "
             f"program {sum(p.duration_s for p in program)} s, stall_decode {stall_secs} s")
    soak_cfg = loadgen.SoakConfig(
        workload=workload, phases=program, seed=seed, step_dt_s=None, slo=slo,
        fault_specs=f"stall_decode@0:secs={stall_secs:g}",
        report_path=os.path.join(out_dir, "soak-report.json"), drain_grace_s=30.0,
        label="serve_soak")
    t0 = time.perf_counter()
    report = loadgen.SoakHarness(engine, soak_cfg).run()
    soak_wall = time.perf_counter() - t0
    head, fault = report["headline"], report["fault"]
    for p in report["phases"]:
        rep.line(f"soak phase {p['phase']}: offered {p['offered']} at {p['offered_rps']} rps, "
                 f"finished {p['finished']}, shed {p['shed']} {json.dumps(p['sheds_by_reason'])},"
                 f" goodput {p['goodput_tokens_per_s']} tokens/s, p95 TTFT {p['p95_ttft_s']} s, "
                 f"p95 ITL {p['p95_itl_s']} s, arrival lag p95 {p['arrival_lag_p95_s']} s, "
                 f"breached {p['breached']}")
    vs_baseline = ttft_obj / head["soak_p95_ttft_s"] if head["soak_p95_ttft_s"] else None
    rep.line(f"soak headline: goodput {head['goodput_tokens_per_s_at_slo']} tokens/s at the SLO,"
             f" vs_baseline {vs_baseline} (objective over soak p95 TTFT "
             f"{head['soak_p95_ttft_s']} s), slo_ok {head['slo_ok']}; capacity at the breach "
             f"point {head['capacity_rps_at_breach_point']} rps (saturated "
             f"{head['capacity_saturated']}); sheds {json.dumps(report['shed_totals'])}; "
             f"requests planned {report['requests_planned']}, finished "
             f"{report['requests_finished']}, shed {report['requests_shed']}; arrival lag p95 "
             f"{report['arrival_lag']['p95_s']} s; {report['engine_steps']} engine steps in "
             f"{soak_wall} s")
    rep.line(f"soak fault window ({', '.join(fault['specs'])}): sheds {fault['sheds_in_window']},"
             f" SLO violations {fault['slo_violations_in_window']}, recovered "
             f"{fault['recovered']} after {fault['recovery_s']} s; decode retraces after warmup "
             f"{report['decode_retraces']}, builds {engine.trace_counts()}")
    names = [p["phase"] for p in report["phases"]]
    if names != [p.name for p in program]:
        fail(f"soak: the report's phases are {names}, not the program's")
    if report["decode_retraces"] != 0 or engine.trace_counts()["decode"] != 1:
        fail(f"soak: the decode step was rebuilt: {report['decode_retraces']}, "
             f"{engine.trace_counts()}")
    if report["interrupted"] or report["requests_submitted"] != report["requests_planned"]:
        fail(f"soak: the run was cut: {report['stop_reason']}")
    if loadgen.read_report(soak_cfg.report_path) != json.loads(json.dumps(report)):
        fail("soak: the written soak-report.json is not the run's report")
    del engine
    gc.collect()

    # the A/B arms on the virtual clock
    t0 = time.perf_counter()
    tele = {}
    arms = soak_ab_arms(
        loadgen, lambda clock, **kw: ServingEngine(model, max_slots=max_slots,
                                                   block_size=block_size, now=clock, **kw),
        plan, report_dir=out_dir, telemetry=lambda name: tele.setdefault(name, StepTelemetry(
            TelemetryConfig(history=1 << 16))))
    ab_wall = time.perf_counter() - t0
    for name, (rep_arm, eng) in arms.items():
        rep.line(f"soak arm {name}: {rep_arm['engine_steps']} engine steps, planned "
                 f"{rep_arm['requests_planned']}, finished {rep_arm['requests_finished']}, shed "
                 f"{rep_arm['requests_shed']}; phases "
                 + "; ".join(f"{p['phase']} p95 TTFT {p['p95_ttft_s']} s shed {p['shed']}"
                             for p in rep_arm["phases"])
                 + f"; preempts {eng._preempt_counts}, resumes {eng._resumes_total}, chunks "
                 f"{eng._prefill_chunks_total}, builds {eng.trace_counts()}, pool "
                 f"{json.dumps(eng.pool.stats())}")
        if rep_arm["decode_retraces"] != 0 or eng.trace_counts()["decode"] != 1:
            fail(f"soak arm {name}: the decode step was rebuilt: {eng.trace_counts()}")
        if len(rep_arm["phases"]) != len(plan["burst_phases" if "chunked" in name
                                              else "pressure_phases"]):
            fail(f"soak arm {name}: phase records missing")
    off, on = soak_p95(arms["chunked-off"][0]), soak_p95(arms["chunked-on"][0])
    chunks = arms["chunked-on"][1]._prefill_chunks_total
    rep.line(f"soak chunked A/B (budget {plan['chunk_budget']} tokens, giants of "
             f"{plan['long_tokens']}, pool {plan['ab_blocks']} blocks): soak p95 TTFT off {off} "
             f"s, on {on} s (virtual), improvement {off / on if on else None}; chunks {chunks}")
    if not (on is not None and off is not None and on < off and chunks > 0):
        fail(f"soak chunked: p95 TTFT on {on} not below off {off}, or no chunk ({chunks})")
    rep_shed, eng_shed = arms["preempt-off"]
    rep_pre, eng_pre = arms["preempt-on"]
    preempted = [r["request_id"] for r in eng_pre.stats.requests if r.get("preempted_count")]
    compared = [r for r in preempted if eng_shed.result(r) is not None]
    match = all(eng_pre.result(r) == eng_shed.result(r) for r in compared)
    stats = eng_pre.pool.stats()
    swapped_bytes = sum(r["swap_bytes"] for r in tele["preempt-on"].records
                        if r["kind"] == "preempt")
    rep.line(f"soak preempt A/B (pool {plan['pressure_blocks']} blocks, "
             f"{plan['pressure_fault']}, max_queue_delay_s {plan['pressure_delay_s']}): fault-"
             f"window sheds off {rep_shed['fault']['sheds_in_window']}, on "
             f"{rep_pre['fault']['sheds_in_window']}; preempts in the window "
             f"{rep_pre['fault']['preempts_in_window']}, in all {eng_pre._preempt_counts}; "
             f"resumes {eng_pre._resumes_total}; bytes swapped out {swapped_bytes}; "
             f"{len(preempted)} preempted requests finished, {len(compared)} held against the "
             f"shed-only control: tokens equal {match}; pool at the end {json.dumps(stats)}")
    if not rep_pre["fault"]["sheds_in_window"] < rep_shed["fault"]["sheds_in_window"]:
        fail("soak preempt: preemption did not shed fewer in the fault window")
    if sum(eng_pre._preempt_counts.values()) < 1 or not compared or not match:
        fail(f"soak preempt: preempts {eng_pre._preempt_counts}, {len(compared)} compared, "
             f"tokens equal {match}")
    if stats["swapped"] or stats["allocated"]:
        fail(f"soak preempt: the pool did not drain: {stats}")
    del arms, eng_shed, eng_pre
    gc.collect()
    torch.cuda.empty_cache()

    # int8 KV: census bytes and seats at a fixed budget (measure.py:1509-1548)
    tel_fp, tel_i8 = StepTelemetry(True), StepTelemetry(True)
    eng_fp = ServingEngine(model, max_slots=max_slots, block_size=block_size, telemetry=tel_fp)
    eng_i8 = ServingEngine(model, max_slots=max_slots, block_size=block_size, telemetry=tel_i8,
                           kv_dtype="int8")
    kv_fp = tel_fp.sample_memory(force=True)["census_owner_bytes"]["kv_cache"]
    kv_i8 = tel_i8.sample_memory(force=True)["census_owner_bytes"]["kv_cache"]
    blocks = eng_fp.pool.num_blocks
    footprint = eng_fp.pool.blocks_for_tokens(workload.prompt_tokens_median
                                              + workload.output_tokens_median)
    seats_fp = (blocks - 1) // footprint
    seats_i8 = max(0, int(kv_fp // (kv_i8 / blocks)) - 1) // footprint
    outs = [drain(eng, calib) for eng in (eng_fp, eng_i8)]
    agree = sum(a == b for a, b in zip(*outs))
    rep.line(f"soak int8 KV: census kv_cache bytes bf16 {kv_fp}, int8 {kv_i8}, ratio "
             f"{kv_fp / kv_i8}; kv_bytes_per_token {eng_fp.kv_bytes_per_token} and "
             f"{eng_i8.kv_bytes_per_token}; seats at the bf16 pool's bytes ({blocks} blocks, "
             f"{footprint} a median request) {seats_fp} and {seats_i8}, ratio "
             f"{seats_i8 / seats_fp}; greedy outputs of the {len(calib)} calibration requests "
             f"equal for {agree} (all equal {agree == len(calib)}; a reading, not gated); "
             f"builds {eng_i8.trace_counts()}")
    if not (kv_fp / kv_i8 >= 1.8 and seats_i8 / seats_fp >= 1.8):
        fail(f"soak int8: byte ratio {kv_fp / kv_i8} or seat ratio {seats_i8 / seats_fp} < 1.8")
    if eng_i8.trace_counts()["decode"] != 1:
        fail(f"soak int8: the decode step was rebuilt: {eng_i8.trace_counts()}")
    soak_kv_checks(torch, model, [t for r in calib for t in r.prompt][:200], rep)
    del eng_fp, eng_i8
    gc.collect()
    torch.cuda.empty_cache()
    soak_profiles(torch, model, rep)
    launches = {w.__name__: w.launches for w in wrappers}
    rep.line(f"soak kernel launches of the port {json.dumps(launches)}")
    if any(launches.values()):
        fail(f"soak: kernels of the port launched on the serving path: {launches}")
    shutil.rmtree(out_dir)
    rep.line(f"soak phase: {time.perf_counter() - phase_t0} s (A/B arms {ab_wall} s)")


# ---------------------------------------------------------------------- #
# phase 16: the reference benchmark's fleet_soak and disagg_soak variants
# ---------------------------------------------------------------------- #
def fleet_plan(loadgen, cfg, max_slots: int, block_size: int, target_requests: int,
               seed: int) -> dict:
    """``measure.py:_run_fleet_soak``'s workload, phases and priming
    (:1715-1755) for a model config, built with ``loadgen`` (either
    package's): four replicas, templated cohorts (90 % of requests open
    with one of four 3-block prefixes), the policy arms' warmup + soak and
    the kill arm's warmup, soak, fault and recovery, sized so one policy arm
    offers about ``target_requests``. Pure arithmetic on the config."""
    n_replicas = 4
    prefix_tokens = 3 * block_size
    workload = loadgen.WorkloadConfig(
        vocab_size=cfg.vocab_size, num_cohorts=4, prefix_tokens=prefix_tokens,
        cohort_fraction=0.9, prompt_tokens_min=2, prompt_tokens_median=4,
        prompt_tokens_max=2 * block_size, output_tokens_min=2, output_tokens_median=6,
        output_tokens_max=16, max_total_tokens=cfg.max_seq_len)
    ab_dt = 0.01  # virtual seconds a fleet step (one step a replica)
    vcap = n_replicas * max_slots / ((2 + workload.output_tokens_median) * ab_dt)
    u = max(0.2, target_requests / (1.35 * vcap))
    max_prompt = prefix_tokens + workload.prompt_tokens_max
    return dict(
        workload=workload, seed=seed, ab_dt=ab_dt, vcap=vcap, u=u, n_replicas=n_replicas,
        fingerprint="fleet-bench", prime_lens=_prime_lens(max_prompt, cfg.max_seq_len),
        policy_phases=(loadgen.Phase("warmup", "warmup", u, 0.25 * vcap),
                       loadgen.Phase("soak", "soak", 2 * u, 0.55 * vcap)),
        kill_phases=(loadgen.Phase("warmup", "warmup", u, 0.25 * vcap),
                     loadgen.Phase("soak", "soak", u, 0.55 * vcap),
                     loadgen.Phase("fault", "fault", u, 0.55 * vcap),
                     loadgen.Phase("recovery", "recovery", 2 * u, 0.55 * vcap)),
        kill_fault="replica_kill@0:replica=1")


def disagg_plan(loadgen, cfg, max_slots: int, block_size: int, target_requests: int,
                seed: int) -> dict:
    """``measure.py:_run_disagg_soak``'s workload, phases, priming and step
    cost (:1997-2041, :2090): two prefill and two decode replicas against
    four colocated ones, cohorts (80 %) with a quarter of the requests
    carrying an 8-block prompt body, the offered load sized to the decode
    pool, and the stall arm's phases."""
    n_prefill = n_decode = 2
    prefix_tokens = 3 * block_size
    long_tokens = 8 * block_size
    workload = loadgen.WorkloadConfig(
        vocab_size=cfg.vocab_size, num_cohorts=4, prefix_tokens=prefix_tokens,
        cohort_fraction=0.8, prompt_tokens_min=2, prompt_tokens_median=4,
        prompt_tokens_max=2 * block_size, long_prompt_fraction=0.25,
        long_prompt_tokens=long_tokens, output_tokens_min=2, output_tokens_median=6,
        output_tokens_max=16, max_total_tokens=cfg.max_seq_len)
    ab_dt = 0.01
    vcap = n_decode * max_slots / ((2 + workload.output_tokens_median) * ab_dt)
    u = max(0.2, target_requests / (1.35 * vcap))
    return dict(
        workload=workload, seed=seed, ab_dt=ab_dt, vcap=vcap, u=u, n_prefill=n_prefill,
        n_decode=n_decode, fingerprint="disagg-bench", block_size=block_size,
        # a full giant bucket bills 8 decode quanta (measure.py:2087-2090)
        prefill_cost=ab_dt / (2 * block_size),
        prime_lens=_prime_lens(prefix_tokens + long_tokens, cfg.max_seq_len),
        ab_phases=(loadgen.Phase("warmup", "warmup", u, 0.25 * vcap),
                   loadgen.Phase("burst", "soak", 2 * u, 0.55 * vcap)),
        stall_phases=(loadgen.Phase("warmup", "warmup", u, 0.25 * vcap),
                      loadgen.Phase("soak", "soak", u, 0.55 * vcap),
                      loadgen.Phase("fault", "fault", u, 0.55 * vcap),
                      loadgen.Phase("recovery", "recovery", 2 * u, 0.55 * vcap)),
        stall_fault="transfer_stall@0:secs=1")


def _prime_lens(max_prompt: int, max_seq_len: int) -> list:
    """Every prefill bucket a trace can reach (measure.py:1750-1755)."""
    lens, m = [], 2
    while m < 2 * max_prompt and m + 2 <= max_seq_len:
        lens.append(min(m, max_prompt))
        m *= 2
    return lens


def _prime_fleet_engine(engine, plan: dict) -> None:
    """Build every prefill bucket and the decode step before an arm, then
    reset the stats and the prefix index (measure.py:1757-1772): arms
    measure placement on cold caches, and the zero-retrace deltas count
    from here."""
    import numpy as np

    rng = np.random.default_rng(plan["seed"] + 99)
    for n in plan["prime_lens"]:
        engine.add_request(rng.integers(1, plan["workload"].vocab_size, size=n).tolist(),
                           max_new_tokens=2)
    while engine.has_work:
        engine.step()
    engine.set_prefix_cache(False)
    engine.set_prefix_cache(True, plan["fingerprint"])
    engine.stats = type(engine.stats)()


def _arm_out(report, fleet, engines, primed, roles) -> dict:
    """An arm's report and the readings phase 16 checks, taken before its
    engines are let go: build deltas since priming a replica, the router's
    and the plane's ledgers, the cache's hits."""
    cache = [e.prefix_cache.stats() for e in engines]
    plane = fleet.transfer_plane
    counts = {
        "requests_finished": report["requests_finished"],
        "requests_shed": report["requests_shed"],
        "routed_by_replica": dict(fleet.routed_by_replica),
        "warm_lookups": sum(c["lookups"] for c in cache),
        "warm_hits": sum(c["hits"] for c in cache),
        "requests_requeued": fleet.requests_requeued,
        "requests_lost": fleet.requests_lost,
        "transfers_delivered": fleet.transfers_delivered_total,
        "blocks_moved": plane.blocks_moved_total if plane is not None else 0,
        "blocks_deduped": plane.blocks_deduped_total if plane is not None else 0,
    }
    return {
        "report": report, "counts": counts, "roles": roles,
        "decode_retraces": [e.trace_counts()["decode"] - p["decode"]
                            for e, p in zip(engines, primed)],
        "prefill_retraces": [e.trace_counts()["prefill"] - p["prefill"]
                             for e, p in zip(engines, primed)],
        "transfer": report.get("transfer") or {},
        "router": report.get("router") or {},
    }


def fleet_arms(loadgen, router_pkg, make_engine, plan: dict, report_dir=None) -> dict:
    """``fleet_soak``'s four arms (measure.py:1774-1839) on the virtual
    clock: round robin, least loaded and prefix affinity on one trace, then
    prefix affinity under ``replica_kill@0:replica=1``, each on four fresh
    replicas ``make_engine(clock)`` (either package's, prefix cache on)
    behind ``router_pkg.FleetRouter``. The kill arm also records the seats
    and the unadmitted requests replica 1 held when the kill landed."""
    import os

    arms = {}
    specs = [(p, p, plan["policy_phases"], "") for p in
             ("round_robin", "least_loaded", "prefix_affinity")]
    specs.append(("replica_kill", "prefix_affinity", plan["kill_phases"], plan["kill_fault"]))
    for name, policy, phases, fault in specs:
        clock = loadgen.SoakClock()
        engines = [make_engine(clock) for _ in range(plan["n_replicas"])]
        for engine in engines:
            _prime_fleet_engine(engine, plan)
        primed = [dict(e.trace_counts()) for e in engines]
        fleet = router_pkg.FleetRouter(
            [router_pkg.InProcessReplica(f"r{i}", e) for i, e in enumerate(engines)],
            policy=policy, now=clock)
        at_kill = {}
        kill = fleet.kill

        def kill_and_record(rep_name, kill=kill, at_kill=at_kill, fleet=fleet):
            rep = fleet.replica(rep_name)
            sched = rep.engine.scheduler
            at_kill.update(replica=rep_name, seats=rep.seated_count(),
                           queued=[r.request_id for r in sched.queue])
            return kill(rep_name)

        fleet.kill = kill_and_record  # the chaos adapter calls engine.kill
        config = loadgen.SoakConfig(
            workload=plan["workload"], phases=phases, seed=plan["seed"] + 17,
            step_dt_s=plan["ab_dt"], fault_specs=fault,
            report_path=(os.path.join(report_dir, f"soak-report-fleet-{name}.json")
                         if report_dir else None),
            drain_grace_s=60.0, label=f"fleet_soak_{name}")
        report = loadgen.SoakHarness(fleet, config, clock=clock).run()
        out = _arm_out(report, fleet, engines, primed, ["colocated"] * len(engines))
        if at_kill:
            queued = at_kill["queued"]
            out["kill"] = dict(at_kill, requeued_finished_or_shed=all(
                fleet.result(r) is not None or fleet.shed_reason(r) is not None
                for r in queued))
        arms[name] = out
    return arms


def disagg_arms(loadgen, router_pkg, plane_cls, make_engine, plan: dict,
                report_dir=None) -> dict:
    """``disagg_soak``'s three arms (measure.py:2060-2202) on the virtual
    clock: four colocated replicas, then two prefill and two decode
    replicas with ``placement="disagg"`` over ``plane_cls("host_buffer")``,
    then the latter under ``transfer_stall@0:secs=1``; every replica primed
    colocated, then given its role; the harness's step cost charges a
    replica's prefill work while it hosts decodes (measure.py:2081-2105).
    ``make_engine(clock, plane)`` builds either package's engine. Each
    arm also returns its hand-offs' wall seconds, and the stall arm the
    requests whose hand-off was seen stalled and how each ended."""
    import os

    n_p, n_d = plan["n_prefill"], plan["n_decode"]
    arms = {}
    for name, phases, disagg, fault in (
            ("colocated", plan["ab_phases"], False, ""),
            ("disagg", plan["ab_phases"], True, ""),
            ("transfer_stall", plan["stall_phases"], True, plan["stall_fault"])):
        clock = loadgen.SoakClock()
        plane = plane_cls("host_buffer", now=clock) if disagg else None
        roles = ["prefill"] * n_p + ["decode"] * n_d if disagg else ["colocated"] * (n_p + n_d)
        engines, walls = [], []
        for role in roles:
            engine = make_engine(clock, plane)
            _prime_fleet_engine(engine, plan)
            if role != "colocated":
                engine.set_role(role)
            handoff = engine._handoff_slot

            def timed(slot, handoff=handoff):
                t0 = time.perf_counter()
                handoff(slot)
                walls.append(time.perf_counter() - t0)

            engine._handoff_slot = timed
            engines.append(engine)
        primed = [dict(e.trace_counts()) for e in engines]
        issued = {id(e): e.prefill_bucket_tokens_total for e in engines}
        hosted = {id(e): 0 for e in engines}

        def step_cost(_fleet, engines=engines, issued=issued, hosted=hosted):
            surcharge = 0.0
            for e in engines:
                delta = e.prefill_bucket_tokens_total - issued[id(e)]
                issued[id(e)] = e.prefill_bucket_tokens_total
                if delta and hosted[id(e)]:
                    surcharge = max(surcharge, delta * plan["prefill_cost"])
                hosted[id(e)] = sum(1 for s in e.scheduler.slots
                                    if s.busy and not s.done and not s.mid_prefill)
            return plan["ab_dt"] + surcharge

        fleet = router_pkg.FleetRouter(
            [router_pkg.InProcessReplica(f"{role[0]}{i}", e)
             for i, (role, e) in enumerate(zip(roles, engines))],
            policy="prefix_affinity", now=clock, placement="disagg" if disagg else "colocated",
            transfer_plane=plane)
        stalled = set()
        pump = fleet._pump_transfers

        def pump_and_record(pump=pump, fleet=fleet, stalled=stalled):
            pump()
            stalled.update(r.manifest.request_id for r in fleet._transfers
                           if r.state == "stalled")

        fleet._pump_transfers = pump_and_record
        config = loadgen.SoakConfig(
            workload=plan["workload"], phases=phases, seed=plan["seed"] + 17,
            step_dt_s=plan["ab_dt"], step_cost=step_cost, fault_specs=fault,
            report_path=(os.path.join(report_dir, f"soak-report-disagg-{name}.json")
                         if report_dir else None),
            drain_grace_s=60.0, label=f"disagg_soak_{name}")
        report = loadgen.SoakHarness(fleet, config, clock=clock).run()
        out = _arm_out(report, fleet, engines, primed, roles)
        out["handoff_wall_s"] = walls
        out["stalled"] = {r: (fleet.transfer_record(r) is not None, fleet.result(r) is not None)
                          for r in sorted(stalled)}
        arms[name] = out
    return arms


def disagg_probe(plane_cls, make_engine, vocab: int, plan: dict) -> tuple:
    """The closed-loop greedy probe (measure.py:2155-2194): four prompts
    through a colocated engine, and through a prefill engine and a decode
    engine pumped by hand over a ``host_buffer`` plane. Returns both
    results by request id; they must be equal token for token."""
    import numpy as np

    bs = plan["block_size"]
    rng = np.random.default_rng(plan["seed"] + 7)
    prompts = [rng.integers(1, vocab, size=n).tolist() for n in (bs + 4, 2 * bs, 3 * bs + 1, 5)]
    base = make_engine("colocated", None)
    rids = [base.add_request(p, max_new_tokens=8, request_id=f"bw{i}")
            for i, p in enumerate(prompts)]
    while base.has_work:
        base.step()
    plane = plane_cls("host_buffer")
    pre, dec = make_engine("prefill", plane), make_engine("decode", plane)
    for i, p in enumerate(prompts):
        pre.add_request(p, max_new_tokens=8, request_id=f"bw{i}")
    for _ in range(500):
        if not (pre.has_work or dec.has_work):
            break
        pre.step()
        for manifest in pre.pop_manifests():
            dec.acquire(manifest)
        dec.step()
    return {r: base.result(r) for r in rids}, {r: dec.result(r) for r in rids}


def fleet_counts(fleet: dict, disagg: dict) -> dict:
    """The virtual-clock counts check (f) compares between runs."""
    return {f"{kind}:{name}": arm["counts"]
            for kind, arms in (("fleet", fleet), ("disagg", disagg)) for name, arm in arms.items()}


def fleet_cpu_model(torch, port, cfg, seed: int = 0):
    """A 1-layer fp32 model on the CPU with ``cfg``'s vocab and
    ``max_seq_len``: check (f)'s witness (the arms read no token value)."""
    small = port.TransformerConfig.tiny(num_layers=1, vocab_size=cfg.vocab_size,
                                        max_seq_len=cfg.max_seq_len, dtype="float32")
    return port.CausalLM(small, device="cpu", generator=torch.Generator().manual_seed(seed))


def run_fleet_variants(torch, port, model, report_dir=None) -> tuple:
    """Both variants' arms at the reference's arguments (FLEET, DISAGG) on
    ``model``: returns the fleet arms, the disagg arms and the plans."""
    from accelerate_tpu_torch import loadgen, router
    from accelerate_tpu_torch.serving import ServingEngine, TransferPlane

    cfg = model.config
    f_plan = fleet_plan(loadgen, cfg, FLEET["max_slots"], FLEET["block_size"],
                        FLEET["target_requests"], FLEET["seed"])
    d_plan = disagg_plan(loadgen, cfg, DISAGG["max_slots"], DISAGG["block_size"],
                         DISAGG["target_requests"], DISAGG["seed"])
    f_arms = fleet_arms(loadgen, router, lambda clock: ServingEngine(
        model, max_slots=FLEET["max_slots"], block_size=FLEET["block_size"], now=clock,
        prefix_cache=True, model_fingerprint=f_plan["fingerprint"]), f_plan, report_dir)
    gc.collect()
    d_arms = disagg_arms(loadgen, router, TransferPlane, lambda clock, plane: ServingEngine(
        model, max_slots=DISAGG["max_slots"], block_size=DISAGG["block_size"], now=clock,
        prefix_cache=True, model_fingerprint=d_plan["fingerprint"], transfer_plane=plane),
        d_plan, report_dir)
    gc.collect()
    return f_arms, d_arms, f_plan, d_plan


def fleet_phase(torch, port, wrappers, rep: Report, model) -> None:
    """The reference benchmark's ``fleet_soak`` and ``disagg_soak`` variants
    on the ``decode`` config (see phase 16 in the module docstring). Every
    launch counter is set to 0 before and read after."""
    from accelerate_tpu_torch.serving import ServingEngine, TransferPlane

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    checks = {}
    out_dir = tempfile.mkdtemp(prefix="fleet_soak-")
    f_arms, d_arms, f_plan, d_plan = run_fleet_variants(torch, port, model, out_dir)
    arms_s = time.perf_counter() - phase_t0

    def itl(report):
        return report["headline"].get("soak_p95_itl_s")

    for name, arm in {**f_arms, **d_arms}.items():
        report, counts = arm["report"], arm["counts"]
        plane = arm["transfer"].get("plane") or {}
        walls = arm.get("handoff_wall_s") or []
        rep.line(f"fleet arm {name}: goodput {report['headline']['goodput_tokens_per_s_at_slo']} "
                 f"tokens/s at the SLO, soak p95 ITL {itl(report)} s, warm hit rate "
                 f"{counts['warm_hits'] / counts['warm_lookups'] if counts['warm_lookups'] else 0.0}"
                 f"; {report['engine_steps']} fleet steps; counts {json.dumps(counts)}; decode "
                 f"retraces {arm['decode_retraces']}, prefill retraces {arm['prefill_retraces']} "
                 f"({arm['roles']}); dedup_ratio {plane.get('dedup_ratio')}, bytes_moved_total "
                 f"{plane.get('bytes_moved_total')}, transfer_ms_p95 {plane.get('transfer_ms_p95')}"
                 f" (virtual); hand-offs {len(walls)}, wall s median "
                 f"{statistics.median(walls) if walls else None} max {max(walls, default=None)}")
    rr, af, kill = f_arms["round_robin"], f_arms["prefix_affinity"], f_arms["replica_kill"]
    good = {k: a["report"]["headline"]["goodput_tokens_per_s_at_slo"] for k, a in f_arms.items()}
    rep.line(f"fleet_soak: vs_baseline {good['prefix_affinity'] / good['round_robin'] if good['prefix_affinity'] and good['round_robin'] else None} "
             f"(affinity / round-robin goodput; a reading), warm hits affinity "
             f"{af['counts']['warm_hits']} vs round robin {rr['counts']['warm_hits']}; kill: "
             f"{json.dumps(kill['kill'])}, router {json.dumps(kill['router'])}, recovered "
             f"{kill['report']['fault']['recovered']} after {kill['report']['fault']['recovery_s']}"
             f" s")
    # (a) the probe: greedy tokens across the hand-off equal the colocated run's
    want, got = disagg_probe(TransferPlane, lambda role, plane: ServingEngine(
        model, max_slots=DISAGG["max_slots"], block_size=DISAGG["block_size"], prefix_cache=True,
        model_fingerprint=d_plan["fingerprint"], role=role, transfer_plane=plane),
        model.config.vocab_size, d_plan)
    checks["a"] = got == want and all(v is not None for v in want.values())
    rep.line(f"disagg probe: {len(want)} prompts, tokens across the hand-off equal the colocated "
             f"engine's {checks['a']} ({json.dumps(got)})")
    # (b) zero retraces after priming: decode on every replica, prefill on
    # every decode-role replica
    checks["b"] = all(not any(a["decode_retraces"]) for a in {**f_arms, **d_arms}.values()) and all(
        n == 0 for a in d_arms.values() for n, role in zip(a["prefill_retraces"], a["roles"])
        if role == "decode")
    # (c) affinity's warm hits strictly above round robin's
    checks["c"] = af["counts"]["warm_hits"] > rr["counts"]["warm_hits"]
    # (d) the kill's ledger adds up, every re-queued request ended
    checks["d"] = (kill["counts"]["requests_lost"] == kill["kill"]["seats"]
                   and kill["counts"]["requests_requeued"] == len(kill["kill"]["queued"])
                   and kill["kill"]["requeued_finished_or_shed"])
    # (e) the stall: nothing lost, every stalled hand-off delivered later
    stall = d_arms["transfer_stall"]
    checks["e"] = (stall["counts"]["requests_lost"] == 0 and bool(stall["stalled"])
                   and all(delivered and done for delivered, done in stall["stalled"].values())
                   and stall["transfer"].get("in_flight") == 0)
    colo_itl, dis_itl = itl(d_arms["colocated"]["report"]), itl(d_arms["disagg"]["report"])
    rep.line(f"disagg_soak: p95 ITL colocated {colo_itl} s, disagg {dis_itl} s, vs_baseline "
             f"{colo_itl / dis_itl if colo_itl and dis_itl else None} (a reading); stall arm: "
             f"{len(stall['stalled'])} hand-offs seen stalled, all delivered and finished "
             f"{checks['e']}, recovery {stall['transfer'].get('stall_recovery_s')} s, recovered "
             f"{stall['report']['fault']['recovered']}")
    peak = torch.cuda.max_memory_allocated()
    # (f) the counts equal a CPU run of the same plans on a 1-layer model
    t0 = time.perf_counter()
    card_counts = fleet_counts(f_arms, d_arms)
    del f_arms, d_arms
    gc.collect()
    cpu_f, cpu_d, _, _ = run_fleet_variants(torch, port, fleet_cpu_model(torch, port,
                                                                         model.config))
    cpu_counts = fleet_counts(cpu_f, cpu_d)
    checks["f"] = cpu_counts == card_counts
    rep.line(f"fleet counts on the card equal the CPU run's (1-layer fp32 model, "
             f"{time.perf_counter() - t0:.1f} s) {checks['f']}"
             + ("" if checks["f"] else f": card {json.dumps(card_counts)} cpu "
                f"{json.dumps(cpu_counts)}"))
    launches = {w.__name__: w.launches for w in wrappers}
    rep.line(f"fleet kernel launches of the port {json.dumps(launches)}")
    checks["no_kernel"] = not any(launches.values())
    shutil.rmtree(out_dir)
    rep.line(f"fleet checks {json.dumps(checks)}")
    rep.line(f"fleet phase: {time.perf_counter() - phase_t0:.1f} s (arms {arms_s:.1f} s), "
             f"max_memory_allocated {peak} B")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"fleet: hard checks failed: {failed}")


# ---------------------------------------------------------------------- #
# phases 9-11: the reference benchmark's single-card training variants
# ---------------------------------------------------------------------- #
def variant_trainer(torch, port, cfg_kw: dict, batch: int, steps: int, seed: int = 0,
                    mixed_precision: str = "bf16", optimizer: str = "adamw"):
    """A CausalLM of the reference's config ``cfg_kw`` built on the card from
    a seeded generator, ``prepare``d (under ``mixed_precision="fp8"`` that
    converts its projections) with ``optimizer`` (adamw or sgd, lr 3e-4) and
    clip 1.0, and one batch of seeded tokens that repeats every step (also
    returned, on the card, as the last item)."""
    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision=mixed_precision)
    cfg = port.TransformerConfig(**cfg_kw)
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                           generator=torch.Generator().manual_seed(seed)).numpy()
    dataset = [{"input_ids": tokens[i % batch]} for i in range(steps * batch)]
    model, opt, loader = acc.prepare(model, getattr(port, optimizer)(3e-4),
                                     port.DataLoader(dataset, batch_size=batch))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    first = {"input_ids": torch.from_numpy(tokens[:batch]).to(acc.device)}
    torch.cuda.synchronize()
    return acc, model, opt, loader, step, carry, first


def set_config(model, **changes) -> None:
    """``model``'s config, and every submodule's that shares it, with
    ``changes`` in place (``remat``, ``attention_impl``)."""
    import dataclasses

    old = model.config
    new = dataclasses.replace(old, **changes)
    for module in model.modules():
        if getattr(module, "config", None) is old:
            module.config = new


def grads_of(torch, model, batch, dtype) -> dict:
    """The step's gradients: the loss on the params cast to ``dtype``, its
    gradients on the fp32 masters (``Accelerator.unified_step``'s own
    arithmetic), returned as fp32 tensors by name."""
    params = dict(model.named_parameters())
    compute = {k: p.to(dtype) for k, p in params.items()}
    batch = {k: v.to("cuda") for k, v in batch.items()}
    loss = model.loss_fn(model)(compute, batch)
    grads = torch.autograd.grad(loss.float(), list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def unequal(a: dict, b: dict) -> list:
    return [k for k in a if not a[k].equal(b[k])]


def run_counted(torch, wrappers, step, carry, loader):
    """``run_steps`` with every launch counter set to 0 just before and read
    just after; the peak memory of the steps."""
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, batch, losses, norms, times = run_steps(torch, step, carry, loader)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    return carry, batch, losses, times, launches, by_design, torch.cuda.max_memory_allocated()


def check_launches(name, launches, by_design, want, design: str = "wgmma") -> None:
    """Exact launches of every wrapper (those not in ``want``: 0), each flash
    wrapper's counted under ``design`` alone."""
    full = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_fused": 0,
            "qkv_prologue": 0, "adamw_epilogue": 0, **want}
    if launches != full:
        fail(f"{name} kernel launches {launches}, want {full}")
    other = "wmma" if design == "wgmma" else "wgmma"
    want_design = {w: {design: full[w], other: 0} for w in by_design}
    if by_design != want_design:
        fail(f"{name} launches by design {by_design}, want {want_design}")


# kernel groups of the variants' profiled steps, first match wins
VARIANT_GROUPS = (
    ("grouped GEMMs", lambda k: "GroupProblemShape" in k or "grouped_gemm" in k),
    ("fp8 GEMMs", lambda k: re.match(r"nvjet_[qr][qr]", k) is not None),
    ("flash kernels", lambda k: "flash_" in k and "_kernel" in k),
    ("other matmuls", lambda k: any(t in k.lower() for t in ("gemm", "nvjet", "xmma",
                                                             "cutlass"))),
    ("quantisation (amax, scale, clamp, fp8 casts)",
     lambda k: any(t in k for t in ("Float8", "float8", "AbsMax", "clamp", "NormOps"))),
    ("dispatch (sort, gathers, bincount, cumsum, combine)",
     lambda k: any(t in k.lower() for t in ("sort", "index", "gather", "scatter", "bincount",
                                            "scan", "histogram", "cumsum", "one_hot",
                                            "embedding"))),
)


def profile_groups(torch, fn, rep: Report, name: str):
    """``fn()`` once under torch.profiler: wall (host clock ending in a
    synchronise), device busy (every kernel's self time) and its share, the
    busy time by VARIANT_GROUPS (the rest: elementwise and the rest), the
    optimizer's ``unified_step.sync_apply`` range on the device, and the
    launches of each kernel name. Returns {kernel name: launches}, or None
    when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, counts, sync_ms = {}, {}, None
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key == "unified_step.sync_apply":
            sync_ms = evt.device_time_total / 1e3
        else:
            kernels[evt.key] = evt.self_device_time_total / 1e3
            counts[evt.key] = evt.count
    busy = sum(kernels.values())
    if busy == 0:
        rep.line(f"{name} profiled step: the profiler saw no device time (not measured)")
        return None
    groups = dict.fromkeys([g for g, _ in VARIANT_GROUPS] + ["the rest (elementwise, norms, "
                                                              "loss, optimizer)"], 0.0)
    for key, ms in kernels.items():
        group = next((g for g, match in VARIANT_GROUPS if match(key)), None)
        groups[group or list(groups)[-1]] += ms
    rep.line(f"{name} profiled step: wall {wall_ms} ms, device busy {busy} ms "
             f"({100 * busy / wall_ms} %), by group ms {json.dumps(groups)}; optimizer "
             f"(unified_step.sync_apply) {sync_ms} ms on the device")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        rep.line(f"{name} profiled step: {ms} ms x{counts[key]} {key[:100]}")
    return counts


def time_flash_shape(torch, fa, rep: Report, label: str, B, S, H, Hkv, D,
                     bwd_library_on_dq: bool = False, dtype=None) -> list[dict]:
    """B1-B3 at a variant's attention shape (bf16 unless ``dtype`` says
    otherwise, causal): first the gated ``check_case`` at this shape (every
    flash kernel against its plain version row by row, launches by design,
    the repeat bits; a failure ends the script), whose max abs errors go
    into the rows; then the times of kernel, plain version and, for B1,
    SDPA's forward; B2 + B3 beside PyTorch's backward of the same attention
    as a yardstick (the flash backward op; in fp32, which it does not
    take, SDPA's backward through autograd), which ``bwd_library_on_dq``
    also puts in B2's row as its library column (it computes dq, dk and
    dv: B2 and B3 together)."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    tag = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}[dtype]
    gc.collect()
    torch.cuda.empty_cache()
    reading, abs_errs = check_case(torch, fa, f"{label}_{tag}_causal", B, S, H, Hkv, D, dtype)
    rep.line(json.dumps(reading))
    if reading["bad"]:
        fail(f"flash kernels at {label}'s shape beyond tolerance or design: {reading['bad']}")
    torch.cuda.empty_cache()
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, dtype, seed=5)
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = fa.attention_delta(out, dout)
    torch.cuda.empty_cache()
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                      lambda: fa.flash_fwd_reference(q, k, v, scale, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale,
                                                           True)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale,
                                                             True)),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    pairs = visible_pairs(torch, S, S, True) * B * H
    e = q.element_size()
    qo, kv, stat = B * S * H * D * e, B * S * Hkv * D * e, B * H * S * 4
    work = {
        "flash_fwd": (2 * 2 * D * pairs, qo + 2 * kv + qo + stat),
        "flash_bwd_dq": (3 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo),
        "flash_bwd_dkv": (4 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + 2 * kv),
    }
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    rows = []
    for wrapper, (kfn, pfn) in fns.items():
        ms = time_ms(torch, kfn, 20, flush)
        plain_ms = time_ms(torch, pfn, 2, flush)
        torch.cuda.empty_cache()
        row = kernel_row(wrapper, fa.kernel_design(dtype, D), ms, plain_ms,
                         *work[wrapper], peak, abs_errs[wrapper],
                         library_fwd if wrapper == "flash_fwd" else None)
        row["shape"] = f"{label} B{B} S{S} H{H} Hkv{Hkv} D{D} {tag} causal"
        rows.append(row)
        rep.line(f"{KERNELS[wrapper][0]} at {label}'s shape: {ms:.4f} ms (plain {plain_ms:.4f} "
                 f"ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                 f"{work[wrapper][0] / ms / 1e9:.1f} TFLOP/s), max abs err {abs_errs[wrapper]}")

    def two_pass():
        fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True)
        fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True)

    if dtype == torch.float32:
        library_bwd = time_sdpa_bwd(torch, q, k, v, dout, scale, flush, rep, f"{label}'s shape")
    else:
        library_bwd = time_library_bwd(torch, q, k, v, dout, scale, flush, rep,
                                       f"{label}'s shape")
    rep.line(f"at {label}'s shape ({tag}): SDPA forward {library_fwd:.4f} ms; B2 + B3 "
             f"{time_ms(torch, two_pass, 10, flush):.4f} ms against PyTorch's backward "
             f"{library_bwd:.4f} ms (yardstick: all of dq, dk, dv, no GQA sum)")
    if bwd_library_on_dq:
        rows[1]["library_ms"] = library_bwd
    del q, k, v, dout, out, lse, delta, scratch
    torch.cuda.empty_cache()
    return rows


def moe_layer_outputs(torch, moe_module, x, g, dispatch, factor=None):
    """One MoE layer's output and the gradients of <output, g> with respect
    to x, the router and the three stacks, under ``dispatch``."""
    import dataclasses

    cfg = moe_module.config
    moe_module.config = dataclasses.replace(
        cfg, moe_dispatch=dispatch, moe_capacity_factor=factor or cfg.moe_capacity_factor)
    try:
        xg = x.detach().requires_grad_(True)
        out = moe_module(xg)
        params = [xg, moe_module.router.weight, moe_module.gate_proj, moe_module.up_proj,
                  moe_module.down_proj]
        grads = torch.autograd.grad(out, params, g)
    finally:
        moe_module.config = cfg
    return [out.detach()] + [t.detach() for t in grads]


def moe_phase(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 9: see the module docstring. Returns B1-B3's rows at the
    config's attention shape, with this phase's launches."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import moe as moe_ops

    cfg_kw, B, steps = MOE_CFG, VARIANT_BATCH["moe"], VARIANT_STEPS
    S, E, K = cfg_kw["max_seq_len"], cfg_kw["num_experts"], cfg_kw["num_experts_per_tok"]
    rows = time_flash_shape(torch, fa, rep, "moe", B, S, cfg_kw["num_heads"],
                            cfg_kw["num_kv_heads"], 128)
    moe_small_check(torch, port, rep)
    t0 = time.perf_counter()
    acc, model, opt, loader, step, carry, _ = variant_trainer(torch, port, cfg_kw, B, steps)
    n_params = sum(p.numel() for p in model.parameters())
    rep.line(f"moe set-up: {n_params} params (registry.py:214-258), "
             f"{time.perf_counter() - t0:.2f} s")

    # 1-3: one MoE layer at full width on B*S tokens: ragged and capacity
    # against the dense oracle, row by row; capacity 1.25's drops
    layer = model.layers[0].moe
    T, h = B * S, cfg_kw["hidden_size"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(T, 1, h, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(T, 1, h, generator=gen, device="cuda").to(torch.bfloat16)
    names = ("out", "dx", "router", "gate_proj", "up_proj", "down_proj")
    dense = moe_layer_outputs(torch, layer, x, g, "dense")
    readings = {}
    for label, dispatch, factor in (
            ("ragged", "ragged", None),
            ("capacity_no_drop", "capacity", moe_ops.no_drop_capacity_factor(E, K))):
        got = moe_layer_outputs(torch, layer, x, g, dispatch, factor)
        readings[label] = {n: row_err(torch, a, b) for n, a, b in zip(names, got, dense)}
        del got
    del dense
    torch.cuda.empty_cache()
    rep.line(f"moe layer against the dense oracle (T {T}, bf16), worst row's max error over its "
             f"RMS: {json.dumps(readings)}; limit {MOE_ORACLE_TOL}")
    worst = max(v for r in readings.values() for v in r.values())
    if not worst <= MOE_ORACLE_TOL:
        fail(f"moe: ragged or capacity against the dense oracle {worst} > {MOE_ORACLE_TOL}")
    # a shared direction in every token skews the routing, so capacity 1.25
    # must drop (seeded tokens alone route evenly enough that nothing drops)
    x = x + torch.randn(h, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        logits = layer.router(x.float())
        sel = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                         stable=True).indices[..., :K].reshape(T, K)
    C = moe_ops.expert_capacity(T, E, K, cfg_kw["moe_capacity_factor"])
    slot, keep = moe_ops.capacity_slots(sel, E, C)
    cpu_slot, cpu_keep = moe_ops.capacity_slots(sel.cpu(), E, C)
    out = moe_layer_outputs(torch, layer, x, g, "capacity")[0].reshape(T, h)
    both = (~keep).reshape(T, K).all(dim=1)
    rep.line(f"moe capacity {cfg_kw['moe_capacity_factor']} (C {C}): {int((~keep).sum())} of "
             f"{T * K} (token, choice) pairs dropped on the card, {int((~cpu_keep).sum())} by "
             f"the plain version on the CPU; {int(both.sum())} tokens lost both choices")
    if not (torch.equal(keep.cpu(), cpu_keep) and torch.equal(slot.cpu(), cpu_slot)):
        fail("moe: the card's capacity slots differ from the plain version's on the CPU")
    if not torch.equal(out[both], torch.zeros_like(out[both])):
        fail("moe: a token whose choices were all dropped did not read zeros")
    if not 0 < int((~cpu_keep).sum()) < T * K:
        fail("moe: the skewed routing dropped no pair at capacity 1.25: the check saw nothing")
    del x, g, out, logits, sel, slot, keep

    # 5 steps with exact launch counts, then one profiled step
    carry, batch, losses, times, launches, by_design, peak = run_counted(
        torch, wrappers, step, carry, loader)
    steady = statistics.median(times[1:])
    rep.line(f"moe losses {losses}")
    rep.line(f"moe step seconds {times}; median of steps 2-{steps} {steady} s, {B * S / steady} "
             f"tokens/s; peak memory {peak / 2**30} GiB")
    rep.line(f"moe kernel launches {json.dumps(launches)}")
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        fail(f"moe losses {losses}: not finite or not falling on a repeated batch")
    L = cfg_kw["num_layers"]
    check_launches("moe", launches, by_design, {"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                                                 "flash_bwd_dkv": L * steps})
    counts = profile_groups(torch, lambda: step(carry, batch), rep, "moe")
    if counts is None or not any("GroupProblemShape" in k for k in counts):
        fail("moe profiled step: no grouped GEMM kernel seen")

    # 4: repeat from one copy of the state, bit for bit
    loss_a, grads_a = grads_of(torch, model, batch, torch.bfloat16)
    loss_b, grads_b = grads_of(torch, model, batch, torch.bfloat16)
    bad = unequal(grads_a, grads_b)
    del grads_a, grads_b
    state = opt.opt_state
    snap = {k: t.detach().clone() for k, t in carry["params"].items()}
    moments = {k: (state["mu"][k].clone(), state["nu"][k].clone()) for k in snap}
    count = state["count"]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for k, t in carry["params"].items():
                t.copy_(snap[k])
                state["mu"][k].copy_(moments[k][0])
                state["nu"][k].copy_(moments[k][1])
        state["count"] = count
        _, m = step(carry, batch)
        runs.append((float(m["loss"]), {k: t.detach().clone() for k, t in carry["params"].items()}))
    bad += unequal(runs[0][1], runs[1][1])
    rep.line(f"moe repeat: grads of one state twice {'equal' if loss_a == loss_b else 'differ'} "
             f"(loss {loss_a} vs {loss_b}); a step from one copy twice: loss {runs[0][0]} vs "
             f"{runs[1][0]}; tensors that differ {bad[:4]} ({len(bad)})")
    if loss_a != loss_b or runs[0][0] != runs[1][0] or bad:
        fail(f"moe: a repeated step is not bit for bit the same: {bad[:4]}")
    del acc, model, opt, loader, step, carry, snap, moments, runs
    for row in rows:
        row["launches"] = launches[WRAPPER_OF[row["name"]]]
    return rows


def moe_small_check(torch, port, rep: Report) -> None:
    """A 2-layer fp32 tiny-width MoE CausalLM (ragged: the grouped GEMM on
    the card, the per-expert loop on the CPU) on both devices from one set
    of weights: loss and grads within 1e-4 relative."""
    cfg = port.TransformerConfig.tiny(vocab_size=512, hidden_size=128, intermediate_size=256,
                                      num_heads=4, num_kv_heads=2, num_experts=4,
                                      moe_dispatch="ragged", attention_impl="flash")
    cpu_model = port.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = port.CausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(1))
    results = []
    for model, device in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        params = dict(model.named_parameters())
        loss = port.CausalLM.loss_fn(model)(params, {"input_ids": ids.to(device)})
        grads = torch.autograd.grad(loss, list(params.values()))
        results.append((float(loss.detach()), [t.cpu() for t in grads]))
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
    grad_err = max(rel_err(torch, a, b) for a, b in zip(gpu_grads, cpu_grads))
    rep.line(f"small MoE model fp32 (grouped GEMM, flash) vs CPU plain path: loss {gpu_loss} vs "
             f"{cpu_loss}, max grad rel err {grad_err:.3g}")
    if not (abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss) and grad_err <= 1e-4):
        fail("small MoE model: the card disagrees with the CPU plain path")


def check_fp8_products(torch, rep: Report) -> dict:
    """``fp8_matmul`` on the card (``torch._scaled_mm``) against its plain
    version on the card (the codes multiplied in fp32), at the dense
    config's projection shapes (M = B*S rows): the forward, dx and dw row
    by row. Both sides quantise the same bf16 inputs to the same codes."""
    from accelerate_tpu_torch.ops import fp8

    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
    M, h, f = VARIANT_BATCH["dense"] * DENSE_CFG["max_seq_len"], DENSE_CFG["hidden_size"], \
        DENSE_CFG["intermediate_size"]
    kv = DENSE_CFG["num_kv_heads"] * 128
    gen = torch.Generator(device="cuda").manual_seed(11)
    readings = {}
    for label, k, n in (("q/o", h, h), ("k/v", h, kv), ("gate/up", h, f), ("down", f, h)):
        x = torch.randn(M, k, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        w.requires_grad_()
        g = torch.randn(M, n, generator=gen, device="cuda").to(torch.bfloat16)
        out = fp8.fp8_matmul(x, w, out_dtype=torch.bfloat16)
        dx, dw = torch.autograd.grad(out, (x, w), g)
        xs, ws = fp8._scale_for(x, fp8.E4M3_MAX), fp8._scale_for(w, fp8.E4M3_MAX)
        gs = fp8._scale_for(g, fp8.E5M2_MAX)
        xq, wq = fp8.quantize_fp8(x.detach(), e4m3, xs), fp8.quantize_fp8(w.detach(), e4m3, ws)
        gq = fp8.quantize_fp8(g, e5m2, gs)
        plain = fp8.scaled_mm_reference(xq, wq, xs, ws, torch.float32)
        pdx = fp8.scaled_mm_reference(gq, wq.t(), gs, ws, torch.float32)
        pdw = fp8.scaled_mm_reference(xq.t(), gq, xs, gs, torch.float32)
        readings[label] = {"out": row_err(torch, out, plain), "dx": row_err(torch, dx, pdx),
                           "dw": row_err(torch, dw, pdw)}
        del x, w, g, out, dx, dw, xq, wq, gq, plain, pdx, pdw
    torch.cuda.empty_cache()
    rep.line(f"fp8_matmul (torch._scaled_mm, e4m3 / e5m2) against its plain version on the card at "
             f"M {M}, worst row's max error over its RMS: {json.dumps(readings)}; limit "
             f"{FP8_PRODUCT_TOL}")
    worst = max(v for r in readings.values() for v in r.values())
    if not worst <= FP8_PRODUCT_TOL:
        fail(f"fp8_matmul on the card against its plain version: {worst} > {FP8_PRODUCT_TOL}")
    return readings


def dense_fp8_phase(torch, port, wrappers, rep: Report) -> None:
    """Phase 10: see the module docstring."""
    from accelerate_tpu_torch.models.transformer import Fp8Dense
    from accelerate_tpu_torch.ops import fp8

    cfg_kw, B, steps = DENSE_CFG, VARIANT_BATCH["dense"], VARIANT_STEPS
    S, L = cfg_kw["max_seq_len"], cfg_kw["num_layers"]
    check_fp8_products(torch, rep)
    results = {}
    for precision in ("bf16", "fp8"):
        name = f"dense {precision}"
        t0 = time.perf_counter()
        acc, model, opt, loader, step, carry, _ = variant_trainer(
            torch, port, cfg_kw, B, steps, mixed_precision=precision)
        n_fp8 = sum(isinstance(m, Fp8Dense) for m in model.modules())
        rep.line(f"{name} set-up: {sum(p.numel() for p in model.parameters())} params "
                 f"(registry.py:205-213, remat {model.config.remat!r}), {n_fp8} Fp8Dense "
                 f"projections, {time.perf_counter() - t0:.2f} s")
        if n_fp8 != (7 * L if precision == "fp8" else 0):
            fail(f"{name}: {n_fp8} projections converted to fp8")
        fp8.scaled_mm.calls = 0
        carry, batch, losses, times, launches, by_design, peak = run_counted(
            torch, wrappers, step, carry, loader)
        calls = fp8.scaled_mm.calls
        steady = statistics.median(times[1:])
        rep.line(f"{name} losses {losses}")
        rep.line(f"{name} step seconds {times}; median of steps 2-{steps} {steady} s, "
                 f"{B * S / steady} tokens/s; peak memory {peak / 2**30} GiB")
        rep.line(f"{name} kernel launches {json.dumps(launches)}; fp8 product wrapper "
                 f"(scaled_mm) called {calls} times")
        if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            fail(f"{name} losses {losses}: not finite or not falling on a repeated batch")
        # "dots": the recompute replays the flash forward, once more a layer
        check_launches(name, launches, by_design, {"flash_fwd": 2 * L * steps,
                                                   "flash_bwd_dq": L * steps,
                                                   "flash_bwd_dkv": L * steps})
        # 7 projections x L layers x (forward, dx, dw) fp8 GEMMs a step; the
        # recompute's forward products come from the "dots" cache, though
        # the wrapper is called again for them
        want_calls = (7 * L * 4 * steps) if precision == "fp8" else 0
        if calls != want_calls:
            fail(f"{name}: the fp8 product wrapper called {calls} times, want {want_calls}")
        counts = profile_groups(torch, lambda: step(carry, batch), rep, name)
        if counts is None:
            fail(f"{name}: the profiler saw no kernel, so the fp8 GEMMs cannot be counted")
        fp8_gemms = sum(n for k, n in counts.items() if re.match(r"nvjet_[qr][qr]", k))
        rep.line(f"{name} profiled step: {fp8_gemms} fp8 GEMM kernels (nvjet_[qr][qr]*)")
        if fp8_gemms != (7 * L * 3 if precision == "fp8" else 0):
            fail(f"{name}: {fp8_gemms} fp8 GEMM kernels in one step, want "
                 f"{7 * L * 3 if precision == 'fp8' else 0}")
        if precision == "bf16":  # "dots" against no remat, bit for bit
            _, dots = grads_of(torch, model, batch, torch.bfloat16)
            set_config(model, remat=None)
            _, plain = grads_of(torch, model, batch, torch.bfloat16)
            set_config(model, remat=cfg_kw["remat"])
            bad = unequal(dots, plain)
            rep.line(f"dense bf16: one step's grads under 'dots' and without remat: "
                     f"{len(dots) - len(bad)} of {len(dots)} tensors bitwise equal")
            if bad:
                fail(f"dense: 'dots' changes the step's gradients: {bad[:4]}")
            del dots, plain
        results[precision] = (losses, steady, peak)
        del acc, model, opt, loader, step, carry
    (bl, bs, bp), (fl, fs, fp) = results["bf16"], results["fp8"]
    rep.line(f"dense fp8 against bf16: step time ratio fp8/bf16 {fs / bs}, tokens/s ratio "
             f"{bs / fs}, peak memory {fp / 2**30} vs {bp / 2**30} GiB")
    fp8_loss_gaps(torch, port, rep, {"bf16": bl, "fp8": fl})


def fp8_loss_gaps(torch, port, rep: Report, curves=None) -> None:
    """fp8 against bf16 on the dense config from every seed of FP8_SEEDS,
    5 steps each (``curves``, {precision: losses}, gives the first seed's
    runs where the caller has made them): |fp8 - bf16| by step over the
    bf16 run's first loss, each within FP8_LOSS_TOL."""
    B, steps = VARIANT_BATCH["dense"], VARIANT_STEPS
    runs = {} if curves is None else {FP8_SEEDS[0]: curves}
    for seed in FP8_SEEDS:
        for precision in ("bf16", "fp8"):
            if precision in runs.setdefault(seed, {}):
                continue
            acc, model, opt, loader, step, carry, _ = variant_trainer(
                torch, port, DENSE_CFG, B, steps, seed=seed, mixed_precision=precision)
            runs[seed][precision] = run_steps(torch, step, carry, loader)[2]
            del acc, model, opt, loader, step, carry
    gaps = {seed: [abs(f - b) / r["bf16"][0] for f, b in zip(r["fp8"], r["bf16"])]
            for seed, r in runs.items()}
    worst = [max(g[i] for g in gaps.values()) for i in range(min(map(len, gaps.values())))]
    rep.line(f"dense fp8 against bf16, losses by seed {json.dumps(runs)}")
    rep.line(f"dense fp8 against bf16, |fp8 - bf16| over the bf16 run's first loss by seed "
             f"{json.dumps(gaps)}; largest by step {worst}, limits {list(FP8_LOSS_TOL)}")
    bad = [(seed, "steps") for seed, g in gaps.items() if len(g) != len(FP8_LOSS_TOL)]
    bad += [(seed, i + 1) for seed, g in gaps.items()
            for i, (x, t) in enumerate(zip(g, FP8_LOSS_TOL)) if not x <= t]
    if bad:
        fail(f"dense: the fp8 runs' losses left the bf16 runs' at (seed, step) {bad[:6]}: "
             f"largest by step {worst}, limits {list(FP8_LOSS_TOL)}")


def longseq_phase(torch, port, wrappers, rep: Report) -> tuple[list[dict], float]:
    """Phase 11: see the module docstring. Returns B1-B3's rows at the
    config's attention shape, with the "save_mlp" run's launches, and the
    "save_mlp" run's median step seconds (phase 13's flash side at S 8192)."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    cfg_kw, steps = LONGSEQ_CFG, LONGSEQ_STEPS
    S, L = cfg_kw["max_seq_len"], cfg_kw["num_layers"]
    rows = time_flash_shape(torch, fa, rep, "longseq", 1, S, cfg_kw["num_heads"],
                            cfg_kw["num_kv_heads"], 128)
    grads, by_policy = {}, {}
    for remat in ("save_mlp", "full", None):
        t0 = time.perf_counter()
        acc, model, opt, loader, step, carry, first = variant_trainer(
            torch, port, dict(cfg_kw, remat=remat), 1, steps)
        name = f"longseq remat={remat!r}"
        rep.line(f"{name} set-up: {sum(p.numel() for p in model.parameters())} params "
                 f"(registry.py:259-288), {time.perf_counter() - t0:.2f} s")
        _, grads[remat] = grads_of(torch, model, first, torch.bfloat16)
        if remat != "save_mlp":  # held against the first policy's, then dropped
            bad = unequal(grads[remat], grads["save_mlp"])
            rep.line(f"{name}: one step's grads against 'save_mlp': {len(bad)} tensors differ")
            if bad:
                fail(f"longseq: remat={remat!r} changes the step's gradients: {bad[:4]}")
            del grads[remat]
        carry, batch, losses, times, launches, by_design, peak = run_counted(
            torch, wrappers, step, carry, loader)
        steady = statistics.median(times[1:])
        rep.line(f"{name} losses {losses}; step seconds {times}; median of steps 2-{steps} "
                 f"{steady} s, {S / steady} tokens/s; peak memory {peak / 2**30} GiB")
        rep.line(f"{name} kernel launches {json.dumps(launches)}")
        if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            fail(f"{name} losses {losses}: not finite or not falling on a repeated batch")
        fwd = (1 if remat is None else 2) * L * steps
        check_launches(name, launches, by_design, {"flash_fwd": fwd, "flash_bwd_dq": L * steps,
                                                   "flash_bwd_dkv": L * steps})
        by_policy[remat] = launches
        if remat == "save_mlp":
            save_mlp_s = steady
            profile_groups(torch, lambda: step(carry, batch), rep, name)
        del acc, model, opt, loader, step, carry
    del grads
    for row in rows:
        row["launches"] = by_policy["save_mlp"][WRAPPER_OF[row["name"]]]
    return rows, save_mlp_s


def variant_phases(torch, port, wrappers, rep: Report) -> tuple[list[dict], float]:
    """Phases 9-11; returns the B1-B3 rows at the moe and longseq shapes and
    longseq's "save_mlp" step seconds."""
    t0 = time.perf_counter()
    rows = moe_phase(torch, port, wrappers, rep)
    t1 = time.perf_counter()
    dense_fp8_phase(torch, port, wrappers, rep)
    t2 = time.perf_counter()
    longseq_rows, save_mlp_s = longseq_phase(torch, port, wrappers, rep)
    rep.line(f"variant phases: moe {t1 - t0:.1f} s, dense/fp8 {t2 - t1:.1f} s, longseq "
             f"{time.perf_counter() - t2:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rows + longseq_rows, save_mlp_s


# ---------------------------------------------------------------------- #
# phase 13: the reference benchmark's accum variant and the long-sequence
# flash-against-plain pair
# ---------------------------------------------------------------------- #
def accum_trainer(torch, port, fused: bool, policy=None):
    """``measure.py:_run_accum``'s set-up in one mode on the ``small``
    config: the model and one batch of tokens from seed 0, adamw (lr 3e-4),
    clip 1.0, telemetry on, K microbatches an optimizer step (fused: the
    batch stacked K times, one call; unfused: K calls); ``policy`` replaces
    the bf16 policy (phase 23 (d)'s grad_dtype). Returns the accelerator, the step,
    its carry, the batch, the calls an optimizer step takes and the
    parameter count."""
    B, K = ACCUM["B"], ACCUM["K"]
    S, vocab = ACCUM_CFG["max_seq_len"], ACCUM_CFG["vocab_size"]
    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision="bf16", telemetry=True,
                           gradient_accumulation_plugin=port.GradientAccumulationPlugin(
                               num_steps=K, fused=fused), mixed_precision_policy=policy)
    model = port.CausalLM(port.TransformerConfig(**ACCUM_CFG), device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(0))
    model, opt = acc.prepare(model, port.adamw(3e-4))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    ids = torch.randint(0, vocab, (B, S), generator=torch.Generator().manual_seed(0)).to("cuda")
    batch = {"input_ids": ids.expand(K, B, S).contiguous() if fused else ids}
    torch.cuda.synchronize()
    return acc, step, carry, batch, 1 if fused else K, sum(p.numel() for p in model.parameters())


def accum_steps(torch, step, carry, batch, calls: int, n: int):
    """``n`` optimizer steps of ``calls`` calls each. Returns the carry, the
    losses (each microbatch's) and each optimizer step's seconds (host clock
    ending in a synchronise)."""
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        for _ in range(calls):
            carry, metrics = step(carry, batch)
            losses += (metrics["loss_per_microbatch"].tolist() if calls == 1
                       else [float(metrics["loss"])])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return carry, losses, times


def accum_mode(torch, port, wrappers, fused: bool, rep: Report) -> dict:
    """One mode of ``_run_accum`` with telemetry on: ``ACCUM["warmup"]`` and
    then ``ACCUM["iters"]`` optimizer steps, every launch counter set to 0
    just before and read just after. Returns the readings and, for the
    profile, the step, its carry and its batch."""
    K, L = ACCUM["K"], ACCUM_CFG["num_layers"]
    acc, step, carry, batch, calls, n_params = accum_trainer(torch, port, fused)
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    steps = ACCUM["warmup"] + ACCUM["iters"]
    carry, losses, times = accum_steps(torch, step, carry, batch, calls, steps)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    records = [r for r in acc.telemetry.records if r.get("kind") == "step"]
    name = "accum fused" if fused else "accum unfused"
    timed = times[ACCUM["warmup"]:]
    out = {
        "name": name, "timed": timed, "losses": losses, "records": len(records),
        "microbatches": records[-1]["microbatches"],
        "dispatches_per_opt_step": records[-1]["dispatches_per_opt_step"],
        "launches": launches, "peak": torch.cuda.max_memory_allocated(),
        "opt_step": carry["opt_step"], "n_params": n_params,
        "params": {k: p.detach().clone() for k, p in carry["params"].items()},
        "profile": (step, carry, batch, calls),
    }
    rep.line(f"{name}: optimizer-step seconds {times} (median of the {ACCUM['iters']} timed "
             f"{statistics.median(timed)} s); records {len(records)}, last record microbatches "
             f"{out['microbatches']} dispatches_per_opt_step {out['dispatches_per_opt_step']}; "
             f"peak memory {out['peak'] / 2**30} GiB; kernel launches {json.dumps(launches)}")
    check_launches(name, launches, by_design, {"flash_fwd": L * K * steps,
                                               "flash_bwd_dq": L * K * steps,
                                               "flash_bwd_dkv": L * K * steps})
    return out


def accum_phase(torch, port, wrappers, rep: Report) -> list[dict]:
    """The ``accum`` variant: fused and unfused from one init and batch, in
    the order unfused, fused (once each: the repeat of each mode, 7.6 s, was
    cut for phase 23's time); their records, launches and
    times, the params bit for bit, a profiled optimizer step of each and the
    kernels whose launch counts differ between the two. Returns B1-B3's
    rows at its attention shape."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    K = ACCUM["K"]
    H, Hkv = ACCUM_CFG["num_heads"], ACCUM_CFG["num_kv_heads"]
    rows = time_flash_shape(torch, fa, rep, "accum", ACCUM["B"], ACCUM_CFG["max_seq_len"], H,
                            Hkv, ACCUM_CFG["hidden_size"] // H)
    timed, params, losses, counts = {False: [], True: []}, {}, {}, {}
    for fused in (False, True):
        run = accum_mode(torch, port, wrappers, fused, rep)
        want = (K, 1) if fused else (1, K)
        got = (run["microbatches"], run["dispatches_per_opt_step"])
        calls = (1 if fused else K) * (ACCUM["warmup"] + ACCUM["iters"])
        if got != want or run["records"] != calls:
            fail(f"{run['name']}: {run['records']} step records reading (microbatches, "
                 f"dispatches_per_opt_step) {got}, want {calls} reading {want}")
        if run["opt_step"] != ACCUM["warmup"] + ACCUM["iters"]:
            fail(f"{run['name']} took {run['opt_step']} optimizer steps")
        if not all(math.isfinite(x) for x in run["losses"]):
            fail(f"{run['name']}: a loss is not finite: {run['losses']}")
        timed[fused] += run["timed"]
        if fused not in params:  # the first run of each mode: params, profile
            params[fused], losses[fused] = run["params"], run["losses"]
            step, carry, batch, calls = run["profile"]

            def one_opt_step(step=step, carry=carry, batch=batch, calls=calls):
                for _ in range(calls):
                    carry = step(carry, batch)[0]

            counts[fused] = profile_groups(torch, one_opt_step, rep,
                                           f"{run['name']} optimizer step") or {}
            del step, carry, batch, one_opt_step
            if fused:
                for row in rows:
                    row["launches"] = run["launches"][WRAPPER_OF[row["name"]]]
        del run
    differ = sorted(((k, counts[False].get(k, 0), counts[True].get(k, 0))
                     for k in set(counts[False]) | set(counts[True])
                     if counts[False].get(k, 0) != counts[True].get(k, 0)),
                    key=lambda t: -abs(t[2] - t[1]))
    rep.line(f"accum: kernels launched a different number of times in one optimizer step, "
             f"(name, unfused, fused): {[(k[:70], u, f) for k, u, f in differ[:8]]}")
    bad = unequal(params[True], params[False])
    worst = max((rel_err(torch, params[True][k], params[False][k]) for k in bad), default=0.0)
    rep.line(f"accum: {ACCUM_CFG} ({sum(p.numel() for p in params[True].values())} params, "
             f"registry.py:298-304 small); fused against unfused after "
             f"{ACCUM['warmup'] + ACCUM['iters']} optimizer steps: "
             f"{len(params[True]) - len(bad)} of {len(params[True])} tensors bitwise equal, "
             f"worst differing tensor max|diff| / max|unfused| {worst}; losses equal: "
             f"{losses[True] == losses[False]}")
    u, f = statistics.median(timed[False]), statistics.median(timed[True])
    rep.line(f"accum: median optimizer-step seconds of each mode: unfused {u} "
             f"(runs {timed[False]}), fused {f} (runs {timed[True]}); vs_baseline "
             f"(unfused / fused) {u / f}")
    if bad or losses[True] != losses[False]:
        fail(f"accum: fused and unfused differ: {bad[:4]} ({len(bad)} tensors)")
    return rows


def longseq_pair(torch, port, wrappers, rep: Report) -> tuple[list[dict], float]:
    """``longseq4k`` and ``longseq_xla4k``: the flash and the plain path at
    S 4096 under ``"full"`` remat with sgd, one step's gradients of each
    from one init held against each other row by row, then
    LONGSEQ4K_STEPS steps of each with exact launches. Returns B1-B3's rows
    at the shape and the flash side's median step seconds."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    S, L = LONGSEQ4K_CFG["max_seq_len"], LONGSEQ4K_CFG["num_layers"]
    rows = time_flash_shape(torch, fa, rep, "longseq4k", 1, S, LONGSEQ4K_CFG["num_heads"],
                            LONGSEQ4K_CFG["num_kv_heads"], 128)
    steps, steady, flash_grads = LONGSEQ4K_STEPS, {}, None
    for impl in ("flash", "xla"):
        name = "longseq4k" if impl == "flash" else "longseq_xla4k"
        acc, model, opt, loader, step, carry, first = variant_trainer(
            torch, port, dict(LONGSEQ4K_CFG, attention_impl=impl), 1, steps, optimizer="sgd")
        _, grads = grads_of(torch, model, first, torch.bfloat16)
        if flash_grads is None:  # held on the host while the plain side runs
            flash_grads = {k: g.cpu() for k, g in grads.items()}
        else:
            errs = {k: row_err(torch, flash_grads[k].to("cuda"), g) for k, g in grads.items()}
            worst = max(errs, key=errs.get)
            rep.line(f"longseq4k: first-step grads, flash against plain, worst row's max error "
                     f"over its RMS {errs[worst]} ({worst}); median over tensors "
                     f"{statistics.median(errs.values())}; limit {LONGSEQ_GRAD_TOL}")
            if not errs[worst] <= LONGSEQ_GRAD_TOL:
                fail(f"longseq4k: flash and plain grads differ: {errs[worst]} > "
                     f"{LONGSEQ_GRAD_TOL} at {worst}")
            del flash_grads
        del grads
        carry, batch, losses, times, launches, by_design, peak = run_counted(
            torch, wrappers, step, carry, loader)
        steady[impl] = statistics.median(times[1:])
        rep.line(f"{name} losses {losses}; step seconds {times}; median of steps 2-{steps} "
                 f"{steady[impl]} s, {S / steady[impl]} tokens/s; peak memory {peak / 2**30} GiB")
        rep.line(f"{name} kernel launches {json.dumps(launches)}")
        if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            fail(f"{name} losses {losses}: not finite or not falling on a repeated batch")
        want = ({"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                 "flash_bwd_dkv": L * steps} if impl == "flash" else {})
        check_launches(name, launches, by_design, want)
        profile_groups(torch, lambda: step(carry, batch), rep, name)
        if impl == "flash":
            for row in rows:
                row["launches"] = launches[WRAPPER_OF[row["name"]]]
        del acc, model, opt, loader, step, carry, first, batch
    rep.line(f"longseq4k pair: flash_speedup_vs_xla {steady['xla'] / steady['flash']} at S {S} "
             f"(sgd, remat 'full'; runner.py:526-534's ratio)")
    return rows, steady["flash"]


def longseq_xla_phase(torch, port, wrappers, rep: Report, flash_s) -> None:
    """``longseq_xla``: the ``longseq`` config on the plain path at S 8192
    (``"save_mlp"``, adamw), its steps, peak memory and launches (none),
    and ``flash_speedup_vs_xla`` against the flash side's median step
    (phase 11's, or its own run of the flash side when phase 11 did not
    run)."""
    steps, S = LONGSEQ_STEPS, LONGSEQ_CFG["max_seq_len"]
    if flash_s is None:
        acc, model, opt, loader, step, carry, _ = variant_trainer(torch, port, LONGSEQ_CFG, 1,
                                                                  steps)
        times = run_counted(torch, wrappers, step, carry, loader)[3]
        flash_s = statistics.median(times[1:])
        rep.line(f"longseq flash 'save_mlp' (for the ratio): step seconds {times}")
        del acc, model, opt, loader, step, carry
    acc, model, opt, loader, step, carry, _ = variant_trainer(
        torch, port, dict(LONGSEQ_CFG, attention_impl="xla"), 1, steps)
    carry, batch, losses, times, launches, by_design, peak = run_counted(
        torch, wrappers, step, carry, loader)
    xla_s = statistics.median(times[1:])
    rep.line(f"longseq_xla losses {losses}; step seconds {times}; median of steps 2-{steps} "
             f"{xla_s} s; peak memory {peak / 2**30} GiB; kernel launches {json.dumps(launches)}")
    rep.line(f"longseq_xla: flash_speedup_vs_xla {xla_s / flash_s} at S {S} (adamw, remat "
             f"'save_mlp'; flash {flash_s} s)")
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        fail(f"longseq_xla losses {losses}: not finite or not falling on a repeated batch")
    check_launches("longseq_xla", launches, by_design, {})
    profile_groups(torch, lambda: step(carry, batch), rep, "longseq_xla")


def oom_phase(torch, port, rep: Report) -> None:
    """A real CUDA out-of-memory error through ``find_executable_batch_size``:
    two steps of ``longseq_xla`` at S 8192 from B ``OOM_START_BATCH``, whose
    fp32 scores alone take 32 GiB a layer. At least one OOM must be caught
    and the batch halved, the batch it settles on must train with finite
    losses, and after ``free_memory`` the allocated bytes must be back to
    what they were before the first attempt (within 1 %, and 1 MiB)."""
    from accelerate_tpu_torch.utils.memory import release_memory

    release_memory()
    before = torch.cuda.memory_allocated()
    tried, caught = [], []

    @port.find_executable_batch_size(starting_batch_size=OOM_START_BATCH)
    def train(batch_size):
        tried.append(batch_size)
        acc, model, opt, loader, step, carry, _ = variant_trainer(
            torch, port, dict(LONGSEQ_CFG, attention_impl="xla"), batch_size, 2)
        try:
            losses = run_steps(torch, step, carry, loader)[2]
        except torch.OutOfMemoryError as e:
            caught.append(str(e).splitlines()[0][:160])
            raise
        return losses, acc

    t0 = time.perf_counter()
    losses, acc = train()
    acc.free_memory()
    del acc
    after = torch.cuda.memory_allocated()
    rep.line(f"oom: batch sizes tried {tried}, CUDA OOMs caught {len(caught)} ({caught[:1]}); "
             f"settled at B {tried[-1]} with losses {losses}; allocated before the first "
             f"attempt {before} B, after free_memory {after} B; {time.perf_counter() - t0:.1f} s")
    if not caught or len(tried) < 2 or tried[1] != tried[0] // 2:
        fail(f"oom: no CUDA OOM caught and halved: tried {tried}, caught {caught}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"oom: the settled batch's losses are not finite: {losses}")
    if abs(after - before) > 0.01 * before + 2**20:
        fail(f"oom: {after} B allocated after free_memory against {before} B before")


def phase13(torch, port, wrappers, rep: Report, flash_8k_s=None) -> list[dict]:
    """Phase 13: see the module docstring. Returns B1-B3's rows at the
    ``accum`` and ``longseq4k`` shapes."""
    t0 = time.perf_counter()
    rows = accum_phase(torch, port, wrappers, rep)
    t1 = time.perf_counter()
    pair_rows, _ = longseq_pair(torch, port, wrappers, rep)
    t2 = time.perf_counter()
    longseq_xla_phase(torch, port, wrappers, rep, flash_8k_s)
    t3 = time.perf_counter()
    oom_phase(torch, port, rep)
    rep.line(f"phase 13: accum {t1 - t0:.1f} s, longseq4k pair {t2 - t1:.1f} s, longseq_xla "
             f"{t3 - t2:.1f} s, oom {time.perf_counter() - t3:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rows + pair_rows


# ---------------------------------------------------------------------- #
# phase 14: the ckpt variant
# ---------------------------------------------------------------------- #
def ckpt_trainer(torch, port, project_dir: str, model_seed: int = 0, reset: bool = True):
    """``measure.py:_run_ckpt``'s set-up (:195-230) on the ``small`` config:
    the model built on the card from a seeded generator, bf16, adamw (lr
    3e-4, no clip), telemetry on, automatic checkpoint naming under
    ``project_dir`` with ``total_limit`` 2. The reference's one batch of
    seeded tokens comes from a prepared loader that repeats it, so each
    checkpoint also carries a loader cursor. ``reset=False`` builds a second
    accelerator beside a live one (the shared states stay as they are)."""
    B, S, vocab = CKPT["B"], ACCUM_CFG["max_seq_len"], ACCUM_CFG["vocab_size"]
    if reset:
        gc.collect()
        torch.cuda.empty_cache()
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision="bf16", telemetry=True,
                           project_config=port.ProjectConfiguration(
                               project_dir=project_dir, automatic_checkpoint_naming=True,
                               total_limit=CKPT["total_limit"]))
    model = port.CausalLM(port.TransformerConfig(**ACCUM_CFG), device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(model_seed))
    tokens = torch.randint(0, vocab, (B, S), generator=torch.Generator().manual_seed(0)).numpy()
    dataset = [{"input_ids": tokens[i % B]} for i in range(CKPT["batches"] * B)]
    model, opt, loader = acc.prepare(model, port.adamw(3e-4), port.DataLoader(dataset,
                                                                            batch_size=B))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt)
    return acc, step, acc.init_carry(model, opt), loader


def host_flat(torch, port, carry) -> dict:
    """Every leaf of the carry, tensors copied to the host (synchronously:
    stream order puts the copies after every kernel queued so far)."""
    return {k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
            for k, v in port.checkpointing.flatten_tree(carry).items()}


def flat_diff(torch, got: dict, want: dict) -> list:
    """The names whose values differ, bit for bit (and any name only one has),
    compared where both live (on the host when their devices differ)."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = got[k], want[k]
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            same = torch.equal(a, b) if a.device == b.device else torch.equal(a.cpu(), b.cpu())
        else:
            same = not isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor) and a == b
        if not same:
            bad.append(k)
    return bad


def host_state_at(acc, loader) -> dict:
    """What a save made now must record: the step, the iteration it took
    (the counter is already one past it), the loader's cursor."""
    return {"step": acc.step, "iteration": acc.project_configuration.iteration - 1,
            "sampler": json.loads(json.dumps(loader.state_dict()))}


def host_state_in(path: str) -> dict:
    """The same, as the checkpoint at ``path`` recorded it."""
    with open(os.path.join(path, "accelerate_state.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "sampler_0.json")) as f:
        sampler = json.load(f)
    return {"step": meta["step"], "iteration": meta["iteration"], "sampler": sampler}


def saved_equals(torch, port, fresh, path: str, want: dict, host: dict):
    """Load ``path`` into the fresh trainer's carry and hold it against
    ``want`` (a ``host_flat``) bit for bit, and its recorded host state
    against ``host``. Returns (the names that differ, the host fields that
    differ)."""
    facc, _, fcarry, _ = fresh
    loaded = facc.load_state(path, carry=fcarry)
    bad = flat_diff(torch, host_flat(torch, port, loaded), want)
    got = host_state_in(path)
    return bad, [k for k in host if got[k] != host[k]]


def shard_digest(path: str) -> str:
    import hashlib

    digest = hashlib.sha256()
    with open(os.path.join(path, "state_shard_00000.safetensors"), "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    return digest.hexdigest()


def host_alloc_stats(torch) -> dict:
    """The caching host allocator's count of page-locked allocations and
    their total time (us), where this PyTorch reports them."""
    stats = torch.cuda.memory.host_memory_stats()
    return {k: v for k, v in stats.items()
            if k in ("num_host_alloc", "host_alloc_time.total", "allocated_bytes.current")}


def ckpt_arm(torch, port, wrappers, mode: str, base: str, rep: Report, checks: dict) -> dict:
    """One arm of ``_run_ckpt`` (:206-262): ``CKPT["warmup"]`` steps, then
    ``CKPT["iters"]`` steps with a CheckpointManager saving every
    CKPT_EVERY synchronously or in the background, each step timed on the
    host clock after its loss is read (the step done on the card before
    the save, as :240 does). Every launch counter is set to 0 just before
    the timed steps and read just after. Then the hard checks of this arm
    (``checks`` gets one entry each, True when it held): (b) the committed
    set; (c) the newest checkpoint against the live carry; (d)
    restore_or_init on a fresh accelerator, then step 17 of both; in the
    async arm also (a) the step-12 save against a host clone taken right
    after it was submitted, while steps 13-16 update the same tensors in
    place; (a2) the same for a ``save_state(block=False)`` made while its
    step may still be running on the card; (e) SIGTERM with a save in
    flight. Returns the arm's readings."""
    import signal

    project_dir = os.path.join(base, mode)
    acc, step, carry, loader = ckpt_trainer(torch, port, project_dir)
    n_params = sum(p.numel() for p in carry["params"].values())
    batches = iter(loader)
    for _ in range(CKPT["warmup"]):
        carry, metrics = step(carry, next(batches))
    float(metrics["loss"])
    mgr = port.CheckpointManager(acc, every_n_steps=CKPT_EVERY, handle_signals=False,
                                 async_saves=mode == "async")
    reset_counts(wrappers)
    host_before = host_alloc_stats(torch)
    times, saved_at, race = [], [], None
    for i in range(1, CKPT["iters"] + 1):
        t0 = time.perf_counter()
        carry, metrics = step(carry, next(batches))
        float(metrics["loss"])
        saved = mgr.step(carry)
        times.append(time.perf_counter() - t0)
        if saved:
            saved_at.append(i)
        if mode == "async" and i == CKPT["race_step"]:
            race = (saved, host_state_at(acc, loader), host_flat(torch, port, carry))
    pinned = mgr._checkpointer.buffers.pinned_bytes if mode == "async" else 0
    mgr.wait()
    host_after = host_alloc_stats(torch)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    mgr.close()
    L = ACCUM_CFG["num_layers"]
    check_launches(f"ckpt {mode}", launches, by_design,
                   {w: L * CKPT["iters"] for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
    recs = [r for r in acc.telemetry.records if r.get("kind") == "checkpoint"]
    save_steps = [t for i, t in enumerate(times, 1) if i in saved_at]
    quiet = [t for i, t in enumerate(times, 1) if i not in saved_at]
    after = [t for i, t in enumerate(times, 1) if i - 1 in saved_at and i - 1 != CKPT["race_step"]]
    out = {
        "saves": len(recs), "blocked_s": statistics.fmean(r["blocked_s"] for r in recs),
        "background_s": statistics.fmean(r["background_s"] for r in recs),
        "bytes_written": recs[-1]["bytes_written"],
        "write_gib_s": statistics.fmean(r["write_bandwidth_bytes_per_s"] or 0.0
                                        for r in recs) / 2**30,
        "save_step_s": statistics.fmean(save_steps), "quiet_step_s": statistics.fmean(quiet),
        "save_step_overhead_s": statistics.fmean(save_steps) - statistics.fmean(quiet),
        "after_save_step_s": statistics.fmean(after) if after else None,
        "pinned_bytes": pinned, "host_rss_bytes": port.telemetry.collector.host_memory_rss(),
        # the caching host allocator's page-locked allocations during the timed steps
        "pinned_allocs": {k: host_after[k] - host_before.get(k, 0) for k in host_after},
        "n_params": n_params, "launches": launches,
    }
    rep.line(f"ckpt {mode}: saves at steps {saved_at} of {CKPT['iters']} (every {CKPT_EVERY}); "
             f"records {[(r['mode'], r['step'], os.path.basename(r['dir'])) for r in recs]}; "
             f"blocked_s {[r['blocked_s'] for r in recs]}, background_s "
             f"{[r['background_s'] for r in recs]}; step seconds {times}")
    rep.line(f"ckpt {mode}: {json.dumps({k: v for k, v in out.items() if k != 'launches'})}; "
             f"kernel launches {json.dumps(launches)}")

    # (b) the committed set
    ckpt_base = os.path.join(project_dir, "checkpoints")
    names = sorted(os.listdir(ckpt_base))
    committed = port.checkpointing._list_checkpoints(ckpt_base)
    newest = committed[-1] if committed else None
    newest_step = host_state_in(newest)["step"] if newest else None
    checks[f"b_{mode}"] = (len(committed) == len(names) and not any(".tmp" in n for n in names)
                           and newest_step == acc.step)
    rep.line(f"ckpt {mode} (b): left {names}, committed {[os.path.basename(c) for c in committed]}"
             f", the newest at step {newest_step} (the live step {acc.step})")

    # (c) the newest checkpoint against the live carry, through restore_or_init (d)
    fresh = ckpt_trainer(torch, port, project_dir, model_seed=1, reset=False)
    facc, fstep, fcarry, floader = fresh
    with port.CheckpointManager(facc, handle_signals=False) as fmgr:
        fcarry, resumed = fmgr.restore_or_init(fcarry)
    fresh = (facc, fstep, fcarry, floader)
    live = host_flat(torch, port, carry)
    bad = flat_diff(torch, host_flat(torch, port, fcarry), live)
    out["digest"] = shard_digest(newest)
    checks[f"c_{mode}"] = resumed and not bad
    rep.line(f"ckpt {mode} (c): the newest checkpoint against the live carry at step "
             f"{acc.step}: {len(live) - len(bad)} of {len(live)} leaves equal bit for bit "
             f"(differ: {bad[:4]}); shard sha256 {out['digest'][:16]}")
    carry, metrics = step(carry, next(batches))
    fcarry, fmetrics = fstep(fcarry, next(iter(floader)))
    bad = flat_diff(torch, host_flat(torch, port, fcarry), host_flat(torch, port, carry))
    same_loss = float(metrics["loss"]) == float(fmetrics["loss"])
    checks[f"d_{mode}"] = resumed and facc.step == acc.step and not bad and same_loss
    rep.line(f"ckpt {mode} (d): restore_or_init resumed {resumed} at step {facc.step - 1}; step "
             f"{CKPT['iters'] + 1} (optimizer step {acc.step}) of the resumed run against the "
             f"live one: losses equal {same_loss}, leaves differing {bad[:4]}")
    fresh = (facc, fstep, fcarry, floader)
    if mode == "sync":
        return out

    # (a) the step-12 save against the clone taken right after its submit
    path, host, want = race
    bad, host_bad = saved_equals(torch, port, fresh, path, want, host)
    checks["a"] = not bad and not host_bad
    rep.line(f"ckpt (a): the async save at step {CKPT['race_step']} ({os.path.basename(path)}), "
             f"written while steps {CKPT['race_step'] + 1}-{CKPT['iters']} updated the same "
             f"tensors in place, against the clone taken right after its submit: "
             f"{len(want) - len(bad)} of {len(want)} leaves equal bit for bit (differ: "
             f"{bad[:4]}); host state {host} (differ: {host_bad})")
    # (a2) a save made while its step may still be running on the card
    carry, metrics = step(carry, next(batches))
    path = acc.save_state(carry=carry, block=False)
    host, want = host_state_at(acc, loader), host_flat(torch, port, carry)
    for _ in range(3):
        carry, metrics = step(carry, next(batches))
    float(metrics["loss"])
    acc.wait_for_checkpoint()
    bad, host_bad = saved_equals(torch, port, fresh, path, want, host)
    checks["a2"] = not bad and not host_bad
    rep.line(f"ckpt (a2): save_state(block=False) with no synchronise after its step, then 3 "
             f"steps: {len(want) - len(bad)} of {len(want)} leaves equal bit for bit (differ: "
             f"{bad[:4]}); host fields differing {host_bad}")
    # (e) SIGTERM with an async save in flight
    with port.CheckpointManager(acc, every_n_steps=1, async_saves=True) as emgr:
        carry, metrics = step(carry, next(batches))
        float(metrics["loss"])
        drained = emgr.step(carry)
        os.kill(os.getpid(), signal.SIGTERM)
        in_flight = emgr.in_flight
        carry, metrics = step(carry, next(batches))
        float(metrics["loss"])
        final = emgr.step(carry)
        stopped, left = emgr.should_stop, emgr.in_flight
    committed = port.checkpointing._list_checkpoints(ckpt_base)
    want = host_flat(torch, port, carry)
    with port.CheckpointManager(facc, handle_signals=False) as fmgr:
        fcarry, resumed = fmgr.restore_or_init(fcarry)
    bad = flat_diff(torch, host_flat(torch, port, fcarry), want)
    checks["e"] = (in_flight and stopped and not left
                   and port.checkpoint_async.is_committed(drained) and committed[-1] == final
                   and resumed and facc.step == acc.step and not bad)
    rep.line(f"ckpt (e): SIGTERM with the async save {os.path.basename(drained)} in flight "
             f"({in_flight}); the next step drained it and wrote {os.path.basename(final)} "
             f"synchronously: should_stop {stopped}, in flight after {left}, committed "
             f"{[os.path.basename(c) for c in committed]}; resumed at step {facc.step} (live "
             f"{acc.step}), leaves differing {bad[:4]}")
    return out


def snapshot_copy_timing(torch, port, rep: Report) -> None:
    """The parts of an async save's snapshot on the card, apart: binding one
    pinned buffer set for the small config's carry (with the host
    allocator's count of fresh page-locked allocations), and the copy of its
    CUDA leaves into it (CUDA events), against a synchronous ``.to("cpu")``
    of the same leaves into fresh pageable memory."""
    dc = port.dist_checkpoint
    acc, _, carry, _ = ckpt_trainer(torch, port, tempfile.gettempdir())  # saves nothing
    named = port.checkpointing.flatten_tree(carry)
    layout = dc.device_layout(named)
    before = host_alloc_stats(torch)
    t0 = time.perf_counter()
    buffers = dc.HostBufferPool(1).acquire(layout)
    alloc_s = time.perf_counter() - t0
    allocs = {k: v - before.get(k, 0) for k, v in host_alloc_stats(torch).items()}
    nbytes = sum(int(math.prod(shape)) * dtype.itemsize for _, shape, dtype in layout)
    copy_ms, pageable_s = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dc.host_copies(named, buffers)
        end.record()
        end.synchronize()
        copy_ms.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        dc.host_copies(named)
        pageable_s.append(time.perf_counter() - t0)
    rep.line(f"ckpt snapshot parts: one pinned buffer set of {buffers.nbytes} B bound in "
             f"{alloc_s} s (the caching host allocator's page-locked allocations meanwhile: "
             f"{allocs}; none when it served freed blocks); the {len(layout)} CUDA leaves "
             f"({nbytes} B) copied into it in "
             f"{copy_ms} ms ({[nbytes / m / 1e6 for m in copy_ms]} GB/s); synchronous "
             f".to('cpu') into pageable memory {pageable_s} s")
    del acc, carry, named, buffers


def phase14(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 14: see the module docstring. Returns B1-B3's rows at the
    ``ckpt`` shape."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    H, Hkv = ACCUM_CFG["num_heads"], ACCUM_CFG["num_kv_heads"]
    rows = time_flash_shape(torch, fa, rep, "ckpt", CKPT["B"], ACCUM_CFG["max_seq_len"], H,
                            Hkv, ACCUM_CFG["hidden_size"] // H)  # check (f)
    t1 = time.perf_counter()
    arm = ckpt_checks(torch, port, wrappers, rep)
    for row in rows:
        row["launches"] = arm["launches"][WRAPPER_OF[row["name"]]]
    t2 = time.perf_counter()
    snapshot_copy_timing(torch, port, rep)
    rep.line(f"phase 14: B1-B3 at the ckpt shape {t1 - t0:.1f} s, the arms and their checks "
             f"{t2 - t1:.1f} s, the snapshot's parts {time.perf_counter() - t2:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def ckpt_checks(torch, port, wrappers, rep: Report) -> dict:
    """The sync and the async arm, then the hard checks; fails naming every
    check that did not hold. Returns the async arm's readings."""
    base = tempfile.mkdtemp(prefix="ckpt_smoke_")
    checks: dict = {}
    try:
        arms = {mode: ckpt_arm(torch, port, wrappers, mode, base, rep, checks)
                for mode in ("sync", "async")}
    finally:
        shutil.rmtree(base, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    checks["c_across"] = arms["sync"]["digest"] == arms["async"]["digest"]
    sync_b, async_b = arms["sync"]["blocked_s"], arms["async"]["blocked_s"]
    rep.line(f"ckpt: {arms['async']['n_params']} params (registry.py:298-304 small), B "
             f"{CKPT['B']}, S {ACCUM_CFG['max_seq_len']}, bytes_written a save "
             f"{arms['async']['bytes_written']}; vs_baseline (sync blocked_s / async blocked_s) "
             f"{sync_b / async_b}; the two arms' step-{CKPT['iters']} shards equal "
             f"{checks['c_across']}")
    rep.line(f"ckpt checks {json.dumps(checks)}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"ckpt: hard checks failed: {failed}")
    return arms["async"]


# ---------------------------------------------------------------------- #
# phase 15: the diagnostics plane and the overhead variant
# ---------------------------------------------------------------------- #
def overhead_setup(torch, port, cfg, B: int, S: int, mode: str, project_dir: str) -> dict:
    """One arm of ``_run_overhead``'s set-up (:2326-2360): an Accelerator in
    bf16, telemetry and diagnostics on (``anomaly_sample_every`` 8) or both
    off, the model from seed 0 on the card, adamw (lr 3e-4), clip 1.0, and
    the reference's batch (numpy's ``default_rng(0)`` tokens). Each arm also
    gets a project directory, which nothing reads while it is timed (the
    checkpoint check (e) saves into it afterwards)."""
    import numpy as np

    diagnostics = (port.DiagnosticsConfig(anomaly_sample_every=OVERHEAD["sample_every"])
                   if mode == "on" else None)
    acc = port.Accelerator(mixed_precision="bf16", telemetry=mode == "on",
                           diagnostics=diagnostics,
                           project_config=port.ProjectConfiguration(
                               project_dir=os.path.join(project_dir, mode),
                               automatic_checkpoint_naming=True))
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    model, opt = acc.prepare(model, port.adamw(3e-4))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    return {"acc": acc, "step": step, "carry": carry, "n_params": n_params, "cfg": cfg,
            "batch": {"input_ids": torch.from_numpy(ids).to(acc.device)},
            "times": [], "losses": []}


def path_design(torch, fa, cfg) -> str:
    """The flash design a model's attention takes: its activations run in
    ``cfg.dtype`` (the reference's "activation dtype at apply time"; under
    bf16 mixed precision only the parameters are cast)."""
    return fa.kernel_design(getattr(torch, cfg.dtype), cfg.hidden_size // cfg.num_heads)


def flash_kernel_names(fa, design: str) -> dict:
    """wrapper -> the kernel name B1-B3 launch as on ``design``."""
    return {w: KERNELS[w][0] if design == "wgmma" else KERNELS[w][0].replace("_kernel",
                                                                              "_wmma_kernel")
            for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def run_arm(s: dict, n: int) -> list:
    """``n`` steps of one arm, each timed on the host clock around the step
    and the read of its loss (the same synchronise in both arms); returns
    the seconds and appends the losses."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        s["carry"], metrics = s["step"](s["carry"], s["batch"])
        loss = float(metrics["loss"])
        ts.append(time.perf_counter() - t0)
        s["losses"].append(loss)
    return ts


def overhead_ab(torch, port, wrappers, rep: Report, label: str, cfg, B: int, S: int,
                iters: int, warmup: int, base: str, checks: dict) -> tuple[dict, dict, dict]:
    """The A/B of ``_run_overhead`` (:2363-2424): both arms built from one
    seed and resident together, ``warmup`` steps each, then ``iters`` steps
    each in interleaved chunks of ``max(1, min(3, iters // 6))``, off before
    on in every round; ``harness_overhead_pct`` is the median of the
    rounds' (on median - off median) over the median "off" step. Every
    launch counter is set to 0 just before the rounds and read just after.
    Then checks (a) (losses at every step, params and moments after the
    last, on against off, bit for bit) and (b) (the "on" arm's step and
    goodput records, the buckets against their wall clock, ``summary()``'s
    ``goodput_pct``). Returns the arms, the readings and the launches."""
    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arms = {}
    for mode in ("off", "on"):
        arms[mode] = overhead_setup(torch, port, cfg, B, S, mode, os.path.join(base, label))
        run_arm(arms[mode], warmup)
    setup_s = time.perf_counter() - t0
    chunk = max(1, min(3, iters // 6))
    reset_counts(wrappers)
    measured, deltas = 0, []
    while measured < iters:
        n = min(chunk, iters - measured)
        med = {}
        for mode in ("off", "on"):
            ts = run_arm(arms[mode], n)
            arms[mode]["times"] += ts
            med[mode] = statistics.median(ts)
        deltas.append(med["on"] - med["off"])
        measured += n
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    peak = torch.cuda.max_memory_allocated()
    medians = {m: statistics.median(a["times"]) for m, a in arms.items()}
    pct = statistics.median(deltas) / medians["off"] * 100.0
    tel = arms["on"]["acc"].telemetry
    records = list(tel.records)
    steps = [r for r in records if r.get("kind") == "step"]
    out = {
        "harness_overhead_pct": pct, "vs_baseline": 2.0 / pct if pct > 0 else None,
        "median_step_on_s": medians["on"], "median_step_off_s": medians["off"],
        "iters": iters, "step_records_emitted_on": len(steps),
        "anomaly_sample_every": tel.diagnostics.config.anomaly_sample_every,
        "params": arms["on"]["n_params"], "batch": B, "seq": S,
        "peak_memory_allocated_bytes": peak, "setup_s": setup_s,
    }
    rep.line(f"overhead {label}: {json.dumps(out)}")
    rep.line(f"overhead {label}: rounds of {chunk}, (on - off) median a round {deltas} s; step "
             f"seconds off {arms['off']['times']}, on {arms['on']['times']}; kernel launches "
             f"{json.dumps(launches)}, by design {json.dumps(by_design)}")
    from accelerate_tpu_torch.ops import flash_attention as fa

    want = cfg.num_layers * iters * 2
    check_launches(f"overhead {label}", launches, by_design,
                   {w: want for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
                   design=path_design(torch, fa, cfg))

    # (a) diagnostics changes no arithmetic
    flatten = port.checkpointing.flatten_tree
    bad = flat_diff(torch, flatten(arms["on"]["carry"]), flatten(arms["off"]["carry"]))
    same_losses = arms["on"]["losses"] == arms["off"]["losses"]
    checks[f"a_{label}"] = not bad and same_losses and len(arms["on"]["losses"]) == warmup + iters
    n_leaves = len(port.checkpointing.flatten_tree(arms["on"]["carry"]))
    rep.line(f"overhead {label} (a): losses of all {warmup + iters} steps equal on and off "
             f"{same_losses} ({arms['on']['losses'][-1]} last); params, moments and counters "
             f"after the last step: {n_leaves - len(bad)} of {n_leaves} leaves equal bit for "
             f"bit (differ: {bad[:4]})")

    # (b) the "on" arm's records
    interval = tel.diagnostics.config.goodput_interval
    goodput = [r for r in records if r.get("kind") == "goodput"]
    at = [r["step"] for r in goodput]
    want_at = [steps[interval * (i + 1) - 1]["step"] for i in range(len(steps) // interval)]
    gaps = [abs(r["productive_s"] + sum(r[f"badput_{b}_s"] for b in
                                        ("compile", "dataloader", "checkpoint", "idle"))
                - r["wall_s"]) for r in goodput]
    summary = tel.summary()
    checks[f"b_{label}"] = (len(steps) == warmup + iters and at == want_at
                            and all(g <= GOODPUT_SUM_TOL for g in gaps)
                            and summary.get("goodput_pct") is not None)
    rep.line(f"overhead {label} (b): {len(steps)} step records (want {warmup + iters}); goodput "
             f"records at steps {at} (want {want_at}, every {interval}); |buckets - wall_s| "
             f"{gaps} (limit {GOODPUT_SUM_TOL}); summary goodput_pct "
             f"{summary.get('goodput_pct')}, buckets {json.dumps(summary.get('goodput'))}, "
             f"anomalies {summary.get('anomalies')}")
    return arms, out, launches


def hook_breakdown(torch, port, arm: dict, rep: Report, label: str) -> None:
    """HOOK_STEPS more steps of the "on" arm with its telemetry hooks timed
    apart on the host clock (each wrapped for these steps only): where an
    "on" step's extra host time goes. The synchronise is the wait for the
    card inside ``end_step``; the "off" arm makes the same wait when it
    reads its loss."""
    from accelerate_tpu_torch.telemetry import collector

    tel = arm["acc"].telemetry
    spent: dict = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    label_ = arm["step"].label
    det = tel.detector(label_)
    patched = {"_synchronize": collector._synchronize,
               "device_memory_stats": collector.device_memory_stats,
               "host_memory_rss": collector.host_memory_rss,
               "_scalar_items": collector._scalar_items}
    try:
        for name, fn in patched.items():
            setattr(collector, name, timed(name, fn))
        det.check = timed("detector.check", det.check)
        tel.end_step = timed("end_step", tel.end_step)
        tel.diagnostics.observe = timed("diagnostics.observe", tel.diagnostics.observe)
        ts = run_arm(arm, HOOK_STEPS)
    finally:
        for name, fn in patched.items():
            setattr(collector, name, fn)
        for obj, name in ((det, "check"), (tel, "end_step"), (tel.diagnostics, "observe")):
            del obj.__dict__[name]
    per_step_us = {k: v / HOOK_STEPS * 1e6 for k, v in spent.items()}
    rep.line(f"overhead {label} hooks: {HOOK_STEPS} 'on' steps, median {statistics.median(ts)} s; "
             f"host microseconds a step by hook (end_step holds the synchronise, the memory "
             f"reads, the scalars and diagnostics.observe) {json.dumps(per_step_us)}")


def trace_kernel_counts(overlap, trace_dir: str) -> tuple[dict, set]:
    """Launches by port kernel name in every trace under ``trace_dir``, and
    the names of all its device events."""
    counts, device = {}, set()
    for path in overlap.trace_paths(trace_dir):
        for e in overlap.trace_events(path):
            if not overlap.is_device_event(e):
                continue
            device.add(e.get("name"))
            m = re.search(r"\b((?:flash|qkv|adamw)\w*_kernel)\b", str(e.get("name", "")))
            if m and e.get("cat") == "kernel":
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts, device


def captured_steps(torch, wrappers, arm: dict, diag) -> tuple[dict, dict]:
    """The capture started at the last step's boundary: ``capture_steps``
    steps under it, counted by the wrappers (the launches inside the
    trace), then one more step, whose record carries ``top_ops``. Returns
    the launches inside the capture and that record."""
    before = {w.__name__: w.launches for w in wrappers}
    run_arm(arm, diag.config.capture_steps)
    inside = {w.__name__: w.launches - before[w.__name__] for w in wrappers}
    run_arm(arm, 1)
    last = [r for r in arm["acc"].telemetry.records if r.get("kind") == "step"][-1]
    return inside, last


def hold_capture(fa, overlap, design, entry, inside: dict, record: dict, want_reason: str,
                 want_launches: int, rep: Report, label: str) -> bool:
    """The capture's trace against the wrappers' counts: B1-B3 by kernel
    name as many times as they launched inside it, and ``top_ops`` on the
    next record naming device kernels of that trace."""
    counts, device = trace_kernel_counts(overlap, entry["dir"])
    names = flash_kernel_names(fa, design)
    in_trace = {w: counts.get(k, 0) for w, k in names.items()}
    counted = {w: inside[w] for w in names}
    top = record.get("top_ops") or []
    ok = (entry["reason"] == want_reason and in_trace == counted
          and all(n == want_launches for n in counted.values())
          and bool(top) and all(o["op"] in device for o in top))
    rep.line(f"{label}: capture {entry['reason']} at step {entry['start_step']} -> "
             f"{len(overlap.trace_paths(entry['dir']))} trace(s); B1-B3 in the trace by name "
             f"{json.dumps({names[w]: n for w, n in in_trace.items()})}, counted by the wrappers "
             f"{json.dumps(counted)} (want {want_launches} each); top_ops on step "
             f"{record.get('step')}: {json.dumps(top)}; overlap_pct {record.get('overlap_pct')}")
    return ok


def nan_capture_and_diagnose(torch, port, wrappers, arm: dict, rep: Report, base: str,
                             design: str, checks: dict) -> None:
    """Checks (e) then (c) on arm A's "on" arm, after its measurement: the
    variant's config has no dump dir and no trace dir, so both are set on
    it now (the measured arm stays the reference's). A ``CheckpointManager``
    commits one save; then one NaN is written into one weight and real
    steps run: exactly one ``nan_grad`` anomaly, a ``torch.profiler``
    capture of ``capture_steps`` steps on disk whose B1-B3 launches equal
    the counters, ``top_ops`` naming CUDA kernels. Then ``end_training``
    (the final ``"shutdown"`` dump), and ``diagnose`` through
    ``python -m``, as text and as JSON."""
    from accelerate_tpu_torch.compilation import overlap
    from accelerate_tpu_torch.ops import flash_attention as fa

    acc = arm["acc"]
    diag = acc.telemetry.diagnostics
    diag_dir, trace_dir = os.path.join(base, "diag"), os.path.join(base, "traces")
    os.makedirs(diag_dir)
    diag.config.dir, diag.config.trace_dir = diag_dir, trace_dir
    with port.CheckpointManager(acc, every_n_steps=1, handle_signals=False) as mgr:
        run_arm(arm, 1)
        saved = mgr.step(arm["carry"])
    saved_step = acc.step
    name, weight = next((k, p) for k, p in arm["carry"]["params"].items()
                        if ".1." in k and p.dim() == 2)
    with torch.no_grad():
        weight.view(-1)[0] = float("nan")
    run_arm(arm, 1)  # its gradients are not finite: nan_grad fires, the capture starts
    nan_step = acc.step
    started = diag.capture.active
    inside, record = captured_steps(torch, wrappers, arm, diag)
    records = list(acc.telemetry.records)
    nan_records = [r for r in records if r.get("anomaly_type") == "nan_grad"]
    entries = diag.capture.captures
    summary = acc.telemetry.summary()
    ok_c = (started and len(nan_records) == 1 and len(entries) == 1
            and nan_records[0]["step"] == nan_step)
    if entries:
        ok_c = hold_capture(fa, overlap, design, entries[0], inside, record, "anomaly_nan_grad",
                            arm["cfg"].num_layers * diag.config.capture_steps, rep,
                            "overhead tiny (c)") and ok_c
    rep.line(f"overhead tiny (c): NaN written into {name}[0] before step {nan_step}; losses "
             f"since {arm['losses'][-5:]}; nan_grad records {len(nan_records)} at steps "
             f"{[(r['step'], r.get('fields')) for r in nan_records]} (the non-finite steps "
             f"counted {summary.get('anomalies')}); captures {[e['dir'] for e in entries]}")
    checks["c"] = ok_c
    last_step = acc.step
    acc.end_training()

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "diagnose",
           diag_dir]
    text = subprocess.run(cmd, cwd=here, env=env, capture_output=True, text=True, timeout=300)
    js = subprocess.run(cmd + ["--json"], cwd=here, env=env, capture_output=True, text=True,
                        timeout=300)
    for line in text.stdout.splitlines():
        rep.line(f"diagnose: {line}")
    report = json.loads(js.stdout) if js.returncode == 0 else {}
    rank = (report.get("ranks") or {}).get("0") or {}
    ck = report.get("last_checkpoint") or {}
    gp = report.get("goodput_pct")
    out = text.stdout
    checks["e"] = (
        text.returncode == 0 and js.returncode == 0
        and re.search(rf"^\s+0\s+{last_step}\s+shutdown\b", out, re.M) is not None
        and "Anomalies: nan_grad=1" in out and report.get("anomalies") == {"nan_grad": 1}
        and gp is not None and f"Goodput: {gp:.1f}% productive" in out
        and f"Last checkpoint: step {saved_step} at {saved} [committed]" in out
        and ck.get("dir") == saved and ck.get("committed") is True
        and rank.get("dump_reason") == "shutdown" and rank.get("last_step") == last_step)
    rep.line(f"overhead tiny (e): diagnose exit {text.returncode} (--json {js.returncode}); "
             f"the JSON reads rank 0 {rank.get('dump_reason')} at step {rank.get('last_step')} "
             f"(the run's last {last_step}), anomalies {report.get('anomalies')}, goodput_pct "
             f"{gp}, last checkpoint {ck} (saved {saved} at step {saved_step})"
             + (f"; stderr {text.stderr[-400:]}" if text.returncode else ""))



def trigger_capture(torch, port, wrappers, arm: dict, rep: Report, base: str,
                    checks: dict) -> None:
    """Check (d) on arm B's "on" arm after its measurement: a trace dir and
    a trigger file are set on its config, the file is touched, and exactly
    one capture runs at full width, whose B1-B3 launches in the trace equal
    the counters, with ``top_ops`` on the next record."""
    from accelerate_tpu_torch.compilation import overlap
    from accelerate_tpu_torch.ops import flash_attention as fa

    diag = arm["acc"].telemetry.diagnostics
    trigger = os.path.join(base, "trace-now")
    diag.config.trace_dir, diag.config.trigger_file = os.path.join(base, "traces_b"), trigger
    with open(trigger, "w") as f:
        f.write("go")
    run_arm(arm, 1)  # its boundary finds the trigger: the capture starts
    started = diag.capture.active
    inside, record = captured_steps(torch, wrappers, arm, diag)
    run_arm(arm, 1)  # the trigger's mtime is consumed: no second capture
    entries = diag.capture.captures
    checks["d"] = bool(entries) and hold_capture(
        fa, overlap, path_design(torch, fa, arm["cfg"]),
        entries[0], inside, record, "trigger_file",
        arm["cfg"].num_layers * diag.config.capture_steps, rep,
        "overhead llama3_8b_2l (d)") and started and len(entries) == 1


def phase15(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 15: see the module docstring. Returns B1-B3's rows at the
    ``overhead`` variant's shape."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    tiny = port.TransformerConfig.tiny()
    H, D = tiny.num_heads, tiny.hidden_size // tiny.num_heads
    shape = (OVERHEAD["B"], OVERHEAD["S"], H, tiny.num_kv_heads, D)
    # check (f): B1-B3 at this shape in bf16, then in the path's dtype (the
    # tiny config's activations are fp32), whose rows go into the table
    bf16_rows = time_flash_shape(torch, fa, rep, "overhead", *shape, bwd_library_on_dq=True)
    rep.line(f"overhead's shape in bf16 (not the path's dtype; no launch of the path): "
             f"{json.dumps(bf16_rows)}")
    rows = time_flash_shape(torch, fa, rep, "overhead", *shape, bwd_library_on_dq=True,
                            dtype=getattr(torch, tiny.dtype))
    checks = {"f": True}  # time_flash_shape ends the script on a miss
    t1 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="diag_smoke_")
    try:
        arms, _, launches = overhead_ab(torch, port, wrappers, rep, "tiny", tiny, OVERHEAD["B"],
                                        OVERHEAD["S"], OVERHEAD["iters"], OVERHEAD["warmup"],
                                        base, checks)
        for row in rows:
            row["launches"] = launches[WRAPPER_OF[row["name"]]]
        hook_breakdown(torch, port, arms["on"], rep, "tiny")
        nan_capture_and_diagnose(torch, port, wrappers, arms["on"], rep, base,
                                 path_design(torch, fa, tiny), checks)
        arms["off"]["acc"].end_training()
        del arms
        t2 = time.perf_counter()
        big = port.TransformerConfig.llama3_8b(num_layers=OVERHEAD_B["num_layers"],
                                               dtype="bfloat16", max_seq_len=OVERHEAD_B["S"])
        arms, out_b, _ = overhead_ab(torch, port, wrappers, rep, "llama3_8b_2l", big,
                                     OVERHEAD_B["B"], OVERHEAD_B["S"], OVERHEAD_B["iters"],
                                     OVERHEAD_B["warmup"], base, checks)
        hook_breakdown(torch, port, arms["on"], rep, "llama3_8b_2l")
        trigger_capture(torch, port, wrappers, arms["on"], rep, base, checks)
        for arm in arms.values():
            arm["acc"].end_training()
        del arms
    finally:
        shutil.rmtree(base, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rep.line(f"diag checks {json.dumps(checks)}")
    rep.line(f"phase 15: B1-B3 at the overhead shape {t1 - t0:.1f} s, arm A and checks (c), (e) "
             f"{t2 - t1:.1f} s, arm B and check (d) {time.perf_counter() - t2:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"diag: hard checks failed: {failed}")
    return rows


# ---------------------------------------------------------------------- #
# phase 17: the lora variant and the Accelerator's one-process surface
# ---------------------------------------------------------------------- #
def accelerator_smoke(torch, port, rep: Report) -> None:
    """An ``Accelerator()`` on the card: its repr, ``mixed_precision``,
    ``distributed_type`` and a ``JSONLTracker`` round trip of a value that
    lives on the card."""
    from accelerate_tpu_torch.tracking import JSONLTracker

    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator()
    base = tempfile.mkdtemp(prefix="tracker_smoke_")
    try:
        tracker = JSONLTracker("run", logging_dir=base)
        tracker.log({"loss": torch.tensor(0.25, device=acc.device)}, step=1)
        tracker.finish()
        with open(os.path.join(base, "run", "metrics.jsonl")) as f:
            line = json.loads(f.read())
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rep.line(f"accelerator: {json.dumps(repr(acc))}, mixed_precision {acc.mixed_precision!r}, "
             f"distributed_type {acc.distributed_type.value!r}, JSONLTracker round trip "
             f"{json.dumps(line)}")
    if acc.device.type != "cuda" or line.get("loss") != 0.25 or line.get("_step") != 1:
        fail(f"accelerator smoke: device {acc.device}, tracker line {line}")
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


def lora_setup(torch, port, seed: int = 0):
    """A fresh bf16 Accelerator and the small config's model on the card from
    a seeded generator, with the variant's one batch of seeded tokens."""
    import numpy as np

    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision="bf16")
    cfg = port.TransformerConfig(**ACCUM_CFG)
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(seed))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (LORA["B"], cfg.max_seq_len))
    batch = {"input_ids": torch.from_numpy(ids).to(acc.device)}
    return acc, cfg, model, batch


def lora_timed(torch, wrappers, step, carry, batch):
    """``measure.py:_run_lora``'s ``timed_loop``: warmup steps, then the
    timed ones, the loss read once at the end of each; every launch counter
    set to 0 just before and read just after. Returns the carry, the losses,
    the seconds a timed step, the launches, by design, and the peak bytes."""
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(LORA["warmup"]):
        carry, metrics = step(carry, batch)
        losses.append(metrics["loss"])
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(LORA["iters"]):
        carry, metrics = step(carry, batch)
        losses.append(metrics["loss"])
    float(metrics["loss"])
    seconds = (time.perf_counter() - t0) / LORA["iters"]
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    return (carry, [float(x) for x in losses], seconds, launches, by_design,
            torch.cuda.max_memory_allocated())


def lora_flash_launches(cfg) -> dict:
    """What the code predicts for ``lora_timed``: one forward (B1) and one
    two-pass backward (B2, B3) a layer a step, no remat, nothing fused."""
    n = cfg.num_layers * (LORA["warmup"] + LORA["iters"])
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def lora_training(torch, port, wrappers, rep: Report, checks: dict) -> dict:
    """Phases 1 and 2 of ``_run_lora``: the full fine-tune, then the rank-8
    adapter over the int8 base (QLoRA), each 2 + 8 ``unified_step``s with
    exact launches, peak memory and one profiled step."""
    from accelerate_tpu_torch import adapters
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_params

    out = {}
    # phase 1: every base parameter in the optimizer
    acc, cfg, model, batch = lora_setup(torch, port)
    n_params = sum(p.numel() for p in model.parameters())
    full_bytes = adapters.adapter_num_bytes(dict(model.named_parameters()))
    model, opt = acc.prepare(model, port.adamw(3e-4))
    step = acc.unified_step(port.CausalLM.loss_fn(model), max_grad_norm=1.0)
    carry, losses, full_s, launches, by_design, peak = lora_timed(
        torch, wrappers, step, acc.init_carry(model, opt), batch)
    check_launches("lora full", launches, by_design, lora_flash_launches(cfg))
    rep.line(f"lora phase 1 (full fine-tune, {n_params} params, B {LORA['B']}, S "
             f"{cfg.max_seq_len}, bf16, adamw 3e-4, clip 1.0): full_step_s {full_s}, "
             f"full_param_bytes {full_bytes}, peak {peak / 2**30} GiB, losses {losses}, "
             f"launches {json.dumps(launches)}")
    profile_groups(torch, lambda: step(carry, batch), rep, "lora full")
    out.update(n_params=n_params, full_bytes=full_bytes, full_s=full_s, full_peak=peak,
               launches=launches)
    del acc, model, opt, step, carry

    # phase 2: the adapter over the int8 base; the model's own parameters
    # never enter autograd
    acc, cfg, model, batch = lora_setup(torch, port)
    model.requires_grad_(False)
    lcfg = adapters.LoraConfig(rank=LORA["rank"], alpha=LORA["alpha"],
                               target_modules=LORA["targets"])
    qbase = quantize_params(model, QuantizationConfig(load_in_8bit=True))
    adapter = acc.prepare(adapters.init_adapter(
        torch.Generator(device=acc.device).manual_seed(1), cfg, lcfg))
    adapter_bytes = adapters.adapter_num_bytes(adapter)
    opt = acc.prepare(port.adamw(3e-4))
    carry = acc.init_carry(adapter, opt)
    with torch.no_grad():  # the bf16 base with the fresh adapter (B = 0: the base's own loss)
        base_loss = float(adapters.lora_loss_fn(model, model, lcfg, torch.bfloat16)(
            {t: {k: v.to(torch.bfloat16) for k, v in pair.items()} for t, pair in adapter.items()},
            batch))
    step = acc.unified_step(adapters.lora_loss_fn(model, qbase, lcfg,
                                                  compute_dtype=torch.bfloat16),
                            max_grad_norm=1.0)
    carry, qlosses, lora_s, qlaunches, qby_design, qpeak = lora_timed(torch, wrappers, step,
                                                                      carry, batch)
    check_launches("lora qlora", qlaunches, qby_design, lora_flash_launches(cfg))
    try:
        adapters.assert_adapter_only(carry["params"], lcfg)
        checks["adapter_only"] = True
    except AssertionError as e:
        rep.line(f"lora: the carry is not adapter-only: {e}")
        checks["adapter_only"] = False
    checks["no_base_grad"] = (all(p.grad is None and not p.requires_grad
                                  for p in model.parameters())
                              and all(q.scales.grad is None and not q.scales.requires_grad
                                      for q in qbase.values() if hasattr(q, "scales")))
    checks["loss_finite_falling"] = (all(math.isfinite(x) for x in qlosses)
                                     and qlosses[-1] < qlosses[0])
    gap = abs(qlosses[0] - base_loss) / base_loss
    checks["qlora_first_loss"] = gap <= QLORA_LOSS_TOL
    rep.line(f"lora phase 2 (QLoRA: rank {lcfg.rank}, alpha {lcfg.alpha}, {lcfg.target_modules}, "
             f"int8 base): lora_step_s {lora_s}, adapter_param_bytes {adapter_bytes}, peak "
             f"{qpeak / 2**30} GiB, losses {qlosses}, first loss {qlosses[0]} against the bf16 "
             f"base's {base_loss}: gap {gap} (QLORA_LOSS_TOL {QLORA_LOSS_TOL}), launches "
             f"{json.dumps(qlaunches)}")
    profile_groups(torch, lambda: step(carry, batch), rep, "lora qlora")
    out.update(adapter_bytes=adapter_bytes, lora_s=lora_s, lora_peak=qpeak, qlaunches=qlaunches,
               lcfg=lcfg)
    del acc, opt, step, carry, qbase, adapter
    out["model"], out["cfg"] = model, cfg
    return out


def nonzero_adapter(torch, adapters, cfg, lcfg, seed: int, device):
    """An adapter whose B is not zero (a fresh one decodes as the base):
    A from ``init_adapter``, B ~ N(0, LORA_B_STD), both from one seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    ad = adapters.init_adapter(g, cfg, lcfg)
    for pair in ad.values():
        pair["lora_b"].normal_(0.0, LORA_B_STD, generator=g)
    return ad


def lora_serve(engine, rng, names, vocab: int, new_tokens: int) -> list:
    """``_run_lora``'s ``serve``: one request a name (prompt 4 + i seeded
    tokens), then drain; returns each request's tokens."""
    rids = [engine.add_request(rng.integers(0, vocab, 4 + i).tolist(), max_new_tokens=new_tokens,
                               adapter=name) for i, name in enumerate(names)]
    for _ in engine.stream():
        pass
    return [engine.result(rid) for rid in rids]


def lora_serving(torch, port, rep: Report, model, cfg, lcfg, checks: dict) -> dict:
    """Phase 3 of ``_run_lora`` on the bf16 base, then checks (b)-(d)."""
    import numpy as np

    from accelerate_tpu_torch import adapters
    from accelerate_tpu_torch.serving import ServingEngine

    def engine_with(registry):
        return ServingEngine(model, max_slots=LORA["max_slots"], block_size=LORA["block_size"],
                             adapters=registry)

    def registry_on(device):
        return adapters.AdapterRegistry(cfg, capacity=LORA["capacity"], max_rank=lcfg.rank,
                                        target_modules=lcfg.target_modules, device=device)

    dev = model.embed.weight.device
    registry = registry_on(dev)
    engine = engine_with(registry)
    rng = np.random.default_rng(0)
    ptrs = [t.data_ptr() for pair in registry.stacks().values() for t in pair.values()]
    registry.load("t0", adapters.init_adapter(torch.Generator(device=dev).manual_seed(2), cfg,
                                              lcfg), lcfg)
    lora_serve(engine, rng, ["t0", "t0"], cfg.vocab_size, LORA["new_tokens"])  # warmup
    warm = engine.trace_counts()["decode"]
    lora_serve(engine, rng, ["t0", "t0", None], cfg.vocab_size, LORA["new_tokens"])
    single = engine.trace_counts()["decode"] - warm
    for i in (1, 2):
        registry.load(f"t{i}", adapters.init_adapter(
            torch.Generator(device=dev).manual_seed(2 + i), cfg, lcfg), lcfg)
    lora_serve(engine, rng, ["t0", "t1", "t2", None], cfg.vocab_size, LORA["new_tokens"])
    multi = engine.trace_counts()["decode"] - warm - single
    checks["a_retraces"] = single == 0 and multi == 0 and warm == 1
    rep.line(f"lora phase 3: single_adapter_decode_retraces {single}, "
             f"multi_adapter_decode_retraces {multi} (decode built {warm} time at warmup), "
             f"registry loads {registry.load_total}, evictions {registry.evict_total}")

    # (b) tenants with a nonzero B in one batch, each against a single-
    # tenant engine of the same width
    names = ["t0", "t1", "t2", None]
    tenants = {n: nonzero_adapter(torch, adapters, cfg, lcfg, 10 + i, dev)
               for i, n in enumerate(names[:3])}
    for name, ad in tenants.items():
        registry.load(name, ad, lcfg)  # rows written in place: no new build
    mixed = lora_serve(engine, np.random.default_rng(5), names, cfg.vocab_size,
                       LORA["check_tokens"])
    rng = np.random.default_rng(5)  # the mixed batch's prompts, drawn as lora_serve draws them
    prompts = [rng.integers(0, cfg.vocab_size, 4 + i).tolist() for i in range(4)]
    alone = []
    for i, name in enumerate(names):
        reg = registry_on(dev)
        if name is not None:
            reg.load(name, tenants[name], lcfg)
        solo = engine_with(reg)
        rid = solo.add_request(prompts[i], max_new_tokens=LORA["check_tokens"], adapter=name)
        for _ in solo.stream():
            pass
        alone.append(solo.result(rid))
    checks["b_mixed_equals_single"] = mixed == alone and len({tuple(t) for t in mixed}) > 1
    # (c) a tenant loaded after the capture decodes as one loaded before it
    late = nonzero_adapter(torch, adapters, cfg, lcfg, 77, dev)
    registry.load("late", late, lcfg)
    prompt = prompts[1]
    got_late = lora_serve_one(engine, prompt, "late")
    got_base = lora_serve_one(engine, prompt, None)
    reg = registry_on(dev)
    reg.load("late", late, lcfg)
    fresh = engine_with(reg)
    want_late = lora_serve_one(fresh, prompt, "late")
    checks["c_late_load"] = got_late == want_late and got_late != got_base
    checks["a_retraces"] = checks["a_retraces"] and engine.trace_counts()["decode"] == 1
    checks["stacks_in_place"] = ptrs == [t.data_ptr() for pair in registry.stacks().values()
                                         for t in pair.values()]
    rep.line(f"lora checks (b), (c): mixed {mixed}, alone {alone}; late tenant {got_late}, "
             f"base {got_base}, loaded before the capture {want_late}; engine decode builds "
             f"{engine.trace_counts()['decode']}, stacks at their addresses "
             f"{checks['stacks_in_place']}")
    out = {"single": single, "multi": multi}
    del engine, fresh, registry, reg
    checks["d_tiny_card_cpu"] = lora_tiny_card_cpu(torch, port, rep)
    return out


def lora_serve_one(engine, prompt, adapter) -> list:
    rid = engine.add_request(prompt, max_new_tokens=LORA["check_tokens"], adapter=adapter)
    for _ in engine.stream():
        pass
    return engine.result(rid)


def lora_tiny_card_cpu(torch, port, rep: Report) -> bool:
    """(d): a 2-layer fp32 tiny model with three tenants and the base in one
    batch: the card's greedy tokens equal the CPU's."""
    import numpy as np

    from accelerate_tpu_torch import adapters
    from accelerate_tpu_torch.serving import ServingEngine

    cfg = port.TransformerConfig.tiny(num_layers=2, max_seq_len=64, dtype="float32")
    lcfg = adapters.LoraConfig(rank=4, alpha=8.0, target_modules=("q_proj", "v_proj", "o_proj"))
    cpu = port.CausalLM(cfg, device="cpu")
    tenants = {f"t{i}": nonzero_adapter(torch, adapters, cfg, lcfg, 20 + i, "cpu")
               for i in range(3)}
    names = ["t0", "t1", "t2", None]
    outs = {}
    for where in ("card", "cpu"):
        model = cpu
        if where == "card":
            model = port.CausalLM(cfg, device=CARD)
            model.load_state_dict(cpu.state_dict())
        reg = adapters.AdapterRegistry(cfg, capacity=3, max_rank=4,
                                       target_modules=lcfg.target_modules,
                                       device=model.embed.weight.device)
        for name, ad in tenants.items():
            reg.load(name, ad, lcfg)
        engine = ServingEngine(model, max_slots=4, block_size=8, adapters=reg)
        outs[where] = lora_serve(engine, np.random.default_rng(6), names, cfg.vocab_size, 12)
    rep.line(f"lora check (d), tiny fp32 model with three tenants and the base: card "
             f"{outs['card']}, CPU {outs['cpu']}")
    return outs["card"] == outs["cpu"] and len({tuple(t) for t in outs["cpu"]}) > 1


def phase17(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 17: see the module docstring. Returns B1-B3's rows at the
    ``lora`` shape, their launches those of phases 1 and 2 together."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    accelerator_smoke(torch, port, rep)
    H, Hkv = ACCUM_CFG["num_heads"], ACCUM_CFG["num_kv_heads"]
    rows = time_flash_shape(torch, fa, rep, "lora", LORA["B"], ACCUM_CFG["max_seq_len"], H, Hkv,
                            ACCUM_CFG["hidden_size"] // H, bwd_library_on_dq=True)
    t1 = time.perf_counter()
    checks: dict = {}
    train = lora_training(torch, port, wrappers, rep, checks)
    for row in rows:
        wrapper = WRAPPER_OF[row["name"]]
        row["launches"] = train["launches"][wrapper] + train["qlaunches"][wrapper]
    t2 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    served = lora_serving(torch, port, rep, train["model"], train["cfg"], train["lcfg"], checks)
    serve_launches = {w.__name__: w.launches for w in wrappers}
    checks["serving_no_kernel"] = not any(serve_launches.values())
    serve_peak = torch.cuda.max_memory_allocated()
    ratio = train["full_bytes"] / max(train["adapter_bytes"], 1)
    result = {
        "metric": "lora_param_bytes_ratio", "value": ratio, "unit": "x", "vs_baseline": ratio,
        "extra": {
            "full_step_s": train["full_s"], "lora_step_s": train["lora_s"],
            "step_speedup": train["full_s"] / max(train["lora_s"], 1e-9),
            "full_param_bytes": train["full_bytes"],
            "adapter_param_bytes": train["adapter_bytes"], "adapter_rank": LORA["rank"],
            "single_adapter_decode_retraces": served["single"],
            "multi_adapter_decode_retraces": served["multi"], "params": train["n_params"],
            "device": torch.cuda.get_device_name(0), "batch": LORA["B"],
            "seq": ACCUM_CFG["max_seq_len"], "iters": LORA["iters"],
        },
    }
    rep.line(f"lora: step_speedup {result['extra']['step_speedup']} (full_step_s / lora_step_s), "
             f"peak GiB full {train['full_peak'] / 2**30}, qlora {train['lora_peak'] / 2**30}, "
             f"serving {serve_peak / 2**30}")
    rep.line(f"lora result {json.dumps(result)}")
    rep.line(f"lora_param_bytes_ratio {ratio} (the reference rounds it to {round(ratio, 1)})")
    rep.line(f"lora checks {json.dumps(checks)}")
    rep.line(f"phase 17: the accelerator line and B1-B3 at the lora shape {t1 - t0:.1f} s, "
             f"phases 1-2 {t2 - t1:.1f} s, phase 3 and checks (a)-(d) "
             f"{time.perf_counter() - t2:.1f} s")
    del train
    gc.collect()
    torch.cuda.empty_cache()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"lora: hard checks failed: {failed}")
    return rows


def vm_rss() -> int:
    """This process's resident set, bytes (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise KeyError("VmRSS")


def peak_rss() -> int:
    """This process's peak resident set since it started, bytes: VmHWM of
    /proc/self/status where the kernel gives it, else getrusage's
    ru_maxrss (the same high-water mark; a sandboxed kernel may give no VmHWM)."""
    import resource

    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class RssPeak:
    """VmRSS sampled every 5 ms on a thread over a window, with the peak
    resident set at its ends: that peak is the process's since it started,
    so a window after a larger peak reads no rise there; the samples read
    the window's own."""

    def __enter__(self) -> "RssPeak":
        self.before, self.hwm_before = vm_rss(), peak_rss()
        self.peak = self.before
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, vm_rss())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, vm_rss())
        self.hwm_after = peak_rss()


def drop_file_pages(paths) -> None:
    """``POSIX_FADV_DONTNEED`` on the phase's own files, so that the next
    read goes to the disk if the kernel honours it. Nothing else of the
    machine is touched."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def files_in(path: str) -> list[str]:
    return sorted(os.path.join(path, f) for f in os.listdir(path))


def load_scratch(need: int, rep: Report) -> str:
    """A fresh directory on the larger of the temp dir and the repository's
    gitignored ``dev/``; fails when neither has ``need`` bytes free."""
    repo_dev = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dev")
    os.makedirs(repo_dev, exist_ok=True)
    free = {d: shutil.disk_usage(d).free for d in (tempfile.gettempdir(), repo_dev)}
    best = max(free, key=free.get)
    rep.line(f"decode_load: free bytes {json.dumps(free)}; need {need} "
             f"({LOAD['margin']} x the checkpoint); writing under {best}")
    if free[best] < need:
        fail(f"decode_load: no directory has {need} bytes free ({free}): the phase needs one "
             "checkpoint of the decode model on disk at a time")
    return tempfile.mkdtemp(prefix="decode_load-", dir=best)


def phase18(torch, port, wrappers, rep: Report, model) -> list[dict]:
    """Phase 18: see the module docstring. Returns B1's row at the decode
    forward's shape, its launches those of the counted forward."""
    import numpy as np

    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch.checkpointing import save_model_weights
    from accelerate_tpu_torch.models.generation import make_generate_fn
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.utils import hf_interop, quantization

    t0 = time.perf_counter()
    cfg = model.config
    live = model.state_dict()
    nbytes = sum(t.nbytes for t in live.values())
    n_params = sum(t.numel() for t in live.values())
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rows = time_flash_shape(torch, fa, rep, "decode_load", LOAD["B"], LOAD["S"], H, Hkv, D)[:1]
    base = load_scratch(int(LOAD["margin"] * nbytes), rep)
    checks: dict = {}
    out: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.no_grad():
            # (a) the native checkpoint: write, the disk-to-host leg, the load
            native = os.path.join(base, "native")
            t = time.perf_counter()
            save_model_weights(model, native, max_shard_size=LOAD["shard"])
            out["write_s"] = time.perf_counter() - t
            files = files_in(native)
            out["files"] = len(files)  # the shards and the index
            out["shards"] = sum(f.endswith(".safetensors") for f in files)
            out["file_bytes"] = sum(os.path.getsize(f) for f in files)
            drop_file_pages(files)
            meta = bm.init_empty_weights(port.CausalLM, cfg)
            names = list(meta.state_dict())

            def read_all() -> int:
                with bm._lazy_checkpoint_reader(native) as read:
                    return sum(read(name).nbytes for name in names)

            t = time.perf_counter()
            checks["disk_to_host_bytes"] = read_all() == nbytes
            out["disk_to_host_s"] = time.perf_counter() - t
            # the same pass with the pages kept: says whether the advice took
            t = time.perf_counter()
            read_all()
            out["disk_to_host_warm_s"] = time.perf_counter() - t
            drop_file_pages(files)
            with RssPeak() as rss:
                t = time.perf_counter()
                loaded = bm.load_checkpoint_and_dispatch(
                    bm.init_empty_weights(port.CausalLM, cfg), native, device_map={"": 0})
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t
            loaded.requires_grad_(False)
            out.update(load_s=load_s, host_to_device_s=load_s - out["disk_to_host_s"],
                       gib=nbytes / 2**30, gib_per_s=nbytes / 2**30 / load_s,
                       vs_baseline=LOAD["baseline_s"] / load_s,
                       host_rss_rise_bytes=rss.peak - rss.before,
                       peak_rss_rise_bytes=rss.hwm_after - rss.hwm_before,
                       peak_rss_before_bytes=rss.hwm_before)
            checks["returned_the_model"] = isinstance(loaded, port.CausalLM)
            checks["native_bitwise"] = not flat_diff(torch, loaded.state_dict(), live)
            trace = serve_trace(cfg.vocab_size, cfg.max_seq_len)
            prompt, new = torch.from_numpy(trace[0][0][None]).to(CARD), trace[0][1]
            checks["greedy_tokens"] = torch.equal(
                make_generate_fn(loaded, max_new_tokens=new)(prompt),
                make_generate_fn(model, max_new_tokens=new)(prompt))
            ids = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (LOAD["B"], LOAD["S"]))).to(CARD)
            reset_counts(wrappers)
            logits = loaded(ids)
            torch.cuda.synchronize()
            launches = {w.__name__: w.launches for w in wrappers}
            by_design = {w.__name__: dict(w.by_design) for w in wrappers
                         if hasattr(w, "by_design")}
            check_launches("decode_load forward", launches, by_design,
                           {"flash_fwd": cfg.num_layers}, fa.kernel_design(torch.bfloat16, D))
            checks["forward_bitwise"] = same_bits(torch, logits, model(ids))
            out["device_peak_a_bytes"] = torch.cuda.max_memory_allocated()
            del loaded, logits
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(native)

            # (b) the HF round trip, through the port's own writer
            hf = os.path.join(base, "hf")
            t = time.perf_counter()
            hf_interop.save_hf_checkpoint(model, cfg, hf, max_shard_size=LOAD["shard"])
            out["hf_write_s"] = time.perf_counter() - t
            inferred = hf_interop.infer_config_from_hf(hf)
            shaping = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
                       "num_heads", "num_kv_heads", "head_dim", "qkv_bias", "tie_embeddings",
                       "num_experts")
            checks["hf_config"] = all(getattr(inferred, f) == getattr(cfg, f) for f in shaping)
            checks["hf_detected"] = hf_interop.is_hf_checkpoint(hf)
            drop_file_pages(files_in(hf))
            t = time.perf_counter()
            loaded = bm.load_checkpoint_and_dispatch(bm.init_empty_weights(port.CausalLM, cfg),
                                                     hf, device_map={"": 0})
            torch.cuda.synchronize()
            out["hf_load_s"] = time.perf_counter() - t
            checks["hf_bitwise"] = not flat_diff(torch, loaded.state_dict(), live)
            del loaded
            gc.collect()
            torch.cuda.empty_cache()

            # (d) quantize on load, from (b)'s checkpoint, against the live weights
            qcfg = quantization.QuantizationConfig(load_in_8bit=True)
            t = time.perf_counter()
            qload = quantization.load_and_quantize_model(
                bm.init_empty_weights(port.CausalLM, cfg), hf, qcfg, device=CARD)
            torch.cuda.synchronize()
            out["quantize_load_s"] = time.perf_counter() - t
            want = quantization.quantize_params(model, qcfg)
            bad = []
            for name, w in want.items():
                g = qload[name]
                if quantization.is_quantized(w):
                    same = (quantization.is_quantized(g) and torch.equal(g.codes, w.codes)
                            and torch.equal(g.scales, w.scales))
                else:
                    same = not quantization.is_quantized(g) and torch.equal(g, w.float())
                if not same:
                    bad.append(name)
            n_q = sum(quantization.is_quantized(w) for w in want.values())
            out["quantized_leaves"] = n_q
            out["int8_bytes"] = sum(w.nbytes for w in qload.values()
                                    if quantization.is_quantized(w))
            checks["quantize_bitwise"] = not bad and n_q == 7 * cfg.num_layers
            del qload, want
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(hf)

            # (c) the three tiers, and layers streamed from the disk tier
            # (after (d), with (b)'s checkpoint gone: one copy on disk at a time)
            dm = bm.infer_auto_device_map(meta, LOAD["tiers"], dtype_bytes=2)
            sizes = bm.compute_module_sizes(meta, dtype_bytes=2)
            tier_bytes: dict = {}
            for group, target in dm.items():
                tier_bytes[str(target)] = tier_bytes.get(str(target), 0) + sizes[group]
            out["tier_bytes"] = tier_bytes
            checks["three_tiers"] = set(tier_bytes) == {"0", "cpu", "disk"}
            tree = bm.dispatch_params(model, dm, offload_dir=os.path.join(base, "offload"))
            kinds = {type(v).__name__ + ("/" + v.device.type if hasattr(v, "device") else "")
                     for v in tree.values()}
            checks["tier_kinds"] = kinds == {"Tensor/cuda", "Tensor/cpu", "OffloadedLeaf"}
            checks["tiers_bitwise"] = not flat_diff(
                torch, bm.materialize_offloaded(tree, CARD), live)
            del tree
            gc.collect()
            torch.cuda.empty_cache()
            layers = model.layers[:LOAD["stream_layers"]]
            block_names = [n for n, _ in layers[0].named_parameters()]
            stacked = {n: torch.stack([dict(layer.named_parameters())[n] for layer in layers])
                       for n in block_names}
            disk = bm.disk_offload(stacked, os.path.join(base, "stack"))
            del stacked
            positions = torch.arange(LOAD["S"], device=CARD)[None]
            x = model.embed(ids).to(torch.bfloat16)

            def block_fn(group, h):
                for i in range(next(iter(group.values())).shape[0]):
                    h = torch.func.functional_call(layers[0], {n: g[i] for n, g in group.items()},
                                                   (h, positions))
                return h

            dense = x
            for layer in layers:
                dense = layer(dense, positions)
            streamed = bm.streamed_apply(block_fn, disk, x, group_size=LOAD["group"])
            out["stream_row_err"] = row_err(torch, streamed, dense)
            checks["streamed_equal"] = out["stream_row_err"] <= STREAM_TOL
            out["device_peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rows[0]["launches"] = launches["flash_fwd"]
    rows[0]["shape"] = f"decode_load forward B{LOAD['B']} S{LOAD['S']} H{H} Hkv{Hkv} D{D} bf16"
    result = {"metric": "checkpoint_load_seconds", "value": out["load_s"], "unit": "s",
              "vs_baseline": out["vs_baseline"],
              "extra": {**out, "params": n_params, "bytes": nbytes,
                        "device": torch.cuda.get_device_name(0)}}
    rep.line(f"decode_load result {json.dumps(result)}")
    rep.line(f"decode_load: checkpoint_load_seconds {out['load_s']} (disk_to_host_s "
             f"{out['disk_to_host_s']}, warm {out['disk_to_host_warm_s']}, host_to_device_s "
             f"{out['host_to_device_s']}), "
             f"{out['gib']} GiB at {out['gib_per_s']} GiB/s, vs_baseline {out['vs_baseline']}; "
             f"write {out['write_s']} s ({out['shards']} shards, {out['file_bytes']} B); host RSS "
             f"rise {out['host_rss_rise_bytes']} B (peak RSS rise {out['peak_rss_rise_bytes']} B); "
             f"device peak (a) {out['device_peak_a_bytes']} B, phase {out['device_peak_bytes']} B")
    rep.line(f"decode_load checks {json.dumps(checks)}")
    rep.line(f"phase 18: {time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"decode_load: hard checks failed: {failed}")
    return rows


# phase 19: processes and data. (a) the main path through a real NCCL group
# of one (the card's only world size), against the same 5 steps without a
# group; (b) LAUNCH_WORLD CPU processes over gloo on the host; (c) a world-2
# CPU checkpoint of the tiny CausalLM restored onto the card at world 1
LAUNCH_WORLD = 2
RESTORE = dict(steps=3, rows=4, more=2, lr=0.5, clip=1.0, seed=0, fresh_seed=5)
# card against CPU after the restore: losses and grad norms (relative), the
# params by ||card - CPU|| / ||update|| over the tree (SMALL_UPDATE_TOL)
RESTORE_TOL = 1e-4


def nccl_profile(torch, step, carry, batch, rep: Report, label: str = "launch (a)") -> int:
    """One step of the grouped path under torch.profiler: the device ms and
    launches of every kernel whose name names NCCL, and the host-side
    all-reduce calls, or a note that no NCCL kernel launched. Returns the
    count of ``c10d::allreduce_`` calls on the host."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(carry, batch)
        torch.cuda.synchronize()
    device, host = {}, {}
    for evt in prof.key_averages():
        key = evt.key
        if evt.device_type == torch.autograd.DeviceType.CUDA and "nccl" in key.lower():
            device[key[:100]] = (evt.self_device_time_total / 1e3, evt.count)
        elif evt.device_type != torch.autograd.DeviceType.CUDA and (
                "allreduce" in key.lower().replace("_", "") or "nccl" in key.lower()):
            host[key[:60]] = evt.count
    if device:
        rep.line(f"{label} profiled step: NCCL kernels (device ms, launches) "
                 f"{json.dumps(device)}, all-reduce device ms in all "
                 f"{sum(ms for ms, _ in device.values())}; host calls {json.dumps(host)}")
    else:
        rep.line(f"{label} profiled step: no NCCL kernel launched (a group of one); "
                 f"host calls {json.dumps(host)}")
    return host.get("c10d::allreduce_", 0), sum(n for _, n in device.values())


def launch_main_path(torch, port, wrappers, rep: Report, checks: dict) -> dict:
    """Phase 19 (a): the main path twice, first without a group, then with
    ``ACCELERATE_TPU_NUM_PROCESSES=1``, ``_PROCESS_ID=0`` and
    ``_COORDINATOR_ADDRESS`` set (the Accelerator brings up NCCL and every
    optimizer step's gradient mean and every loss go through it). Returns
    each run's readings, keyed by whether it ran grouped."""
    from accelerate_tpu_torch.data_loader import BatchSamplerShard
    from accelerate_tpu_torch.launchers import _free_port
    from accelerate_tpu_torch.state import group_is_up

    runs = {}
    for grouped in (False, True):
        if grouped:
            os.environ.update({"ACCELERATE_TPU_NUM_PROCESSES": "1",
                               "ACCELERATE_TPU_PROCESS_ID": "0",
                               "ACCELERATE_TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}"})
        try:
            step, carry, loader, _ = build_path(torch, port, False, False)
            state = port.AcceleratorState()
            if grouped != group_is_up() or (grouped and (
                    state.distributed_type.value != "MULTI_GPU" or state.backend != "nccl")):
                fail(f"launch (a): a group up {group_is_up()}, {state.distributed_type}, "
                     f"backend {state.backend}: want grouped={grouped}")
            if not isinstance(loader.batch_sampler, BatchSamplerShard):
                fail("launch (a): the loader is not prepared through BatchSamplerShard")
            reset_counts(wrappers)
            torch.cuda.reset_peak_memory_stats()
            carry, batch, losses, norms, times = run_steps(torch, step, carry, loader)
            launches = {w.__name__: w.launches for w in wrappers}
            by_design = {w.__name__: dict(w.by_design) for w in wrappers
                         if hasattr(w, "by_design")}
            peak = torch.cuda.max_memory_allocated()
            name = "with the group" if grouped else "without a group"
            runs[grouped] = {"losses": losses, "norms": norms, "times": times,
                             "launches": launches, "peak": peak}
            rep.line(f"launch (a) {name}: losses {losses}, grad norms {norms}; step seconds "
                     f"{times}; median of steps 2-{STEPS} {statistics.median(times[1:])} s; "
                     f"launches {json.dumps(launches)}; peak {peak / 2**30} GiB")
            check_launches(f"launch (a) {name}", launches, by_design,
                           {"flash_fwd": NUM_LAYERS * STEPS, "flash_bwd_dq": NUM_LAYERS * STEPS,
                            "flash_bwd_dkv": NUM_LAYERS * STEPS})
            if not grouped:
                runs["params"] = {k: v.detach().clone() for k, v in carry["params"].items()}
            else:
                checks["launch_params_bitwise"] = all(
                    torch.equal(carry["params"][k], v) for k, v in runs["params"].items())
                # the step went through the group: one all-reduce a gradient
                # leaf, one for the mask counts and one for the loss
                calls = nccl_profile(torch, step, carry, batch, rep)[0]
                want = len(carry["params"]) + 2
                rep.line(f"launch (a) profiled step: {calls} all-reduce calls, want {want}")
                checks["launch_allreduce_calls"] = calls == want
            del step, carry, loader, batch
        finally:
            if grouped:
                port.AcceleratorState().partial_state.destroy_process_group()
                port.AcceleratorState._reset_state(reset_partial_state=True)
                port.GradientState._reset_state()
                for key in ("NUM_PROCESSES", "PROCESS_ID", "COORDINATOR_ADDRESS"):
                    os.environ.pop("ACCELERATE_TPU_" + key, None)
    del runs["params"]
    gc.collect()
    torch.cuda.empty_cache()
    checks["launch_group_down"] = not group_is_up()
    checks["launch_losses_bitwise"] = runs[True]["losses"] == runs[False]["losses"]
    checks["launch_norms_bitwise"] = runs[True]["norms"] == runs[False]["norms"]
    return runs


def launch_gloo(rep: Report, base: str) -> dict:
    """Phase 19 (b): the reference's workers (one launch) and the whole
    assertion script, each in LAUNCH_WORLD CPU processes over gloo (a
    failure in any process raises); then (c)'s source: the tiny CausalLM trained RESTORE["steps"]
    steps by LAUNCH_WORLD processes on global batches whose processes hold
    different mask counts, and saved through the done-marker commit.
    Returns the seconds of each launch."""
    import torch

    from accelerate_tpu_torch import CausalLM, TransformerConfig
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts import multiprocess_worker as workers
    from accelerate_tpu_torch.test_utils.scripts.test_script import run_all_checks
    from accelerate_tpu_torch.test_utils.training import TINY_LM

    seconds = {}
    # the three workers in one launch (a spawn of the processes costs 10-20 s)
    checks = ("collective_worker", "training_worker", "local_sgd_worker")
    for fn, args in ((workers.sequence_worker, (checks,)), (run_all_checks, ())):
        t0 = time.perf_counter()
        debug_launcher(fn, args, num_processes=LAUNCH_WORLD)
        seconds[fn.__name__] = time.perf_counter() - t0
    init = CausalLM(TransformerConfig(**TINY_LM), device="cpu",
                    generator=torch.Generator().manual_seed(RESTORE["seed"])).state_dict()
    torch.save(init, os.path.join(base, "init.pt"))
    t0 = time.perf_counter()
    debug_launcher(workers.tiny_lm_worker, (base, RESTORE["steps"], RESTORE["rows"],
                                            RESTORE["seed"]), num_processes=LAUNCH_WORLD)
    seconds["tiny_lm_worker"] = time.perf_counter() - t0
    rep.line(f"launch (b): {LAUNCH_WORLD} processes over gloo, seconds a launch "
             f"{json.dumps(seconds)}")
    return seconds


def restore_run(torch, port, path: str, device: str, rank0: dict, checks: dict) -> dict:
    """A fresh tiny CausalLM (other weights) at world 1 on ``device``: the
    world-2 checkpoint refused without ``allow_reshape`` (nothing written),
    then loaded with it, every param bitwise rank 0's; then RESTORE["more"]
    steps on the global batches that follow. Returns the losses, grad norms
    and params (on the host) before and after."""
    import numpy as np

    from accelerate_tpu_torch.test_utils.training import TINY_LM, MaskedTokens

    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(cpu=device == "cpu")
    model = port.CausalLM(port.TransformerConfig(**TINY_LM), device=acc.device,
                          generator=torch.Generator(acc.device).manual_seed(RESTORE["fresh_seed"]))
    model, opt = acc.prepare(model, port.sgd(RESTORE["lr"]))
    step = acc.unified_step(port.CausalLM.loss_fn(model), max_grad_norm=RESTORE["clip"])
    carry = acc.init_carry(model, opt)
    before = {k: v.detach().clone() for k, v in carry["params"].items()}
    try:
        acc.load_state(path, carry=carry)
        checks[f"restore_{device}_refused"] = False
    except ValueError as e:
        checks[f"restore_{device}_refused"] = "different topology" in str(e)
    checks[f"restore_{device}_refusal_wrote_nothing"] = all(
        torch.equal(carry["params"][k], v) for k, v in before.items())
    carry = acc.load_state(path, carry=carry, allow_reshape=True)
    checks[f"restore_{device}_bitwise"] = all(
        torch.equal(carry["params"][k].cpu(), v) for k, v in rank0["params"].items()) and (
        carry["opt_step"] == RESTORE["steps"])
    start = {k: v.detach().cpu().clone() for k, v in carry["params"].items()}
    gbs = RESTORE["rows"] * LAUNCH_WORLD
    data = MaskedTokens((RESTORE["steps"] + RESTORE["more"]) * gbs, RESTORE["rows"],
                        seed=RESTORE["seed"])
    losses, norms = [], []
    for i in range(RESTORE["steps"], RESTORE["steps"] + RESTORE["more"]):
        rows = range(i * gbs, (i + 1) * gbs)
        batch = {k: torch.from_numpy(np.stack([data[r][k] for r in rows])).to(acc.device)
                 for k in ("input_ids", "loss_mask")}
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    end = {k: v.detach().cpu().clone() for k, v in carry["params"].items()}
    return {"losses": losses, "norms": norms, "start": start, "end": end}


def launch_restore(torch, port, rep: Report, base: str, checks: dict) -> None:
    """Phase 19 (c): (b)'s world-2 checkpoint (its RNG files, done markers
    and topology), restored at world 1 on the CPU and on the card; two more
    steps on the card against two more on the CPU."""
    path = os.path.join(base, "ckpt")
    names = set(os.listdir(path))
    checks["restore_files"] = {"random_states_0.pkl", "random_states_1.pkl", "done_00000",
                               "done_00001", "COMMITTED"} <= names
    with open(os.path.join(path, "topology.json")) as f:
        checks["restore_topology"] = json.load(f)["world_size"] == LAUNCH_WORLD
    ranks = [torch.load(os.path.join(base, f"rank{r}.pt")) for r in range(LAUNCH_WORLD)]
    checks["restore_mask_counts_differ"] = all(
        len(set(c)) == LAUNCH_WORLD for c in zip(*(r["mask_counts"] for r in ranks)))
    cpu = restore_run(torch, port, path, "cpu", ranks[0], checks)
    gpu = restore_run(torch, port, path, "cuda", ranks[0], checks)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    loss_rel = [rel(a, b) for a, b in zip(gpu["losses"], cpu["losses"])]
    norm_rel = [rel(a, b) for a, b in zip(gpu["norms"], cpu["norms"])]
    num = sum(float((gpu["end"][k] - cpu["end"][k]).float().norm() ** 2) for k in cpu["end"])
    den = sum(float((cpu["end"][k] - cpu["start"][k]).float().norm() ** 2) for k in cpu["end"])
    update_rel = math.sqrt(num / den)
    checks["restore_card_vs_cpu"] = (max(loss_rel + norm_rel) <= RESTORE_TOL
                                     and update_rel <= SMALL_UPDATE_TOL)
    rep.line(f"launch (c): losses card {gpu['losses']} CPU {cpu['losses']} (rel {loss_rel}), "
             f"grad norms card {gpu['norms']} CPU {cpu['norms']} (rel {norm_rel}), params "
             f"||card - CPU|| / ||update|| {update_rel}; limits {RESTORE_TOL} and "
             f"{SMALL_UPDATE_TOL}")
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


def phase19(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 19 (``--launch-only``): see LAUNCH_WORLD and the functions
    above. Returns B1-B3's rows at the main shape, their launches those of
    (a)'s grouped run."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    checks: dict = {}
    runs = launch_main_path(torch, port, wrappers, rep, checks)
    rep.line(f"launch (a): median of steps 2-{STEPS} without a group "
             f"{statistics.median(runs[False]['times'][1:])} s, with the group "
             f"{statistics.median(runs[True]['times'][1:])} s")
    t1 = time.perf_counter()
    rows = time_flash_shape(torch, fa, rep, "launch", MAIN["B"], MAIN["S"], MAIN["H"],
                            MAIN["Hkv"], MAIN["D"], bwd_library_on_dq=True)
    for row in rows:
        row["launches"] = runs[True]["launches"][WRAPPER_OF[row["name"]]]
    t2 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="launch_")
    try:
        launch_gloo(rep, base)
        t3 = time.perf_counter()
        launch_restore(torch, port, rep, base, checks)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rep.line(f"launch checks {json.dumps(checks)}")
    rep.line(f"phase 19: (a) {t1 - t0:.1f} s, B1-B3 at the main shape {t2 - t1:.1f} s, "
             f"(b) {t3 - t2:.1f} s, (c) {time.perf_counter() - t3:.1f} s, in all "
             f"{time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"launch: hard checks failed: {failed}")
    return rows


# phase 20: sharding. (a) the main path under each strategy at world 1 in an
# NCCL group of one against the path without a plugin, (b) the fused path
# under FULL_SHARD against the fused path without one, (c) a SHARD_WORLD
# CPU checkpoint of the tiny CausalLM under FULL_SHARD at fsdp 2 x tp 2,
# restored onto the card at world 1
SHARD_WORLD = 4
SHARD_RESTORE = dict(steps=3, rows=4, more=2, lr=0.5, clip=1.0, seed=0, fresh_seed=5,
                     plugin=dict(dp_size=1, fsdp_size=2, tp_size=2))
# (name, strategy or None, fused path, accumulation K); each plugin run is
# held bit for bit against the no-plugin run before it
# (d)-(f): a decode of the main path's model, its raw loop and phase 17's
# adapter step, each on FULL_SHARD DTensor params against its run without
SHARD_DECODE = dict(prompt=512, new=16, seed=3)
SHARD_RAW = dict(K=2, steps=2)
# (g): the serving engine over the main path's model, serve_trace's first
# requests cut to ``trace`` (new tokens at most ``new``) beside a 32-token
# template of 8 seeded tokens four times (the n-gram proposer's prompt)
# submitted twice (the second a full-prompt prefix hit, a copy on write),
# and at step ``late`` one request of priority 1 while every seat is taken
# (a preemption, swapped out and back in); n-gram speculation at k 2
SHARD_ENGINE = dict(max_slots=4, block_size=16, spec_k=2, trace=3, new=40, template_new=16,
                    late=3, seed=7)
SHARD_RUNS = (("none", None, False, 1), ("no_shard", "no_shard", False, 1),
              ("shard_opt", "shard_opt", False, 1), ("full_shard", "full_shard", False, 1),
              ("none_k2", None, False, 2), ("shard_grad_op_k2", "shard_grad_op", False, 2),
              ("fused_none", None, True, 1), ("fused_full_shard", "full_shard", True, 1))


def shard_runs(torch, port, wrappers, rep: Report, checks: dict) -> dict:
    """Phase 20 (a) and (b) (SHARD_RUNS), every run in one NCCL group of
    one. Returns each run's readings."""
    from accelerate_tpu_torch.parallel.runtime import to_local
    from accelerate_tpu_torch.parallel.sharding import is_dtensor

    runs, base = {}, None
    with nccl_group_of_one(port):
        for name, strategy, fused_path, accum in SHARD_RUNS:
            plugin = None if strategy is None else port.ParallelismPlugin(
                sharding_strategy=port.ShardingStrategy(strategy))
            step, carry, loader, _ = build_path(torch, port, fused_path, fused_path,
                                                plugin=plugin, accum=accum)
            state = port.AcceleratorState()
            if state.distributed_type.value != "MULTI_GPU" or (plugin is None) != (
                    state.mesh is None):
                fail(f"shard {name}: {state.distributed_type}, mesh {state.mesh}")
            params = carry["params"]
            if plugin is not None and not all(is_dtensor(p) for p in params.values()):
                fail(f"shard {name}: the carry's params are not DTensors")
            reset_counts(wrappers)
            torch.cuda.reset_peak_memory_stats()
            carry, batch, losses, norms, times = run_steps(torch, step, carry, loader)
            launches = {w.__name__: w.launches for w in wrappers}
            by_design = {w.__name__: dict(w.by_design) for w in wrappers
                         if hasattr(w, "by_design")}
            peak = torch.cuda.max_memory_allocated()
            per_layer = NUM_LAYERS * STEPS
            want = {"flash_fwd": per_layer, "flash_bwd_dq": per_layer,
                    "flash_bwd_dkv": per_layer}
            if fused_path:
                want.update(qkv_prologue=per_layer, adamw_epilogue=STEPS)
            check_launches(f"shard {name}", launches, by_design, want)
            median = statistics.median(times[1:])
            runs[name] = {"losses": losses, "norms": norms, "median_s": median, "peak": peak,
                          "launches": launches}
            final = {k: to_local(v).detach() for k, v in carry["params"].items()}
            if strategy is None:
                # on the host, so the plugin runs' peaks read as the base run's
                base = {k: v.cpu() for k, v in final.items()}
                base_run = runs[name]
            else:
                checks[f"shard_{name}_params_bitwise"] = all(
                    torch.equal(final[k].cpu(), v) for k, v in base.items())
                checks[f"shard_{name}_losses_bitwise"] = losses == base_run["losses"]
                checks[f"shard_{name}_norms_bitwise"] = (
                    [x for x in norms if x == x] == [x for x in base_run["norms"] if x == x]
                    and [x != x for x in norms] == [x != x for x in base_run["norms"]])
                calls, kernels = nccl_profile(torch, step, carry, batch, rep, f"shard {name}")
                runs[name].update(allreduce_calls=calls, nccl_kernels=kernels)
            rep.line(f"shard {name}: losses {losses}, grad norms {norms}; step seconds {times}; "
                     f"median of steps 2-{STEPS} {median} s; peak {peak / 2**30} GiB; "
                     f"launches {json.dumps(launches)}")
            del step, carry, loader, batch, params, final
            if strategy is not None and name in ("full_shard", "shard_grad_op_k2",
                                                 "fused_full_shard"):
                base = None  # the last run held against this base
            gc.collect()
            torch.cuda.empty_cache()
    return runs


def shard_decode_run(torch, port, plugin, rep: Report, label: str) -> dict:
    """Phase 20 (d), one run: the main path's model prepared under ``plugin``,
    ``make_generate_fn`` and ``generate`` of SHARD_DECODE["new"] greedy
    tokens from a seeded (MAIN["B"], SHARD_DECODE["prompt"]) prompt; the
    decode step's s/token from replays of its program."""
    from accelerate_tpu_torch.models.generation import generate, make_generate_fn

    acc = fresh_accelerator(torch, port, plugin)
    cfg, model = main_model(torch, port, acc)
    model = acc.prepare(model)
    prompt = torch.randint(0, cfg.vocab_size, (MAIN["B"], SHARD_DECODE["prompt"]),
                           generator=torch.Generator().manual_seed(SHARD_DECODE["seed"]))
    prompt = prompt.to(acc.device)
    torch.cuda.reset_peak_memory_stats()
    fn = make_generate_fn(model, max_new_tokens=SHARD_DECODE["new"])
    tokens = fn(prompt)
    eager = generate(model, prompt, max_new_tokens=SHARD_DECODE["new"])
    _, _, program = fn.decode_programs[MAIN["B"]]
    times = []
    for _ in range(SHARD_DECODE["new"]):  # the cache holds prompt + new; room for as many
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = {"tokens": tokens.cpu(), "eager": eager.cpu(), "traces": fn.trace_counts(),
           "graph": len(fn.decode_programs) == 1 and program.graph is not None,
           "s_per_token": statistics.median(times), "peak": torch.cuda.max_memory_allocated()}
    rep.line(f"shard (d) {label}: decode step {out['s_per_token']} s/token (median of "
             f"{len(times)} replays), one CUDA graph {out['graph']}, traces "
             f"{json.dumps(out['traces'])}, peak {out['peak'] / 2**30} GiB, new tokens "
             f"{tokens[:, SHARD_DECODE['prompt']:].tolist()}")
    del model, fn, program, acc
    return out


def shard_raw_run(torch, port, wrappers, plugin, rep: Report, label: str) -> dict:
    """Phase 20 (e), one run: the raw loop over the main path's model under
    ``plugin``: ``accumulate`` at K SHARD_RAW["K"] over MAIN's batch,
    ``backward``, the sum of the microbatches' gradients, ``clip_grad_norm_``
    (1.0) and adamw's ``step`` on each boundary, SHARD_RAW["steps"]
    optimizer steps; every launch counter set to 0 just before."""
    from accelerate_tpu_torch.parallel.runtime import to_local

    K = SHARD_RAW["K"]
    acc = fresh_accelerator(torch, port, plugin, gradient_accumulation_steps=K)
    cfg, model = main_model(torch, port, acc)
    tokens = torch.randint(0, cfg.vocab_size, (K * SHARD_RAW["steps"] * MAIN["B"], MAIN["S"]),
                           generator=torch.Generator().manual_seed(0)).numpy()
    model, opt, loader = acc.prepare(model, port.adamw(3e-4), port.DataLoader(
        [{"input_ids": row} for row in tokens], batch_size=MAIN["B"]))
    params = dict(model.named_parameters())
    loss_fn = port.CausalLM.loss_fn(model)
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    total, losses, norms, times = None, [], [], []
    for batch in loader:
        t0 = time.perf_counter()
        with acc.accumulate(model):
            loss, grads = acc.backward(loss_fn, params, batch)
            total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
            del grads
            if acc.sync_gradients:
                total, norm = acc.clip_grad_norm_(total, 1.0)
                opt.step(params, total)
                norms.append(float(norm))
                total = None
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    n = NUM_LAYERS * K * SHARD_RAW["steps"]
    check_launches(f"shard (e) {label}", launches, by_design,
                   {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n})
    out = {"losses": losses, "norms": norms, "launches": launches,
           "median_s": statistics.median(times[1:]), "peak": torch.cuda.max_memory_allocated(),
           "params": {k: to_local(v).detach().cpu() for k, v in params.items()}}
    rep.line(f"shard (e) {label}: losses {losses}, grad norms {norms}; microbatch seconds "
             f"{times}, median of calls 2-{len(times)} {out['median_s']} s; peak "
             f"{out['peak'] / 2**30} GiB; launches {json.dumps(launches)}")
    del model, opt, loader, params, acc
    return out


def shard_lora_run(torch, port, wrappers, plugin, rep: Report, label: str) -> dict:
    """Phase 20 (f), one run: phase 17's adapter step (ACCUM_CFG's model in
    bf16, rank LORA["rank"] on LORA["targets"], adamw 3e-4, clip 1.0,
    ``lora_timed``'s warmup and timed steps), over the bf16 base prepared
    under ``plugin``, with an adapter whose B is not zero."""
    import numpy as np

    from accelerate_tpu_torch import adapters
    from accelerate_tpu_torch.accelerator import _flat_params
    from accelerate_tpu_torch.parallel.runtime import to_local

    acc = fresh_accelerator(torch, port, plugin)
    cfg = port.TransformerConfig(**ACCUM_CFG)
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(0))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (LORA["B"], cfg.max_seq_len))
    batch = {"input_ids": torch.from_numpy(ids).to(acc.device)}
    model.requires_grad_(False)
    model = acc.prepare(model)
    lcfg = adapters.LoraConfig(rank=LORA["rank"], alpha=LORA["alpha"],
                               target_modules=LORA["targets"])
    adapter = acc.prepare(nonzero_adapter(torch, adapters, cfg, lcfg, 1, acc.device))
    opt = acc.prepare(port.adamw(3e-4))
    step = acc.unified_step(adapters.lora_loss_fn(model, model, lcfg,
                                                  compute_dtype=torch.bfloat16),
                            max_grad_norm=1.0)
    carry, losses, seconds, launches, by_design, peak = lora_timed(
        torch, wrappers, step, acc.init_carry(adapter, opt), batch)
    check_launches(f"shard (f) {label}", launches, by_design, lora_flash_launches(cfg))
    out = {"losses": losses, "step_s": seconds, "peak": peak, "launches": launches,
           "adapter": {k: to_local(v).detach().cpu() for k, v in _flat_params(adapter).items()}}
    rep.line(f"shard (f) {label}: losses {losses}; {seconds} s a timed step; peak "
             f"{peak / 2**30} GiB; launches {json.dumps(launches)}")
    del model, adapter, opt, step, carry, acc
    return out


def shard_engine_traffic(cfg) -> list:
    """(g)'s requests: (submit step, prompt, max_new_tokens, priority)."""
    import numpy as np

    rng = np.random.default_rng(SHARD_ENGINE["seed"])
    template = np.tile(rng.integers(0, cfg.vocab_size, 8), 4).tolist()
    trace = serve_trace(cfg.vocab_size, cfg.max_seq_len)[:SHARD_ENGINE["trace"] + 1]
    out = [(0, template, SHARD_ENGINE["template_new"], 0),
           (1, template, SHARD_ENGINE["template_new"], 0)]
    for prompt, new in trace[:-1]:
        out.append((1, prompt.tolist(), min(int(new) * 8, SHARD_ENGINE["new"]), 0))
    prompt, new = trace[-1]
    out.append((SHARD_ENGINE["late"], prompt.tolist(), min(int(new) * 8, SHARD_ENGINE["new"]), 1))
    return out


def shard_engine_run(torch, port, plugin, rep: Report, label: str, kv_dtype: str) -> dict:
    """Phase 20 (g), one run: the serving engine over the main path's model
    prepared under ``plugin`` (prefix caching, n-gram speculation, preemption,
    ``kv_dtype``) on ``shard_engine_traffic``; the tokens, the counts, the
    int8 scale arrays, tokens/s over the trace, the decode program's
    s/token from its replays, the peak and one profiled decode step."""
    from accelerate_tpu_torch.serving import ServingEngine
    from accelerate_tpu_torch.serving.speculation import SpecConfig

    acc = fresh_accelerator(torch, port, plugin)
    cfg, model = main_model(torch, port, acc)
    if plugin is not None:
        model = acc.prepare(model)
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, max_slots=SHARD_ENGINE["max_slots"],
                           block_size=SHARD_ENGINE["block_size"], seed=0, prefix_cache=True,
                           spec_decode=SpecConfig(k=SHARD_ENGINE["spec_k"]), preemption=True,
                           kv_dtype=kv_dtype)
    traffic = shard_engine_traffic(cfg)
    rids, step, generated = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while step == 0 or engine.has_work or any(t >= step for t, *_ in traffic):
        for i, (at, prompt, new, priority) in enumerate(traffic):
            if at == step:
                rids.append(engine.add_request(prompt, max_new_tokens=new, priority=priority,
                                               request_id=f"g{i}"))
        generated += len(engine.step())
        step += 1
        if step > 2000:
            fail(f"shard (g) {label}: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scales = [t.cpu() for t in engine.cache.tensors()[2:]]
    program = engine._decode_program
    engine._decode_in["lengths"].zero_()
    times = []
    for _ in range(16):  # every row empty: the replays write the garbage block only
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        program()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    out = {"tokens": {r: engine.result(r) for r in rids}, "traces": engine.trace_counts(),
           "cow": engine.prefix_cache.cow_copies_total, "preempts": sum(
               engine._preempt_counts.values()), "resumes": engine._resumes_total,
           "proposed": engine._spec_proposed_total, "accepted": engine._spec_accepted_total,
           "graph": program.graph is not None, "s_per_token": statistics.median(times),
           "tokens_per_s": generated / wall, "generated": generated, "steps": step,
           "wall_s": wall, "peak": torch.cuda.max_memory_allocated(),
           "kv_bytes_per_token": engine.kv_bytes_per_token, "scales": scales}
    rep.line(f"shard (g) {label} kv {kv_dtype}: {generated} tokens in {step} steps, {wall} s "
             f"({out['tokens_per_s']} tokens/s); decode step {out['s_per_token']} s/token "
             f"(median of {len(times)} replays), one CUDA graph {out['graph']}; traces "
             f"{json.dumps(out['traces'])}; copies on write {out['cow']}, preemptions "
             f"{out['preempts']}, resumes {out['resumes']}, drafts {out['accepted']}/"
             f"{out['proposed']} accepted; peak {out['peak'] / 2**30} GiB")
    profile_call(torch, program, rep, f"shard (g) {label} kv {kv_dtype} decode step")
    del engine, model, program, acc
    return out


def shard_qlora_run(torch, port, wrappers, plugin, rep: Report, label: str) -> dict:
    """Phase 20 (h), one run: phase 17's QLoRA step (ACCUM_CFG's model, its
    weights quantized to int8 whole, rank LORA["rank"] on LORA["targets"],
    ``lora_timed``) over the int8 base as it is (no plugin) or placed by
    ``Accelerator.prepare`` under ``plugin`` (codes and scales DTensors),
    with an adapter whose B is not zero."""
    import numpy as np

    from accelerate_tpu_torch import adapters
    from accelerate_tpu_torch.accelerator import _flat_params
    from accelerate_tpu_torch.parallel.runtime import to_local
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_params

    acc = fresh_accelerator(torch, port, plugin)
    cfg = port.TransformerConfig(**ACCUM_CFG)
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(0))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (LORA["B"], cfg.max_seq_len))
    batch = {"input_ids": torch.from_numpy(ids).to(acc.device)}
    model.requires_grad_(False)
    qbase = quantize_params(model, QuantizationConfig(load_in_8bit=True))
    if plugin is not None:
        qbase = acc.prepare(qbase, logical_specs=model)
    lcfg = adapters.LoraConfig(rank=LORA["rank"], alpha=LORA["alpha"],
                               target_modules=LORA["targets"])
    adapter = acc.prepare(nonzero_adapter(torch, adapters, cfg, lcfg, 1, acc.device))
    opt = acc.prepare(port.adamw(3e-4))
    step = acc.unified_step(adapters.lora_loss_fn(model, qbase, lcfg,
                                                  compute_dtype=torch.bfloat16),
                            max_grad_norm=1.0)
    carry, losses, seconds, launches, by_design, peak = lora_timed(
        torch, wrappers, step, acc.init_carry(adapter, opt), batch)
    check_launches(f"shard (h) {label}", launches, by_design, lora_flash_launches(cfg))
    out = {"losses": losses, "step_s": seconds, "peak": peak, "launches": launches,
           "adapter": {k: to_local(v).detach().cpu() for k, v in _flat_params(adapter).items()}}
    rep.line(f"shard (h) {label}: losses {losses}; {seconds} s a timed step; peak "
             f"{peak / 2**30} GiB; launches {json.dumps(launches)}")
    del model, qbase, adapter, opt, step, carry, acc
    return out


def shard_paths(torch, port, wrappers, rep: Report, checks: dict) -> dict:
    """Phase 20 (d)-(h) in an NCCL group of one: decoding, the raw loop, the
    LoRA step, the serving engine (native and int8 KV) and the QLoRA step
    with the params (the int8 base's codes and scales) as FULL_SHARD
    DTensors, each held bit for bit against its run without a plugin.
    Returns each run's readings."""
    full = lambda: port.ParallelismPlugin(  # noqa: E731
        sharding_strategy=port.ShardingStrategy.FULL_SHARD)
    out = {}
    with nccl_group_of_one(port):
        base = shard_decode_run(torch, port, None, rep, "without a plugin")
        dec = shard_decode_run(torch, port, full(), rep, "FULL_SHARD")
        checks["shard_decode_tokens_bitwise"] = torch.equal(dec["tokens"], base["tokens"])
        checks["shard_decode_generate_bitwise"] = (torch.equal(dec["eager"], base["eager"])
                                                   and torch.equal(dec["eager"], dec["tokens"]))
        checks["shard_decode_one_graph"] = dec["graph"] and base["graph"]
        out["decode"] = {k: {"s_per_token": r["s_per_token"], "peak": r["peak"]}
                         for k, r in (("none", base), ("full_shard", dec))}
        del base, dec
        base = shard_raw_run(torch, port, wrappers, None, rep, "without a plugin")
        raw = shard_raw_run(torch, port, wrappers, full(), rep, "FULL_SHARD")
        checks["shard_raw_losses_bitwise"] = raw["losses"] == base["losses"]
        checks["shard_raw_norms_bitwise"] = raw["norms"] == base["norms"]
        checks["shard_raw_params_bitwise"] = all(torch.equal(raw["params"][k], v)
                                                 for k, v in base["params"].items())
        checks["shard_raw_launches"] = raw["launches"] == base["launches"]
        out["raw"] = {k: {"median_s": r["median_s"], "peak": r["peak"],
                          "launches": r["launches"]} for k, r in (("none", base),
                                                                  ("full_shard", raw))}
        del base, raw
        base = shard_lora_run(torch, port, wrappers, None, rep, "without a plugin")
        lora = shard_lora_run(torch, port, wrappers, full(), rep, "FULL_SHARD")
        checks["shard_lora_losses_bitwise"] = lora["losses"] == base["losses"]
        checks["shard_lora_adapter_bitwise"] = all(torch.equal(lora["adapter"][k], v)
                                                   for k, v in base["adapter"].items())
        out["lora"] = {k: {"step_s": r["step_s"], "peak": r["peak"], "launches": r["launches"]}
                       for k, r in (("none", base), ("full_shard", lora))}
        del base, lora
        t0 = time.perf_counter()
        for kv in ("bf16", "int8"):
            base = shard_engine_run(torch, port, None, rep, "without a plugin", kv)
            eng = shard_engine_run(torch, port, full(), rep, "FULL_SHARD", kv)
            checks[f"shard_engine_{kv}_tokens_bitwise"] = (
                eng["tokens"] == base["tokens"] and all(v for v in base["tokens"].values()))
            checks[f"shard_engine_{kv}_traces"] = (eng["traces"] == base["traces"]
                                                   and eng["traces"]["decode"] == 1
                                                   and eng["graph"] and base["graph"])
            checks[f"shard_engine_{kv}_levers"] = all(
                r["cow"] >= 1 and r["preempts"] >= 1 and r["resumes"] == r["preempts"]
                and r["traces"]["verify"] >= 1 and r["proposed"] > 0 for r in (base, eng))
            if kv == "int8":
                checks["shard_engine_int8_scales_bitwise"] = all(
                    torch.equal(a, b) for a, b in zip(eng["scales"], base["scales"])) and len(
                    eng["scales"]) == 2
            out[f"engine_{kv}"] = {k: {f: r[f] for f in ("s_per_token", "tokens_per_s", "peak",
                                                        "generated", "wall_s",
                                                        "kv_bytes_per_token")}
                                   for k, r in (("none", base), ("full_shard", eng))}
            del base, eng
        t1 = time.perf_counter()
        base = shard_qlora_run(torch, port, wrappers, None, rep, "without a plugin")
        qlora = shard_qlora_run(torch, port, wrappers, full(), rep, "FULL_SHARD")
        checks["shard_qlora_losses_bitwise"] = qlora["losses"] == base["losses"]
        checks["shard_qlora_adapter_bitwise"] = all(torch.equal(qlora["adapter"][k], v)
                                                    for k, v in base["adapter"].items())
        out["qlora"] = {k: {"step_s": r["step_s"], "peak": r["peak"], "launches": r["launches"]}
                        for k, r in (("none", base), ("full_shard", qlora))}
        del base, qlora
        rep.line(f"phase 20: (g) {t1 - t0:.1f} s, (h) {time.perf_counter() - t1:.1f} s")
    return out


def prologue_row(torch, fused, rep: Report, label: str) -> dict:
    """B5 at the main path's prologue shape (llama3_8b's E 4096, (2, 2048)
    rows, bf16): checked against its plain version (``check_prologue_case``)
    and timed beside it."""
    pro = dict(B=MAIN["B"], S=MAIN["S"], E=4096, H=MAIN["H"], Hkv=MAIN["Hkv"], D=MAIN["D"])
    reading, err = check_prologue_case(torch, fused, f"{label}_main_bf16", **pro,
                                       dtype=torch.bfloat16)
    rep.line(json.dumps(reading))
    if reading["bad"]:
        fail(f"prologue at {label}'s shape: {reading['bad']}")
    args, statics = prologue_inputs(torch, fused, **pro, dtype=torch.bfloat16, seed=2)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: fused.qkv_prologue(*args, **statics), 20, scratch.zero_)
    plain_ms = time_ms(torch, lambda: fused._prologue_reference_tables(*args, **statics), 5,
                       scratch.zero_)
    rows_, E, W, e = pro["B"] * pro["S"], pro["E"], (pro["H"] + 2 * pro["Hkv"]) * pro["D"], 2
    work = (2 * rows_ * E * W,
            rows_ * E * e + W * E * e + E * 4 + 2 * rows_ * pro["D"] * 4 + rows_ * W * e)
    row = kernel_row("qkv_prologue", "+".join(reading["launched"]), ms, plain_ms, *work,
                     PEAK_BF16_FLOPS, err, None)
    row["shape"] = f"{label} prologue B{pro['B']} S{pro['S']} E{E} H{pro['H']} Hkv{pro['Hkv']} bf16"
    rep.line(f"qkv_prologue_kernel at {label}'s shape: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
             f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}), max abs err {err}")
    del args
    torch.cuda.empty_cache()
    return row


def epilogue_row(torch, port, fused, rep: Report, label: str) -> dict:
    """B6: bit for bit against its plain version over the first 10 leaves
    of the main path (the embedding and layer 0), then timed over all 39
    (``time_epilogue``)."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS)
    shapes = main_tree_shapes(cfg)[:10]
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4)
    row = fused.epilogue_scalars(hp["b1"], hp["b2"], 3, -3e-4, True, "cuda")
    leaves = [epilogue_leaf(torch, shape, i) for i, shape in enumerate(shapes)]
    fused.adamw_epilogue(*[list(c) for c in zip(*leaves)], row, **hp)
    worst = 0.0
    for i, shape in enumerate(shapes):
        want = list(epilogue_leaf(torch, shape, i))
        fused.adamw_leaf_reference(*want, row, **hp)
        for got, w in zip(leaves[i][1:], want[1:]):
            worst = max(worst, float((got - w).abs().max()))
        del want
    del leaves
    torch.cuda.empty_cache()
    rep.line(f"adamw_epilogue at {label}: the first 10 leaves' max abs diff from the plain "
             f"version {worst}")
    if worst != 0.0:
        fail(f"adamw_epilogue at {label} is not bitwise its plain version: {worst}")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out = time_epilogue(torch, port, fused, rep, scratch.zero_, worst)
    out["shape"] = f"{label}: main path leaves"
    return out


def shard_gloo(rep: Report, base: str) -> float:
    """Phase 20 (c)'s source: SHARD_WORLD CPU processes over gloo train the
    tiny CausalLM (fp32, weights seeded) SHARD_RESTORE["steps"] steps under
    FULL_SHARD at fsdp 2 x tp 2 on global batches whose data ranks hold
    different mask counts, save through the multi-process commit and write
    the whole final state. Returns the launch's seconds."""
    import torch

    from accelerate_tpu_torch import CausalLM, TransformerConfig
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts import sharding_workers
    from accelerate_tpu_torch.test_utils.training import TINY_LM

    init = CausalLM(TransformerConfig(**TINY_LM), device="cpu",
                    generator=torch.Generator().manual_seed(SHARD_RESTORE["seed"])).state_dict()
    torch.save(init, os.path.join(base, "init.pt"))
    t0 = time.perf_counter()
    debug_launcher(sharding_workers.sharded_lm_worker,
                   (base, SHARD_RESTORE["plugin"], SHARD_RESTORE["steps"], SHARD_RESTORE["rows"],
                    SHARD_RESTORE["lr"], SHARD_RESTORE["clip"]), num_processes=SHARD_WORLD)
    seconds = time.perf_counter() - t0
    rep.line(f"shard (c): {SHARD_WORLD} processes over gloo (fsdp 2 x tp 2, FULL_SHARD) trained "
             f"and saved in {seconds} s")
    return seconds


def shard_restore_run(torch, port, path: str, device: str, full: dict, plugin) -> dict:
    """A fresh tiny CausalLM (other weights) at world 1 on ``device``,
    ``plugin`` None or FULL_SHARD in a group of one: the world-4 checkpoint
    loaded with ``allow_reshape``, then SHARD_RESTORE["more"] steps on the
    global batches that follow. Returns whether every param was bitwise the
    saved state, the losses, grad norms and params before and after."""
    import numpy as np

    from accelerate_tpu_torch.parallel.runtime import gather_full
    from accelerate_tpu_torch.test_utils.training import TINY_LM, MaskedTokens

    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(cpu=device == "cpu", parallelism_plugin=plugin)
    model = port.CausalLM(port.TransformerConfig(**TINY_LM), device=acc.device,
                          generator=torch.Generator(acc.device).manual_seed(
                              SHARD_RESTORE["fresh_seed"]))
    model, opt = acc.prepare(model, port.sgd(SHARD_RESTORE["lr"]))
    step = acc.unified_step(port.CausalLM.loss_fn(model), max_grad_norm=SHARD_RESTORE["clip"])
    carry = acc.init_carry(model, opt)
    carry = acc.load_state(path, carry=carry, allow_reshape=True)
    whole = {k: gather_full(v).detach().cpu().clone() for k, v in carry["params"].items()}
    bitwise = all(torch.equal(whole[k], v) for k, v in full.items()) and (
        carry["opt_step"] == SHARD_RESTORE["steps"])
    gbs = SHARD_RESTORE["rows"] * 2  # two data ranks (fsdp 2) held each global batch
    data = MaskedTokens((SHARD_RESTORE["steps"] + SHARD_RESTORE["more"]) * gbs,
                        SHARD_RESTORE["rows"], seed=SHARD_RESTORE["seed"])
    losses, norms = [], []
    for i in range(SHARD_RESTORE["steps"], SHARD_RESTORE["steps"] + SHARD_RESTORE["more"]):
        rows = range(i * gbs, (i + 1) * gbs)
        batch = {k: torch.from_numpy(np.stack([data[r][k] for r in rows])).to(acc.device)
                 for k in ("input_ids", "loss_mask")}
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    end = {k: gather_full(v).detach().cpu().clone() for k, v in carry["params"].items()}
    if plugin is not None:
        acc.state.partial_state.destroy_process_group()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    return {"bitwise": bitwise, "losses": losses, "norms": norms, "start": whole, "end": end}


def shard_restore(torch, port, rep: Report, base: str, checks: dict) -> None:
    """Phase 20 (c): the world-4 checkpoint's chunks (each in its writer's
    file, the coverage complete), restored at world 1 on the CPU, on the
    card without a plugin and on the card under FULL_SHARD; two more steps
    on the card against two on the CPU."""
    from accelerate_tpu_torch import dist_checkpoint

    path = os.path.join(base, "ckpt")
    stats = dist_checkpoint.validate_coverage(path)
    own = True
    for proc in range(SHARD_WORLD):
        with open(os.path.join(path, f"state_index_{proc:05d}.json")) as f:
            frag = json.load(f)
        own = own and all(c["file"] == f"state_shard_{proc:05d}.safetensors"
                          for e in frag.values() for c in e["chunks"])
    checks["shard_ckpt_coverage"] = stats["files"] == SHARD_WORLD and stats["chunks"] > stats[
        "leaves"]
    checks["shard_ckpt_own_chunks"] = own
    rep.line(f"shard (c): coverage {json.dumps(stats)}, each chunk in its writer's file {own}")
    full = torch.load(os.path.join(base, "full.pt"))
    cpu = shard_restore_run(torch, port, path, "cpu", full, None)
    from accelerate_tpu_torch.launchers import _free_port

    results = {"cpu": cpu, "card": shard_restore_run(torch, port, path, "cuda", full, None)}
    os.environ.update({"ACCELERATE_TPU_NUM_PROCESSES": "1", "ACCELERATE_TPU_PROCESS_ID": "0",
                       "ACCELERATE_TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}"})
    try:
        results["card_full_shard"] = shard_restore_run(
            torch, port, path, "cuda", full,
            port.ParallelismPlugin(sharding_strategy=port.ShardingStrategy.FULL_SHARD))
    finally:
        for key in ("NUM_PROCESSES", "PROCESS_ID", "COORDINATOR_ADDRESS"):
            os.environ.pop("ACCELERATE_TPU_" + key, None)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    for name, run in results.items():
        checks[f"shard_restore_{name}_bitwise"] = run["bitwise"]
        if name == "cpu":
            continue
        loss_rel = [rel(a, b) for a, b in zip(run["losses"], cpu["losses"])]
        norm_rel = [rel(a, b) for a, b in zip(run["norms"], cpu["norms"])]
        num = sum(float((run["end"][k] - cpu["end"][k]).float().norm() ** 2) for k in cpu["end"])
        den = sum(float((cpu["end"][k] - cpu["start"][k]).float().norm() ** 2)
                  for k in cpu["end"])
        update_rel = math.sqrt(num / den)
        checks[f"shard_restore_{name}_vs_cpu"] = (max(loss_rel + norm_rel) <= RESTORE_TOL
                                                  and update_rel <= SMALL_UPDATE_TOL)
        rep.line(f"shard (c) {name}: losses {run['losses']} CPU {cpu['losses']} (rel "
                 f"{loss_rel}), grad norms {run['norms']} CPU {cpu['norms']} (rel {norm_rel}), "
                 f"params ||card - CPU|| / ||update|| {update_rel}; limits {RESTORE_TOL} and "
                 f"{SMALL_UPDATE_TOL}")


def phase20(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 20 (``--shard-only``): see SHARD_RUNS and the functions above.
    Returns B1-B3's rows at the main shape (their launches the FULL_SHARD
    run's) and B5's and B6's (their launches the fused FULL_SHARD run's)."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused

    t0 = time.perf_counter()
    checks: dict = {}
    runs = shard_runs(torch, port, wrappers, rep, checks)
    summary = {name: {k: run[k] for k in ("median_s", "peak", "allreduce_calls", "nccl_kernels")
                      if k in run} for name, run in runs.items()}
    rep.line(f"shard (a)(b) by run: {json.dumps(summary)}")
    t_paths = time.perf_counter()
    paths = shard_paths(torch, port, wrappers, rep, checks)
    rep.line(f"shard (d)-(h) by run: {json.dumps(paths)}")
    t1 = time.perf_counter()
    rows = time_flash_shape(torch, fa, rep, "shard", MAIN["B"], MAIN["S"], MAIN["H"],
                            MAIN["Hkv"], MAIN["D"], bwd_library_on_dq=True)
    for row in rows:
        row["launches"] = runs["full_shard"]["launches"][WRAPPER_OF[row["name"]]]
    for row in (prologue_row(torch, fused, rep, "shard"),
                epilogue_row(torch, port, fused, rep, "shard")):
        row["launches"] = runs["fused_full_shard"]["launches"][WRAPPER_OF[row["name"]]]
        rows.append(row)
    t2 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="shard_")
    try:
        shard_gloo(rep, base)
        shard_restore(torch, port, rep, base, checks)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rep.line(f"shard checks {json.dumps(checks)}")
    rep.line(f"phase 20: (a)(b) {t_paths - t0:.1f} s, (d)-(h) {t1 - t_paths:.1f} s, kernel "
             f"rows {t2 - t1:.1f} s, (c) "
             f"{time.perf_counter() - t2:.1f} s, in all {time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"shard: hard checks failed: {failed}")
    return rows


# Phase 21 (``--pipe-only``): the pipeline, ring and expert-shard bodies of
# queue A7 parts 3 and 4 on the card, every rank's body in one process
PIPE = dict(micro_a=2, stages=2, micro_b=8, rows_b=1, sp=4, eps=(2, 4),
            moe_tokens=16 * 1024, drop_cf=1.25)
# limits, worst row's max error over its RMS (bf16) unless said: about 3x
# the reading on an H100 (PERF.md's parity table)
PIPE_LOSS_TOL = 1e-6  # relative: 1F1B and GPipe losses against the sequential run (read 0.0)
PIPE_GRAD_TOL = 0.3  # each leaf's gradient against the sequential run (1F1B read 0.102)
# the ring's output, dq, dk, dv against the flash kernels' (read 0.032, 0.198, 0.044, 0.039)
RING_TOL = {"out": 0.1, "dq": 0.6, "dk": 0.15, "dv": 0.12}
EP_TOL = 0.0  # the summed shards' output and expert gradients against moe_ragged (read 0.0)


def pipe_model(torch, port, seed: int = 0):
    """The llama3_8b-width 4-layer CausalLM in bf16 on the card, made from
    ``seed``; its layers' fp32 parameters stacked (leading NUM_LAYERS dim)
    as the pipeline's block, a Block on the meta device to run them, and
    the frozen final norm and lm_head of the loss."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS, dtype="bfloat16",
                                           max_seq_len=MAIN["S"])
    model = port.CausalLM(cfg, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(seed))
    names = [n for n, _ in model.layers[0].named_parameters()]
    stack = {n: torch.stack([dict(layer.named_parameters())[n].detach()
                             for layer in model.layers]) for n in names}
    from accelerate_tpu_torch.models.transformer import Block

    template = Block(cfg, device="meta")
    head = model.lm_head.weight.detach().to(torch.bfloat16)
    norm = model.final_norm
    embed = model.embed.weight.detach()
    del model
    return cfg, stack, template, head, norm, embed


def pipe_block(torch, template, seq: int):
    """``block_fn(local, x)``: ``x`` (B, S, E) through the layers of the
    stacked ``local`` in order, each a functional call of the Block."""
    def block_fn(local, x):
        positions = torch.arange(seq, device=x.device)[None, :].expand(x.shape[0], seq)
        for i in range(next(iter(local.values())).shape[0]):
            x = torch.func.functional_call(template, {k: v[i] for k, v in local.items()},
                                           (x, positions))
        return x

    return block_fn


def pipe_loss(torch, norm, head):
    """``loss_fn(y, t)``: the frozen final norm and lm_head, then the mean
    cross-entropy of the fp32 logits against ``t``."""
    import torch.nn.functional as F

    def loss_fn(y, t):
        logits = norm(y) @ head.t().to(y.dtype)
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), t.reshape(-1))

    return loss_fn


def pipe_data(torch, cfg, embed, rows: int, seed: int):
    """Inputs: the embedding of seeded tokens (bf16), and seeded targets."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (rows, MAIN["S"]), generator=gen).cuda()
    targets = torch.randint(0, cfg.vocab_size, (rows, MAIN["S"]), generator=gen).cuda()
    return embed[ids].to(torch.bfloat16), targets


def pipe_step_runs(torch, port, wrappers, rep: Report, checks: dict) -> dict:
    """(a): ``unified_pipeline_step`` at pp 1 (NUM_LAYERS stacked as the
    block, MAIN's B 2 x S 2048 in PIPE["micro_a"] microbatches, STEPS
    steps, clip 1.0) against ``unified_step`` whose loss runs the same
    microbatch loop, with adamw and with fused_adamw, in an NCCL group of
    one: bit for bit, B1-B3 once per layer and microbatch a step, B6 once a
    step on the fused runs."""
    from accelerate_tpu_torch.launchers import _free_port

    os.environ.update({"ACCELERATE_TPU_NUM_PROCESSES": "1", "ACCELERATE_TPU_PROCESS_ID": "0",
                       "ACCELERATE_TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}"})
    runs = {}
    M = PIPE["micro_a"]
    try:
        cfg, stack, template, head, norm, embed = pipe_model(torch, port)
        block_fn = pipe_block(torch, template, MAIN["S"])
        loss_fn = pipe_loss(torch, norm, head)
        x, t = pipe_data(torch, cfg, embed, MAIN["B"], seed=1)
        del embed
        for fused in (False, True):
            for kind in ("pipeline", "unified"):
                port.AcceleratorState._reset_state(reset_partial_state=True)
                port.GradientState._reset_state()
                acc = port.Accelerator(mixed_precision="bf16", parallelism_plugin=(
                    port.ParallelismPlugin(num_micro_batches=M)))
                params = {k: v.clone() for k, v in stack.items()}
                opt = acc.prepare((port.fused_adamw if fused else port.adamw)(3e-4))
                carry = acc.init_carry(params, opt)
                if kind == "pipeline":
                    step = acc.unified_pipeline_step(block_fn, loss_fn, max_grad_norm=1.0)
                    call = lambda c: step(c, x, t)  # noqa: E731
                else:
                    def micro_loss(p, batch):
                        xm = batch["x"].reshape((M, -1) + tuple(batch["x"].shape[1:]))
                        tm = batch["t"].reshape((M, -1) + tuple(batch["t"].shape[1:]))
                        return torch.stack([loss_fn(block_fn(p, xm[j]), tm[j]).float()
                                            for j in range(M)]).mean()

                    step = acc.unified_step(micro_loss, max_grad_norm=1.0)
                    call = lambda c: step(c, {"x": x, "t": t})  # noqa: E731
                reset_counts(wrappers)
                torch.cuda.reset_peak_memory_stats()
                losses, norms, times = [], [], []
                for _ in range(STEPS):
                    t0 = time.perf_counter()
                    carry, m = call(carry)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                launches = {w.__name__: w.launches for w in wrappers}
                by_design = {w.__name__: dict(w.by_design) for w in wrappers
                             if hasattr(w, "by_design")}
                want = {w: NUM_LAYERS * M * STEPS
                        for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                if fused:
                    want["adamw_epilogue"] = STEPS
                name = f"{kind}_{'fused_adamw' if fused else 'adamw'}"
                check_launches(f"pipe (a) {name}", launches, by_design, want)
                peak = torch.cuda.max_memory_allocated()
                runs[name] = {"losses": losses, "norms": norms, "launches": launches,
                              "median_s": statistics.median(times[1:]), "peak": peak,
                              "params": {k: v.detach().cpu() for k, v in carry["params"].items()}}
                rep.line(f"pipe (a) {name}: losses {losses}, grad norms {norms}; step seconds "
                         f"{times}; median of steps 2-{STEPS} {runs[name]['median_s']} s; peak "
                         f"{peak / 2**30} GiB")
                del acc, opt, carry, step, call, params
                gc.collect()
                torch.cuda.empty_cache()
            opt_name = "fused_adamw" if fused else "adamw"
            a, b = runs[f"pipeline_{opt_name}"], runs[f"unified_{opt_name}"]
            checks[f"pipe_a_{opt_name}_bitwise"] = (
                a["losses"] == b["losses"] and a["norms"] == b["norms"]
                and all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"]))
        del stack, template, head, norm, x, t
    finally:
        port.AcceleratorState().partial_state.destroy_process_group()
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        for key in ("NUM_PROCESSES", "PROCESS_ID", "COORDINATOR_ADDRESS"):
            os.environ.pop("ACCELERATE_TPU_" + key, None)
    for run in runs.values():
        del run["params"]
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def pipe_schedules(torch, port, wrappers, rep: Report, checks: dict) -> None:
    """(b): 1F1B at PIPE["stages"] stages on the card: both stages' bodies
    in one process through the library's tick table (layers 0-1 and 2-3,
    PIPE["micro_b"] microbatches of B 1 x S 2048, bf16), and GPipe through
    its tick table with autograd; each against the sequential autograd run
    (loss PIPE_LOSS_TOL relative, each leaf's gradient PIPE_GRAD_TOL);
    exact launches; the 1F1B peak below GPipe's."""
    from accelerate_tpu_torch.test_utils import pipeline_runner as runner

    cfg, stack, template, head, norm, embed = pipe_model(torch, port, seed=2)
    M, S = PIPE["micro_b"], PIPE["stages"]
    per = NUM_LAYERS // S
    block_fn = pipe_block(torch, template, MAIN["S"])
    loss_fn = pipe_loss(torch, norm, head)
    x, t = pipe_data(torch, cfg, embed, M * PIPE["rows_b"], seed=3)
    del embed
    xm = x.reshape(M, PIPE["rows_b"], MAIN["S"], -1)
    tm = t.reshape(M, PIPE["rows_b"], MAIN["S"])
    compute = {k: v.to(torch.bfloat16) for k, v in stack.items()}
    del stack
    stages = [{k: v[i * per:(i + 1) * per] for k, v in compute.items()} for i in range(S)]
    want = {"1f1b": {"flash_fwd": 2 * NUM_LAYERS * M, "flash_bwd_dq": NUM_LAYERS * M,
                     "flash_bwd_dkv": NUM_LAYERS * M},
            "gpipe": {w: NUM_LAYERS * M for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
            "sequential": {w: NUM_LAYERS * M
                           for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}}
    rep.line(f"pipe (b) predicted launches: {json.dumps(want)}")
    out = {}
    for name in ("sequential", "gpipe", "1f1b"):
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if name == "1f1b":
            loss, grads, bodies = runner.run_1f1b([block_fn] * S, stages, loss_fn, xm, tm)
            extra = {"peak_inputs": [b.peak_inputs for b in bodies]}
            del bodies
        elif name == "gpipe":
            loss, grads = runner.run_gpipe([block_fn] * S, stages, loss_fn, xm, tm)
            extra = {}
        else:
            loss, grads = runner.run_gpipe([block_fn], [compute], loss_fn, xm, tm)
            grads = [{k: g[i * per:(i + 1) * per] for k, g in grads[0].items()}
                     for i in range(S)]
            extra = {}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = {w.__name__: w.launches for w in wrappers}
        by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
        check_launches(f"pipe (b) {name}", launches, by_design, want[name])
        out[name] = {"loss": float(loss), "grads": grads, "peak": peak, "seconds": seconds,
                     **extra}
        rep.line(f"pipe (b) {name}: loss {float(loss)}, peak above the start "
                 f"{peak / 2**30} GiB, {seconds} s, launches {json.dumps(launches)} "
                 f"{json.dumps(extra)}")
    seq = out["sequential"]
    for name in ("1f1b", "gpipe"):
        loss_rel = abs(out[name]["loss"] - seq["loss"]) / abs(seq["loss"])
        worst = max(row_err(torch, out[name]["grads"][i][k], seq["grads"][i][k])
                    for i in range(S) for k in seq["grads"][i])
        checks[f"pipe_b_{name}_vs_sequential"] = loss_rel <= PIPE_LOSS_TOL and \
            worst <= PIPE_GRAD_TOL
        rep.line(f"pipe (b) {name} against the sequential run: loss rel {loss_rel}, worst "
                 f"gradient row error {worst}; limits {PIPE_LOSS_TOL}, {PIPE_GRAD_TOL}")
    ratio = out["gpipe"]["peak"] / max(out["1f1b"]["peak"], 1)
    checks["pipe_b_1f1b_peak_below_gpipe"] = out["1f1b"]["peak"] < out["gpipe"]["peak"]
    rep.line(f"pipe (b) peaks above the start: 1F1B {out['1f1b']['peak'] / 2**30} GiB, GPipe "
             f"{out['gpipe']['peak'] / 2**30} GiB, sequential "
             f"{out['sequential']['peak'] / 2**30} GiB; GPipe / 1F1B {ratio}")
    del out, stages, compute, xm, tm, x, t, head, norm, template
    gc.collect()
    torch.cuda.empty_cache()


def pipe_ring(torch, fa, rep: Report, checks: dict) -> None:
    """(c): ring attention at LONGSEQ_CFG's attention (B 1, S 8192, 32
    heads, 8 kv heads, head_dim 128, bf16, causal), every one of PIPE["sp"]
    ranks' bodies in one process through the ring order, against the flash
    kernels (B1-B3) on the same inputs: the output and dq, dk, dv by row
    (RING_TOL, by quantity); the peaks of the ring and of the dense
    ``xla_attention``."""
    from accelerate_tpu_torch.ops.attention import xla_attention
    from accelerate_tpu_torch.test_utils import pipeline_runner as runner

    S, H, Hkv, D = LONGSEQ_CFG["max_seq_len"], LONGSEQ_CFG["num_heads"], \
        LONGSEQ_CFG["num_kv_heads"], LONGSEQ_CFG["hidden_size"] // LONGSEQ_CFG["num_heads"]
    q, k, v, dout = make_inputs(torch, 1, S, H, Hkv, D, torch.bfloat16, seed=7)
    results = {}
    for name, fn in (("flash", lambda a, b, c: fa.flash_attention(a, b, c, causal=True)),
                     ("ring", lambda a, b, c: runner.ring_rank_bodies(a, b, c, PIPE["sp"])),
                     ("dense", lambda a, b, c: xla_attention(a, b, c, causal=True))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        results[name] = {"out": out.detach(), "grads": grads, "peak": peak}
        del out, leaves
        if name == "dense":
            results[name] = {"peak": peak}
    errs = {"out": row_err(torch, results["ring"]["out"], results["flash"]["out"])}
    for i, g in enumerate(("dq", "dk", "dv")):
        errs[g] = row_err(torch, results["ring"]["grads"][i], results["flash"]["grads"][i])
    checks["pipe_c_ring_vs_flash"] = all(errs[k] <= RING_TOL[k] for k in RING_TOL)
    rep.line(f"pipe (c) ring (sp {PIPE['sp']}) against flash at B 1 S {S} H {H} Hkv {Hkv} "
             f"D {D} bf16: row errors {json.dumps(errs)}, limits {json.dumps(RING_TOL)}; peaks "
             f"above the start: ring {results['ring']['peak'] / 2**30} GiB, dense xla "
             f"{results['dense']['peak'] / 2**30} GiB, flash {results['flash']['peak'] / 2**30} "
             "GiB (every rank's ring body in one process)")
    del results, q, k, v, dout
    gc.collect()
    torch.cuda.empty_cache()


def pipe_experts(torch, rep: Report, checks: dict) -> None:
    """(d): MOE_CFG's MoE (T = PIPE["moe_tokens"] tokens, 8 experts, top 2,
    h 4096, f 3584, bf16): the ep 2 and ep 4 shard windows in one process,
    summed, at capacity_factor ep against ``moe_ragged`` (output and expert
    gradients by row within EP_TOL: bit for bit, zero drops); at
    PIPE["drop_cf"] the share of token choices dropped (a reading)."""
    from accelerate_tpu_torch.ops import moe
    from accelerate_tpu_torch.test_utils import pipeline_runner as runner

    T, h, f = PIPE["moe_tokens"], MOE_CFG["hidden_size"], MOE_CFG["intermediate_size"]
    E, K = MOE_CFG["num_experts"], MOE_CFG["num_experts_per_tok"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(T, h, device="cuda", generator=gen).to(torch.bfloat16)
    router = torch.randn(h, E, device="cuda", generator=gen) * h ** -0.5
    weights, sel = torch.topk(torch.softmax(x.float() @ router, -1), K)
    weights = weights / weights.sum(-1, keepdim=True)
    stacks = [(torch.randn(shape, device="cuda", generator=gen) * shape[1] ** -0.5).to(
        torch.bfloat16) for shape in ((E, h, f), (E, h, f), (E, f, h))]
    g = torch.randn(T, h, device="cuda", generator=gen).to(torch.bfloat16)

    def run(fn):
        leaves = [w.detach().requires_grad_(True) for w in stacks]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, g)

    want_out, want_grads = run(lambda a, b, c: moe.moe_ragged(x, sel, weights, a, b, c))
    readings = {}
    for ep in PIPE["eps"]:
        out, grads = run(lambda a, b, c: runner.expert_shards(x, sel, weights, a, b, c, ep,
                                                           float(ep)))
        errs = [row_err(torch, out, want_out)] + [row_err(torch, gg, w)
                                                  for gg, w in zip(grads, want_grads)]
        dropped = T * K - sum(moe.shard_coverage(sel, E, ep, float(ep)))
        tight = T * K - sum(moe.shard_coverage(sel, E, ep, PIPE["drop_cf"]))
        readings[ep] = {"row_errs": errs, "dropped_at_ep": dropped,
                        "drop_share_at_1.25": tight / (T * K)}
        checks[f"pipe_d_ep{ep}_vs_ragged"] = max(errs) <= EP_TOL and dropped == 0
        del out, grads
    rep.line(f"pipe (d) expert shards at T {T} E {E} K {K} h {h} f {f} bf16 against moe_ragged: "
             f"{json.dumps(readings)}, limit {EP_TOL}")
    del x, stacks, g, want_out, want_grads
    gc.collect()
    torch.cuda.empty_cache()


def phase21(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 21 (``--pipe-only``): (a)-(d) above, then B1-B3 checked and
    timed at the main shape and B6 at the main path's leaves for their rows
    (launches: (a)'s pipeline runs)."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused

    t0 = time.perf_counter()
    checks: dict = {}
    runs = pipe_step_runs(torch, port, wrappers, rep, checks)
    t1 = time.perf_counter()
    pipe_schedules(torch, port, wrappers, rep, checks)
    t2 = time.perf_counter()
    pipe_ring(torch, fa, rep, checks)
    pipe_experts(torch, rep, checks)
    t3 = time.perf_counter()
    rows = time_flash_shape(torch, fa, rep, "pipe", MAIN["B"], MAIN["S"], MAIN["H"],
                            MAIN["Hkv"], MAIN["D"], bwd_library_on_dq=True)
    for row in rows:
        row["launches"] = runs["pipeline_adamw"]["launches"][WRAPPER_OF[row["name"]]]
    row = epilogue_row(torch, port, fused, rep, "pipe")
    row["launches"] = runs["pipeline_fused_adamw"]["launches"]["adamw_epilogue"]
    rows.append(row)
    rep.line(f"pipe checks {json.dumps(checks)}")
    rep.line(f"phase 21: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c)(d) {t3 - t2:.1f} s, "
             f"kernel rows {time.perf_counter() - t3:.1f} s, in all "
             f"{time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"pipe: hard checks failed: {failed}")
    return rows


# ---------------------------------------------------------------------- #
# phase 22: the model zoo
# ---------------------------------------------------------------------- #
# google/gemma-2b's config.json: its published widths, nothing cut
GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384, num_layers=18,
                num_heads=8, num_kv_heads=1, head_dim=256, norm_offset=True, embed_scale=True,
                mlp_activation="gelu_tanh", tie_embeddings=True, rms_norm_eps=1e-6,
                rope_theta=10000.0, max_seq_len=2048)
GEMMA_ROPE = dict(theta=10000.0, scaling=None)
ZOO = dict(gemma_B=1, gemma_S=2048, gpt2_B=8, gpt2_S=1024, t5_B=8, t5_S=512, prompt=128,
           new=32)
ZOO_STEPS = 5
# fp32 B1-B4 at (1, 2048) 8/1 x 256 sum 2048 keys and a group of 8 in other
# orders than the plain version: its own row limit, about 3x its reading
# 2.78e-5 (dv; o 1.04e-5) on an H100 80GB HBM3 at 700 W; TOL elsewhere
D256_FP32_CAUSAL_TOL = 8.5e-5
# |flash - xla| / |xla| of Gemma-2B's step-1 loss and grad norm at the same
# weights (bf16 compute): about 3x the readings 1.51e-5 and 2.19e-4 on an H100
# 80GB HBM3 at 700 W (PERF.md)
GEMMA_XLA_TOL = {"loss": 5e-5, "grad_norm": 7e-4}
SMALL_TOL = 1e-4  # tiny fp32 models, card against CPU: small_model_phase's limit
GPT2_PARAMS = 124_439_808  # TransformerConfig.gpt2(): GPT-2 small


def zoo_kernel_cases(torch, fa, fused, build, rep: Report) -> None:
    """(a): B1-B4 at head_dim 256 in three dtypes, the host's carve of every
    wmma kernel against the C launcher's, and B5 at Gemma-2B's widths."""
    lib = build.bind("flash_attention", fa._SIGNATURES, "flash_error_string")
    kinds = ("fwd", "dq", "dkv", "fused")
    wrong = [(code, d, k) for code, dtype in ((0, torch.float32), (1, torch.bfloat16),
                                              (2, torch.float16))
             for d in range(16, 257, 16) for i, k in enumerate(kinds)
             if lib.flash_wmma_smem(i, code, d) != fa.wmma_smem_bytes(k, dtype, d)]
    if wrong:
        fail(f"wmma_smem_bytes disagrees with the C launcher's carve: {wrong[:8]}")
    at256 = {str(dt).replace("torch.", ""): {k: fa.wmma_smem_bytes(k, dt, 256) for k in kinds}
             for dt in (torch.bfloat16, torch.float32)}
    rep.line(f"wmma carve: host and C launcher agree at every head_dim 16-256, 3 dtypes; at "
             f"256 {json.dumps(at256)} bytes of {fa.MAX_DYNAMIC_SMEM}")
    g = dict(B=1, S=2048, H=8, Hkv=1, D=256)
    failed = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        cases = [
            ("d256_causal_gqa8", dict(g, row_limit=D256_FP32_CAUSAL_TOL
                                      if dtype == torch.float32 else None)),
            ("d256_noncausal_lengths", dict(B=3, S=512, H=4, Hkv=2, D=256, causal=False,
                                            lens=[512, 300, 129])),
            ("d256_window", dict(B=2, S=1024, H=4, Hkv=1, D=256, window=300)),
            ("d256_nan_rows_causal", dict(B=3, S=384, H=4, Hkv=2, D=256,
                                          lens=[384, 384, 0], nan=True)),
            ("d256_nan_rows_noncausal", dict(B=3, S=384, H=4, Hkv=2, D=256, causal=False,
                                             lens=[384, 384, 0], nan=True)),
        ]
        for name, kw in cases:
            reading, _ = check_case(torch, fa, f"{name}_{tag}", dtype=dtype, **kw)
            rep.line(json.dumps(reading))
            if reading["bad"] or reading["design"] != "wmma":
                failed.append(f"{name}_{tag}: {reading['bad']}")
            torch.cuda.empty_cache()
    reading, _ = check_prologue_case(torch, fused, "gemma2b_norm_offset", B=1, S=2048, E=2048,
                                     H=8, Hkv=1, D=256, dtype=torch.bfloat16, norm_offset=True,
                                     rope=GEMMA_ROPE)
    rep.line(json.dumps(reading))
    if reading["bad"]:
        failed.append(f"prologue_gemma2b_norm_offset: {reading['bad']}")
    if failed:
        fail(f"zoo: kernel cases beyond tolerance or design: {'; '.join(failed)}")


def zoo_trainer(torch, port, model, rows: list, batch: int, loss_fn):
    """``model`` prepared with plain AdamW (lr 3e-4) and clip 1.0 in a fresh
    bf16 accelerator, over ``rows`` (one batch, repeated)."""
    acc = fresh_accelerator(torch, port)
    model = model.to(acc.device)
    model, opt, loader = acc.prepare(model, port.adamw(3e-4),
                                     port.DataLoader(rows, batch_size=batch))
    step = acc.unified_step(loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    torch.cuda.synchronize()
    return acc, model, step, carry, loader


def zoo_steps(torch, wrappers, rep: Report, name: str, step, carry, loader, per_step: int,
              design: str):
    """The path's steps with every counter at 0 before and read after:
    exact B1-B3 launches (``per_step`` a step each, on ``design``), finite
    losses that fall on the repeated batch. Returns the carry, the batch,
    the losses, the grad norms, the launches, the median step and the
    peak."""
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, batch, losses, norms, times = run_steps(torch, step, carry, loader)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(times[1:])
    rep.line(f"{name} losses {losses}, grad norms {norms}; step seconds {times}, median of "
             f"steps 2-{len(times)} {steady} s; peak {peak / 2**30} GiB; launches "
             f"{json.dumps(launches)}")
    if len(losses) != ZOO_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{name}: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: the loss did not fall on a repeated batch: {losses}")
    n = per_step * ZOO_STEPS
    check_launches(name, launches, by_design,
                   {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}, design)
    return carry, batch, losses, norms, launches, steady, peak


def gemma_path(torch, port, wrappers, rep: Report) -> dict:
    """(b): Gemma-2B at its published widths."""
    from accelerate_tpu_torch.models import count_params

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = port.TransformerConfig(**GEMMA_2B, dtype="bfloat16")
    model = port.CausalLM(cfg, device=CARD,
                          generator=torch.Generator(device=CARD).manual_seed(0))
    B, S = ZOO["gemma_B"], ZOO["gemma_S"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(0)).numpy()
    first = {"input_ids": torch.from_numpy(tokens).to(CARD)}
    # the plain path's step-1 loss and grad norm at the same weights
    set_config(model, attention_impl="xla")
    xla_loss, grads = grads_of(torch, model, first, torch.bfloat16)
    xla_norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    del grads
    set_config(model, attention_impl=None)
    rows = [{"input_ids": tokens[i % B]} for i in range(ZOO_STEPS * B)]
    acc, model, step, carry, loader = zoo_trainer(torch, port, model, rows, B,
                                                  port.CausalLM.loss_fn)
    rep.line(f"gemma-2b path set-up: {count_params(model)} params (google/gemma-2b widths, "
             f"nothing cut), {time.perf_counter() - t0:.1f} s")
    carry, batch, losses, norms, launches, steady, peak = zoo_steps(
        torch, wrappers, rep, "gemma-2b path", step, carry, loader, cfg.num_layers, "wmma")
    gaps = {"loss": abs(losses[0] - xla_loss) / abs(xla_loss),
            "grad_norm": abs(norms[0] - xla_norm) / abs(xla_norm)}
    rep.line(f"gemma-2b path step 1 against attention_impl='xla' at the same weights: loss "
             f"{losses[0]} vs {xla_loss}, grad norm {norms[0]} vs {xla_norm}; relative "
             f"{json.dumps(gaps)}, limits {json.dumps(GEMMA_XLA_TOL)}; {B * S / steady} tokens/s")
    if any(not gaps[k] <= GEMMA_XLA_TOL[k] for k in gaps):
        fail(f"gemma-2b path: flash and xla disagree at step 1: {gaps}")
    ran = profile_step(torch, step, carry, batch, rep, "gemma-2b path")
    want_ran = {"flash_fwd_wmma_kernel", "flash_bwd_dq_wmma_kernel", "flash_bwd_dkv_wmma_kernel"}
    if ran is not None and ran != want_ran:
        fail(f"gemma-2b path: the profiled step ran {sorted(ran)}, want {sorted(want_ran)}")
    del acc, model, step, carry, loader, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def small_card_cpu(torch, port, cls, cfg, args, rep: Report, name: str, seed: int = 0):
    """A tiny fp32 model of ``cls`` on the card (through the kernels where
    its config takes them) and on the CPU with the same weights: logits,
    loss and every gradient within SMALL_TOL. Returns both models."""
    cpu = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    card_model = cls(cfg, device=CARD)
    card_model.load_state_dict(cpu.state_dict())
    out = []
    for model, device in ((cpu, "cpu"), (card_model, CARD)):
        params = dict(model.named_parameters())
        batch = {k: v.to(device) for k, v in args.items()}
        loss = cls.loss_fn(model)(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append((loss.item(), [g.cpu() for g in grads]))
    (c_loss, c_grads), (g_loss, g_grads) = out
    grad_err = max(rel_err(torch, g, c) for g, c in zip(g_grads, c_grads))
    rep.line(f"{name} fp32 on the card vs the CPU: loss {g_loss} vs {c_loss}, max grad rel err "
             f"{grad_err}")
    if not (abs(g_loss - c_loss) <= SMALL_TOL * abs(c_loss) and grad_err <= SMALL_TOL):
        fail(f"{name}: the card disagrees with the CPU")
    return cpu.eval(), card_model.eval()


def gpt2_path(torch, port, wrappers, rep: Report) -> dict:
    """(c): GPT-2 at the gpt2 preset, its generate, a tiny card-vs-CPU."""
    from accelerate_tpu_torch.models import GPT2LM, count_params
    from accelerate_tpu_torch.models.generation import generate, make_generate_fn

    t0 = time.perf_counter()
    cfg = port.TransformerConfig.gpt2(dtype="bfloat16")
    model = GPT2LM(cfg, device=CARD, generator=torch.Generator(device=CARD).manual_seed(0))
    if count_params(model) != GPT2_PARAMS:
        fail(f"gpt2: {count_params(model)} params, not the preset's {GPT2_PARAMS}")
    B, S = ZOO["gpt2_B"], ZOO["gpt2_S"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1)).numpy()
    rows = [{"input_ids": tokens[i % B]} for i in range(ZOO_STEPS * B)]
    acc, model, step, carry, loader = zoo_trainer(torch, port, model, rows, B, GPT2LM.loss_fn)
    rep.line(f"gpt2 path set-up: {GPT2_PARAMS} params, {time.perf_counter() - t0:.1f} s")
    launches = zoo_steps(torch, wrappers, rep, "gpt2 path", step, carry, loader,
                         cfg.num_layers, "wgmma")[4]
    prompt = torch.from_numpy(tokens[:1, :ZOO["prompt"]]).to(CARD)
    fn = make_generate_fn(model, max_new_tokens=ZOO["new"])
    replay = fn(prompt)
    t1 = time.perf_counter()
    replay = fn(prompt)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t1
    eager = generate(model, prompt, max_new_tokens=ZOO["new"])
    rep.line(f"gpt2 make_generate_fn B 1, a {ZOO['prompt']}-token prompt, {ZOO['new']} new: "
             f"{replay_s} s a call ({replay_s / ZOO['new'] * 1e3} ms a token, prefill "
             f"included); builds {fn.trace_counts()}; equal to the eager loop bit for bit "
             f"{torch.equal(replay, eager)}")
    if not torch.equal(replay, eager) or fn.trace_counts()["decode"] != 1:
        fail("gpt2: the decode graph's replay is not the eager loop's, or it was rebuilt")
    del acc, model, step, carry, loader, fn
    gc.collect()
    torch.cuda.empty_cache()
    tiny = port.TransformerConfig.gpt2(vocab_size=512, hidden_size=128, intermediate_size=512,
                                       num_layers=2, num_heads=4, max_seq_len=128,
                                       attention_impl="flash")
    ids = torch.randint(0, 512, (2, 96), generator=torch.Generator().manual_seed(2))
    cpu, card_model = small_card_cpu(torch, port, GPT2LM, tiny, {"input_ids": ids}, rep,
                                     "gpt2 tiny")
    with torch.no_grad():
        logit_err = rel_err(torch, card_model(ids.to(CARD)).cpu(), cpu(ids))
    rep.line(f"gpt2 tiny logits rel err {logit_err}")
    if not logit_err <= SMALL_TOL:
        fail("gpt2 tiny: the card's logits disagree with the CPU's")
    return launches


def t5_rows(torch, vocab: int, B: int, S: int, seed: int, mask: bool = False) -> list:
    """Copy-task rows: the source, the target as the source shifted behind a
    BOS of 0, and with ``mask`` every other row's source right-padded from
    S / 2."""
    src = torch.randint(1, vocab, (B, S), generator=torch.Generator().manual_seed(seed)).numpy()
    rows = []
    for i in range(B):
        row = {"input_ids": src[i], "labels": src[i],
               "decoder_input_ids": src[i].copy()}
        row["decoder_input_ids"][1:] = src[i][:-1]
        row["decoder_input_ids"][0] = 0
        if mask:
            m = src[i].copy() * 0 + 1
            if i % 2:
                m[S // 2:] = 0
            row["attention_mask"] = m
        rows.append(row)
    return rows


def t5_path(torch, port, wrappers, rep: Report) -> dict:
    """(d): the t5_base Seq2SeqLM, then a masked step, a tiny card-vs-CPU."""
    from accelerate_tpu_torch.models import Seq2SeqLM, count_params

    t0 = time.perf_counter()
    cfg = port.TransformerConfig.t5_base(dtype="bfloat16")
    model = Seq2SeqLM(cfg, device=CARD, generator=torch.Generator(device=CARD).manual_seed(0))
    B, S = ZOO["t5_B"], ZOO["t5_S"]
    rows = t5_rows(torch, cfg.vocab_size, B, S, seed=3)
    acc, model, step, carry, loader = zoo_trainer(torch, port, model, rows * ZOO_STEPS, B,
                                                  Seq2SeqLM.loss_fn)
    rep.line(f"t5_base path set-up: {count_params(model)} params (12 + 12 layers, nothing "
             f"cut), {time.perf_counter() - t0:.1f} s")
    carry, _, _, _, launches, _, _ = zoo_steps(torch, wrappers, rep, "t5_base path", step, carry,
                                               loader, 2 * cfg.num_layers, "wgmma")
    masked = port.DataLoader(t5_rows(torch, cfg.vocab_size, B, S, seed=4, mask=True),
                             batch_size=B)
    batch = {k: torch.as_tensor(v).to(CARD) for k, v in next(iter(masked)).items()}
    reset_counts(wrappers)
    carry, metrics = step(carry, batch)
    masked_launches = {w.__name__: w.launches for w in wrappers}
    rep.line(f"t5_base path, one step with a right-padded source mask: loss "
             f"{float(metrics['loss'])}, launches {json.dumps(masked_launches)} (the masked "
             f"encoder on the plain path)")
    want = {w.__name__: 0 for w in wrappers}
    want.update(flash_fwd=cfg.num_layers, flash_bwd_dq=cfg.num_layers,
                flash_bwd_dkv=cfg.num_layers)
    if masked_launches != want or not math.isfinite(float(metrics["loss"])):
        fail(f"t5_base masked step: launches {masked_launches}, want {want}")
    del acc, model, step, carry, loader
    gc.collect()
    torch.cuda.empty_cache()
    tiny = port.TransformerConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                                  num_layers=2, num_decoder_layers=2, num_heads=4,
                                  max_seq_len=64, tie_embeddings=True, attention_impl="flash")
    small = t5_rows(torch, 256, 2, 48, seed=5)
    args = {k: torch.stack([torch.as_tensor(r[k]) for r in small]).long() for k in small[0]}
    cpu, card_model = small_card_cpu(torch, port, Seq2SeqLM, tiny, args, rep, "t5 tiny")
    want_tokens = cpu.generate(args["input_ids"], max_new_tokens=24)
    got = card_model.generate(args["input_ids"].to(CARD), max_new_tokens=24).cpu()
    rep.line(f"t5 tiny greedy generate, 24 tokens: card equals CPU {torch.equal(got, want_tokens)}")
    if not torch.equal(got, want_tokens):
        fail("t5 tiny: the card's greedy tokens are not the CPU's")
    return launches


def gemma2_tiny(torch, port, rep: Report) -> None:
    """(e): a tiny fp32 Gemma-2 on the card against the CPU, and engines."""
    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.serving import ServingEngine

    cfg = port.TransformerConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                                 num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
                                 max_seq_len=128, rope_theta=10000.0, norm_offset=True,
                                 embed_scale=True, mlp_activation="gelu_tanh", post_norms=True,
                                 attn_softcap=50.0, final_softcap=30.0,
                                 query_pre_attn_scalar=32.0, layer_windows=(8, None, 8, None),
                                 tie_embeddings=True)
    ids = torch.randint(0, 512, (2, 40), generator=torch.Generator().manual_seed(6))
    cpu, card_model = small_card_cpu(torch, port, port.CausalLM, cfg, {"input_ids": ids}, rep,
                                     "gemma-2 tiny")
    with torch.no_grad():
        logit_err = rel_err(torch, card_model(ids.to(CARD)).cpu(), cpu(ids))
    want = generate(cpu, ids[:, :12], max_new_tokens=16)
    got = generate(card_model, ids[:, :12].to(CARD), max_new_tokens=16).cpu()
    prompts = [ids[0, :n].tolist() for n in (5, 17, 9, 30, 3, 12)]
    outs = []
    for model in (cpu, card_model):
        engine = ServingEngine(model, max_slots=4, block_size=16)
        rids = [engine.add_request(p, max_new_tokens=12, temperature=0.0) for p in prompts]
        while engine.has_work:
            engine.step()
        outs.append(([engine.result(r) for r in rids], engine.trace_counts()["decode"]))
    rep.line(f"gemma-2 tiny: logits rel err {logit_err}; greedy generate card equals CPU "
             f"{torch.equal(got, want)}; a 4-slot engine's tokens card equal CPU "
             f"{outs[0][0] == outs[1][0]}, decode builds {outs[1][1]}")
    if not (logit_err <= SMALL_TOL and torch.equal(got, want) and outs[0][0] == outs[1][0]
            and outs[1][1] == 1):
        fail("gemma-2 tiny: the card disagrees with the CPU")


def zoo_bwd_fused_row(torch, fa, rep: Report, B, S, H, Hkv, D) -> dict:
    """B4 timed at Gemma-2B's attention (0 launches on the path: FUSED_BWD
    off), beside its plain version and PyTorch's flash backward op."""
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, torch.bfloat16, seed=5)
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = fa.attention_delta(out, dout)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    ms = time_ms(torch, lambda: fa.flash_bwd_fused(q, k, v, dout, lse, delta, scale, True), 20,
                 flush)
    plain_ms = time_ms(torch, lambda: fa.flash_bwd_fused_reference(q, k, v, dout, lse, delta,
                                                                   scale, True), 2, flush)
    library = time_library_bwd(torch, q, k, v, dout, scale, flush, rep, "Gemma-2B's shape")
    got = fa.flash_bwd_fused(q, k, v, dout, lse, delta, scale, True)
    want = fa.flash_bwd_fused_reference(q, k, v, dout, lse, delta, scale, True)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    pairs = visible_pairs(torch, S, S, True) * B * H
    e = q.element_size()
    qo, kv, stat = B * S * H * D * e, B * S * Hkv * D * e, B * H * S * 4
    row = kernel_row("flash_bwd_fused", fa.kernel_design(torch.bfloat16, D), ms, plain_ms,
                     5 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo + 2 * kv,
                     PEAK_BF16_FLOPS, err, library)
    row["shape"] = f"gemma-2b B{B} S{S} H{H} Hkv{Hkv} D{D} bf16 causal"
    row["launches"] = 0
    rep.line(f"flash_bwd_fused_kernel at Gemma-2B's shape: {ms:.4f} ms (plain {plain_ms:.4f} ms,"
             f" bound {row['bound_ms']:.4f} ms by {row['bound_by']}), flash bwd op {library:.4f}"
             f" ms, max abs err {err}")
    del q, k, v, dout, out, lse, delta, scratch, got, want
    torch.cuda.empty_cache()
    return row


def phase22(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 22 (``--zoo-only``): (a)-(e) above, then B1-B4 timed at
    Gemma-2B's attention and B1-B3 at GPT-2's and T5's for their rows."""
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused

    t0 = time.perf_counter()
    zoo_kernel_cases(torch, fa, fused, _build, rep)
    t1 = time.perf_counter()
    gemma = gemma_path(torch, port, wrappers, rep)
    t2 = time.perf_counter()
    gpt2 = gpt2_path(torch, port, wrappers, rep)
    t3 = time.perf_counter()
    t5 = t5_path(torch, port, wrappers, rep)
    t4 = time.perf_counter()
    gemma2_tiny(torch, port, rep)
    t5_ = time.perf_counter()
    rows = []
    for label, shape, launches in (
            ("gemma-2b", (1, 2048, 8, 1, 256), gemma), ("gpt2", (8, 1024, 12, 12, 64), gpt2),
            ("t5_base", (8, 512, 12, 12, 64), t5)):
        got = time_flash_shape(torch, fa, rep, label, *shape, bwd_library_on_dq=True)
        for row in got:
            row["launches"] = launches[WRAPPER_OF[row["name"]]]
        rows += got
    rows.append(zoo_bwd_fused_row(torch, fa, rep, 1, 2048, 8, 1, 256))
    rep.line(f"phase 22: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, "
             f"(d) {t4 - t3:.1f} s, (e) {t5_ - t4:.1f} s, kernel rows "
             f"{time.perf_counter() - t5_:.1f} s, in all {time.perf_counter() - t0:.1f} s")
    return rows


def a8_prologue_cases(torch, fused, rep: Report) -> dict:
    """Phase 23 (a): A8_PROLOGUE_CASES through ``check_prologue_case`` (row
    by row at the prologue TOL, counted under ``prologue_kernel_design``'s
    design, repeated bit for bit into guarded outputs), then B5 timed at
    bert_base's prologue shape (rows 16384, E 768, 12/12 x 64, bf16) beside
    its plain version and ``F.linear`` of x with the concatenated q/k/v
    weight. Returns the kernel row."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    for name, kw in A8_PROLOGUE_CASES:
        reading, err = check_prologue_case(torch, fused, name, **kw, dtype=bf16)
        rep.line(json.dumps(reading))
        if reading["bad"]:
            fail(f"prologue {name}: {reading['bad']}")
        if name == "bert_mha":
            bert_err = err
    kw = dict(A8_PROLOGUE_CASES[0][1])
    args, statics = prologue_inputs(torch, fused, **kw, dtype=bf16, seed=2)
    x, wq, wk, wv = args[0], args[2], args[3], args[4]
    rows, E = kw["B"] * kw["S"], kw["E"]
    x2, wcat = x.reshape(rows, E), torch.cat([wq, wk, wv])
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: fused.qkv_prologue(*args, **statics), 20, scratch.zero_)
    plain_ms = time_ms(torch, lambda: fused._prologue_reference_tables(*args, **statics), 5,
                       scratch.zero_)
    library_ms = time_ms(torch, lambda: F.linear(x2, wcat), 20, scratch.zero_)
    W, e = wcat.shape[0], 2
    work = (2 * rows * E * W, rows * E * e + W * E * e + E * 4 + 2 * rows * kw["D"] * 4
            + rows * W * e)
    design = fused.prologue_kernel_design(bf16, kw["H"], kw["Hkv"], kw["D"], E)
    row = kernel_row("qkv_prologue", design, ms, plain_ms, *work, PEAK_BF16_FLOPS, bert_err,
                     library_ms)
    row["shape"] = f"bert_base prologue B{kw['B']} S{kw['S']} E{E} H{kw['H']} Hkv{kw['Hkv']} bf16"
    rep.line(f"qkv_prologue_kernel at bert_base's shape ({design}): {ms:.4f} ms (plain "
             f"{plain_ms:.4f} ms, F.linear of x with the q/k/v weight {library_ms:.4f} ms, bound "
             f"{row['bound_ms']:.4f} ms by {row['bound_by']}), max abs err {bert_err}")
    del args, x2, wcat, scratch
    torch.cuda.empty_cache()
    return row


def a8_bert_run(torch, port, wrappers, rep: Report, fused_kernels: bool) -> dict:
    """bert_base (``bert_trainer``, seed 0) for BERT["steps"] unified_steps
    and, fused, the eval pass, every launch counter set to 0 just before and
    read just after; then one profiled step. Returns the readings."""
    name = "a8 bert fused" if fused_kernels else "a8 bert unfused"
    acc, model, opt, train, evals, step, carry = bert_trainer(torch, port, seed=0,
                                                              fused_kernels=fused_kernels)
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, losses, times, _, last, norms = train_bert(torch, step, carry, train, BERT["steps"])
    peak = torch.cuda.max_memory_allocated()
    n_eval = 0
    if fused_kernels:
        with torch.no_grad():
            for batch in evals:
                model(batch["input_ids"], batch["attention_mask"])
                n_eval += 1
        torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    steady = statistics.median(times[1:])
    rep.line(f"{name}: losses {losses}, grad norms {norms}; step seconds {times}, median of "
             f"steps 2-{BERT['steps']} {steady} s; peak memory {peak / 2**30} GiB; launches "
             f"{json.dumps(launches)}, by design {json.dumps(by_design)}")
    if not all(math.isfinite(v) for v in losses + norms):
        fail(f"{name}: a loss or grad norm is not finite: {losses}, {norms}")
    out = {"losses": losses, "norms": norms, "step_s": steady, "peak": peak,
           "launches": launches, "by_design": by_design, "n_eval": n_eval,
           "layers": model.config.num_layers, "busy": None}
    out["ran"] = profile_step(torch, step, carry, last, rep, name, out)
    del acc, model, opt, train, evals, step, carry
    gc.collect()
    torch.cuda.empty_cache()
    return out


def a8_bert_fused(torch, port, wrappers, rep: Report, unfused: dict | None) -> dict:
    """Phase 23 (b): the unfused and the fused bert_base runs from the same
    weights and batches. The fused run's launches exactly: B5 once a layer a
    forward (steps and eval), B1 the same, B2 and B3 once a layer a step,
    every one on the wgmma design; step 1's loss and grad norm within
    A8_LOSS_TOL / A8_GNORM_TOL of the unfused run's; step time, busy share
    and peak side by side. ``unfused``: phase 7's readings in the whole
    script (``bert_phase``: the same seed, data and steps, its losses read
    equal); None (``--a8-only``) runs the unfused run here. Returns the
    fused run's launch counts."""
    if unfused is not None:
        plain = unfused
        rep.line("a8 bert unfused: phase 7's run (bert_phase) is the baseline")
    else:
        plain = a8_bert_run(torch, port, wrappers, rep, fused_kernels=False)
    fused_run = a8_bert_run(torch, port, wrappers, rep, fused_kernels=True)
    L, steps, n_eval = fused_run["layers"], BERT["steps"], fused_run["n_eval"]
    fwd = L * (steps + n_eval)
    want = {"flash_fwd": fwd, "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
            "flash_bwd_fused": 0, "qkv_prologue": fwd, "adamw_epilogue": 0}
    if fused_run["launches"] != want:
        fail(f"a8 bert fused: launches {fused_run['launches']}, want {want}")
    want_design = {w: {"wgmma": want[w], "wmma": 0} for w in fused_run["by_design"]}
    if fused_run["by_design"] != want_design:
        fail(f"a8 bert fused: launches by design {fused_run['by_design']}, want {want_design}")
    want_ran = {KERNELS[w][0] for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    want_ran |= {"qkv_prologue_rstd_kernel", "qkv_prologue_kernel"}
    if fused_run["ran"] is not None and fused_run["ran"] != want_ran:
        fail(f"a8 bert fused: the profiled step ran {sorted(fused_run['ran'])}, want "
             f"{sorted(want_ran)}")
    loss_gap = abs(fused_run["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
    norm_gap = abs(fused_run["norms"][0] - plain["norms"][0]) / abs(plain["norms"][0])
    rep.line(f"a8 bert: step 1 fused against unfused: loss {fused_run['losses'][0]} vs "
             f"{plain['losses'][0]} (relative {loss_gap}, limit {A8_LOSS_TOL}), grad norm "
             f"{fused_run['norms'][0]} vs {plain['norms'][0]} (relative {norm_gap}, limit "
             f"{A8_GNORM_TOL}); median step {fused_run['step_s']} vs {plain['step_s']} s; busy "
             f"share {fused_run['busy']} vs {plain['busy']}; "
             f"peak {fused_run['peak'] / 2**30} vs {plain['peak'] / 2**30} GiB")
    if not (loss_gap <= A8_LOSS_TOL and norm_gap <= A8_GNORM_TOL):
        fail(f"a8 bert: step 1 of the fused classifier is off the unfused one: loss "
             f"{loss_gap}, grad norm {norm_gap}")
    return fused_run["launches"]


def a8_examples(torch, port, wrappers, rep: Report) -> None:
    """Phase 23 (c): the port's ``cv_example`` (8192 shapes, 1 epoch, lr
    3e-3, B 32), ``seq2seq_example`` (256 wide, 2048 rows, 14 epochs, lr
    1e-3, bf16) and ``schedule_free`` (bert_base, bf16, one epoch over
    1/A8_ROWS_CUT of its rows) on the card, each at least its reference
    test's bound (A8_EXAMPLES), with its seconds. None of them reaches a
    port kernel (S 128, S 12 and convolutions)."""
    import argparse

    from accelerate_tpu_torch.examples import cv_example, nlp_example, schedule_free
    from accelerate_tpu_torch.examples import seq2seq_example

    runs = (
        (cv_example, {"lr": 3e-3, "num_epochs": 1, "seed": 42, "batch_size": 32}, None),
        (seq2seq_example, {"lr": 1e-3, "num_epochs": 14, "seed": 42, "batch_size": 32}, "bf16"),
        (schedule_free, {"lr": 2e-4, "num_epochs": 1, "seed": 42, "batch_size": 16}, "bf16"),
    )
    make_dataset = nlp_example.make_paraphrase_dataset
    nlp_example.make_paraphrase_dataset = (  # train and eval sets alike
        lambda n, **kw: make_dataset(n // A8_ROWS_CUT, **kw))
    try:
        for module, config, precision in runs:
            name = module.__name__.rsplit(".", 1)[-1]
            gc.collect()
            torch.cuda.empty_cache()
            port.AcceleratorState._reset_state(reset_partial_state=True)
            port.GradientState._reset_state()
            reset_counts(wrappers)
            t0 = time.perf_counter()
            metric = module.training_function(
                config, argparse.Namespace(cpu=False, mixed_precision=precision))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {w.__name__: w.launches for w in wrappers}
            rep.line(f"a8 example {name} ({json.dumps(config)}, mixed_precision {precision}): "
                     f"{metric}, {seconds} s; launches {json.dumps(launches)}")
            if not metric["accuracy"] >= A8_EXAMPLES[name]:
                fail(f"a8 example {name}: accuracy {metric['accuracy']} under its bound "
                     f"{A8_EXAMPLES[name]}")
            if any(launches.values()):
                fail(f"a8 example {name} launched the port's kernels: {launches}")
    finally:
        nlp_example.make_paraphrase_dataset = make_dataset


def a8_grad_dtype(torch, port, wrappers, rep: Report) -> None:
    """Phase 23 (d): ``grad_dtype=bfloat16`` at accum's config (small, B 4,
    S 512, K 8), unfused and fused, against the fp32 buffer, A8_ACCUM_STEPS
    optimizer steps each from one init and batch: the carried buffer is bf16
    at half the bytes, the peaks are read, and the last optimizer step's
    losses stay within A8_GRAD_DTYPE_LOSS_TOL of the fp32 run's without all
    equalling them (a bf16 run that ignored ``grad_dtype`` would)."""
    runs = {}
    for fused in (False, True):
        for grad_dtype in (None, torch.bfloat16):
            policy = port.MixedPrecisionPolicy(compute_dtype=torch.bfloat16, grad_dtype=grad_dtype)
            acc, step, carry, batch, calls, _ = accum_trainer(torch, port, fused, policy=policy)
            buffer = carry.get("accum_grads")
            buf = (None if buffer is None else
                   (sorted({str(t.dtype) for t in buffer.values()}),
                    sum(t.numel() * t.element_size() for t in buffer.values())))
            torch.cuda.reset_peak_memory_stats()
            carry, losses, times = accum_steps(torch, step, carry, batch, calls, A8_ACCUM_STEPS)
            key = ("fused" if fused else "unfused", "bf16" if grad_dtype else "fp32")
            runs[key] = {"losses": losses, "peak": torch.cuda.max_memory_allocated(),
                         "buffer": buf, "times": times}
            rep.line(f"a8 grad_dtype {key}: losses {losses}; optimizer-step seconds {times}; "
                     f"peak {runs[key]['peak'] / 2**30} GiB; carried buffer {buf}")
            if not all(math.isfinite(v) for v in losses):
                fail(f"a8 grad_dtype {key}: a loss is not finite")
            del acc, step, carry, batch
    K = ACCUM["K"]
    for mode in ("unfused", "fused"):
        low, full = runs[(mode, "bf16")], runs[(mode, "fp32")]
        gap = max(abs(a - b) / abs(b) for a, b in zip(low["losses"][-K:], full["losses"][-K:]))
        rep.line(f"a8 grad_dtype {mode}: last optimizer step's losses bf16 against fp32 buffer, "
                 f"largest relative difference {gap} (limit {A8_GRAD_DTYPE_LOSS_TOL}); peak "
                 f"{low['peak'] / 2**30} vs {full['peak'] / 2**30} GiB")
        if not gap <= A8_GRAD_DTYPE_LOSS_TOL:
            fail(f"a8 grad_dtype {mode}: losses {gap} off the fp32 buffer's")
        if low["losses"] == full["losses"]:  # grad_dtype reached the step
            fail(f"a8 grad_dtype {mode}: the bf16 run's losses equal the fp32 buffer's")
    low, full = runs[("unfused", "bf16")]["buffer"], runs[("unfused", "fp32")]["buffer"]
    if low[0] != ["torch.bfloat16"] or full[0] != ["torch.float32"] or 2 * low[1] != full[1]:
        fail(f"a8 grad_dtype: the unfused carried buffer is {low}, the fp32 one {full}")
    if runs[("fused", "bf16")]["buffer"] is not None:
        fail("a8 grad_dtype: the fused carry holds a buffer")


def phase23(torch, port, wrappers, rep: Report, bert_unfused: dict | None = None
            ) -> list[dict]:
    """Phase 23 (``--a8-only``): (a)-(d) above, (b) against
    ``bert_unfused`` (phase 7's readings) when given. Returns B5's row at
    bert_base's shape, its launches those of (b)'s fused run."""
    from accelerate_tpu_torch.ops import fused

    t0 = time.perf_counter()
    row = a8_prologue_cases(torch, fused, rep)
    t1 = time.perf_counter()
    launches = a8_bert_fused(torch, port, wrappers, rep, bert_unfused)
    row["launches"] = launches["qkv_prologue"]
    t2 = time.perf_counter()
    a8_examples(torch, port, wrappers, rep)
    t3 = time.perf_counter()
    a8_grad_dtype(torch, port, wrappers, rep)
    t4 = time.perf_counter()
    rep.line(f"phase 23: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, "
             f"(d) {t4 - t3:.1f} s, in all {t4 - t0:.1f} s")
    return [row]


def main() -> None:
    script_t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    try:
        import accelerate_tpu_torch as port
        from accelerate_tpu_torch.ops import _build
        from accelerate_tpu_torch.ops import flash_attention as fa
        from accelerate_tpu_torch.ops import fused
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = Report(card())
    rep.line(f"torch {torch.__version__} cuda {torch.version.cuda} device "
             f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    wrappers = (*fa.KERNEL_WRAPPERS, *fused.KERNEL_WRAPPERS)
    for flag, phase in (("--serve-only", serve_phase), ("--soak-only", soak_phase),
                        ("--fleet-only", fleet_phase)):
        if flag in sys.argv[1:]:
            phase(torch, port, wrappers, rep, build_decode_model(torch, port, rep))
            rep.line(f"{flag[2:]}: the {phase.__name__.split('_')[0]} phase passed")
            print(rep.card)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            }}))
            return

    t0 = time.perf_counter()
    sources = ["flash_attention", "fused"]
    seconds = _build.build(sources)
    rep.line(f"build: {json.dumps(seconds)} s per source, {time.perf_counter() - t0:.2f} s in all")
    for source in sources:
        for line in _build.BUILD_LOGS.get(source, "").splitlines():
            if any(t in line for t in ("registers", "spill", "Compiling entry", "Performance")):
                rep.line(f"ptxas {source}: {line.strip()}")

    def small_models():
        small_model_phase(torch, port, rep)
        for seed in SMALL_SEEDS:
            small_fused_phase(torch, port, fa, fused, rep, seed)

    if "--small-only" in sys.argv[1:]:
        small_models()
        rep.line("small-only: the small models on the card agree with the CPU")
        return
    if "--variants-only" in sys.argv[1:]:
        rows = variant_phases(torch, port, wrappers, rep)[0]
        print(json.dumps({"kernels": rows}))
        rep.line("variants-only: the moe, dense/fp8 and longseq phases passed")
        return
    if "--accum-only" in sys.argv[1:]:
        rows = phase13(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("accum-only: the accum, longseq pair, longseq_xla and oom phases passed")
        return
    if "--ckpt-only" in sys.argv[1:]:
        rows = phase14(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("ckpt-only: the ckpt phase passed")
        return
    if "--diag-only" in sys.argv[1:]:
        rows = phase15(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("diag-only: the diagnostics phase passed")
        return
    if "--load-only" in sys.argv[1:]:
        rows = phase18(torch, port, wrappers, rep, build_decode_model(torch, port, rep))
        print(json.dumps({"kernels": rows}))
        rep.line("load-only: the decode_load phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if "--launch-only" in sys.argv[1:]:
        rows = phase19(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("launch-only: the processes-and-data phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if "--shard-only" in sys.argv[1:]:
        rows = phase20(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("shard-only: the sharding phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if "--pipe-only" in sys.argv[1:]:
        rows = phase21(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("pipe-only: the pipelines phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if "--zoo-only" in sys.argv[1:]:
        rows = phase22(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("zoo-only: the model zoo phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if "--a8-only" in sys.argv[1:]:
        rows = phase23(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("a8-only: the A8 remainder phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if "--lora-only" in sys.argv[1:]:
        rows = phase17(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("lora-only: the lora phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return
    if "--bert-only" in sys.argv[1:]:
        failed = run_cases(torch, fa, bert_cases(torch), rep)[0]
        if failed:
            fail(f"kernel outputs beyond tolerance: {'; '.join(failed)}")
        rows = time_bert_kernels(torch, fa, rep)
        bert_launches, _ = bert_phase(torch, port, wrappers, rep)
        example_phase(torch, port, wrappers, rep)
        for row in rows:
            row["launches"] = bert_launches[WRAPPER_OF[row["name"]]]
        print(json.dumps({"kernels": rows}))
        rep.line("bert-only: the BERT kernel cases, the BERT phase and the example passed")
        return
    rows = kernel_phase(torch, port, fa, fused, _build, rep,
                        check_only="--check-only" in sys.argv[1:])
    if not rows:
        rep.line("check-only: every kernel case within tolerance")
        return
    bert_rows_ = time_bert_kernels(torch, fa, rep)
    small_models()
    launches, losses = main_path_phase(torch, port, wrappers, rep)
    fa.FUSED_BWD = True  # the reference's switch, on for the fused path
    try:
        fused_launches, fused_losses = main_path_phase(torch, port, wrappers, rep,
                                                       fused_path=True)
    finally:
        fa.FUSED_BWD = False
    check_path_losses(losses, fused_losses, rep)
    bert_launches, bert_unfused = bert_phase(torch, port, wrappers, rep)
    example_phase(torch, port, wrappers, rep)
    model = build_decode_model(torch, port, rep)
    serve_phase(torch, port, wrappers, rep, model)
    soak_phase(torch, port, wrappers, rep, model)
    fleet_phase(torch, port, wrappers, rep, model)
    load_rows = phase18(torch, port, wrappers, rep, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    variant_rows, flash_8k_s = variant_phases(torch, port, wrappers, rep)
    variant_rows += phase13(torch, port, wrappers, rep, flash_8k_s)
    variant_rows += phase14(torch, port, wrappers, rep)
    variant_rows += phase15(torch, port, wrappers, rep)
    variant_rows += phase17(torch, port, wrappers, rep)
    variant_rows += load_rows
    variant_rows += phase19(torch, port, wrappers, rep)
    variant_rows += phase20(torch, port, wrappers, rep)
    variant_rows += phase21(torch, port, wrappers, rep)
    variant_rows += phase22(torch, port, wrappers, rep)
    variant_rows += phase23(torch, port, wrappers, rep, bert_unfused)
    runs_on_fused_path = ("flash_bwd_fused", "qkv_prologue", "adamw_epilogue")
    for row in rows:
        wrapper = WRAPPER_OF[row["name"]]
        row["shape"] = "llama3_8b main shape" if wrapper != "adamw_epilogue" else "main path leaves"
        row["launches"] = (fused_launches if wrapper in runs_on_fused_path else launches)[wrapper]
    for row in bert_rows_:
        row["launches"] = bert_launches[WRAPPER_OF[row["name"]]]

    rep.line(f"whole script: {time.perf_counter() - script_t0} s")
    print(json.dumps({"kernels": rows + bert_rows_ + variant_rows}))
    print(rep.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
