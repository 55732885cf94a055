#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right, trains
(paper-350m and the model zoo) and serves (the dense, MoE and recurrent
families, the encoder-decoder and the VLM; every family also on a
("data", "model") mesh, across four cards where there are four, and
checkpoints and resumes on a mesh; P pods of such meshes, and a two-tier
fleet of them, train and checkpoint), and that its dry run counts what
the card runs.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 17b,18b,19b,20b,21b,22b   # four cards

The processes it starts (pods, mesh ranks, one process per model) fork
from ``launch/mesh.py``'s start server, which imports torch and the port
once; the server reads their bytecode from ``build/pycache``, which the
first run writes.

Phases (any failure exits nonzero before the result lines):

1. card check: a CUDA device, and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each gather + EF encode kernel (K1-K4) against its plain PyTorch
   version on the card, bit for bit: the reference's ``_gather_case``
   inputs (a denormal row, an all-zero row, the zero pad row, perm lengths
   1-23, gamma 1.0 / 0.9 / 0.6) and a perm over every block of
   paper-350m (NB = 443,697 rows of 1024 f32), the top-k kernel at every
   k the ladder's top-k rungs use; time kernel and plain version on that
   perm with CUDA events;
4. agreement on a small input: one SMOKE-model ``grad_sync`` step under
   a plan with a group on every rung on the card (kernels) and on the
   CPU (plain versions) from the same weights and batch, for paper-350m
   (bf16), qwen3-moe-30b-a3b and gemma2-9b (f32) at 64 positions,
   falcon-mamba-7b and recurrentgemma-2b (f32) at 512 (the scans'
   backward over two chunks), and seamless-m4t-medium and
   llava-next-mistral-7b (bf16) at 64, fed the pipeline's seeded
   non-zero frames / patch embeddings: the losses within 2e-2 relative, the
   updated weights within 1e-3, and for the MoE the top-k sets of every
   dispatch (forward and the backward's recompute) equal;
5. the main path: paper-350m at full width (24 layers, d 1024, vocab
   50,304, seq 1024, batch 8) under ``acesync`` with ``replan_every=4``
   through ``TrainSession`` for 8 steps (two ``delta_sync`` rounds, one
   device replan), then one ``grad_sync`` step under a plan that puts the
   11 parameter groups round-robin on all 8 ladder rungs.  Every kernel's
   launch count is reset just before and read just after; each of K1-K4
   must have launched, and every loss must be finite;
6. hold each decode-accumulate kernel (K5-K11) against its plain version
   on the card, bit for bit: small cases (omega 0.37 / 0 / 1, denormal,
   zero and -0 accumulator entries, a zero and a denormal scale,
   fixed_bits 16 and a width where the clip saturates, top-k at every k
   of the ladder) and one call over all 443,697 rows of paper-350m, which
   is timed;
6b. hold each flat encoder and the int8 dequantiser (K12-K16) against its
   plain version on the card, bit for bit: row counts 1-23 with a
   denormal row, an all-zero row and -0 entries, gamma 1.0 / 0.9 / 0.6,
   top-k at every k of the ladder, and one call over all 443,697 rows,
   which is timed, and K16 also against its single-call library
   counterpart ``torch.mul(q, s)``, which is timed too;
7. the multi-pod main path: P pods as processes sharing the card (the
   pod group is gloo, staged through pinned host memory), paper-350m at
   full width under ``acesync`` with the default ``ACESyncConfig`` (the
   chunked ring on every rung the roofline grid of
   ``repro_torch.core.planexec`` rings, the one-shot exchange elsewhere)
   and ``replan_every=4``: P = 2 with global batch 8 for 8 steps at 12
   layers, P = 3 with global batch 6 for 4 steps at 8 layers (24 and 16
   until phase 19 joined the script; a run that does not fit fails),
   each then one all-rungs ``grad_sync`` whose payload rungs ring
   in 2 chunks and, in the same pod processes, one all-rungs
   ``sync_tree`` round on the same gradients
   under three exec plans: one-shot, the ring forced to 2 chunks, and the
   roofline's own grid.  At P = 2 the pods first measure their link (the
   ping-pong of ``repro_torch.launch.linkbench``).  The parameters after
   every ``delta_sync`` and the all-rungs aggregate must be bit-identical
   on every pod; the three plans' aggregates bit-identical to each other
   and on every pod, their residuals to each other; the bytes moved
   (gather + ring) equal to ``plan_wire_bytes`` of the gather rungs in
   every sync step and round; the ring hops posted equal to what the
   chunk grids ask for; the losses finite; and K1-K4, K12-K15, K5-K8
   (P = 2) and K8-K11 (P = 3) must have launched (launches of all pods,
   over the whole path).  FULL's bytes (a reduce-scatter and an
   all-gather) must equal ``FullCodec.wire_bytes`` within the shard
   padding.  Per step kind: step times, the transport's host time, peak
   memory per pod.  Pods that share one card time-share it: these are
   not a deployment's step times;
8. the two-tier path: a fleet of C = 2 clusters x E = 2 members, four
   pod processes sharing the card (``spawn_pods(..., n_edge=2)``: the
   ``intra`` and ``cross`` sub-groups), paper-350m at full width at 6
   layers (``PATHS["hier"]``; 12 until phase 19 joined the script, four
   members at 16 do not fit, and a run that does not fit fails), global
   batch 8, under ``acesync_hier``
   with ``replan_every=4``: 6 steps (one ``delta_sync``, one device
   replan), one all-rungs ``grad_sync`` with the bf16 intra stage and one
   with the INT8 intra stage and the cross tier forced to a 2-chunk ring,
   then one all-rungs ``sync_tree`` round under the two-tier plan with
   the cross tier one-shot and forced to the ring, and the flat plan.
   The members' parameters after every ``delta_sync`` and their
   all-rungs aggregates must be bit-identical; the ring's aggregate and
   residuals the one-shot's; the bytes of every sync per tier equal to
   the priced ones (``plan_wire_bytes(..., n_cross=2)`` of the cross
   tier's payload rungs exactly, FULL within its shard padding,
   ``plan_intra_bytes``); the two-tier round's cross-tier bytes below the
   flat round's; and K5, K6, K12, K13, K3 / K11 and K4 / K8 must have
   launched.  Prints the tier grids, the bytes per tier, the cross-tier
   reduction, step means and peak memory per member;
9. the fault-tolerant train loop.  9a, restart-replay on one pod in phase
   5's configuration cut to 2 layers (paper-350m, batch 8, seq 1024,
   ``replan_every`` 4, ``ckpt_every`` 4, ``blocking_replans``, in a
   process of its own under ``RunConfig.deterministic``, so that no
   other phase runs under deterministic algorithms and cuBLAS): run A
   trains 10 steps; run B trains 9 in a fresh directory, leaves a
   crashed writer's ``step_….tmp`` and
   bit-rots the newest checkpoint's largest leaf; a fresh TrainSession
   must restore step 4, record 8 as corrupt and train to step 10 with
   params, moments, anchor and EF residuals, the plan, H and the loop
   counters bit-identical to run A's.  Prints the bytes per checkpoint,
   save()'s foreground seconds, the background write's seconds and
   rate, and the restore's seconds.  9b, elastic membership: three pod
   processes sharing the card at 2 layers (6 until phase 19 joined the
   script, 4 until phase 23 did), global batch 6, the default
   ``ACESyncConfig`` with ``replan_every`` 4, ``ckpt_every`` 5, 12
   steps, pod 2 preempted at step 4 and back at step 8: the membership
   events [2, 3] at steps 4 and 8, the global batch 6 -> 4 -> 6, right
   after the rejoin every state leaf of the rejoining pod bit-identical
   to pod 0's, after every ``delta_sync`` the parameters bit-identical
   on every live pod and the bytes moved equal to ``plan_wire_bytes`` at
   that pod count, omega and the plan identical on every live pod,
   finite losses; then pods 0 and 1 restore the step-10 checkpoint
   (three pods' rows) as a P = 2 fleet and must read back the rows they
   wrote.  Prints the seconds from each membership event to the end of
   the first step at the new pod count.  Phases 7, 8 and 9b print each
   pod's host time in the loop's heartbeat exchanges.  The checkpoints
   go to ``build/chip_smoke_ckpt`` (free space printed first), removed
   at the end;
10. serving the dense zoo, in a process of its own: paper-350m (24
   layers), qwen3-8b (36) and gemma2-9b (42) at their full published
   widths and depths, seeded random weights held in bf16, each served
   by ``repro_torch.launch.serve.Server``: (a) one server batch of four
   requests, prompts of 512 / 384 / 200 / 512 tokens (left-padded to
   512) from ``np.random.RandomState(0)``, 32 new tokens each; (b)
   gemma2-9b only, one 6,144-token prompt (past its 4,096 window: the
   local ring wraps in prefill and again in decode), 16 new tokens.
   Each workload runs twice, the first run cold.  Gates: (1) every
   request gets its token budget and every logit is finite; (2) for (b)
   and paper-350m's longest request, 16 teacher-forced decode steps
   against ``lm_logits`` of one full forward at those positions within
   the reference test's rtol = atol = 0.15 (the largest difference and
   the share of positions whose argmax agrees printed); (3) the three
   SMOKE configs served on the card and on the CPU from the same
   weights: f32 logits within 1e-4 relative and equal tokens, bf16
   prefill logits within 3e-2; (4) K1-K16 launch 0 times.  Prints per
   model and workload the bf16 weight bytes, prefill ms (CUDA events)
   and its share of 989 TFLOP/s at 2 * N * tokens, the decode step's
   median / min / max ms against its bound ((weight + KV bytes) / 3.35
   TB/s), generated tokens/s and peak allocated / reserved memory;
11. serving the MoE family, in a process of its own:
   qwen3-moe-30b-a3b at full published width and depth (48 layers, 128
   experts top-8) and dbrx-132b at full width cut to 8 of its 40 layers
   (16 experts top-4; 262 GB of bf16 weights at 40 layers: one card
   holds 8, phase 17 serves all 40 across four), seeded bf16 weights drawn
   slice by slice, each served twice (the first cold) on phase 10's
   workload (a).  Gates: (1) every request gets its token budget and
   every logit is finite; (2) qwen3-moe: 16 teacher-forced decode steps
   after the 512-token prompt against one forward over 528 tokens
   within rtol = atol = 0.15, at capacity factor E / K (C >= T in every
   call, so nothing drops on either side), restored after.  The top-k
   is discontinuous and a bf16 near-tie that decode and forward round
   apart swaps an expert, so the forward is routed as the prefill and
   the decode steps routed, and their router logits must agree within
   3e-2 of their largest; the forward on its own routes is compared
   too and printed (the share of (token, layer) top-k sets that agree,
   where they first part and the margin there), and so is the same
   check in f32 compute; (3) both MoE SMOKE configs card against CPU
   as in phase 10, the card's bf16 prefill routed as the CPU's (router
   logits within 3e-2); (4) K1-K16 launch 0 times.  Prints phase 10's line per model, then
   the prefill's capacity and share of (token, k) pairs dropped (pads
   included, from one untimed prefill), its executed capacity FLOPs
   (every expert over its C rows) beside 2 * N_active * tokens, the
   experts each layer routes to in one untimed decode step, and two
   decode bounds: all weights + caches (what the capacity arithmetic
   reads) and routed (the weights that are not experts, the experts
   routed to, the caches) at 3.35 TB/s.

12. training the zoo, one process per model: qwen3-moe-30b-a3b,
   gemma2-9b and qwen3-8b at their full published widths, cut in depth
   (``TRAIN_ZOO``) to what the card holds with 8 GiB to spare at the
   train step's measured bytes per parameter (``ZOO_BYTES_PER_PARAM``,
   from ``python -m repro_torch.launch.memory``; reckoned before
   anything is built, and a depth that does not fit fails), seeded
   weights, seq 1024, batch 8, each through ``TrainSession`` under
   ``acesync`` with ``replan_every=4`` for 8 steps (two ``delta_sync``
   rounds, one device replan), then one ``grad_sync`` with a group on
   every rung; then qwen3-moe at 1 layer (its phase-12 depth of 2 until
   phase 22 joined the script) twice more under
   ``RunConfig.deterministic`` (a process of its own), 3 steps ending in
   a ``delta_sync``.  Gates: (1) every loss finite; (2) K1-K4 launched on
   every model's path; (3) the two deterministic runs' parameter hashes
   equal; (5) the peak allocated memory leaves 8 GiB free (gate 4 is
   phase 4's).  Prints per model the layers, parameters (total and
   active), train-state bytes, init seconds, ms per step kind (CUDA
   events: median of the steady steps, min and max), tokens/s and MFU
   at 6 * N_active * tokens of 989 TFLOP/s, N_active counted on the
   tree (``LanguageModel.active_param_count``; MoE: also the executed
   capacity FLOPs, 3x the forward's every expert at C, and the share of
   (token, k) pairs one untimed training forward drops), K1-K4's
   launches and peak memory allocated and reserved.
13. serving the recurrent families, in a process of its own:
   falcon-mamba-7b (64 mamba layers, d 4096, d_inner 8192, state 16) and
   recurrentgemma-2b (26 layers: 8 (rec, rec, local attn) groups and 2
   rec layers, d 2560, window 2048) at full published width and depth,
   seeded bf16 weights drawn slice by slice, each served by ``Server``
   on phase 10's workload (a) and on (b): one 4,096-token prompt, batch
   1, 16 new tokens (recurrentgemma's ring wraps in prefill and again in
   decode); each workload twice, the first cold.  Gates: (1) every
   request gets its token budget and every logit is finite; (2) in f32
   compute (the bf16 weights cast at use), 16 teacher-forced decode
   steps after (a)'s 512-token request and after (b) against one forward
   within rtol = atol = 0.15 — the forward runs over the next multiple
   of 256 (the scan's chunk rule refuses 528 and 4,112 tokens), its
   extra tail tokens from the seed, compared at the 16 decoded positions
   only.  The same check in bf16 compute is printed beside its control,
   a forward 256 tokens longer at the same positions: with 64 layers of
   random weights the bf16 forward differs from itself across lengths
   (the matmuls' shapes change their rounding) by more than the
   tolerance, so bf16 cannot hold the gate; (3) both SMOKE configs card
   against CPU as in phase 10; (4) K1-K16 launch 0 times; (5)
   falcon-mamba's peak allocation above its weights during (b)'s
   prefill stays below one f32 (1, 4096, 8192, 16) tensor (the scan
   holds one 256-position chunk at a time); (6) a 300-token prompt is
   refused with a ``ValueError`` naming its length, before any decode
   step.  Prints phase 10's line per model and workload (the decode
   bound counts the recurrent states read and written), and the
   recurrent-state and ring bytes per sequence beside qwen3-8b's KV
   bytes at the same length.
14. training the recurrent families, one process per model:
   falcon-mamba-7b and recurrentgemma-2b at their full published widths,
   at 6 and 5 layers (phase 12's rule at each model's own measured bytes
   per parameter gives 12 and 8, the depths until phase 19 joined the
   script; ``TRAIN_RECURRENT``; recurrentgemma at n_layers = 2 mod 3,
   so that its unrolled tail trains), seeded weights, seq 1024 (four scan
   chunks), batch 8, trained as phase 12 trains its models (8 steps
   under ``acesync`` with ``replan_every=4``, then an all-rungs
   ``grad_sync``).  Gates: (1) every loss finite; (2) K1-K4 launched on
   each model's path; (3) the peak allocated memory leaves 8 GiB free;
   (4) falcon-mamba's scan transient during the backward, measured on
   the empty card before the session (``launch.memory.scan_memory``: the
   peak of ``SelectiveScan``'s backward at the run's shapes above the
   allocation just before it), stays below ``SCAN_BWD_CHUNKS`` one-chunk
   (8, 256, 8192, 16) f32 tensors.  Prints phase 12's lines per model
   (MFU at 6 * N * tokens with N from the tree) and the scans' saved
   bytes, backward peak and one full-width layer's saved bytes.
15. serving the encoder-decoder and the VLM, in a process of its own:
   seamless-m4t-medium (12 encoder + 12 decoder layers, d 1024, vocab
   256,206) and llava-next-mistral-7b (32 layers, d 4096, 576 stub patch
   embeddings before the tokens) at full published width and depth,
   seeded bf16 weights drawn slice by slice, each workload twice (the
   first cold), the Server feeding zero frames / patches as the
   reference's does: seamless on phase 10's (a) (F = 64 frames) and
   (b), one 4,096-token prompt (F = 512) + 16; llava on (a'), prompts
   448 / 384 / 200 / 448 + 32 (1,024 positions with the patches; (a)'s
   512 gives 1,088, which the chunk rule refuses), and (b), one
   1,472-token prompt (2,048 positions) + 16.  Gates: (1) every request
   gets its token budget and every logit is finite; (2) with seeded
   non-zero frames / patch embeddings (zero frames make the encoder's
   output exactly 0, so the Server's run alone tests none of the
   encoder or the cross path), 16 teacher-forced decode steps (seamless
   after 512 tokens, llava after 432: 1,024 positions for the forward)
   against one forward within rtol = atol = 0.15; (3) the frontend is
   live: the prefill logits with the seeded inputs differ from those
   with zeros by more than 0.15; (4) both SMOKE configs card against
   CPU as in phase 10, and a prefill with seeded inputs in f32; (5)
   K1-K16 launch 0 times.  Prints phase 10's line per model and
   workload (the decode bound counts the cross K/V), the cache bytes
   per sequence (seamless: self ring and cross K/V; llava: the ring, its
   patches' share) and seamless's prefill FLOPs as executed (the
   encoder over the frames).
16. training the encoder-decoder and the VLM, one process per model:
   seamless-m4t-medium at full width and full depth, llava at full
   width cut in depth by phase 12's rule at its own measured bytes per
   parameter (``TRAIN_FRONTEND``), seeded weights, seq 1024 (llava's
   576 patches among them), batch 8, the pipeline's seeded frames /
   patch embeddings, trained as phase 12 trains its models (8 steps
   under ``acesync`` with ``replan_every=4``, then an all-rungs
   ``grad_sync``).  Gates: (1) every loss finite; (2) K1-K4 launched on
   each model's path; (3) the peak allocated memory leaves 8 GiB free;
   seamless at fewer than its 12 decoder layers fails.  Prints phase
   12's lines per model, and seamless's MFU also at its executed FLOPs
   (the encoder over the 128 frames, the LM head over the tokens).
17. serving on a within-pod ("data", "model") mesh, one process per
   rank (``launch/mesh.py``'s ``spawn_mesh``).  (a) qwen3-8b and
   dbrx-132b at full published width cut to 1 layer, on a (1, 2) mesh
   whose ranks share the card (gloo, staged through pinned host
   memory; their (2, 2) run is in (b) since phase 24 joined the
   script), seeded bf16 weights drawn whole slice by slice and kept shard by
   shard (``init_model(ctx=)``).  Gates: (1) the last position's logits
   of a prefill of 4 x 256 seeded tokens and of 4 teacher-forced decode
   steps, gathered, against an unsharded port
   model of the same seed on the same card (a process of its own)
   within rtol = atol = 0.15: qwen3-8b in bf16; dbrx-132b in f32
   compute (a bf16 near-tie, rounded apart by the mesh's and the one
   card's sums, would swap an expert and, under capacity, the drops
   after it) at capacity factor E / K against the unsharded model (at
   D = 1) and at its 1.25 against ``moe_apply_blocked`` (each mesh
   block dispatched on its own, the reference's semantics); (2) the Server's
   tokens on 4 requests of 256 / 200 / 128 / 256 tokens + 1 identical
   on every rank; (3) each rank's weight bytes equal to its
   shards' sizes reckoned from the specs; (4) K1-K16 launch 0 times.  Prints each
   rank's weight bytes, prefill / decode ms, decode bound per card and
   peak memory (the shared card's and the host's times, not a
   deployment's).  (b) only with four cards or more: dbrx-132b on a
   (1, 4) mesh over NCCL, gate 1 at 8 layers against the unsharded
   8-layer model (phase 11's depth, a process of its own on card 0),
   then at its published 40 layers served on workload (a) twice; gates
   2-4; prints per card the weight bytes, prefill ms and its share of
   4 x 989 TFLOP/s, the decode step's median (min-max) against the
   bound per card ((its weights + its caches) / 3.35 TB/s), tokens/s
   and peak memory; then (a)'s models, depth and gates on a (2, 2)
   mesh, a card a rank (the batch over "data", every forward's FSDP
   gathers, the Server's batch gathered over "data"), against the
   unsharded models on card 0.  On fewer cards (b) prints one line and
   is not run;
18. training on a within-pod ("data", "model") mesh, one process per
   rank (``launch/mesh.py``'s ``spawn_mesh``; one spawn per mesh shape,
   its models in turn), full width, cut in depth
   at ``MESH_BYTES_PER_PARAM`` per parameter of each rank with 8 GiB of
   each card to spare.  (a) the ranks share the one card over gloo:
   qwen3-8b at 2 layers and qwen3-moe-30b-a3b at 1 layer on (1, 2)
   (qwen3-moe's (2, 2) run in (b) since phase 22 joined the script),
   batch 4 x 512, seeded weights; the unsharded
   models of the same seed first, in a process of their own, save their
   f32 gradients.  Each rank trains through TrainSession (the loop's
   steps, a device replan; then a grad_sync under the loop's
   plan and an all-rungs one).  Gates: (1) f32 loss and each leaf's
   gradient, gathered, within 1e-3 of the unsharded model's (the MoE at
   capacity E / K, and at 1.25 against ``moe_apply_blocked``); (2) every sync round bit-identical to the one-pod
   ``sync_tree`` of the step's plan on the rank's own grads, errors and
   local layout; (3) losses, grad norms, plan, step and importance state
   identical on every rank; (4) K1-K4 launched on every rank.  Prints
   step ms per kind (median, min-max), tokens/s, MFU over D * M x 989
   TFLOP/s, peak memory per rank (the host's times: a shared card).  (b)
   only with four cards: dbrx-132b on (1, 4), qwen3-8b and
   qwen3-moe-30b-a3b on (2, 2) over NCCL, at
   ``launch.memory.mesh_train_depth``'s depths, batch 8 x 1024,
   gates 2-4, and ``launch.memory.step_memory``'s bytes per parameter by
   owner per card.  On fewer cards (b) prints one line and is not run;
19. checkpoints on a within-pod ("data", "model") mesh, every run through
   TrainSession under ``RunConfig.deterministic`` (phase 9a's switch).
   (a) one fleet of four processes sharing the card over gloo (one
   spawn), meshes of its ranks made by ``launch.mesh.sub_mesh``:
   paper-350m at full width and phase 9a's 2 layers, batch 8 x 1024,
   ``acesync``, ``replan_every`` 4, ``ckpt_every`` 2: 4 uninterrupted
   steps on (1, 2) (fleet ranks 0-1; the replan at step 4) and one
   all-rungs ``grad_sync``; ranks 2-3, fresh processes in a (1, 2) group
   of their own, resumed from a copy of the step-2 checkpoint to step 4
   and the same all-rungs step; the step-4 checkpoint restored on (2, 2)
   (all four) and, rank 0, on one card without a mesh; then one leaf of the uninterrupted run's step 4 bit-rotted and
   that directory restored on (1, 2).  Gates: (1) every state leaf's
   hash, the plan, H and the losses of the resumed run equal the
   uninterrupted run's on every rank at step 4 and after the all-rungs
   step, and its step-4 leaf files equal byte for byte; (2) every
   cross-shape restore, its ranks' shards assembled
   (``convert.reference_from_shards``), has the one-card restore's
   CRC-32 per leaf; (3) after the corruption every rank restores step 2
   and records step 4 as corrupt; (4) K1-K4 launched on
   the training path; and the ranks' written bytes sum to the
   checkpoint's (each entry written once).  Prints the bytes (the
   checkpoint's and each rank's), ``copy_s`` per rank, ``write_s``,
   rank 0's CRC read-back ``crc_s``, the restore seconds per rank and
   target shape, beside phase 9a's one-card save of the same model, and
   the seconds from the spawn to the end of each stage.
   (b) only with four cards: paper-350m at full depth on (2, 2) over
   NCCL, 4 steps with ``ckpt_every`` 2, the step-4 checkpoint restored
   on (1, 4) and on one card, assembling to one state, the same prints.
   On fewer cards (b) prints one line and is not run;
20. the recurrent families on a within-pod ("data", "model") mesh.
   (a) one fleet of four processes sharing the card over gloo (one
   spawn for phases 20 (a) and 21 (a), ``mesh_fleet_path``; meshes of
   its ranks by ``launch.mesh.sub_mesh``), full width, seeded weights.
   Serving: falcon-mamba-7b at 2 layers on (1, 2) (fleet ranks 0-1) and
   recurrentgemma-2b at 3 (one rec, rec, attn group) on (1, 4) (all
   four: its 10 heads over model = 4, wq / wo split by their flat
   H * Dh columns as the reference splits them, each rank gathering the
   heads its part touches; on (1, 2) until phase 24 joined the script);
   gate 1: rank 0's gathered logits of a 4 x 256 prefill
   and 16 teacher-forced decode steps against the unsharded model of the
   same seed (fleet rank 0, one card) within rtol = atol = 0.15 in bf16
   and 1e-3 in f32 compute; then the Server on phase 17's workload, tokens
   identical on every rank, weight bytes the shards'.  Training, f32
   compute, batch 4 x 512, 4 loop steps (three ``local``, a
   ``delta_sync``) and an all-rungs ``grad_sync``: falcon-mamba-7b at 1
   layer on (1, 2), which checkpoints at step 4, and
   recurrentgemma-2b at 3 layers on (1, 2) (falcon-mamba's (2, 2) run in
   (b) since phase 22 joined the script), each held to a one-card run
   of the same seed and batches by fleet rank 0 (one per model).  Gates:
   (1) above; (2) each loop step's loss and grad norm within 1e-3 of the
   one-card run's, every params / m / v shard after the local steps
   within 1e-3 of its leaf's norm (a sync round blocks the rank's
   shards, the reference's nested layout, where one card blocks whole
   leaves: there the check is phase 18's, every round bit-identical to
   the one-pod ``sync_tree`` on the rank's shards), and losses, grad
   norms, plan and steps identical on every rank; (3) K1-K4 launched on
   every training rank and none in serving; (4) the step-4 checkpoint
   restored as one card by fleet rank 2 (a process of its own) equals
   the (1, 2) ranks' shards bit for bit.  Prints serving and step times,
   MFU over D * M x 989 TFLOP/s and peaks (the host's times: a shared
   card) and the seconds from the spawn to the end of each stage.
   (b) only with four cards, over NCCL: falcon-mamba-7b served at all 64
   layers on (1, 4) (workload (a) twice) and trained there and on (2, 2)
   at ``launch.memory.mesh_train_depth``'s layers (its scan over the
   rank's channels counted), recurrentgemma-2b trained at all 26 layers
   on (2, 2), batch 8 x 1024, phase 18 (b)'s gates and lines.  On fewer
   cards (b) prints one line and is not run;
21. the encoder-decoder and the VLM on a within-pod ("data", "model")
   mesh.  (a) in phase 20 (a)'s fleet, after it, full width, seeded
   weights: seamless-m4t-medium at 2 + 2 layers and
   llava-next-mistral-7b at 2 (its 576 stub patches) served on (1, 2),
   gate 1 as phase 20's on seeded non-zero frames / patches (the VLM's
   decode after its patches), the Server with zero frontend inputs (as
   the reference serves them); trained in f32 compute as phase 20's,
   seamless at 4 x 512 on (1, 2) (checkpointed at step 4; its (2, 2)
   run in (b) since phase 22 joined the script), llava at
   4 x 1024 (576 patches and 448 tokens) on (1, 2), each held
   to a one-card run; gate 4: seamless's checkpoint restored
   on (2, 1) (fleet ranks 2-3) and as one card (fleet rank 2), every
   shard of the writing and the restoring ranks bit for bit.  (b) only
   with four cards, over NCCL: both served at their published depths on
   (1, 4), gate 1 against the unsharded model on one card, workload (a)
   twice; trained on (2, 2) at 8 x 1024, seamless at 12 + 12 layers,
   llava at ``launch.memory.mesh_train_depth``'s, phase 18 (b)'s gates
   and lines.  On fewer cards (b) prints one line and is not run;
22. pods x ("data", "model"): a fleet of P pods, each a (D, M) mesh, one
   process per rank (world rank p * D * M + d * M + m), each with its
   pod's mesh and the pod group of the ranks at its (d, m)
   (``launch.mesh.split_fleet_mesh``).  (a) one spawn of four processes
   sharing the card over gloo: P = 2 pods x (1, 2) of paper-350m at full
   width and 2 layers (4 until phase 23 joined the script), global batch
   8 x 1024, ``acesync`` with
   ``replan_every`` 4, 8 loop steps (a checkpoint at step 4), then an
   all-rungs ``grad_sync`` one-shot and one ringed in 2 chunks; the
   fleet's state freed, mesh rank 0 of each pod restores the step-4
   checkpoint as one of 2 whole-model pods.  Gates: (1) every sync round
   bit-identical to the pod-only ``sync_tree`` of the step's plan on the
   rank's shards over its pod group; (2) every parameter shard
   bit-identical across the pods after each ``delta_sync``; (3) the bytes each
   (d, m)'s pod group moved equal to ``plan_wire_bytes`` of its local
   layout (FULL's within its shard padding); (4) H, the plan, omega and
   the losses identical on every rank; (5) the restore bit for bit:
   every rank's shards of the whole leaves equal the shards it wrote;
   (6) K1-K8 and K12-K15 launched on every rank.  Prints step ms by kind
   (median, min-max), MFU, the pod tier's bytes and host seconds (its
   rate), the mesh tiers' bytes and peak memory per rank.  (b) only with
   four cards, over NCCL: qwen3-8b at full width on P = 2 x (1, 2), a
   card a rank, at ``launch.memory.mesh_train_depth``'s depth for
   (1, 2) at ``FLEET_BYTES_PER_PARAM``, batch 8 x 1024, gates 1-4 and
   6, the same prints.  On fewer cards (b) prints one line and is not
   run;
23. a two-tier fleet of ("data", "model") meshes: C clusters x E members,
   each member a (D, M) mesh, one process per rank (world rank
   (c * E + e) * D * M + d * M + m), each (d, m)'s fleet group split into
   its ``intra`` and ``cross`` sub-groups (``split_fleet_mesh(...,
   n_edge=E)``).  (a) one spawn of eight processes sharing the card over
   gloo: C = 2 x E = 2 members x (1, 2) of paper-350m at full width and 2
   layers, global batch 8 x 1024, ``acesync_hier`` over 16 edge devices
   with ``sync_interval_init`` and ``replan_every`` 3 (the loop's
   clustering re-clusters at each replan), 7 loop steps (a checkpoint at
   step 4), then all-rungs ``grad_sync`` rounds with the two-tier rungs
   at the INT8 intra stage, the cross tier one-shot and ringed in 2
   chunks, and one flat over the four members; mesh rank 0 of each
   member restores the step-4 checkpoint as a 2 x 2 hierarchical fleet of
   one-card members.  Phase 22's gates, with (1) against the two-tier
   ``sync_tree`` over each (d, m)'s groups, (3) the bytes of the cross
   tier (the fleet group's flat rungs and the ``cross`` sub-group's) and
   of the ``intra`` sub-group equal to the priced bytes of the local
   layout, (4) also the tier grid and the clusters identical on every
   rank and the clustering updated at the replans, and (6) K1-K6 and
   K8-K13 on every rank.  Prints phase 22's lines with the bytes and host
   seconds of every tier.  No four-card part: eight ranks on four cards
   would put two ranks of one NCCL communicator on one card.
24. the dry run (``repro_torch.launch.dryrun``): one rank's step counted
   on the meta device (dry process groups, ``analysis/cost.py``'s
   counters, the kernel wrappers recording the launches they would make)
   held against the same step on the card.  Three processes on the CPU,
   started right after phase 2 (none sees the card), run beside the
   card's phases: the dry runs of (a) and (b), and the CLI on each of
   ``DRYRUN_CELLS``.  (a) phase 5's all-rungs ``grad_sync`` (paper-350m,
   24 layers, 8 x 1024) once more inside phase 5's process under the
   same counters: the FLOPs equal, every kernel's launches equal to
   ``launch_counts()`` over the step, the state bytes equal to the card
   state's leaves' (``launch.memory.state_bytes`` counts the pad rows of
   the packed rung buffers the anchor's leaves are views of after a
   ``delta_sync`` too, and is printed beside), and the counted peak of
   the step's allocations within ``PEAK_RTOL`` of
   ``max_memory_allocated`` above the step's start.  (b) phase 22 (a)'s one-shot all-rungs round on rank 0
   of P = 2 x (1, 2) (2 layers): the counted collective bytes and counts
   by op and tier equal to what that rank's groups logged in the step
   (the bytes of gate 1's own reference round left out).  (c) the CLI's
   records of qwen3-8b x train_4k on 16 x 16 and dbrx-132b x train_4k on
   2 x 16 x 16 ``ok``; prints each cell's seconds.

Output: progress lines with each phase's seconds, the pod link's latency
and rate, then the ``nvidia-smi`` line, the kernels' JSON line (each
kernel's launches in total and per main path: ``one_pod`` (phase 5),
``p2`` and ``p3`` (phase 7, all pods), ``hier`` (phase 8, all
members), ``restart`` (phase 9a, its three runs), ``elastic`` (phase
9b, all pods), ``zoo_<arch>`` (phases 12, 14 and 16, each model's
process), ``zoo_determinism`` (phase 12, both runs) and
``mesh_<arch>_<D>x<M>`` (phase 18 (a), all ranks; ``mesh_b_...`` for
(b)) and ``mesh_ckpt`` (phase 19 (a), both runs, all ranks;
``mesh_ckpt_b`` for (b)), ``mesh_rec_<arch>_<D>x<M>`` (phase 20 (a)'s
training runs, all ranks; ``mesh_rec_b_...`` for (b)) and
``mesh_rec_serve`` (phase 20 (a)'s serving, none),
``mesh_front_<arch>_<D>x<M>`` / ``mesh_front_b_...`` /
``mesh_front_serve`` (phase 21's, likewise), ``fleet_mesh`` (phase
22 (a), all ranks; ``fleet_mesh_b`` for (b)), ``fleet_hier_mesh``
(phase 23 (a), all ranks), ``dryrun`` (phase 24 (a)'s step), each
counted from 0
just before its run; phases 10, 11, 13, 15 and 17 launch none;
K16's ``library_ms``
is ``torch.mul(q, s)``'s time; ``paths`` gives each path's pods, members
per cluster and depth; ``link`` the measured link), and as the last line
``{"ok": true, "device": {...}}``.  With ``--phases``, only phases 1-2
and the four-card parts named (of 17b, 18b, 19b, 20b, 21b, 22b) run, and the last
line is ``{"phases": {name: seconds}, "launches": {path: {kernel: n}}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
#: checkpoint directories of every phase (phases 5, 7 and 8 get empty
#: ones, so that no stale checkpoint is resumed); removed at the end
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"

NB_350M = 443_697                   # blocks of paper-350m's 11 groups
HBM_BYTES_PER_S = 3.35e12           # H100 SXM datasheet
FP32_FLOPS = 67e12                  # H100 SXM datasheet, non-tensor f32
LANES = 1024
# the kernels' table lives in the package (a dry run reckons each
# launch's bytes from it): each kernel's TPU counterpart, its bytes per row
# and f32 operations per element; the top-k rungs' k
sys.path.insert(0, str(SRC))
try:
    from repro_torch.kernels.table import (DECODE, DECODE_SOURCE, FLAT,
                                           KERNELS, SOURCE, TOPK_K, TOPK_KS,
                                           row_bytes)
except ImportError as e:
    print(f"chip_smoke: FAILED: the port is not next to this script "
          f"({SRC}): {e}", file=sys.stderr, flush=True)
    sys.exit(1)
#: (fixed_bits, payload scale) of the fixed-point checks: the default
#: width, and one where the clip to +-2^31 saturates
FP_CASES = ((16, 1.0), (30, 50.0))
#: phase 7's paths: pods, global batch, TrainSession steps, depth (None:
#: the architecture's 24 layers), and the least delta_sync rounds and
#: device replans those steps must hold.  Cut in depth to keep the script
#: inside its time limit: P = 2 at 12 layers (24 until phase 19 joined the
#: script), P = 3 at 8 (16)
PATHS = {
    "p2": {"pods": 2, "batch": 8, "steps": 8, "n_layers": 12,
           "min_delta": 2, "min_replans": 1},
    "p3": {"pods": 3, "batch": 6, "steps": 4, "n_layers": 8,
           "min_delta": 1, "min_replans": 0},
    # phase 8: C = 2 clusters x E = 2 members (``edge``); four pods at 16
    # layers would need ~76 of the card's 80 GB (phase 7's ~1.2 GiB a
    # layer); 6 layers (12 until phase 19 joined the script)
    "hier": {"pods": 4, "edge": 2, "batch": 8, "steps": 6, "n_layers": 6,
             "min_delta": 1, "min_replans": 1},
}
#: phase 9a: restart-replay on one pod, phase 5's configuration cut in
#: depth (at 24 layers its disk-bound checkpoint writes of 9.09 GB made it
#: the script's longest phase, 150-161 s; at 12, 79-92 s; 6 since phase
#: 18 joined the script; 4 since phase 19, which trains at this depth,
#: did; 2 since phase 22 did): run A trains ``steps`` steps, run B
#: ``steps - 1`` and restarts from the checkpoints of every ``ckpt_every``
#: steps
RESTART = {"pods": 1, "batch": 8, "steps": 10, "ckpt_every": 4,
           "n_layers": 2}
#: phase 9b: elastic membership, P = 3 pod processes sharing the card
#: (three full-depth pods and their checkpoint copies do not fit; 12
#: layers, 85 s, until phase 18 joined the script: 6; 4 since phase 19
#: joined it; 2 since phase 23 did), pod 2 preempted at step 4 and back
#: at step 8
ELASTIC = {"pods": 3, "batch": 6, "steps": 12, "ckpt_every": 5,
           "n_layers": 2, "kill": 4, "rejoin": 8, "killed": 2}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def four_cards() -> str:
    """The first four cards' ``nvidia-smi`` name and power limit lines."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return "; ".join(out.splitlines()[:4])


def _fns(ops, ref, name, k=TOPK_K):
    """(kernel wrapper, plain version) of ``name`` as f(fb, eb, perm, g);
    ``k`` is the top-k kernel's."""
    if name == "gather_ef_topk":
        return (lambda f, e, p, g: ops.gather_ef_topk(f, e, p, gamma=g, k=k),
                lambda f, e, p, g: ref.ef_topk_gather_ref(f, e, p, gamma=g,
                                                          k=k))
    plain = {"gather_ef_int8": ref.quantize_int8_gather_ref,
             "gather_ef_int4": ref.ef_int4_gather_ref,
             "gather_ef_sign": ref.ef_sign_gather_ref}[name]
    kern = getattr(ops, name)
    return (lambda f, e, p, g: kern(f, e, p, gamma=g),
            lambda f, e, p, g: plain(f, e, p, gamma=g))


def compare(torch, got, want) -> float:
    """Bit-compare kernel and plain outputs; returns max |difference|
    (raises through ``fail`` when any bit differs)."""
    err = 0.0
    for a, b in zip(got, want):
        b = b.reshape(a.shape)
        if a.dtype != b.dtype:
            fail(f"dtype {a.dtype} != {b.dtype}")
        same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
                if a.dtype == torch.float32 else torch.equal(a, b))
        d = (a.float() - b.float()).abs()
        d = float(d.max()) if d.numel() else 0.0
        err = max(err, d if math.isfinite(d) else float("inf"))
        if not same:
            fail(f"kernel and plain version differ (max abs {d})")
    return err


def gather_cases(np, torch, dev):
    """The reference's _gather_case inputs: perm lengths 1-23, denormal /
    all-zero / zero-pad rows."""
    out = []
    for S in range(1, 24):
        nbp1 = 2 + (S * 5) % 9
        r = np.random.RandomState(S)
        fb = r.randn(nbp1, LANES).astype(np.float32)
        eb = r.randn(nbp1, LANES).astype(np.float32)
        if S % 2 and nbp1 > 3:
            fb[0] *= 1e-41
            eb[0] *= 1e-41
            fb[1] = 0.0
            eb[1] = 0.0
        fb[-1] = 0.0
        eb[-1] = 0.0
        perm = r.randint(0, nbp1, size=S).astype(np.int32)
        out.append(tuple(torch.from_numpy(x).to(dev) for x in (fb, eb,
                                                                perm)))
    return out


def time_ms(torch, fn, iters: int) -> float:
    fn()                                            # warm up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def ks(name):
    """The k values phase 3 checks ``name`` at (only top-k reads k)."""
    return TOPK_KS if name == "gather_ef_topk" else (TOPK_K,)


def kernel_phase(np, torch, ops, ref, dev) -> dict:
    """Phase 3: bit parity on the gather cases and on the full-model perm;
    kernel and plain-version times on the full-model perm."""
    results = {}
    cases = gather_cases(np, torch, dev)
    for name in KERNELS:
        err = 0.0
        for k in ks(name):
            kern, plain = _fns(ops, ref, name, k)
            for fb, eb, perm in cases:
                for gamma in (1.0, 0.9, 0.6):
                    err = max(err, compare(torch, kern(fb, eb, perm, gamma),
                                           plain(fb, eb, perm, gamma)))
        results[name] = {"max_abs_err": err}
    log(f"phase 3: K1-K4 bit-exact on {len(cases)} gather cases x 3 gammas "
        f"(top-k at k = {TOPK_KS})")

    g = torch.Generator(device=dev).manual_seed(0)
    fb = torch.randn((NB_350M + 1, LANES), generator=g, device=dev)
    eb = torch.randn((NB_350M + 1, LANES), generator=g, device=dev)
    fb[0] *= 1e-41
    eb[0] *= 1e-41
    fb[1] = 0.0
    eb[1] = 0.0
    fb[-1] = 0.0
    eb[-1] = 0.0
    # the perm a plan putting every group on one rung builds: all NB rows
    perm = torch.arange(NB_350M, dtype=torch.int32, device=dev)
    S = NB_350M
    for name, (_, _, flops_el) in KERNELS.items():
        err = 0.0
        for k in ks(name):
            kern, plain = _fns(ops, ref, name, k)
            err = max(err, compare(torch, kern(fb, eb, perm, 0.9),
                                   plain(fb, eb, perm, 0.9)))
            torch.cuda.empty_cache()
        kern, plain = _fns(ops, ref, name)
        ms = time_ms(torch, lambda: kern(fb, eb, perm, 0.9), 10)
        plain_ms = time_ms(torch, lambda: plain(fb, eb, perm, 0.9), 2)
        torch.cuda.empty_cache()
        nbytes = S * row_bytes(name)
        nops = S * LANES * flops_el
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_FLOPS * 1e3
        r = results[name]
        r.update(max_abs_err=max(r["max_abs_err"], err), ms=ms,
                 plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 bytes=nbytes, gbps=nbytes / (ms * 1e-3) / 1e9)
        log(f"phase 3: {name} full-model perm (S={S}) bit-exact; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"{nbytes / 1e9:.3f} GB moved, {r['gbps']:.0f} GB/s of "
            f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s datasheet, "
            f"bound {r['bound_ms']:.3f} ms")
    del fb, eb, perm
    torch.cuda.empty_cache()
    return results


def decode_inputs(np, torch, dev, rows, seed, k=TOPK_K, scale=1.0):
    """One fold's operands on the card: f32 and int32 accumulators (with
    zero, denormal and -0 entries), int8 values, nibbles, sign bits, top-k
    values and distinct indices, per-row scales (a zero and a denormal
    one), and a second magnitude vector for the sign folds."""
    g = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.randn((rows, LANES), generator=g, device=dev)
    acc[1 % rows] = 0.0
    acc[2 % rows, ::3] *= 1e-41
    acc[3 % rows, ::5] = -0.0
    s = torch.rand((rows,), generator=g, device=dev) * (0.01 * scale)
    s[5 % rows] = 0.0
    s[6 % rows] = 3e-39
    i32 = torch.iinfo(torch.int32)
    idx = torch.rand((rows, LANES), generator=g, device=dev).argsort(
        dim=1)[:, :k].to(torch.int32).to(torch.uint16)
    return {
        "acc": acc, "s": s,
        "iacc": torch.randint(i32.min, i32.max, (rows, LANES), generator=g,
                              device=dev, dtype=torch.int32),
        "q": torch.randint(-127, 128, (rows, LANES), generator=g,
                           device=dev, dtype=torch.int8),
        "nib": torch.randint(0, 256, (rows, LANES // 2), generator=g,
                             device=dev, dtype=torch.uint8),
        "sgn": torch.randint(0, 256, (rows, LANES // 8), generator=g,
                             device=dev, dtype=torch.uint8),
        "mag": torch.randn((rows,), generator=g, device=dev),
        "imag": torch.randint(i32.min, i32.max, (rows,), generator=g,
                              device=dev, dtype=torch.int32),
        "qk": torch.randint(-127, 128, (rows, k), generator=g, device=dev,
                            dtype=torch.int8),
        "idx": idx}


def decode_fns(ops, ref, name, x, w, bits=16):
    """(kernel wrapper, plain version) of decode kernel ``name`` as
    zero-argument calls on the operands ``x``; both return a tuple."""
    s2 = x["s"].reshape(-1, 1)
    if name in ("decode_accum_int8", "decode_accum_int4"):
        src = x["q"] if name.endswith("int8") else x["nib"]
        plain = (ref.dequant_accum_int8_ref if name.endswith("int8")
                 else ref.dequant_accum_int4_ref)
        return (lambda: (getattr(ops, name)(x["acc"], src, x["s"], w),),
                lambda: (plain(x["acc"], src, s2, w),))
    if name in ("decode_accum_int8_fp", "decode_accum_int4_fp"):
        src = x["q"] if "int8" in name else x["nib"]
        kern = getattr(ops, name[:-3])
        plain = (ref.dequant_accum_int8_fp_ref if "int8" in name
                 else ref.dequant_accum_int4_fp_ref)
        return (lambda: (kern(x["iacc"], src, x["s"], w, fixed_bits=bits),),
                lambda: (plain(x["iacc"], src, s2, w, bits),))
    if name == "sign_vote_accum":
        return (lambda: ops.sign_vote_accum(x["acc"], x["mag"], x["sgn"],
                                            x["s"], w),
                lambda: tuple(t.reshape(-1) if t.shape[-1] == 1 else t
                              for t in ref.sign_vote_accum_ref(
                                  x["acc"], x["mag"][:, None], x["sgn"], s2,
                                  w)))
    if name == "sign_vote_accum_fp":
        return (lambda: ops.sign_vote_accum(x["iacc"], x["imag"], x["sgn"],
                                            x["s"], w, fixed_bits=bits),
                lambda: tuple(t.reshape(-1) if t.shape[-1] == 1 else t
                              for t in ref.sign_vote_accum_fp_ref(
                                  x["iacc"], x["imag"][:, None], x["sgn"],
                                  s2, w, bits)))
    return (lambda: (ops.topk_scatter_accum(x["acc"], x["qk"], x["idx"],
                                            x["s"], w),),
            lambda: (ref.topk_scatter_accum_ref(x["acc"], x["qk"], x["idx"],
                                                s2, w),))


def decode_phase(np, torch, ops, ref, dev) -> dict:
    """Phase 6: K5-K11 bit for bit against their plain versions on small
    cases (omega 0.37 / 0 / 1, a saturating fixed-point width, top-k at
    every k of the ladder) and on one call over all NB_350M rows of
    paper-350m, which is also timed."""
    results = {name: {"max_abs_err": 0.0} for name in DECODE}
    n_cases = 0
    for wv in (0.37, 0.0, 1.0):
        w = torch.tensor(wv, dtype=torch.float32, device=dev)
        for bits, scale in FP_CASES:
            for k in TOPK_KS:
                x = decode_inputs(np, torch, dev, 16, 100 + k, k, scale)
                for name in DECODE:
                    if name == "topk_scatter_accum" and bits != 16:
                        continue
                    kern, plain = decode_fns(ops, ref, name, x, w, bits)
                    r = results[name]
                    r["max_abs_err"] = max(r["max_abs_err"],
                                           compare(torch, kern(), plain()))
                    n_cases += 1
    log(f"phase 6: K5-K11 bit-exact on {n_cases} small cases (omega "
        f"0.37 / 0 / 1, fixed_bits 16 and 30, top-k k = {TOPK_KS})")
    w = torch.tensor(0.37, dtype=torch.float32, device=dev)
    x = decode_inputs(np, torch, dev, NB_350M, 7)
    for name in DECODE:
        kern, plain = decode_fns(ops, ref, name, x, w)
        err = compare(torch, kern(), plain())
        torch.cuda.empty_cache()
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 2)
        torch.cuda.empty_cache()
        nbytes = NB_350M * row_bytes(name)
        nops = NB_350M * LANES * 3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_FLOPS * 1e3
        r = results[name]
        r.update(max_abs_err=max(r["max_abs_err"], err), ms=ms,
                 plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 bytes=nbytes, gbps=nbytes / (ms * 1e-3) / 1e9)
        log(f"phase 6: {name} over {NB_350M} rows bit-exact; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {r['gbps']:.0f} GB/s, "
            f"bound {r['bound_ms']:.3f} ms")
    del x
    torch.cuda.empty_cache()
    return results


def flat_inputs(torch, dev, rows, seed):
    """(g, e) (rows, LANES) f32 made on the card from ``seed``, with a
    denormal row, an all-zero row and -0 entries (rows 0, 1 and 2, where
    they exist)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((rows, LANES), generator=gen, device=dev)
    e = torch.randn((rows, LANES), generator=gen, device=dev)
    g[0] *= 1e-41
    e[0] *= 1e-41
    if rows > 1:
        g[1] = 0.0
        e[1] = 0.0
    if rows > 2:
        g[2, ::3] = -0.0
        e[2, ::5] = -0.0
    return g, e


def flat_fns(ops, ref, name, g, e, gamma, k=TOPK_K):
    """(kernel wrapper, plain version) of flat kernel ``name`` as
    zero-argument calls on (rows, LANES) inputs; the wrapper takes the
    flat buffers, as the codecs call it, and both return row tensors."""
    R = g.shape[0]
    gf, ef = g.reshape(-1), e.reshape(-1)
    if name == "quantize_int8":
        x = ref.ef_accumulate(g, e, gamma)
        return (lambda: ops.quantize_int8(x.reshape(-1))[:3],
                lambda: ref.quantize_int8_ref(x))
    if name == "dequant_int8":
        q, s, _ = ref.quantize_int8_ref(ref.ef_accumulate(g, e, gamma))
        s = s.clone()
        s[1 % R] = 3e-39                              # a denormal scale
        return (lambda: (ops.dequant_int8(q, s, R * LANES),),
                lambda: (ref.dequantize_int8_ref(q, s),))
    if name == "ef_topk":
        return (lambda: ops.ef_topk(gf, ef, gamma=gamma, k=k),
                lambda: ref.ef_topk_select_ref(g, e, gamma=gamma, k=k))
    kern = getattr(ops, name)
    plain = {"ef_int4": ref.ef_int4_ref, "ef_sign": ref.ef_sign_ref}[name]
    return (lambda: kern(gf, ef, gamma=gamma)[:3],
            lambda: plain(g, e, gamma=gamma))


def flat_phase(torch, ops, ref, dev) -> dict:
    """Phase 6b: K12-K16 bit for bit against their plain versions on row
    counts 1-23 (a denormal row, an all-zero row, -0 entries) x gamma
    1.0 / 0.9 / 0.6, top-k at every k of the ladder, and on one call over
    all NB_350M rows of paper-350m, which is also timed."""
    results = {name: {"max_abs_err": 0.0} for name in FLAT}
    n_cases = 0
    for rows in range(1, 24):
        g, e = flat_inputs(torch, dev, rows, 200 + rows)
        for gamma in (1.0, 0.9, 0.6):
            for name in FLAT:
                for k in (TOPK_KS if name == "ef_topk" else (TOPK_K,)):
                    kern, plain = flat_fns(ops, ref, name, g, e, gamma, k)
                    r = results[name]
                    r["max_abs_err"] = max(r["max_abs_err"],
                                           compare(torch, kern(), plain()))
                    n_cases += 1
    log(f"phase 6b: K12-K16 bit-exact on {n_cases} small cases (rows 1-23, "
        f"gamma 1.0 / 0.9 / 0.6, top-k k = {TOPK_KS})")
    g, e = flat_inputs(torch, dev, NB_350M, 9)
    for name, (_, _, flops_el) in FLAT.items():
        kern, plain = flat_fns(ops, ref, name, g, e, 0.9)
        err = compare(torch, kern(), plain())
        torch.cuda.empty_cache()
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 2)
        torch.cuda.empty_cache()
        nbytes = NB_350M * row_bytes(name)
        nops = NB_350M * LANES * flops_el
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_FLOPS * 1e3
        r = results[name]
        r.update(max_abs_err=max(r["max_abs_err"], err), ms=ms,
                 plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 bytes=nbytes, gbps=nbytes / (ms * 1e-3) / 1e9)
        extra = ""
        if name == "dequant_int8":
            r["library_ms"], n_den = dequant_library(torch, ops, ref, g, e)
            extra = (f", library torch.mul {r['library_ms']:.3f} ms (bit for "
                     f"bit but {n_den} denormal products K16 flushes)")
        log(f"phase 6b: {name} over {NB_350M} rows bit-exact; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {r['gbps']:.0f} GB/s, "
            f"bound {r['bound_ms']:.3f} ms{extra}")
    del g, e
    torch.cuda.empty_cache()
    return results


def dequant_library(torch, ops, ref, g, e):
    """K16's single-call library counterpart, ``torch.mul(q, s)`` with the
    int8 codes promoted to f32, on phase 6b's full-model operands: timed,
    and held against K16 bit for bit on every entry but the products that
    are denormal, which K16 flushes to zero as the reference does (their
    count is returned; the check fails if any other entry differs)."""
    R = g.shape[0]
    q, s, _ = ref.quantize_int8_ref(ref.ef_accumulate(g, e, 0.9))
    s = s.clone()
    s[1 % R] = 3e-39                                  # a denormal scale
    lib = torch.mul(q, s)
    if lib.dtype != torch.float32:
        fail(f"torch.mul(int8, f32) gave {lib.dtype}")
    kern = ops.dequant_int8(q, s, R * LANES).reshape(R, LANES)
    tiny = torch.finfo(torch.float32).tiny
    den = (lib != 0) & (lib.abs() < tiny)
    same = kern.view(torch.int32) == lib.view(torch.int32)
    flushed = den & (kern == 0)
    if not bool((same | flushed).all()):
        fail("torch.mul(q, s) and K16 differ outside the denormal products")
    ms = time_ms(torch, lambda: torch.mul(q, s), 10)
    del q, s, lib, kern
    torch.cuda.empty_cache()
    return ms, int(den.sum())


#: phase 4's SMOKE configs, their compute dtype (None: the config's,
#: bf16) and sequence length: paper-350m, and the MoE family and gemma2's
#: local / global layers in f32, where the card and the CPU route every
#: token alike, at 64 positions; the recurrent families in f32 at 512, so
#: that the scans' backward runs over two 256-position chunks; the
#: encoder-decoder and the VLM (bf16) at 64, fed the pipeline's seeded
#: non-zero frames / patch embeddings
SMALL_AGREEMENT = (("paper-350m", None, 64),
                   ("qwen3-moe-30b-a3b", "float32", 64),
                   ("gemma2-9b", "float32", 64),
                   ("falcon-mamba-7b", "float32", 512),
                   ("recurrentgemma-2b", "float32", 512),
                   ("seamless-m4t-medium", None, 64),
                   ("llava-next-mistral-7b", None, 64))


def small_agreement(torch):
    """Phase 4: one SMOKE-model grad_sync step on the card and on the CPU
    from the same state and batch, for each of ``SMALL_AGREEMENT``; the
    losses and updated weights must agree (the CPU runs the plain
    versions, the card the kernels), and a MoE model's top-k sets in
    every dispatch (the forward's and the backward's recompute) must be
    the same on both."""
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model

    for arch, dtype, seq in SMALL_AGREEMENT:
        cfg = SMOKE_ARCHS[arch]
        if dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", seq, 2, "train"),
                        lr=1e-2, warmup_steps=1)
        card = Trainer(build_model(run.model, run, device="cuda"), run)
        host = Trainer(build_model(run.model, run, device="cpu"), run)
        states = [card.init_state(0)]
        states.append(convert.move_state(states[0], host))
        outs, routes = [], []
        for tr, state in zip((card, host), states):
            batch = next(TokenPipeline(tr.model, run.shape, seed=1))
            plan = tr.scheduler.plan_from_levels(
                [i % 8 for i in range(len(tr.sizes))], (1.0,))
            calls = []
            real, recorded = recording_dispatch(moe, calls)
            moe.dispatch = recorded
            try:
                state, m = tr.step(state, batch, plan, "grad_sync")
            finally:
                moe.dispatch = real
            routes.append([c[1].sort(-1).values.cpu() for c in calls])
            outs.append((float(m["loss"]),
                         [p.detach().cpu() for p in
                          T.leaves(state["params"])]))
        (lc, pc), (lh, ph) = outs
        tag = f"phase 4: {arch} ({cfg.dtype}, seq {seq})"
        if not (math.isfinite(lc) and abs(lc - lh) <= 2e-2 * abs(lh)):
            fail(f"{tag}: small-input loss: card {lc} vs cpu {lh}")
        worst = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
        if worst > 1e-3:
            fail(f"{tag}: small-input updated weights differ by {worst}")
        rc, rh = routes
        if cfg.family == "moe":
            # the forward's dispatches and the backward's recompute
            if len(rc) != 2 * cfg.n_layers or len(rh) != len(rc):
                fail(f"{tag}: {len(rc)} / {len(rh)} dispatches recorded, "
                     f"not 2 x {cfg.n_layers}")
            parted = sum(int((a != b).any(-1).sum())
                         for a, b in zip(rc, rh))
            if parted:
                fail(f"{tag}: the card's top-k sets differ from the CPU's "
                     f"on {parted} (token, dispatch) rows")
        log(f"{tag}: grad_sync step card loss {lc:.6f} vs cpu {lh:.6f}; "
            f"max weight difference {worst:.3g}"
            + (f"; top-k sets equal in all {len(rc)} dispatches"
               if rc else ""))


def main_path(torch, ops) -> dict:
    """Phase 5: paper-350m at full width through TrainSession, then one
    all-rungs grad_sync step."""
    from repro_torch import tree as T
    from repro_torch.configs.base import ACESyncConfig
    from repro_torch.launch.session import TrainSession

    sess = TrainSession.from_config(
        "paper-350m", strategy="acesync", smoke=False, seq_len=1024,
        batch=8, steps=100, device="cuda", warmup_steps=2,
        ckpt_dir=str(CKPT_ROOT / "phase5"),
        acesync=ACESyncConfig(replan_every=4))
    cfg = sess.model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 1024, 50304)
    trainer = sess.trainer
    times = []
    step = trainer.step

    def timed(state, batch, plan, kind="grad_sync"):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(state, batch, plan, kind)
        e1.record()
        times.append((kind, e0, e1))
        return out

    trainer.step = timed
    sess.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(8, log_every=1)
    plan = trainer.scheduler.plan_from_levels(
        [i % 8 for i in range(len(trainer.sizes))], (1.0,))
    rungs = sorted(set(plan.level_idx))
    state, metrics = trainer.step(sess.state, next(sess.pipeline), plan,
                                  "grad_sync")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gs_loss = float(metrics["loss"])

    losses = sess.losses + [gs_loss]
    kinds = [k for h in sess.history for k in h["kinds"]]
    if rungs != list(range(8)):
        fail(f"round-robin plan covers rungs {rungs}")
    if kinds.count("delta_sync") < 2:
        fail(f"only {kinds.count('delta_sync')} delta_sync rounds")
    if sess.loop.device_replans < 1:
        fail("no device replan was applied")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not 5.0 < losses[0] < 20.0:
        fail(f"implausible initial loss {losses[0]} (ln V = "
             f"{math.log(cfg.vocab_size):.2f})")
    if not all(bool(torch.isfinite(p).all())
               for p in T.leaves(state["params"])):
        fail("non-finite parameters after the main path")
    missing = [k for k in KERNELS if launches[k] < 1]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    per_kind: dict = {}
    for kind, e0, e1 in times:
        per_kind.setdefault(kind, []).append(e0.elapsed_time(e1))
    tokens = 8 * 1024
    for kind, ms in per_kind.items():
        # the first step of a kind carries one-time set-up (cuBLAS
        # handles, allocator growth): steady = the later steps' mean
        steady = ms[1:] or ms
        mean = sum(steady) / len(steady)
        extra = (f", {tokens / (mean / 1e3):.0f} tokens/s"
                 if kind in ("local", "grad_sync") else "")
        log(f"phase 5: {kind}: {len(ms)} steps, ms "
            f"{[round(x, 2) for x in ms]}; steady mean {mean:.2f} ms"
            f"{extra}")
    log(f"phase 5: losses {[round(x, 4) for x in losses]}; "
        f"{kinds.count('delta_sync')} delta_sync rounds, "
        f"{sess.loop.device_replans} device replan(s), plan levels after "
        f"replan {list(sess.loop.plan.level_idx)}")
    log(f"phase 5: launches {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB; wall {wall:.1f} s")
    PHASE24["a"] = dryrun_card_step(torch, ops, step, state,
                                    next(sess.pipeline), plan,
                                    sess.run_config)
    return launches


def dryrun_card_step(torch, ops, step, state, batch, plan, run) -> dict:
    """Phase 24 (a), the card's side, in phase 5's process: phase 5's
    all-rungs ``grad_sync`` once more, from its state, under the dry
    run's counters (``analysis.cost.Counters``), the kernels' launches
    counted from 0 and the allocator's peak above the step's start."""
    import dataclasses as dc
    from repro_torch.analysis.cost import Counters
    from repro_torch.launch.memory import state_bytes
    if dc.replace(run, ckpt_dir="") != dc.replace(dryrun_runs()["a"],
                                                  ckpt_dir=""):
        fail("phase 24 (a): phase 5's RunConfig is not the dry run's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with Counters() as c:
        _, m = step(state, batch, plan, "grad_sync")
    torch.cuda.synchronize()
    from repro_torch import tree as T
    return {"seconds": time.perf_counter() - t0,
            "flops": c.report.flops, "op_flops": c.report.op_flops,
            "launches": ops.launch_counts(),
            "state_bytes": state_bytes(state),
            "state_leaf_bytes": sum(
                x.numel() * x.element_size()
                for _, x in T.reference_leaves_with_path(state)),
            "peak": torch.cuda.max_memory_allocated() - base,
            "counted_peak_on_card": c.report.transient_peak,
            "loss": float(m["loss"])}


#: elements of a tensor that ``bits_hash`` hashes at a time: its int64
#: temporaries stay ~0.5 GiB, where a whole 311M-entry embedding shard's
#: took ~10 GB
HASH_CHUNK = 1 << 24


def bits_hash(torch, t):
    """A position-sensitive hash of a tensor's bits (int64, on device):
    the sum, wrapping in int64, of each 32-bit word times (its index mod
    65521) + 1, taken a chunk at a time."""
    flat = t.detach().contiguous().view(torch.int32).reshape(-1)
    out = torch.zeros((), dtype=torch.int64, device=flat.device)
    for i in range(0, flat.numel(), HASH_CHUNK):
        b = flat[i:i + HASH_CHUNK].to(torch.int64)
        w = torch.arange(i, i + b.numel(), device=b.device,
                         dtype=torch.int64)
        out += (b * (w % 65521 + 1)).sum()
    return out


def log_heartbeats(tag, pods, who="pod"):
    """Each pod's host milliseconds in the loop's heartbeat exchanges
    (waiting for the other pods included)."""
    for pod in pods:
        hb = pod["heartbeat_ms"]
        if hb:
            log(f"{tag}: {who} {pod['pod']} heartbeat exchanges: {len(hb)}, "
                f"mean {sum(hb) / len(hb):.3f} ms, max {max(hb):.3f} ms "
                f"host time")


def tier_priced(ep, n_pods, n_edge):
    """Analytic bytes per member of an executed plan on a fleet of
    ``n_pods`` members in clusters of ``n_edge``, per tier:
    ``(payload, full, intra, full_pad, intra_pad)`` — the cross tier's
    payload rungs (gather and ring: two-tier rungs at the cluster count,
    flat rungs at the fleet size), FULL's flat sum over the fleet, the
    intra tier's (``planexec.sig_wire_bytes`` / ``sig_intra_bytes`` per
    piece), and bounds on the bytes the bf16 sums' reduce-scatter +
    all-gather moves beyond ``FullCodec.wire_bytes`` on the cross and
    intra tiers: a piece of n entries is cut into P shards of ceil(n / P),
    which pads it by fewer than 4 (P - 1) bytes received (none where P
    divides n).  On a flat fleet (``n_edge`` 1) the payload is the gather
    and ring rungs' ``plan_wire_bytes``."""
    from repro_torch.codecs import build_codec
    from repro_torch.core.planexec import INTRA_FULL
    n_cross = n_pods // n_edge
    grids = (zip(ep.seg_sig, ep.seg_hier) if ep.segmented
             else ((ep.sig, ep.hier),))
    pay = full = intra = fpad = ipad = 0
    for sig, hier in grids:
        for r, S in enumerate(sig):
            if not S:
                continue
            lv, n = ep.levels[r], S * ep.block
            h = hier[r] if hier else 0
            if h:
                pay += lv.wire_bytes(n, n_cross)
                inner = build_codec("full" if h == INTRA_FULL else "int8")
                intra += inner.wire_bytes(n, n_edge)
                if h == INTRA_FULL and n % n_edge:
                    ipad += 4 * (n_edge - 1)
            elif lv.codec.name == "full":
                full += lv.wire_bytes(n, n_pods)
                if n % n_pods:
                    fpad += 4 * (n_pods - 1)
            else:
                pay += lv.wire_bytes(n, n_pods)
    return pay, full, intra, fpad, ipad


def ring_entries(ep, n_pods) -> int:
    """Ring hops an executed plan posts, one log entry each: K chunks x
    the critical path's hops (``planexec.ring_hops``) per ringing rung."""
    from repro_torch.core.planexec import ring_hops
    grids = (zip(ep.seg_sig, ep.seg_chunks) if ep.segmented
             else ((ep.sig, ep.chunks),))
    return sum(k * ring_hops(n_pods, ep.bidir) for sig, chunks in grids
               for S, k in zip(sig, chunks) if S and k)


#: phase 7's all-rungs assignment of paper-350m's 11 groups (sorted-key
#: order: wk, wo, wq, wv, w_down, w_gate, w_up, ln1, ln2, embed,
#: final_norm): every rung of the ladder gets a group, and the four payload
#: codecs get the largest (INT8 the embedding, INT4 / TOPK10 / SIGN1 the
#: MLP stacks), the rungs the roofline rings
ALL_RUNGS = (0, 3, 6, 7, 2, 4, 5, 0, 3, 1, 6)
#: phase 7's sync_tree round: exec plans by their ``ring`` argument
RING_PLANS = {"one_shot": -1, "k2": 2, "auto": None}


def sync_round(group, trainer, state, batch, omega, out):
    """Phase 7's all-rungs sync_tree round, one pod: the same gradients
    and residuals through the one-shot, the forced 2-chunk and the auto
    exec plan; hashes of each plan's aggregate and residuals, and its
    logged bytes beside ``plan_wire_bytes`` of its gather rungs."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core import planexec
    from repro_torch.core import sync as S

    P = group.size
    plan = trainer.scheduler.plan_from_levels(list(ALL_RUNGS), omega)
    _, grads, _ = trainer._grad_step(state["params"], batch)
    errors = state["ace"].errors
    for name, ring in RING_PLANS.items():
        ep = planexec.build_exec_plan(
            plan, layout=trainer.leaf_layout, n_pods=P, ring=ring,
            segments=planexec.config_segments(trainer.run.acesync),
            device=group.device)
        log0 = len(group.log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg, new_e = S.sync_tree(grads, errors, ep, gamma=0.9, pods=group)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        new = group.log[log0:]
        out["round"][name] = {
            "agg": [int(bits_hash(torch, x)) for x in T.leaves(agg)],
            "err": [int(bits_hash(torch, x)) for x in T.leaves(new_e)],
            "bytes": sum(x["bytes"] for x in new
                         if x["op"] in ("gather", "ring")),
            "want": tier_priced(ep, P, 1)[0],
            "chunks": [list(c) for c in (ep.seg_chunks if ep.segmented
                                         else (ep.chunks,))],
            "hops": sum(1 for x in new if x["op"] == "ring"),
            "want_hops": ring_entries(ep, P),
            "ms": secs * 1e3}
        del agg, new_e
        torch.cuda.empty_cache()


def pod_main_path(group, spec):
    """Phase 7, one pod process: the pod link's ping-pong (P = 2), then
    paper-350m at full width through TrainSession under the default
    ``ACESyncConfig`` (``spec["steps"]`` steps, one device replan), one
    grad_sync step with all 8 rungs whose payload rungs ring in 2 chunks,
    and the all-rungs sync_tree round under three exec plans.  Returns
    this pod's hashes, counts, bytes and times; the parent compares the
    pods."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.core import planexec
    from repro_torch.kernels import ops
    from repro_torch.launch import linkbench
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = group.size
    link = linkbench.ping_pong(group) if P == 2 else None
    cfg = ARCHS["paper-350m"]
    if spec["n_layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("session", 1024, spec["batch"],
                                      "train"),
                    total_steps=100, warmup_steps=2,
                    ckpt_dir=str(CKPT_ROOT / f"phase7_p{P}"),
                    acesync=ACESyncConfig(replan_every=4))
    sess = TrainSession(build_model(cfg, run, device=group.device), run,
                        strategy="acesync", pods=group)
    cfg = sess.model.cfg
    trainer = sess.trainer
    step = trainer.step
    out = {"times": [], "param_hashes": [], "agg_hashes": [],
           "bytes": [], "width": (cfg.d_model, cfg.vocab_size),
           "layers": cfg.n_layers, "round": {}, "ringed": 0,
           "want_ringed": 0}

    def timed(state, batch, plan, kind="grad_sync"):
        log0 = len(group.log)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = step(state, batch, plan, kind)
        e1.record()
        new = group.log[log0:]
        out["times"].append((kind, e0, e1, sum(x["seconds"] for x in new),
                             sum(x["sync_seconds"] for x in new)))
        if kind in ("delta_sync", "grad_sync"):
            ep = trainer.exec_plan(plan)
            out["ringed"] += sum(1 for x in new if x["op"] == "ring")
            out["want_ringed"] += ring_entries(ep, P)
            pay, full, _, pad, _ = tier_priced(ep, P, 1)
            out["bytes"].append((kind, sum(x["bytes"] for x in new
                                           if x["op"] in ("gather", "ring")),
                                 pay,
                                 sum(x["bytes"] for x in new
                                     if x["op"] == "full"),
                                 full, pad))
        if kind == "delta_sync":
            out["param_hashes"].append(
                [bits_hash(torch, x) for x in T.leaves(res[0]["params"])])
        return res

    trainer.step = timed
    sess.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group.barrier()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(spec["steps"], log_every=1 if group.rank == 0 else 0)
    # the all-rungs step rings every payload rung (2 chunks each)
    acfg = trainer.run.acesync
    plan = planexec.build_exec_plan(
        trainer.scheduler.plan_from_levels(list(ALL_RUNGS),
                                           sess.loop.plan.omega),
        layout=trainer.leaf_layout, n_pods=P, ring=2, bidir=acfg.ring_bidir,
        segments=planexec.config_segments(acfg), device=group.device)
    # the aggregate rows each rung hands to AdamW, hashed in rung order
    update_rows = adamw.update_rows

    def hashed(p, g_rows, *a, **k):
        out["agg_hashes"].append(bits_hash(torch, g_rows))
        return update_rows(p, g_rows, *a, **k)

    adamw.update_rows = hashed
    try:
        state, metrics = trainer.step(sess.state, next(sess.pipeline), plan,
                                      "grad_sync")
    finally:
        adamw.update_rows = update_rows
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    sync_round(group, trainer, state, next(sess.pipeline),
               sess.loop.plan.omega, out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    losses = sess.losses + [float(metrics["loss"])]
    kinds = [k for h in sess.history for k in h["kinds"]]
    finite = all(bool(torch.isfinite(x).all())
                 for x in T.leaves(state["params"]))
    per_kind: dict = {}
    for kind, e0, e1, comm_s, sync_s in out.pop("times"):
        per_kind.setdefault(kind, []).append(
            (e0.elapsed_time(e1), comm_s * 1e3, sync_s * 1e3))
    return {
        "pod": group.rank, "backend": group.backend,
        "losses": losses, "kinds": kinds, "finite": finite,
        "replans": sess.loop.device_replans, "launches": launches,
        "peak": torch.cuda.max_memory_allocated(),
        "reserved": torch.cuda.max_memory_reserved(), "wall": wall,
        "train_s": train_s, "per_kind": per_kind, "bytes": out["bytes"],
        "ringed": out["ringed"], "want_ringed": out["want_ringed"],
        "round": out["round"], "link": link,
        "param_hashes": [[int(h) for h in hs]
                         for hs in out["param_hashes"]],
        "agg_hashes": [int(h) for h in out["agg_hashes"]],
        "layers": out["layers"], "width": out["width"],
        "plan": list(sess.loop.plan.level_idx),
        "heartbeat_ms": [t * 1e3 for t in sess.loop.heartbeat_seconds]}


def multipod_run(spec) -> dict:
    """Drive one path of phase 7 and check what the pods return."""
    from repro_torch.launch.mesh import spawn_pods
    n_pods = spec["pods"]
    t0 = time.perf_counter()
    pods = spawn_pods(pod_main_path, n_pods, "cuda", args=(spec,),
                      timeout=900)
    wall = time.perf_counter() - t0
    tag = f"phase 7 (P={n_pods})"
    first = pods[0]
    if first["width"] != (1024, 50304):
        fail(f"{tag}: not the full width: {first['width']}")
    if first["layers"] != (spec["n_layers"] or 24):
        fail(f"{tag}: ran {first['layers']} layers, not "
             f"{spec['n_layers'] or 24}")
    for pod in pods:
        if not pod["finite"] or not all(math.isfinite(x)
                                        for x in pod["losses"]):
            fail(f"{tag}: non-finite loss or parameters on pod "
                 f"{pod['pod']}: {pod['losses']}")
        if pod["kinds"].count("delta_sync") < spec["min_delta"]:
            fail(f"{tag}: only {pod['kinds'].count('delta_sync')} "
                 f"delta_sync rounds")
        if pod["replans"] < spec["min_replans"]:
            fail(f"{tag}: {pod['replans']} device replans applied")
        for kind, got, want, full, full_priced, pad in pod["bytes"]:
            if got != want:
                fail(f"{tag}: pod {pod['pod']} moved {got} bytes (gather + "
                     f"ring) in a {kind} step, plan_wire_bytes of the "
                     f"gather rungs is {want}")
            if not (0 <= full - full_priced < pad
                    or full == full_priced):
                fail(f"{tag}: pod {pod['pod']} moved {full} FULL bytes in a "
                     f"{kind} step, FullCodec.wire_bytes prices "
                     f"{full_priced} (shard padding at most {pad})")
        if pod["ringed"] != pod["want_ringed"]:
            fail(f"{tag}: the training run's sync steps posted "
                 f"{pod['ringed']} ring hops on pod {pod['pod']}, their "
                 f"chunk grids ask for {pod['want_ringed']}")
        for name, rnd in pod["round"].items():
            if rnd["bytes"] != rnd["want"]:
                fail(f"{tag}: sync_tree round '{name}' moved {rnd['bytes']} "
                     f"bytes on pod {pod['pod']}, plan_wire_bytes "
                     f"{rnd['want']}")
            if rnd["hops"] != rnd["want_hops"]:
                fail(f"{tag}: sync_tree round '{name}' posted {rnd['hops']} "
                     f"ring hops on pod {pod['pod']}, its chunk grid "
                     f"{rnd['chunks']} asks for {rnd['want_hops']}")
            if rnd["err"] != pod["round"]["one_shot"]["err"]:
                fail(f"{tag}: residuals of the '{name}' plan differ from "
                     f"the one-shot's on pod {pod['pod']}")
            if rnd["agg"] != first["round"]["one_shot"]["agg"]:
                fail(f"{tag}: aggregate of the '{name}' plan on pod "
                     f"{pod['pod']} differs from pod 0's one-shot")
    for key, what in (("param_hashes", "parameters after delta_sync"),
                      ("agg_hashes", "all-rungs aggregate"),
                      ("losses", "pod-mean losses"), ("plan", "plans")):
        if any(pod[key] != first[key] for pod in pods[1:]):
            fail(f"{tag}: {what} differ across pods")
    if not first["param_hashes"] or not first["agg_hashes"]:
        fail(f"{tag}: nothing was hashed")
    if not first["round"]["k2"]["hops"] or not first["ringed"]:
        fail(f"{tag}: the forced 2-chunk plans posted no ring hop")
    launches = {k: sum(pod["launches"][k] for pod in pods)
                for k in first["launches"]}
    for kind in sorted(first["per_kind"]):
        for pod in pods:
            rows = pod["per_kind"][kind]
            ms = [round(r[0], 2) for r in rows]
            steady = rows[1:] or rows
            mean = sum(r[0] for r in steady) / len(steady)
            comm = sum(r[1] for r in steady) / len(steady)
            sync = sum(r[2] for r in steady) / len(steady)
            log(f"{tag}: pod {pod['pod']} {kind}: {len(rows)} steps, ms "
                f"{ms}; steady mean {mean:.2f} ms, of it transport "
                f"{comm:.2f} ms host time ({sync:.2f} ms waiting for the "
                f"card before the staged copies)")
    log_heartbeats(tag, pods)
    for kind, got, want, full, full_priced, pad in first["bytes"]:
        log(f"{tag}: {kind} moved {got} B (gather + ring) = plan_wire_bytes "
            f"of the gather rungs {want} B; FULL's reduce-scatter + "
            f"all-gather moved {full} B per pod, FullCodec.wire_bytes "
            f"prices {full_priced} B (a bf16 ring all-reduce; shard padding "
            f"allowed {pad} B)")
    for name, rnd in first["round"].items():
        log(f"{tag}: sync_tree round '{name}': chunk grid {rnd['chunks']}, "
            f"{rnd['hops']} ring hops, {rnd['bytes']} B = plan_wire_bytes, "
            f"{[round(p['round'][name]['ms'], 1) for p in pods]} ms per pod; "
            f"aggregate and residuals bit-identical to the one-shot plan's")
    if first["link"]:
        lk = first["link"]
        log(f"{tag}: pod link ({lk['backend']}, staged {lk['staged']}) "
            f"ping-pong one-way s {[f'{t:.6g}' for t in lk['one_way_s']]} "
            f"for {lk['sizes']} B; fit latency {lk['latency_s']:.6g} s, "
            f"rate {lk['rate_bytes_per_s']:.6g} B/s")
    log(f"{tag}: {first['layers']} layers, backend {first['backend']}, "
        f"losses {[round(x, 4) for x in first['losses']]}; "
        f"{len(first['param_hashes'])} delta_sync rounds and the "
        f"all-rungs aggregate bit-identical on {n_pods} pods; "
        f"{first['ringed']} ring hops in the training run's sync steps "
        f"(as their chunk grids ask); "
        f"training {[round(p['train_s'], 1) for p in pods]} s; peak memory "
        f"per pod {[round(p['peak'] / 2**30, 2) for p in pods]} GiB "
        f"(reserved {[round(p['reserved'] / 2**30, 2) for p in pods]}); "
        f"launches (all pods) {launches}; wall {wall:.1f} s")
    return launches, first["link"]


def multipod_phase(torch) -> dict:
    """Phase 7: the multi-pod main paths under the default ACESyncConfig
    (the chunked ring on the rungs the roofline rings), pods as processes
    sharing the card: P = 2 (global batch 8, 8 steps, 12 layers) and
    P = 3 (global batch 6, 4 steps, 8 layers), each with its all-rungs step and
    sync_tree round.  Returns each path's launch counts (all pods) and the
    pod link's measurement."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # pods share the card: let each one's cache grow in place instead of
    # holding fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    runs, link = {}, None
    for path, spec in PATHS.items():
        if spec.get("edge", 1) > 1:
            continue
        runs[path], got = multipod_run(spec)
        link = link or got
    r2, r3 = runs["p2"], runs["p3"]
    missing2 = [k for k in DECODE if r2[k] < 1 and not k.endswith("_fp")]
    missing3 = [k for k in DECODE if r3[k] < 1
                and (k.endswith("_fp") or k == "topk_scatter_accum")]
    ring = [k for k in FLAT if k != "dequant_int8"]
    missing = [k for k in (*KERNELS, *ring) if r2[k] < 1 or r3[k] < 1]
    if missing2 or missing3 or missing:
        fail(f"phase 7: kernels never launched: P=2 {missing2 + missing}, "
             f"P=3 {missing3 + missing}")
    return runs, link


# ---------------------------------------------------------------------------
# phase 8: the two-tier hierarchy
# ---------------------------------------------------------------------------

#: phase 8's sync_tree round: exec plans by (hier, ring) argument
HIER_PLANS = {"two_tier": (None, -1), "two_tier_ring": (None, 2),
              "flat": (-1, -1)}


def tier_logged(entries):
    """``(payload, full, intra)`` bytes of log entries: the fleet's and the
    cross tier's gathers and ring hops, their FULL sums, and everything
    the intra tier received."""
    cross = [x for x in entries if x["tier"] in ("fleet", "cross")]
    return (sum(x["bytes"] for x in cross if x["op"] in ("gather", "ring")),
            sum(x["bytes"] for x in cross if x["op"] == "full"),
            sum(x["bytes"] for x in entries if x["tier"] == "intra"))


def tier_grids(ep):
    """The executed tier grid(s) of a plan, one per backward segment."""
    return [list(h) for h in (ep.seg_hier if ep.segmented else (ep.hier,))]


def hier_round(group, trainer, state, batch, omega, out):
    """Phase 8's all-rungs sync_tree round, one member: the same gradients
    and residuals through the two-tier plan with its cross tier one-shot,
    forced to a 2-chunk ring, and the flat plan; per plan the hashes of
    aggregate and residuals and the bytes per tier, logged and priced."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core import planexec
    from repro_torch.core import sync as S

    plan = trainer.scheduler.plan_from_levels(list(ALL_RUNGS), omega)
    _, grads, _ = trainer._grad_step(state["params"], batch)
    errors = state["ace"].errors
    for name, (hier, ring) in HIER_PLANS.items():
        ep = planexec.build_exec_plan(
            plan, layout=trainer.leaf_layout, n_pods=group.size,
            n_edge=group.n_edge, hier=hier, ring=ring,
            segments=planexec.config_segments(trainer.run.acesync),
            device=group.device)
        log0 = len(group.log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg, new_e = S.sync_tree(grads, errors, ep, gamma=0.9, pods=group)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["round"][name] = {
            "agg": [int(bits_hash(torch, x)) for x in T.leaves(agg)],
            "err": [int(bits_hash(torch, x)) for x in T.leaves(new_e)],
            "logged": tier_logged(group.log[log0:]),
            "priced": tier_priced(ep, group.size, group.n_edge),
            "hier": tier_grids(ep), "ms": secs * 1e3}
        del agg, new_e
        torch.cuda.empty_cache()


def hier_pod_path(group, spec):
    """Phase 8, one fleet member (slot c * E + e of C clusters x E
    members): paper-350m at full width, ``spec["n_layers"]`` layers,
    through TrainSession under ``acesync_hier`` (the default config with
    ``replan_every=4``), one all-rungs grad_sync with the bf16 intra
    stage and one with the INT8 intra stage and the cross tier forced to
    a 2-chunk ring, and the all-rungs sync_tree round.  Returns this
    member's hashes, bytes per tier, times and launches."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.core import planexec
    from repro_torch.kernels import ops
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["paper-350m"], n_layers=spec["n_layers"])
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("session", 1024, spec["batch"],
                                      "train"),
                    total_steps=100, warmup_steps=2,
                    ckpt_dir=str(CKPT_ROOT / "phase8"),
                    acesync=ACESyncConfig(replan_every=4))
    sess = TrainSession(build_model(cfg, run, device=group.device), run,
                        strategy="acesync_hier", pods=group)
    cfg = sess.model.cfg
    trainer = sess.trainer
    step = trainer.step
    out = {"times": [], "param_hashes": [], "agg_hashes": [], "bytes": [],
           "round": {}}

    def timed(state, batch, plan, kind="grad_sync"):
        log0 = len(group.log)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = step(state, batch, plan, kind)
        e1.record()
        new = group.log[log0:]
        out["times"].append((kind, e0, e1, sum(x["seconds"] for x in new)))
        if kind in ("delta_sync", "grad_sync"):
            ep = trainer.exec_plan(plan)
            out["bytes"].append((kind, tier_logged(new),
                                 tier_priced(ep, group.size, group.n_edge),
                                 tier_grids(ep)))
        if kind == "delta_sync":
            out["param_hashes"].append(
                [int(bits_hash(torch, x)) for x in T.leaves(res[0]["params"])])
        return res

    trainer.step = timed
    sess.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group.barrier()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(spec["steps"], log_every=1 if group.rank == 0 else 0)
    update_rows = adamw.update_rows

    def hashed(p, g_rows, *a, **k):
        out["agg_hashes"].append(int(bits_hash(torch, g_rows)))
        return update_rows(p, g_rows, *a, **k)

    state = sess.state
    plan = trainer.scheduler.plan_from_levels(list(ALL_RUNGS),
                                              sess.loop.plan.omega)
    adamw.update_rows = hashed
    try:
        # all rungs: the bf16 intra stage, then the INT8 intra stage with
        # the cross tier forced to a 2-chunk ring
        for hier, ring in ((1, None), (2, 2)):
            ep = planexec.build_exec_plan(
                plan, layout=trainer.leaf_layout, n_pods=group.size,
                n_edge=group.n_edge, hier=hier,
                ring=planexec.ring_override(0) if ring is None else ring,
                segments=planexec.config_segments(trainer.run.acesync),
                device=group.device)
            state, metrics = trainer.step(state, next(sess.pipeline), ep,
                                          "grad_sync")
    finally:
        adamw.update_rows = update_rows
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    hier_round(group, trainer, state, next(sess.pipeline),
               sess.loop.plan.omega, out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    per_kind: dict = {}
    for kind, e0, e1, comm_s in out.pop("times"):
        per_kind.setdefault(kind, []).append((e0.elapsed_time(e1),
                                              comm_s * 1e3))
    return {
        "pod": group.rank, "backend": group.backend,
        "losses": sess.losses + [float(metrics["loss"])],
        "kinds": [k for h in sess.history for k in h["kinds"]],
        "finite": all(bool(torch.isfinite(x).all())
                      for x in T.leaves(state["params"])),
        "replans": sess.loop.device_replans, "launches": launches,
        "peak": torch.cuda.max_memory_allocated(),
        "reserved": torch.cuda.max_memory_reserved(), "wall": wall,
        "train_s": train_s, "per_kind": per_kind, "bytes": out["bytes"],
        "round": out["round"], "param_hashes": out["param_hashes"],
        "agg_hashes": out["agg_hashes"], "layers": cfg.n_layers,
        "width": (cfg.d_model, cfg.vocab_size),
        "plan": list(sess.loop.plan.level_idx),
        "tier_grid": list(sess.loop.plan.hier),
        "heartbeat_ms": [t * 1e3 for t in sess.loop.heartbeat_seconds]}


def check_tier_bytes(tag, logged, priced):
    """Gate one sync's bytes per tier: payload and INT8 intra bytes equal
    to the priced ones, the bf16 sums' within their shard padding."""
    pay, full, intra = logged
    w_pay, w_full, w_intra, fpad, ipad = priced
    if pay != w_pay:
        fail(f"{tag}: cross-tier payload bytes {pay}, priced {w_pay}")
    for what, got, want, pad in (("FULL", full, w_full, fpad),
                                 ("intra", intra, w_intra, ipad)):
        if not (got == want or 0 <= got - want < pad):
            fail(f"{tag}: {what} bytes {got}, priced {want} (shard padding "
                 f"below {pad})")


def hier_phase(torch):
    """Phase 8: the two-tier path, C = 2 clusters x E = 2 members as four
    processes sharing the card; checks what the members return and
    returns the launch counts (all members)."""
    from repro_torch.launch.mesh import spawn_pods
    spec = PATHS["hier"]
    n_pods, n_edge = spec["pods"], spec["edge"]
    tag = f"phase 8 ({n_pods // n_edge} x {n_edge})"
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pods = spawn_pods(hier_pod_path, n_pods, "cuda", args=(spec,),
                      n_edge=n_edge, timeout=900)
    wall = time.perf_counter() - t0
    first = pods[0]
    if first["width"] != (1024, 50304):
        fail(f"{tag}: not the full width: {first['width']}")
    if first["layers"] != spec["n_layers"]:
        fail(f"{tag}: ran {first['layers']} layers")
    if not any(first["tier_grid"]):
        fail(f"{tag}: the knapsack's plan has no two-tier rung: "
             f"{first['tier_grid']}")
    for pod in pods:
        p = pod["pod"]
        if not pod["finite"] or not all(math.isfinite(x)
                                        for x in pod["losses"]):
            fail(f"{tag}: non-finite loss or parameters on member {p}")
        if pod["kinds"].count("delta_sync") < spec["min_delta"]:
            fail(f"{tag}: only {pod['kinds'].count('delta_sync')} "
                 f"delta_sync rounds")
        if pod["replans"] < spec["min_replans"]:
            fail(f"{tag}: {pod['replans']} device replans applied")
        for i, (kind, logged, priced, grid) in enumerate(pod["bytes"]):
            check_tier_bytes(f"{tag}: member {p} sync step {i} ({kind})",
                             logged, priced)
        rnd = pod["round"]
        for name, r in rnd.items():
            check_tier_bytes(f"{tag}: member {p} round '{name}'",
                             r["logged"], r["priced"])
            if r["agg"] != first["round"][name]["agg"]:
                fail(f"{tag}: round '{name}' aggregate of member {p} "
                     f"differs from member 0's")
        for what in ("agg", "err"):
            if rnd["two_tier_ring"][what] != rnd["two_tier"][what]:
                fail(f"{tag}: member {p}: the cross tier's ring and "
                     f"one-shot {what} differ")
        cross = {n: r["logged"][0] + r["logged"][1] for n, r in rnd.items()}
        if not cross["two_tier"] < cross["flat"]:
            fail(f"{tag}: two-tier cross bytes {cross['two_tier']} not "
                 f"below the flat round's {cross['flat']}")
    for key, what in (("param_hashes", "parameters after delta_sync"),
                      ("agg_hashes", "all-rungs aggregates"),
                      ("losses", "fleet-mean losses"), ("plan", "plans")):
        if any(pod[key] != first[key] for pod in pods[1:]):
            fail(f"{tag}: {what} differ across members")
    if not first["param_hashes"] or not first["agg_hashes"]:
        fail(f"{tag}: nothing was hashed")
    launches = {k: sum(pod["launches"][k] for pod in pods)
                for k in first["launches"]}
    need = ("decode_accum_int8", "decode_accum_int4", "quantize_int8",
            "ef_int4", "gather_ef_sign", "sign_vote_accum_fp",
            "gather_ef_topk", "topk_scatter_accum")
    missing = [k for k in need if launches[k] < 1]
    if missing:
        fail(f"{tag}: kernels never launched: {missing}")
    for kind in sorted(first["per_kind"]):
        for pod in pods:
            rows = pod["per_kind"][kind]
            steady = rows[1:] or rows
            mean = sum(r[0] for r in steady) / len(steady)
            comm = sum(r[1] for r in steady) / len(steady)
            log(f"{tag}: member {pod['pod']} {kind}: {len(rows)} steps, ms "
                f"{[round(r[0], 2) for r in rows]}; steady mean "
                f"{mean:.2f} ms, of it transport {comm:.2f} ms host time")
    log_heartbeats(tag, pods, who="member")
    for kind, logged, priced, grid in first["bytes"]:
        log(f"{tag}: {kind}: tier grid {grid}; cross tier {logged[0]} B "
            f"payload + {logged[1]} B FULL (priced {priced[0]} + "
            f"{priced[1]}), intra {logged[2]} B (priced {priced[2]})")
    rnd = first["round"]
    for name, r in rnd.items():
        log(f"{tag}: sync_tree round '{name}': tier grid {r['hier']}; "
            f"cross {r['logged'][0] + r['logged'][1]} B, intra "
            f"{r['logged'][2]} B per member (priced {r['priced'][:3]}); "
            f"{[round(p['round'][name]['ms'], 1) for p in pods]} ms per "
            f"member")
    two = rnd["two_tier"]["logged"]
    flat = rnd["flat"]["logged"]
    log(f"{tag}: cross-tier bytes per member, two-tier {two[0] + two[1]} "
        f"against flat {flat[0] + flat[1]}: "
        f"{1 - (two[0] + two[1]) / (flat[0] + flat[1]):.2%} fewer; the "
        f"cross tier's ring and one-shot bit-identical")
    log(f"{tag}: {first['layers']} layers, backend {first['backend']}, "
        f"plan {first['plan']} tier grid {first['tier_grid']}, losses "
        f"{[round(x, 4) for x in first['losses']]}; "
        f"{len(first['param_hashes'])} delta_sync rounds and the all-rungs "
        f"aggregates bit-identical on {n_pods} members; training "
        f"{[round(p['train_s'], 1) for p in pods]} s; peak memory per "
        f"member {[round(p['peak'] / 2**30, 2) for p in pods]} GiB "
        f"(reserved {[round(p['reserved'] / 2**30, 2) for p in pods]}); "
        f"launches (all members) {launches}; wall {wall:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the fault-tolerant train loop
# ---------------------------------------------------------------------------


def _disk_check(tag, n_layers, rows):
    """Print the free space for checkpoints and fail when it is short of
    ``rows`` pod rows of a checkpoint of paper-350m at ``n_layers`` (five
    f32 copies of the parameters: params, m, v, anchor, EF residuals)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(ARCHS["paper-350m"],
                              n_layers=n_layers or ARCHS["paper-350m"].n_layers)
    model = build_model(cfg, RunConfig(model=cfg, shape=ShapeConfig(
        "session", 1024, 1, "train")), device="meta")
    need = rows * 5 * 4 * sum(p.numel() for p in model.parameters())
    free = float(shutil.disk_usage(CKPT_ROOT).free)
    log(f"{tag}: {free / 1e9:.1f} GB free on the checkpoint disk, "
        f"{need / 1e9:.1f} GB needed")
    if free < need:
        fail(f"{tag}: {free / 1e9:.1f} GB free for checkpoints, "
             f"{need / 1e9:.1f} GB needed")


def _host_state(torch, state):
    """Host copies of the leaves the restart gate compares."""
    from repro_torch import tree as T
    out = {k: [x.detach().to("cpu", copy=True) for x in T.leaves(state[k])]
           for k in ("params", "m", "v", "anchor")}
    out["errors"] = [x.to("cpu", copy=True)
                     for x in T.leaves(state["ace"].errors)]
    return out


def restart_pod_path(group, spec):
    """Phase 9a, in a process of its own (``RunConfig.deterministic``
    switches the whole process to deterministic algorithms and sets
    ``CUBLAS_WORKSPACE_CONFIG`` before cuBLAS first starts, so no other
    phase runs under them): run A, run B with the damage, and the
    restarted run; returns what the parent checks."""
    import gc
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ACESyncConfig, RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.session import TrainSession, apply_determinism
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import faults as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["paper-350m"], n_layers=spec["n_layers"])

    def session(d):
        # bit-identical replays need deterministic kernels: cuDNN
        # attention's backward is not, by default
        run = RunConfig(model=cfg, shape=ShapeConfig("session", 1024,
                                                     spec["batch"], "train"),
                        total_steps=100, warmup_steps=2, ckpt_dir=str(d),
                        ckpt_every=spec["ckpt_every"],
                        acesync=ACESyncConfig(replan_every=4),
                        deterministic=True)
        apply_determinism(run)
        return TrainSession(build_model(cfg, run, device="cuda"), run,
                            strategy="acesync", blocking_replans=True)

    def loop_state(sess):
        lp = sess.loop
        return (lp.plan.level_idx, lp.plan.sync_interval, lp._H,
                lp._steps_since_sync, sess.trainer.scheduler.sync_interval)

    root = Path(spec["dir"])
    dA, dB = root / "A", root / "B"
    out = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    a = session(dA)
    out["n_params"] = sum(p.numel() for p in a.model.parameters())
    a.run(spec["steps"], log_every=5)
    a.finish()
    out["save"] = dict(a.loop.ckpt.last_save)
    want = _host_state(torch, a.state)
    out["want_loop"] = loop_state(a)
    out["losses_a"] = a.losses
    del a
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(dA)
    b = session(dB)
    b.run(spec["steps"] - 1, log_every=0)
    b.finish()
    del b
    gc.collect()
    torch.cuda.empty_cache()
    last = (spec["steps"] - 1) // spec["ckpt_every"] * spec["ckpt_every"]
    d_last = dB / f"step_{last:08d}"
    os.makedirs(dB / "step_00000099.tmp")
    biggest = max(os.listdir(d_last),
                  key=lambda n: (d_last / n).stat().st_size)
    out.update(last=last, corrupted=F.corrupt_checkpoint_leaf(
        str(dB), int(biggest.split("_")[1].split(".")[0]), step=last))
    b2 = session(dB)
    t1 = time.perf_counter()
    b2.init()
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t1
    out["restored"] = int(b2.state["step"])
    out["corrupt"] = list(b2.loop.ckpt.corrupt_steps)
    b2.run(spec["steps"] - out["restored"], log_every=0)
    b2.finish()
    got = _host_state(torch, b2.state)
    out["bad"] = {k: [i for i, (x, y) in enumerate(zip(want[k], got[k]))
                      if not torch.equal(x, y)] for k in want}
    out["got_loop"] = loop_state(b2)
    out["losses_b"] = b2.losses
    out["step_b"] = int(b2.state["step"])
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    return out


def restart_phase(torch) -> tuple:
    """Phase 9a: restart-replay on one pod, paper-350m at full width and
    ``RESTART``'s 2 layers (phase 5's configuration cut in depth,
    ``ckpt_every`` 4), under ``RunConfig.deterministic``, in a process of
    its own.  Run A trains
    10 steps; run B trains 9 in a fresh directory, leaves a crashed
    writer's ``.tmp`` and
    bit-rots the newest checkpoint's largest leaf; a fresh TrainSession
    must restore step 4, record 8 as corrupt and train to step 10,
    bit-identical to run A.  Returns the launch counts of the three
    runs and run A's last save (bytes and seconds)."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    spec = dict(RESTART, dir=str(CKPT_ROOT / "restart"))
    tag = "phase 9a"
    # run B holds two checkpoints and writes a third beside them
    _disk_check(tag, spec["n_layers"], 3)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        (res,) = spawn_pods(restart_pod_path, 1, "cuda", args=(spec,),
                            timeout=900)
    finally:
        shutil.rmtree(spec["dir"], ignore_errors=True)
    last, restored, corrupt = res["last"], res["restored"], res["corrupt"]
    if not res["corrupted"]:
        fail(f"{tag}: nothing to corrupt in step {last}")
    if restored != last - spec["ckpt_every"] or last not in corrupt:
        fail(f"{tag}: restored step {restored} (corrupt {corrupt}); "
             f"expected {last - spec['ckpt_every']} with {last} corrupt")
    if res["step_b"] != spec["steps"]:
        fail(f"{tag}: the restarted run ended at step {res['step_b']}")
    for k, bad in res["bad"].items():
        if bad:
            fail(f"{tag}: {k} leaves {bad} differ from the uninterrupted "
                 f"run after restart-replay")
    if res["got_loop"] != res["want_loop"]:
        fail(f"{tag}: plan / H / steps_since_sync {res['got_loop']} differ "
             f"from the uninterrupted run's {res['want_loop']}")
    losses_a, losses_b = res["losses_a"], res["losses_b"]
    if not all(math.isfinite(x) for x in losses_a + losses_b):
        fail(f"{tag}: non-finite loss")
    if losses_b != losses_a[restored:]:
        fail(f"{tag}: the replayed losses {losses_b} differ from run A's "
             f"{losses_a[restored:]}")
    launches = res["launches"]
    if not any(launches[k] for k in KERNELS):
        fail(f"{tag}: no gather + EF encode kernel launched: {launches}")
    save = res["save"]
    gbs = save["bytes"] / save["write_s"] / 1e9
    log(f"{tag}: {res['n_params']} parameters, {save['bytes']} bytes per "
        f"checkpoint; save() of step {save['step']} {save['copy_s']:.3f} s "
        f"in the foreground (device -> host copy), background write "
        f"{save['write_s']:.3f} s ({gbs:.3f} GB/s to disk, fsync'd; of it "
        f"the CRC read-back {save['crc_s']:.3f} s); "
        f"restore {res['restore_s']:.3f} s (step {last} rejected by its "
        f"CRC, step {restored} verified and loaded)")
    log(f"{tag}: restored step {restored}, corrupt {corrupt}; params, m, "
        f"v, anchor and EF residuals bit-identical to the uninterrupted "
        f"run at step {spec['steps']}, plan {list(res['got_loop'][0])}, H "
        f"{res['got_loop'][2]}; losses {[round(x, 4) for x in losses_a]}; "
        f"launches {launches}; wall {res['wall']:.1f} s")
    return launches, save


def elastic_pod_path(group, spec):
    """Phase 9b, one pod process: paper-350m at full width,
    ``spec["n_layers"]`` layers, through TrainSession under the default
    ``ACESyncConfig`` (``replan_every`` 4) with pod ``spec["killed"]``
    preempted at step ``spec["kill"]`` and back at ``spec["rejoin"]``,
    checkpoints every ``spec["ckpt_every"]`` steps; then pods 0 and 1
    restore the last checkpoint (written by three pods) as a P = 2
    fleet.  Returns this pod's per-step records, hashes, bytes, times and
    launches."""
    import torch
    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.core.trainer import Trainer
    from repro_torch.kernels import ops
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.faults import FaultSchedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["paper-350m"], n_layers=spec["n_layers"])
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("session", 1024, spec["batch"],
                                      "train"),
                    total_steps=100, warmup_steps=2, ckpt_dir=spec["dir"],
                    ckpt_every=spec["ckpt_every"],
                    acesync=ACESyncConfig(replan_every=4))
    sess = TrainSession(
        build_model(cfg, run, device=group.device), run, strategy="acesync",
        pods=group, fault_schedule=FaultSchedule.preempt_and_rejoin(
            spec["killed"], spec["kill"], spec["rejoin"]))
    loop = sess.loop
    out = {"steps": [], "events_t": [], "saved": {}, "rejoin": None}
    real_step = Trainer.step

    def step(tr, state, batch, plan, kind="grad_sync"):
        since = len(group.log)
        res = real_step(tr, state, batch, plan, kind)
        rec = {"step": loop._host_step, "P": tr.n_pods, "kind": kind,
               "batch": loop._pipeline.shape.global_batch,
               "rows": list(loop._pipeline.rows),
               "omega": [float(w) for w in plan.omega],
               "levels": list(plan.level_idx)}
        if kind == "delta_sync":
            ep = tr.exec_plan(plan)
            new = group.log[since:]
            pay, full, _, pad, _ = tier_priced(ep, tr.n_pods, 1)
            rec["bytes"] = (sum(x["bytes"] for x in new
                                if x["op"] in ("gather", "ring")), pay,
                            sum(x["bytes"] for x in new
                                if x["op"] == "full"), full, pad)
            rec["hashes"] = [int(bits_hash(torch, x))
                             for x in T.leaves(res[0]["params"])]
        if not any(r["P"] == tr.n_pods for r in out["steps"][-1:]):
            # the first step at a new pod count: its end, for the
            # transition's seconds
            torch.cuda.synchronize()
            rec["t_end"] = time.perf_counter()
        out["steps"].append(rec)
        return res

    Trainer.step = step
    begin = loop._begin_transition

    def stamped(n_new):
        out["events_t"].append((loop._host_step, time.perf_counter()))
        return begin(n_new)

    loop._begin_transition = stamped
    transfer = loop._transfer_state

    def hashed_transfer(state, tr, grp, joining):
        new = transfer(state, tr, grp, joining)
        if joining and new is not None:
            # every leaf right after the rejoin: the rejoining pod must
            # hold rank 0's state bit for bit
            out["rejoin"] = [int(bits_hash(torch, x)) for _, x in
                             T.reference_leaves_with_path(new)]
        return new

    loop._transfer_state = hashed_transfer
    save = loop.ckpt.save

    def hashed_save(step_no, state, extras=None, blocking=False):
        out["saved"][step_no] = [int(bits_hash(torch, x)) for _, x in
                                 T.reference_leaves_with_path(state)]
        return save(step_no, state, extras=extras, blocking=blocking)

    loop.ckpt.save = hashed_save
    sess.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group.barrier()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(spec["steps"], log_every=1 if group.rank == 0 else 0)
    sess.finish()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    save_stats = dict(loop.ckpt.last_save)
    finite = all(bool(torch.isfinite(x).all())
                 for x in T.leaves(sess.state["params"]))
    # the last checkpoint (three pods' rows) restored as a P = 2 fleet
    last = spec["steps"] // spec["ckpt_every"] * spec["ckpt_every"]
    sub = group.regroup([0, 1])
    restored = None
    if sub is not None:
        t1 = time.perf_counter()
        state, _ = Checkpointer(spec["dir"], pods=sub).restore(
            loop._trainer_for(sub).init_state(run.seed))
        torch.cuda.synchronize()
        restored = {"seconds": time.perf_counter() - t1,
                    "hashes": [int(bits_hash(torch, x)) for _, x in
                               T.reference_leaves_with_path(state)],
                    "step": int(state["step"])}
        del state
    group.barrier()
    return {"pod": group.rank, "steps": out["steps"],
            "events": [(e["step"], e["n_pods"], e["members"], e["seconds"])
                       for e in loop.membership_events],
            "events_t": out["events_t"], "losses": sess.losses,
            "finite": finite, "launches": launches, "train_s": train_s,
            "peak": torch.cuda.max_memory_allocated(),
            "saved": out["saved"], "last": last, "restored": restored,
            "save": save_stats, "pod_times": loop.pod_step_times,
            "heartbeat_ms": [t * 1e3 for t in loop.heartbeat_seconds],
            "rejoin": out["rejoin"],
            "layers": cfg.n_layers, "width": (cfg.d_model, cfg.vocab_size)}


def elastic_phase(torch) -> dict:
    """Phase 9b: elastic membership P = 3 -> 2 -> 3, three pod processes
    sharing the card; checks what the pods return and returns the launch
    counts (all pods)."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerDetector)
    spec = dict(ELASTIC, dir=str(CKPT_ROOT / "elastic"))
    tag = "phase 9b"
    # a checkpoint at P = 2 and one at P = 3
    _disk_check(tag, spec["n_layers"], 2 + spec["pods"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        pods = spawn_pods(elastic_pod_path, spec["pods"], "cuda",
                          args=(spec,), timeout=900)
    finally:
        shutil.rmtree(spec["dir"], ignore_errors=True)
    wall = time.perf_counter() - t0
    first = pods[0]
    if first["width"] != (1024, 50304) or first["layers"] != spec["n_layers"]:
        fail(f"{tag}: ran {first['layers']} layers at {first['width']}")
    kill, rejoin, killed = spec["kill"], spec["rejoin"], spec["killed"]
    want_events = [(kill, 2), (rejoin, 3)]
    for pod in pods:
        p = pod["pod"]
        ev = [e[:2] for e in pod["events"]]
        if ev != (want_events if p != killed else want_events[1:]):
            fail(f"{tag}: pod {p} membership events {pod['events']}")
        if not pod["finite"] or not all(math.isfinite(x)
                                        for x in pod["losses"]):
            fail(f"{tag}: non-finite loss or parameters on pod {p}")
        for rec in pod["steps"]:
            if rec["batch"] != 2 * rec["P"]:
                fail(f"{tag}: global batch {rec['batch']} at P = "
                     f"{rec['P']} (step {rec['step']})")
            if "bytes" in rec:
                got, pay, full, priced, pad = rec["bytes"]
                if got != pay or not (0 <= full - priced < pad
                                      or full == priced):
                    fail(f"{tag}: pod {p} moved {got} B (gather + ring) and "
                         f"{full} B FULL in the delta_sync of step "
                         f"{rec['step']} at P = {rec['P']}; plan_wire_bytes "
                         f"{pay}, FullCodec.wire_bytes {priced} (+{pad})")
        if p == killed and any(r["P"] == 2 for r in pod["steps"]):
            fail(f"{tag}: the preempted pod stepped while preempted")
    trajectory = [r["P"] for r in first["steps"]]
    if sorted(set(trajectory)) != [2, 3]:
        fail(f"{tag}: pod counts {trajectory}")
    # the rejoin's state transfer: every leaf of the rejoining pod (m, v,
    # anchor and EF residuals too, which the next delta_sync would not
    # equalise) bit-identical to rank 0's
    joined = pods[killed]["rejoin"]
    if not joined or joined != first["rejoin"]:
        fail(f"{tag}: the rejoining pod's state differs from pod 0's "
             f"right after the rejoin ({joined and len(joined)} leaves)")
    # every live pod: the same plan and omega at each step, the same
    # parameters after each delta_sync
    for pod in pods[1:]:
        for rec in pod["steps"]:
            same = [r for r in first["steps"] if r["step"] == rec["step"]
                    and r["kind"] == rec["kind"]]
            if not same:
                fail(f"{tag}: pod {pod['pod']} stepped alone at step "
                     f"{rec['step']}")
            ref = same[0]
            for key in ("omega", "levels", "P", "hashes"):
                if rec.get(key) != ref.get(key):
                    fail(f"{tag}: {key} of pod {pod['pod']} differ from pod "
                         f"0's at step {rec['step']} ({rec['kind']})")
    if first["losses"] != pods[1]["losses"]:
        fail(f"{tag}: pod-mean losses differ across pods")
    n_delta = {P: sum(1 for r in first["steps"] if "bytes" in r
                      and r["P"] == P) for P in (2, 3)}
    if not all(n_delta.values()):
        fail(f"{tag}: delta_sync rounds per pod count {n_delta}")
    last = first["last"]
    for p in (0, 1):
        res = pods[p]["restored"]
        if res is None or res["hashes"] != pods[p]["saved"][last]:
            fail(f"{tag}: pod {p}'s restore of step {last} as a P = 2 fleet "
                 f"differs from the rows it wrote")
    launches = {k: sum(pod["launches"][k] for pod in pods)
                for k in first["launches"]}
    enc = [k for k in (*KERNELS, *FLAT) if launches[k]]
    dec = [k for k in DECODE if launches[k]]
    if not enc or not dec:
        fail(f"{tag}: no encode ({enc}) or decode ({dec}) kernel launched")
    # the transitions' seconds: the event to the end of the first step at
    # the new pod count, on each pod that steps there
    for pod in pods:
        for step_no, t_ev in pod["events_t"]:
            after = [r for r in pod["steps"] if "t_end" in r
                     and r["step"] >= step_no]
            if after and any(e[0] == step_no for e in pod["events"]):
                log(f"{tag}: pod {pod['pod']}: membership event at step "
                    f"{step_no} -> end of the first step at P = "
                    f"{after[0]['P']}: {after[0]['t_end'] - t_ev:.3f} s "
                    f"(swap {[round(e[3], 3) for e in pod['events']]} s)")
    # what the straggler rule would say of the pods' own step times
    mon = HeartbeatMonitor(spec["pods"], timeout_s=1e9)
    for row in first["pod_times"]:
        for p, dt in enumerate(row):
            if math.isfinite(dt):
                mon.beat(p, dt, now=0.0)
    det = StragglerDetector()
    med = {p: sorted(s.step_times)[len(s.step_times) // 2]
           for p, s in mon.pods.items()}
    log(f"{tag}: pods' median step seconds {med}; straggle factors of "
        f"those times {det.straggle_factors(mon)}, flagged "
        f"{det.stragglers(mon)} (the loop beats every pod with the first "
        f"live pod's time)")
    log_heartbeats(tag, pods)
    for pod in pods:
        sv = pod["save"]
        res = pod["restored"]
        log(f"{tag}: pod {pod['pod']}: last save (step {sv.get('step')}) "
            f"{sv.get('bytes')} B over the fleet, {sv.get('copy_s', 0):.3f} "
            f"s foreground, {sv.get('write_s', 0):.3f} s background"
            + (f"; P = 2 restore of step {res['step']} {res['seconds']:.3f} "
               f"s" if res else "")
            + f"; peak memory {pod['peak'] / 2**30:.2f} GiB")
    log(f"{tag}: {first['layers']} layers, pod counts per step "
        f"{trajectory}, global batch {[r['batch'] for r in first['steps']]};"
        f" bytes = plan_wire_bytes in {n_delta} delta_sync rounds at "
        f"P = 2 / 3, parameters bit-identical on the live pods after each; "
        f"the rejoining pod's {len(first['rejoin'])} state leaves "
        f"bit-identical to pod 0's at the rejoin; "
        f"losses {[round(x, 4) for x in first['losses']]}; launches (all "
        f"pods) {launches}; training "
        f"{[round(p['train_s'], 1) for p in pods]} s; wall {wall:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 10: serving the dense zoo
# ---------------------------------------------------------------------------

#: phase 10's models at full published width and depth; (a) serves four
#: requests of these prompt lengths (left-padded to the longest) in one
#: server batch of 4, 32 new tokens each
SERVE_ARCHS = ("paper-350m", "qwen3-8b", "gemma2-9b")
SERVE_A = {"prompts": (512, 384, 200, 512), "new": 32, "batch": 4}
#: (b), gemma2-9b only: one prompt longer than the 4,096 window (a
#: multiple of 2,048, so the reference's chunking accepts it): the local
#: slots' ring wraps in prefill and again in decode
SERVE_B = {"prompts": (6144,), "new": 16, "batch": 1}
#: gate 2: teacher-forced decode steps, held to one full forward within
#: the reference test's rtol = atol
TF_STEPS = 16
TF_TOL = 0.15
#: gate 2's forward over 6,144 + 16 tokens: 6,160 is no multiple of the
#: default 2,048 / 1,024 chunks, so it runs in 5 x 5 chunks of 1,232
TF_CHUNK = 1232
#: gate 3 (SMOKE configs, card against CPU from the same weights): f32
#: logits within 1e-4 relative (atol 1e-4 x the largest magnitude) and
#: equal greedy tokens; bf16 prefill logits within 3e-2 relative norm
SMOKE_F32_RTOL = 1e-4
SMOKE_BF16_REL = 3e-2
#: gates 2 and 3 for the MoE family, routed as the run held against
#: (``ReplayRoutes``): the two runs' router logits agree within this
#: share of their largest magnitude (the bf16 bound of the CPU parity
#: tests)
ROUTE_GAP_REL = 3e-2
BF16_DENSE_FLOPS = 989e12           # H100 SXM datasheet, dense bf16


def _timed(torch, fn, log_to):
    """``fn`` with a CUDA event pair around each call (read after the
    run), and its logits' finiteness ANDed on the card."""
    def f(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        logits, caches = fn(*a, **kw)
        e1.record()
        log_to["events"].append((e0, e1))
        log_to["finite"] = log_to["finite"] & torch.isfinite(logits).all()
        return logits, caches
    return f


def serve_workload(torch, np, tserve, model, spec):
    """Serve ``spec``'s requests twice, the first run cold (the process's
    first launches of each kernel); returns gate 1's checks over both and
    each run's timings."""
    cold = serve_once(torch, np, tserve, model, spec)
    warm = serve_once(torch, np, tserve, model, spec)
    warm["cold"] = {k: cold[k] for k in ("prefill_ms", "decode_ms",
                                         "tok_per_s")}
    warm["tokens_ok"] += cold["tokens_ok"]
    warm["finite"] = warm["finite"] and cold["finite"]
    return warm


def serve_once(torch, np, tserve, model, spec):
    """Serve ``spec``'s requests once; returns gate 1's checks and the
    timings.  A model sharded over a mesh (``model.ctx``) is served as
    one rank of it: its own weights, caches and peak memory, the decode
    bound per card, the prefill's share of the mesh's cards' peak, at N
    from the config."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import flops
    cfg, ctx = model.cfg, model.ctx
    B, new = spec["batch"], spec["new"]
    S = max(spec["prompts"])
    reqs = tserve.make_requests(spec["prompts"], spec["new"], cfg.vocab_size)
    # the ring holds a VLM's patches too
    P = model.n_prefix
    server = tserve.Server(model, P + S + new, B)
    pre = {"events": [], "finite": torch.ones((), dtype=torch.bool,
                                              device=model.device)}
    dec = {"events": [], "finite": pre["finite"].clone()}
    real_pre, real_dec = model.prefill, model.decode_step
    model.prefill = _timed(torch, real_pre, pre)
    model.decode_step = _timed(torch, real_dec, dec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        done = server.serve(reqs)
        torch.cuda.synchronize()
    finally:
        model.prefill, model.decode_step = real_pre, real_dec
    wall = time.perf_counter() - t0
    (p0, p1), = pre["events"]
    dms = sorted(a.elapsed_time(b) for a, b in dec["events"])
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    # the encoder-decoder's cross K/V: the served prompt's frames
    frames = ({"F": model.frames_len(S)} if cfg.family == "encdec" else {})
    cache = model.init_cache(B, P + S + new, **frames)
    kv_bytes = sum(flops.cache_bytes(cache))
    step_bytes = flops.decode_step_bytes(weight_bytes, cache)
    del cache
    prefill_ms = p0.elapsed_time(p1)
    shape = ShapeConfig("serve", P + S, B, "prefill")
    fl = flops.model_flops(cfg, shape, n=None if ctx else
                           model.active_param_count())
    cards = ctx.D * ctx.M if ctx else 1
    n_tok = sum(len(r.out_tokens) for r in done)
    return {
        "tokens": [r.out_tokens for r in done], "cards": cards,
        "prefill_executed": flops.executed_flops(cfg, shape),
        "tokens_ok": [len(r.out_tokens) == r.max_new_tokens for r in done],
        "finite": bool(pre["finite"]) and bool(dec["finite"]),
        "batch": B, "prompt": S, "new": new, "n_requests": len(done),
        "weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
        "prefill_ms": prefill_ms, "prefill_flops": fl,
        "prefill_share": fl / (prefill_ms * 1e-3) / BF16_DENSE_FLOPS / cards,
        "decode_ms": (dms[len(dms) // 2], dms[0], dms[-1]),
        "decode_steps": len(dms),
        "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "tok_per_s": n_tok / wall, "wall_s": wall,
        "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}


def tf_decode(torch, np, model, prompt, seed):
    """Prefill ``prompt``, then feed the next ``TF_STEPS`` tokens (drawn
    from ``seed``) to ``decode_step`` one by one; returns (the whole
    sequence (1, n + TF_STEPS) on the card, the steps' logits f32)."""
    V = model.cfg.vocab_size
    rng = np.random.RandomState(seed)
    seq = np.concatenate([prompt, rng.randint(0, V, size=TF_STEPS)
                          .astype(np.int32)])[None]
    n = prompt.size
    toks = torch.from_numpy(seq).to(model.device)
    with torch.inference_mode():
        _, caches = model.prefill(toks[:, :n], n + TF_STEPS)
        steps = []
        for i in range(TF_STEPS):
            logits, caches = model.decode_step(caches, n + i,
                                               toks[:, n + i:n + i + 1])
            steps.append(logits[0, 0])
        del caches
        return toks, torch.stack(steps).float()


def tf_forward(torch, model, toks, n):
    """``lm_logits`` of one full forward over ``toks``, at positions
    ``n`` onwards only (f32)."""
    from repro_torch.models.layers import check_chunks
    with torch.inference_mode():
        saved = model.q_chunk, model.kv_chunk
        try:
            check_chunks(toks.shape[1], toks.shape[1], *saved)
        except ValueError:
            model.q_chunk = model.kv_chunk = TF_CHUNK
        try:
            x = model(toks)[:, n:]
        finally:
            model.q_chunk, model.kv_chunk = saved
        return model.logits(x)[0].float()


def tf_compare(got, want, V, n_tokens, tol=TF_TOL):
    """Gate 2's verdict: ``got`` within rtol = atol = ``tol`` of
    ``want``."""
    diff = (got - want).abs()
    ok = bool((diff <= tol + tol * want.abs()).all())
    agree = (got[:, :V].argmax(-1) == want[:, :V].argmax(-1)).float().mean()
    return {"tokens": n_tokens, "steps": TF_STEPS, "ok": ok, "tol": tol,
            "max_abs_diff": float(diff.max()),
            "worst_excess": float((diff - tol * want.abs()).max()),
            "argmax_agree": float(agree)}


def teacher_forced(torch, np, model, prompt, seed):
    """Gate 2: prefill ``prompt``, then feed the next ``TF_STEPS`` tokens
    to ``decode_step`` one by one, against ``lm_logits`` of one full
    forward over the whole sequence at those positions only."""
    toks, got = tf_decode(torch, np, model, prompt, seed)
    return tf_compare(got, tf_forward(torch, model, toks, prompt.size),
                      model.cfg.vocab_size, toks.shape[1])


def smoke_card_vs_cpu(torch, np, tserve, arch, dev):
    """Gate 3: ``arch``'s SMOKE config served on the card and on the CPU
    from the same weights: f32 logits (every step) and greedy tokens,
    and bf16 prefill logits.  A MoE config's bf16 prefill on the card is
    routed as the CPU's routed (``ReplayRoutes``), the two router logits
    within ``ROUTE_GAP_REL``: the devices round apart, which swaps an
    expert at a near-tie (see ``moe_teacher_forced``)."""
    import copy
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models import moe
    spec = {"prompts": (40, 33, 17, 40), "new": 8, "batch": 4}
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = SMOKE_ARCHS[arch]
        wdt = torch.float32 if dtype == "float32" else torch.bfloat16
        cfg = dataclasses.replace(cfg, dtype=dtype)
        host = tserve.init_model(cfg, "cpu", seed=1, dtype=wdt)
        card = copy.deepcopy(host).to(dev)
        card.device = torch.device(dev)
        replay = dtype == "bfloat16" and cfg.family == "moe"
        host_calls = []
        real_dispatch, recorded = recording_dispatch(moe, host_calls)
        real_route, routes = moe.route, None
        runs = []
        for model in (host, card):
            if replay and model is host:
                moe.dispatch = recorded
            elif replay:
                # the prefill's dispatches come first, one a layer
                moe.route = routes = ReplayRoutes(
                    real_route, [c[:2] for c in host_calls[:cfg.n_layers]])
            logs = []
            real_pre, real_dec = model.prefill, model.decode_step

            def rec(fn):
                def f(*a, **kw):
                    logits, caches = fn(*a, **kw)
                    logs.append(logits.float().cpu())
                    return logits, caches
                return f
            model.prefill, model.decode_step = rec(real_pre), rec(real_dec)
            reqs = tserve.make_requests(spec["prompts"], spec["new"],
                                        cfg.vocab_size, seed=2)
            try:
                done = tserve.Server(model, 48 + model.n_prefix, 4).serve(reqs)
            finally:
                model.prefill, model.decode_step = real_pre, real_dec
                moe.dispatch, moe.route = real_dispatch, real_route
            runs.append(([r.out_tokens for r in done], logs))
        (th, lh), (tc, lc) = runs
        if dtype == "float32" and host.float_inputs:
            # the Server feeds zero frames / patches: hold a prefill with
            # seeded non-zero ones too (zero frames make the encoder's
            # output exactly 0)
            inputs = seeded_inputs(torch, host, 4, 40, seed=3)
            toks = torch.from_numpy(np.random.RandomState(4).randint(
                0, cfg.vocab_size, size=(4, 40)).astype(np.int32))
            for model, logs in ((host, lh), (card, lc)):
                with torch.inference_mode():
                    logits, _ = model.prefill(
                        toks.to(model.device), 48 + model.n_prefix,
                        **{k: v.to(model.device) for k, v in inputs.items()})
                logs.append(logits.float().cpu())
        if dtype == "float32":
            err = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(lc, lh))
            out[dtype] = {"tokens_equal": tc == th, "max_rel": err,
                          "ok": (tc == th and err <= SMOKE_F32_RTOL
                                 and len(lc) == len(lh))}
        else:
            a, b = lc[0], lh[0]
            err = float((a - b).norm() / b.norm())
            out[dtype] = {"prefill_rel": err, "ok": err < SMOKE_BF16_REL}
            if replay:
                gap = max(routes.gaps)
                out[dtype]["route_gap_rel"] = gap
                out[dtype]["ok"] &= (len(routes.gaps) == cfg.n_layers
                                     and gap <= ROUTE_GAP_REL)
    return out


def serve_path(group, spec):
    """Phase 10, in a process of its own (its peak memory is its own):
    each model at full width, served, gate 2 where asked, then gate 3
    on the SMOKE configs; the kernels' launch counts over the whole
    phase.  ``spec["device"]`` is the card (``"cuda"``)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    out = {"models": {}, "smoke": {}}
    for arch in SERVE_ARCHS:
        t0 = time.perf_counter()
        model = tserve.init_model(ARCHS[arch], spec["device"], seed=0)
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0,
               "n_params": sum(p.numel() for p in model.parameters()),
               "a": serve_workload(torch, np, tserve, model, SERVE_A)}
        if arch == "paper-350m":
            prompt = tserve.make_requests(SERVE_A["prompts"], 0,
                                          model.cfg.vocab_size)[0].prompt
            res["tf"] = teacher_forced(torch, np, model, prompt, seed=1)
        if arch == "gemma2-9b":
            res["b"] = serve_workload(torch, np, tserve, model, SERVE_B)
            prompt = tserve.make_requests(SERVE_B["prompts"], 0,
                                          model.cfg.vocab_size)[0].prompt
            res["tf"] = teacher_forced(torch, np, model, prompt, seed=1)
        out["models"][arch] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in SERVE_ARCHS:
        out["smoke"][arch] = smoke_card_vs_cpu(torch, np, tserve, arch,
                                               spec["device"])
    out["launches"] = ops.launch_counts()
    return out


def serve_phase(torch, card) -> None:
    """Phase 10: paper-350m, qwen3-8b and gemma2-9b served at full width
    and depth from seeded bf16 weights (a process of its own), and the
    four gates."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    tag = "phase 10"
    gc.collect()
    torch.cuda.empty_cache()
    (res,) = spawn_pods(serve_path, 1, "cuda", args=({"device": "cuda"},),
                        timeout=600)
    for arch, r in res["models"].items():
        for wl in ("a", "b"):
            if wl in r:
                check_served(tag, card, arch, r, wl)
        if "tf" in r:
            check_teacher_forced(tag, arch, r["tf"])
    check_smoke_and_launches(tag, res)


def check_served(tag, card, arch, r, wl) -> None:
    """Gate 1 on ``arch``'s workload ``wl``, and its timings' line."""
    w = r[wl]
    if not all(w["tokens_ok"]) or not w["finite"]:
        fail(f"{tag}: {arch} ({wl}): tokens per request "
             f"{w['tokens_ok']}, logits finite {w['finite']}")
    med, lo, hi = w["decode_ms"]
    log(f"{tag}: {arch} ({wl}) on {card}: {r['n_params']} "
        f"parameters, {w['weight_bytes']} bf16 weight bytes; "
        f"batch {w['batch']} x prompt {w['prompt']}, {w['new']} new "
        f"tokens; prefill {w['prefill_ms']:.3f} ms "
        f"({w['prefill_share']:.6g} of 989 TFLOP/s at 2*N*tokens "
        f"= {w['prefill_flops']:.4g}); decode step ms median "
        f"{med:.3f} min {lo:.3f} max {hi:.3f} over "
        f"{w['decode_steps']} steps, bound {w['decode_bound_ms']:.6g}"
        f" ms (weights + {w['kv_bytes']} cache bytes, recurrent states "
        f"read and written, at 3.35 TB/s); "
        f"{w['tok_per_s']:.2f} generated tokens/s "
        f"({w['wall_s']:.3f} s); peak {w['peak_alloc_gib']:.3f} GiB "
        f"allocated, {w['peak_reserved_gib']:.3f} GiB reserved; "
        f"init {r['init_s']:.2f} s; the cold first run before it: "
        f"prefill {w['cold']['prefill_ms']:.3f} ms, decode step "
        f"median {w['cold']['decode_ms'][0]:.3f} ms, "
        f"{w['cold']['tok_per_s']:.2f} tokens/s")


def check_teacher_forced(tag, arch, tf) -> None:
    """Gate 2's line, and its verdict."""
    log(f"{tag}: {arch} teacher-forced {tf['steps']} decode steps "
        f"at {tf['tokens']} tokens against one forward: max |diff| "
        f"{tf['max_abs_diff']:.4g}, argmax agrees on "
        f"{tf['argmax_agree']:.4f} of positions (rtol = atol = "
        f"{tf['tol']}; worst excess over rtol {tf['worst_excess']:.4g})")
    if not tf["ok"]:
        fail(f"{tag}: {arch}: teacher-forced decode differs from "
             f"the forward beyond rtol = atol = {tf['tol']} (worst "
             f"excess {tf['worst_excess']:.4g}; router logits apart by "
             f"{tf.get('route_gap_rel', 0.0):.4g} of their largest, at "
             f"most {ROUTE_GAP_REL})")


def check_smoke_and_launches(tag, res) -> None:
    """Gates 3 (SMOKE configs, card against CPU) and 4 (no ACE-Sync
    kernel launched while serving)."""
    for arch, r in res["smoke"].items():
        f32, bf = r["float32"], r["bfloat16"]
        routed = ("" if "route_gap_rel" not in bf else
                  f", routed as on the CPU, router logits within "
                  f"{bf['route_gap_rel']:.3g} (<= {ROUTE_GAP_REL})")
        log(f"{tag}: {arch} SMOKE card vs CPU: f32 tokens equal "
            f"{f32['tokens_equal']}, logits max rel {f32['max_rel']:.3g} "
            f"(<= {SMOKE_F32_RTOL}); bf16 prefill logits rel "
            f"{bf['prefill_rel']:.3g} (< {SMOKE_BF16_REL}){routed}")
        if not (f32["ok"] and bf["ok"]):
            fail(f"{tag}: {arch} SMOKE config differs between card and "
                 f"CPU: {r}")
    launched = {k: n for k, n in res["launches"].items() if n}
    if launched:
        fail(f"{tag}: serving launched ACE-Sync kernels: {launched}")
    log(f"{tag}: K1-K16 launched 0 times")


# ---------------------------------------------------------------------------
# phase 11: serving the MoE family
# ---------------------------------------------------------------------------

#: phase 11's models at full published width: depth None is the published
#: one; dbrx-132b is cut to 8 of its 40 layers (262 GB of bf16 weights at
#: 40 do not fit one card; phase 17 serves them across four)
MOE_SERVE = {"qwen3-moe-30b-a3b": None, "dbrx-132b": 8}


def recording_dispatch(moe, log_to):
    """``moe.dispatch`` with each call's (router logits, eidx, pos_c, C)
    appended to ``log_to``; install it as ``moe.dispatch`` and put the
    returned real one back after."""
    real = moe.dispatch

    def f(xf, logits, cfg, C):
        out = real(xf, logits, cfg, C)
        log_to.append((logits, out[1], out[2], C))
        return out
    return real, f


class ReplayRoutes:
    """A ``moe.route`` that replays recorded routes in order: each call
    takes the next recorded (router logits, eidx) pair's experts, with
    gates from its own logits, and records how far its router logits lie
    from the recorded ones, as a share of their largest magnitude; once
    the records run out it routes by itself (``real``)."""

    def __init__(self, real, records):
        self.real, self.records, self.gaps = real, list(records), []

    def __call__(self, logits, k):
        if not self.records:
            return self.real(logits, k)
        lg, e = (t.to(logits.device) for t in self.records.pop(0))
        self.gaps.append(float((logits - lg).abs().max() / lg.abs().max()))
        return logits.gather(1, e).softmax(dim=-1), e


def routing_stats(torch, np, model, spec):
    """Untimed: one prefill of ``spec``'s padded batch and one decode step
    after it, their dispatches recorded.  Returns the share of (token, k)
    pairs the prefill dropped (pads included), the experts each decode
    layer routes to, and the decode step's routed bound: the weights
    that are not experts, the experts routed to and the ring caches, at
    3.35 TB/s."""
    from repro_torch.launch import serve as tserve
    from repro_torch.models import moe
    cfg = model.cfg
    B, S = spec["batch"], max(spec["prompts"])
    toks = np.zeros((B, S), np.int32)
    for j, r in enumerate(tserve.make_requests(spec["prompts"], 0,
                                               cfg.vocab_size)):
        toks[j, S - len(r.prompt):] = r.prompt
    pre, dec = [], []
    real, rec_pre = recording_dispatch(moe, pre)
    rec_dec = recording_dispatch(moe, dec)[1]
    moe.dispatch = rec_pre
    try:
        with torch.inference_mode():
            logits, caches = model.prefill(
                torch.from_numpy(toks).to(model.device), S + spec["new"])
            nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
            moe.dispatch = rec_dec
            model.decode_step(caches, S, nxt)
    finally:
        moe.dispatch = real
    dropped = sum(int((p == C).sum()) for _, _, p, C in pre)
    pairs = sum(p.numel() for _, _, p, _ in pre)
    touched = [int(torch.unique(e).numel()) for _, e, _, _ in dec]
    w = model.blocks["slot0"].ffn["w_gate"]
    expert_bytes = 3 * cfg.d_model * cfg.d_ff * w.element_size()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    kv_bytes = sum(t.numel() * t.element_size()
                   for kv in caches.values() for t in kv.values())
    routed = (weight_bytes - cfg.n_layers * cfg.n_experts * expert_bytes
              + sum(touched) * expert_bytes + kv_bytes)
    return {"prefill_dropped": dropped / pairs, "prefill_pairs": pairs,
            "prefill_capacity": pre[0][3], "decode_capacity": dec[0][3],
            "touched": touched,
            "routed_bound_ms": routed / HBM_BYTES_PER_S * 1e3}


def moe_teacher_forced(torch, np, model, prompt, seed, dtype=None):
    """Gate 2 for a MoE model, at capacity factor E / K (C >= T in the
    prefill, every decode step and the forward: nothing drops on either
    side) and, where ``dtype`` is given, in that compute dtype (the bf16
    weights cast at use); both restored after.

    The router's top-k is a discontinuous choice: where the roundings,
    which decode and forward place differently, move two logits across
    a near-tie, an expert swaps, the token's FFN output changes by O(1),
    and every later layer sees it.  So the decode steps are held to a
    forward routed as the prefill and the decode steps routed (its gates
    from its own logits), and the two runs' router logits to within
    ``ROUTE_GAP_REL`` of their largest magnitude: then every choice the
    forward would have made otherwise lies within twice that of a tie.
    The forward on its own routes is compared too, and printed: the
    share of (token, layer) top-k sets that agree, and where they first
    part (the earliest layer), with the forward's margin there between
    its k-th and (k+1)-th logit."""
    from repro_torch.models import moe
    cfg = model.cfg
    L, n, V, K = cfg.n_layers, prompt.size, cfg.vocab_size, \
        cfg.experts_per_token
    calls = []
    real_dispatch, recorded = recording_dispatch(moe, calls)
    real_route, real_dtype = moe.route, model.dtype
    model.cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / K, dtype=dtype or cfg.dtype)
    if dtype:
        model.dtype = getattr(torch, dtype)
    moe.dispatch = recorded
    try:
        toks, got = tf_decode(torch, np, model, prompt, seed)
        served = list(calls)
        calls.clear()
        free = tf_forward(torch, model, toks, n)
        own = list(calls)
        if len(served) != L * (TF_STEPS + 1) or len(own) != L:
            raise RuntimeError(f"{len(served)} + {len(own)} dispatches "
                               f"recorded, not {L} x ({TF_STEPS} + 2)")
        # the served routes of the forward's rows: the prefill's, then
        # one row per decode step, layer by layer
        per_layer = [[served[layer]] + [served[L * (1 + i) + layer]
                                        for i in range(TF_STEPS)]
                     for layer in range(L)]
        s_lg = [torch.cat([c[0] for c in r]) for r in per_layer]
        s_e = [torch.cat([c[1] for c in r]) for r in per_layer]
        moe.route = replay = ReplayRoutes(real_route, zip(s_lg, s_e))
        want = tf_forward(torch, model, toks, n)
    finally:
        moe.dispatch, moe.route = real_dispatch, real_route
        model.cfg, model.dtype = cfg, real_dtype
    tf = tf_compare(got, want, V, toks.shape[1])
    tf["free"] = tf_compare(got, free, V, toks.shape[1])
    same = torch.stack([(s_e[i].sort(-1).values
                         == own[i][1].sort(-1).values).all(-1)
                        for i in range(L)])                   # (L, n + 16)
    tf["topk_agree"] = float(same[:, n:].float().mean())
    tf["topk_agree_prompt"] = float(same[:, :n].float().mean())
    parted = (~same).nonzero()
    if parted.numel():
        layer, row = (int(v) for v in parted[int(parted[:, 0].argmin())])
        srt = own[layer][0][row].sort(descending=True).values
        tf["first_part"] = {
            "layer": layer, "position": row,
            "step": row - n if row >= n else None,
            "margin": float(srt[K - 1] - srt[K]),
            "logit_diff": float((own[layer][0][row]
                                 - s_lg[layer][row]).abs().max())}
    tf["route_gap_rel"] = max(replay.gaps)
    tf["ok"] = tf["ok"] and tf["route_gap_rel"] <= ROUTE_GAP_REL
    tf["capacity_factor"] = cfg.n_experts / K
    tf["dtype"] = dtype or cfg.dtype
    return tf


def serve_moe_path(group, spec):
    """Phase 11, in a process of its own: each MoE model at full width
    (dbrx at its cut depth), served, with its routing statistics, gate 2
    for qwen3-moe, then gate 3 on the two MoE SMOKE configs; the kernels'
    launch counts over the whole phase."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.models import flops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    out = {"models": {}, "smoke": {}}
    for arch, depth in MOE_SERVE.items():
        cfg = ARCHS[arch]
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        t0 = time.perf_counter()
        model = tserve.init_model(cfg, spec["device"], seed=0)
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0, "n_layers": cfg.n_layers,
               "n_params": sum(p.numel() for p in model.parameters()),
               "a": serve_workload(torch, np, tserve, model, SERVE_A)}
        w = res["a"]
        shape = ShapeConfig("serve", w["prompt"], w["batch"], "prefill")
        w["executed_flops"] = flops.executed_flops(cfg, shape)
        w["executed_share"] = (w["executed_flops"] / (w["prefill_ms"] * 1e-3)
                               / BF16_DENSE_FLOPS)
        res["routing"] = routing_stats(torch, np, model, SERVE_A)
        if depth is None:
            prompt = tserve.make_requests(SERVE_A["prompts"], 0,
                                          cfg.vocab_size)[0].prompt
            res["tf"] = moe_teacher_forced(torch, np, model, prompt, seed=1)
            res["tf32"] = moe_teacher_forced(torch, np, model, prompt,
                                             seed=1, dtype="float32")
        out["models"][arch] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MOE_SERVE:
        out["smoke"][arch] = smoke_card_vs_cpu(torch, np, tserve, arch,
                                               spec["device"])
    out["launches"] = ops.launch_counts()
    return out


def log_moe_teacher_forced(tag, arch, tf) -> None:
    """The lines of one ``moe_teacher_forced`` run."""
    fr, part = tf["free"], tf.get("first_part")
    where = "nowhere" if part is None else (
        f"first at layer {part['layer']}, position {part['position']} "
        f"(decode step {part['step']}), the forward's margin between its "
        f"k-th and (k+1)-th logit {part['margin']:.4g} against a logit "
        f"difference of {part['logit_diff']:.4g} there")
    log(f"{tag}: {arch} in {tf['dtype']} at capacity factor "
        f"{tf['capacity_factor']}: the forward on its own routes picks the "
        f"decode's top-k sets on {tf['topk_agree']:.6g} of (decode token, "
        f"layer) pairs and the prefill's on {tf['topk_agree_prompt']:.6g} "
        f"of (prompt token, layer) pairs; they part {where}; its logits "
        f"against the decode's: max |diff| {fr['max_abs_diff']:.4g}, "
        f"within rtol = atol = {TF_TOL} {fr['ok']}; routed as served: "
        f"router logits within {tf['route_gap_rel']:.4g} of their largest "
        f"(<= {ROUTE_GAP_REL})")


def serve_moe_phase(torch, card) -> None:
    """Phase 11: qwen3-moe-30b-a3b at full width and depth and dbrx-132b
    at full width (8 layers) served from seeded bf16 weights (a process
    of its own), and the four gates."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    tag = "phase 11"
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag}: this process holds {torch.cuda.memory_reserved() / 2**30:.3f}"
        f" GiB of the card")
    (res,) = spawn_pods(serve_moe_path, 1, "cuda", args=({"device": "cuda"},),
                        timeout=600)
    for arch, r in res["models"].items():
        check_served(tag, card, arch, r, "a")
        w, rt = r["a"], r["routing"]
        touched = rt["touched"]
        log(f"{tag}: {arch} ({r['n_layers']} layers) routing on {card}: "
            f"prefill capacity {rt['prefill_capacity']} rows per expert, "
            f"{rt['prefill_dropped']:.6g} of {rt['prefill_pairs']} (token, "
            f"k) pairs dropped (pads included); executed prefill FLOPs "
            f"{w['executed_flops']:.4g} ({w['executed_share']:.6g} of 989 "
            f"TFLOP/s) against 2*N_active*tokens {w['prefill_flops']:.4g}; "
            f"decode capacity {rt['decode_capacity']}, experts routed to "
            f"per layer min {min(touched)} median "
            f"{sorted(touched)[len(touched) // 2]} max {max(touched)}; "
            f"decode bounds: all weights {w['decode_bound_ms']:.6g} ms, "
            f"routed {rt['routed_bound_ms']:.6g} ms")
        for key in ("tf32", "tf"):
            if key in r:
                log_moe_teacher_forced(tag, arch, r[key])
                check_teacher_forced(tag, arch, r[key])
    check_smoke_and_launches(tag, res)




# ---------------------------------------------------------------------------
# phase 12: training the zoo
# ---------------------------------------------------------------------------

#: phase 12's models at full published width, cut in depth to the most
#: layers one card holds: the step's peak at ``ZOO_BYTES_PER_PARAM``
#: bytes per parameter must leave ``ZOO_FREE_GIB`` of the card free
#: (reckoned by ``zoo_reckoning`` before anything is built; a depth that
#: does not fit fails, with no retry at a smaller one): qwen3-moe 2 of 48
#: layers (3 would need 97.5 GiB of the card's 79.18), gemma2-9b 2 of 42
#: (one local / global pair; 4 would need 76.5), qwen3-8b 5 of 36 (6
#: would need 79.6)
TRAIN_ZOO = {"qwen3-moe-30b-a3b": {"n_layers": 2, "batch": 8},
             "gemma2-9b": {"n_layers": 2, "batch": 8},
             "qwen3-8b": {"n_layers": 5, "batch": 8}}
#: the largest peak of a train step kind at full width, bytes per
#: parameter, that ``python -m repro_torch.launch.memory`` measured at
#: these depths, batch 8 x 1024, on an H100 (gemma2-9b's ``local`` step:
#: 47.23), rounded up
ZOO_BYTES_PER_PARAM = 48.0
ZOO_FREE_GIB = 8.0
ZOO_SEQ = 1024
ZOO_STEPS = 8
#: the determinism runs: qwen3-moe at ``n_layers`` (its phase-12 depth of
#: 2 until phase 22 joined the script), twice, under
#: ``RunConfig.deterministic``, ``steps`` steps with the sync interval H
#: set so that the last is a delta_sync
ZOO_DET = {"arch": "qwen3-moe-30b-a3b", "n_layers": 1, "steps": 3, "H": 3}


def zoo_config(arch, spec):
    """(the config at phase 12's depth, its parameter count)."""
    from repro_torch.configs import ARCHS
    cfg = dataclasses.replace(ARCHS[arch], n_layers=spec["n_layers"])
    return cfg, cfg.param_count()


def zoo_reckoning(card_bytes, tag="phase 12", table=None):
    """Gate 5, before anything is built: each model's reckoned peak (its
    parameters x its ``bytes_per_param``, by default
    ``ZOO_BYTES_PER_PARAM``) must leave ``ZOO_FREE_GIB`` of the card
    free."""
    for arch, spec in (table or TRAIN_ZOO).items():
        cfg, n = zoo_config(arch, spec)
        per = spec.get("bytes_per_param", ZOO_BYTES_PER_PARAM)
        peak = n * per
        free = (card_bytes - peak) / 2**30
        log(f"{tag}: {arch} at {cfg.n_layers} of its layers: {n:,} "
            f"parameters x {per} B = {peak / 2**30:.2f} GiB "
            f"reckoned peak, {free:.2f} GiB of {card_bytes / 2**30:.2f} "
            f"free")
        if free < ZOO_FREE_GIB:
            fail(f"{tag}: {arch} at {cfg.n_layers} layers does not fit "
                 f"the card with {ZOO_FREE_GIB} GiB to spare")


def zoo_session(torch, arch, spec, deterministic=False, H=None):
    """A TrainSession of ``arch`` at phase 12's depth and batch, built as
    phase 9b builds its reduced-depth sessions, under ``acesync`` with
    ``replan_every=4``."""
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.launch.session import TrainSession, apply_determinism
    from repro_torch.models.registry import build_model
    cfg, _ = zoo_config(arch, spec)
    ace = ACESyncConfig(replan_every=4)
    if H:
        ace = dataclasses.replace(ace, sync_interval_init=H)
    run = RunConfig(model=cfg, shape=ShapeConfig("session", ZOO_SEQ,
                                                 spec["batch"], "train"),
                    total_steps=100, warmup_steps=2, ckpt_dir=spec["dir"],
                    ckpt_every=0, deterministic=deterministic, acesync=ace)
    apply_determinism(run)
    return TrainSession(build_model(cfg, run, device="cuda"), run,
                        strategy="acesync")


def zoo_train_path(group, spec):
    """Phase 12 or 14, one model in a process of its own:
    ``spec["arch"]`` at full width and the phase's depth through
    TrainSession for ``ZOO_STEPS`` steps (two delta_sync rounds, one
    device replan), then one grad_sync under a plan with a group on every
    rung; each step on CUDA events, the kernels' launch counts from 0
    just before the run, then one untimed training forward with its
    dispatches recorded (MoE: the share of (token, k) pairs it drops).  A
    recurrent model first has its scan's memory measured on the empty
    card (``launch.memory.scan_memory``, at the run's shapes)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.memory import scan_memory, state_bytes
    from repro_torch.models import flops, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = spec["arch"]
    out = {}
    shape = ShapeConfig("train", ZOO_SEQ, spec["batch"], "train")
    cfg, _ = zoo_config(arch, spec)
    if cfg.family in ("ssm", "hybrid"):
        out["scan"] = scan_memory(cfg, spec["batch"], ZOO_SEQ)
        out["scan"]["starts"] = flops.scan_start_bytes(cfg, shape)
    t0 = time.perf_counter()
    sess = zoo_session(torch, arch, spec)
    sess.init()
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0,
               state_bytes=state_bytes(sess.state))
    tr = sess.trainer
    times, step = [], tr.step

    def timed(state, batch, plan, kind="grad_sync"):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = step(state, batch, plan, kind)
        e1.record()
        times.append((kind, e0, e1))
        return res

    tr.step = timed
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sess.run(ZOO_STEPS, log_every=0)
    plan = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.sizes))], (1.0,))
    batch = next(sess.pipeline)
    state, metrics = tr.step(sess.state, batch, plan, "grad_sync")
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["peak_alloc"] = torch.cuda.max_memory_allocated()
    out["peak_reserved"] = torch.cuda.max_memory_reserved()
    out["card_bytes"] = torch.cuda.get_device_properties(0).total_memory
    out["losses"] = sess.losses + [float(metrics["loss"])]
    out["finite_params"] = all(bool(torch.isfinite(p).all())
                               for p in T.leaves(state["params"]))
    kinds = [k for h in sess.history for k in h["kinds"]]
    out["delta_rounds"] = kinds.count("delta_sync")
    out["replans"] = sess.loop.device_replans
    out["ms"] = {}
    for kind, e0, e1 in times:
        out["ms"].setdefault(kind, []).append(e0.elapsed_time(e1))
    # the all-rungs grad_sync was the last step timed
    out["ms"]["grad_sync_all_rungs"] = [out["ms"].pop("grad_sync")[-1]]
    out["n_active"] = sess.model.active_param_count()
    out["model_flops"] = flops.model_flops(cfg, shape, out["n_active"])
    out["executed_flops"] = flops.executed_flops(cfg, shape)
    out["n_params"] = sum(p.numel() for p in T.leaves(state["params"]))
    out["n_layers"] = cfg.n_layers
    out["family"] = cfg.family
    if cfg.family == "moe":
        calls = []
        real, recorded = recording_dispatch(moe, calls)
        moe.dispatch = recorded
        try:
            with torch.no_grad():
                sess.model.loss(batch)
        finally:
            moe.dispatch = real
        out["dropped"] = (sum(int((p == C).sum()) for _, _, p, C in calls)
                          / sum(p.numel() for _, _, p, _ in calls))
        out["capacity"] = calls[0][3]
    return out


def zoo_det_path(group, spec):
    """Phase 12's determinism runs, in a process of its own (the switch
    is process-wide): ``ZOO_DET["arch"]`` at ``ZOO_DET["n_layers"]`` under
    ``RunConfig.deterministic``, twice from the same seed, each
    ``ZOO_DET["steps"]`` steps ending in a delta_sync; the hashes of the
    parameters after each run and the launches of both."""
    import gc
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    out = {"hashes": [], "kinds": []}
    for _ in range(2):
        sess = zoo_session(torch, ZOO_DET["arch"], spec, deterministic=True,
                           H=ZOO_DET["H"])
        sess.run(ZOO_DET["steps"], log_every=0)
        out["kinds"].append([k for h in sess.history for k in h["kinds"]])
        out["hashes"].append([int(bits_hash(torch, p))
                              for p in T.leaves(sess.model.param_tree())])
        out["losses"] = sess.losses
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = ops.launch_counts()
    return out


def _spread(ms):
    """(median, min, max) of the steady steps: all but the first of a
    kind (one-time set-up), or the one there is."""
    steady = sorted(ms[1:] or ms)
    return steady[len(steady) // 2], steady[0], steady[-1]


def train_models(torch, card, tag, table) -> tuple:
    """The models of ``table`` trained at full width and their reduced
    depth, one process each (``zoo_train_path``), gates 1, 2 and 5 of
    phase 12 and its lines.  Returns (the kernels' launches per path,
    each model's result)."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    gc.collect()
    torch.cuda.empty_cache()
    zoo_reckoning(torch.cuda.get_device_properties(0).total_memory, tag,
                  table)
    launches, results = {}, {}
    for arch, spec in table.items():
        spec = dict(spec, arch=arch, dir=str(CKPT_ROOT / f"zoo_{arch}"))
        (r,) = spawn_pods(zoo_train_path, 1, "cuda", args=(spec,),
                          timeout=600)
        launches[f"zoo_{arch}"] = r["launches"]
        results[arch] = r
        tokens = spec["batch"] * ZOO_SEQ
        if not all(math.isfinite(x) for x in r["losses"]):
            fail(f"{tag}: {arch}: non-finite loss {r['losses']}")
        if not r["finite_params"]:
            fail(f"{tag}: {arch}: non-finite parameters")
        if r["delta_rounds"] < 2 or r["replans"] < 1:
            fail(f"{tag}: {arch}: {r['delta_rounds']} delta_sync rounds, "
                 f"{r['replans']} device replans")
        missing = [k for k in KERNELS if r["launches"].get(k, 0) < 1]
        if missing:
            fail(f"{tag}: {arch}: kernels never launched: {missing}")
        free = (r["card_bytes"] - r["peak_alloc"]) / 2**30
        if free < ZOO_FREE_GIB:
            fail(f"{tag}: {arch}: peak {r['peak_alloc'] / 2**30:.2f} GiB "
                 f"leaves {free:.2f} GiB free, under {ZOO_FREE_GIB}")
        log(f"{tag}: {arch} on {card}: {r['n_layers']} layers, "
            f"{r['n_params']:,} parameters ({r['n_active']:,} active), "
            f"batch {spec['batch']} x {ZOO_SEQ}; train state "
            f"{r['state_bytes']:,} B; init {r['init_s']:.2f} s; peak "
            f"{r['peak_alloc'] / 2**30:.3f} GiB allocated "
            f"({r['peak_reserved'] / 2**30:.3f} reserved), "
            f"{free:.2f} GiB free, {r['peak_alloc'] / r['n_params']:.2f} B per "
            f"parameter")
        for kind, ms in r["ms"].items():
            med, lo, hi = _spread(ms)
            log(f"{tag}: {arch}: {kind}: {len(ms)} steps, ms "
                f"{[round(x, 3) for x in ms]}; steady median {med:.3f} "
                f"(min {lo:.3f}, max {hi:.3f})")
        med = _spread(r["ms"]["local"])[0]
        mfu = r["model_flops"] / (med * 1e-3) / BF16_DENSE_FLOPS
        line = (f"{tag}: {arch}: local step {tokens / (med * 1e-3):.1f} "
                f"tokens/s, MFU {mfu:.6g} at 6 * N_active * tokens "
                f"({r['model_flops']:.4g} FLOPs) of 989 TFLOP/s")
        if "dropped" in r:
            ex = r["executed_flops"] / (med * 1e-3) / BF16_DENSE_FLOPS
            line += (f"; executed capacity FLOPs {r['executed_flops']:.4g} "
                     f"({ex:.6g} of peak); capacity {r['capacity']} rows "
                     f"per expert, one training forward drops "
                     f"{r['dropped']:.6g} of its (token, k) pairs")
        log(line)
        log(f"{tag}: {arch}: losses {[round(x, 4) for x in r['losses']]}; "
            f"{r['delta_rounds']} delta_sync rounds, {r['replans']} device "
            f"replan(s); K1-K4 launches "
            f"{[r['launches'].get(k, 0) for k in KERNELS]}")
    return launches, results


def zoo_phase(torch, card) -> dict:
    """Phase 12: qwen3-moe-30b-a3b, gemma2-9b and qwen3-8b trained at
    full width and reduced depth, one process each, then the determinism
    runs.  Returns the kernels' launches per path."""
    from repro_torch.launch.mesh import spawn_pods
    tag = "phase 12"
    launches, _ = train_models(torch, card, tag, TRAIN_ZOO)
    spec = dict(TRAIN_ZOO[ZOO_DET["arch"]], n_layers=ZOO_DET["n_layers"],
                dir=str(CKPT_ROOT / "zoo_determinism"))
    (d,) = spawn_pods(zoo_det_path, 1, "cuda", args=(spec,), timeout=600)
    launches["zoo_determinism"] = d["launches"]
    if any(k.count("delta_sync") != 1 for k in d["kinds"]):
        fail(f"{tag}: determinism runs' step kinds {d['kinds']}")
    if d["hashes"][0] != d["hashes"][1]:
        parted = sum(a != b for a, b in zip(*d["hashes"]))
        fail(f"{tag}: the two deterministic runs differ in {parted} of "
             f"{len(d['hashes'][0])} parameter leaves")
    log(f"{tag}: {ZOO_DET['arch']} under RunConfig.deterministic, twice "
        f"{ZOO_DET['steps']} steps ({d['kinds'][0]}): parameter hashes "
        f"equal on all {len(d['hashes'][0])} leaves; losses "
        f"{[round(x, 4) for x in d['losses']]}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: serving the recurrent families
# ---------------------------------------------------------------------------

#: phase 13's models, at full published width and depth
RECURRENT_SERVE = ("falcon-mamba-7b", "recurrentgemma-2b")
#: (b): one prompt twice recurrentgemma's 2,048 window (its local ring
#: wraps in prefill and again in decode; mamba's state does not grow)
SERVE_LONG = {"prompts": (4096,), "new": 16, "batch": 1}
#: gate 5: falcon-mamba's peak allocation above its weights during (b)'s
#: prefill stays below one f32 (1, 4096, 8192, 16) tensor, the scan's
#: discretised input for the whole sequence
SCAN_PEAK_LIMIT = 4 * 4096 * 8192 * 16
#: gate 6: a prompt length the scan's chunk rule refuses
REFUSED_PROMPT = 300
#: the KV bytes per sequence printed beside the recurrent states
KV_REFERENCE_ARCH = "qwen3-8b"
#: gate 2 runs in f32 compute (the bf16 weights cast at use) for these
#: models, its bf16 reading printed beside its control: in bf16 the
#: 64-layer random falcon-mamba's forward differs from itself across
#: lengths (a forward 256 positions longer, at the same positions) by
#: more than TF_TOL, so decode cannot be held to it there
TF_F32_COMPUTE = ("falcon-mamba-7b",)
#: gate 2's rtol = atol in f32 compute: five times the largest reading
#: of decode against the forward, and of the control, on the card
#: (2.036e-3, falcon-mamba (a))
TF_F32_TOL = 1e-2


def recurrent_teacher_forced(torch, np, model, prompt, seed, dtype=None):
    """Gate 2 for a recurrent model, in compute dtype ``dtype`` (the bf16
    weights cast at use; default the config's), restored after: prefill
    ``prompt``, then ``TF_STEPS`` decode steps, against one forward.  The
    forward obeys the scan's chunk rule too (n + 16 is refused), so it
    runs over the next multiple of 256, the tail's extra tokens drawn
    from the seed, and only positions n .. n + 15 are compared: both
    models are causal, so the tail cannot reach them.  The attention's
    chunks are set to the scan's for it (they divide every length the
    scan takes).  The control: a second forward, 256 positions longer,
    at the same positions (the same function; only the matmuls' shapes
    differ)."""
    from repro_torch.models.mamba import SCAN_CHUNK
    cfg, real_dtype = model.cfg, model.dtype
    saved = (getattr(model, "q_chunk", None), getattr(model, "kv_chunk", None))
    if dtype:
        model.cfg = dataclasses.replace(cfg, dtype=dtype)
        model.dtype = getattr(torch, dtype)
    try:
        toks, got = tf_decode(torch, np, model, prompt, seed)
        n, total = prompt.size, toks.shape[1]
        padded = -(-total // SCAN_CHUNK) * SCAN_CHUNK
        tail = np.random.RandomState(seed + 1).randint(
            0, cfg.vocab_size, size=(1, padded + SCAN_CHUNK - total))
        full = torch.cat([toks, torch.from_numpy(tail.astype(np.int32))
                          .to(toks.device)], 1)
        if saved[0] is not None:
            model.q_chunk = model.kv_chunk = SCAN_CHUNK
        with torch.inference_mode():
            want, longer = (
                model.logits(model(full[:, :length])[:, n:n + TF_STEPS])[0]
                .float() for length in (padded, padded + SCAN_CHUNK))
    finally:
        model.cfg, model.dtype = cfg, real_dtype
        if saved[0] is not None:
            model.q_chunk, model.kv_chunk = saved
    tol = TF_F32_TOL if dtype == "float32" else TF_TOL
    tf = tf_compare(got, want, cfg.vocab_size, padded, tol)
    tf["compared"] = (n, n + TF_STEPS)
    tf["dtype"] = dtype or cfg.dtype
    tf["control"] = tf_compare(longer, want, cfg.vocab_size,
                               padded + SCAN_CHUNK, tol)
    return tf


def prefill_peak_above(torch, model, spec):
    """Gate 5, untimed: one prefill of ``spec``'s prompt; the peak
    allocated bytes above what was allocated before it (the weights)."""
    from repro_torch.launch import serve as tserve
    prompt = tserve.make_requests(spec["prompts"], 0,
                                  model.cfg.vocab_size)[0].prompt
    toks = torch.from_numpy(prompt[None]).to(model.device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model.prefill(toks, prompt.size + spec["new"])
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before, before


def refused_prompt(torch, np, tserve, model):
    """Gate 6: a ``REFUSED_PROMPT``-token request raises ``ValueError``
    naming its length, before any decode step."""
    steps = []
    real = model.decode_step

    def counted(*a):
        steps.append(1)
        return real(*a)

    model.decode_step = counted
    req = tserve.Request(0, np.zeros(REFUSED_PROMPT, np.int32), 8)
    try:
        tserve.Server(model, REFUSED_PROMPT + 8, 1).serve([req])
    except ValueError as e:
        return {"refused": str(REFUSED_PROMPT) in str(e), "error": str(e),
                "decode_steps": len(steps)}
    finally:
        model.decode_step = real
    return {"refused": False, "error": None, "decode_steps": len(steps)}


def serve_recurrent_path(group, spec):
    """Phase 13, in a process of its own: each recurrent model at full
    width and depth served on workloads (a) and (b), gate 2 after (a)'s
    512-token request and after (b), gate 5 (mamba), gate 6, the state
    bytes; then gate 3 on the two SMOKE configs; the kernels' launch
    counts over the whole phase."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.models import flops
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    kv_model = build_model(ARCHS[KV_REFERENCE_ARCH], device="meta")
    out = {"models": {}, "smoke": {}}
    for arch in RECURRENT_SERVE:
        cfg = ARCHS[arch]
        t0 = time.perf_counter()
        model = tserve.init_model(cfg, spec["device"], seed=0)
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0, "n_layers": cfg.n_layers,
               "n_params": sum(p.numel() for p in model.parameters())}
        for wl, wspec in (("a", SERVE_A), ("b", SERVE_LONG)):
            res[wl] = serve_workload(torch, np, tserve, model, wspec)
            length = max(wspec["prompts"]) + wspec["new"]
            res[wl]["state"] = flops.cache_bytes(model.init_cache(1, length))
            res[wl]["kv_reference"] = flops.cache_bytes(
                kv_model.init_cache(1, length))[1]
            prompt = tserve.make_requests(wspec["prompts"], 0,
                                          cfg.vocab_size)[0].prompt
            res[wl]["tf_served"] = recurrent_teacher_forced(
                torch, np, model, prompt, seed=1)
            if arch in TF_F32_COMPUTE:
                res[wl]["tf_f32"] = recurrent_teacher_forced(
                    torch, np, model, prompt, seed=1, dtype="float32")
        if cfg.family == "ssm":
            res["b"]["prefill_peak"] = prefill_peak_above(torch, model,
                                                          SERVE_LONG)
        res["refused"] = refused_prompt(torch, np, tserve, model)
        out["models"][arch] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in RECURRENT_SERVE:
        out["smoke"][arch] = smoke_card_vs_cpu(torch, np, tserve, arch,
                                               spec["device"])
    out["launches"] = ops.launch_counts()
    return out


def serve_recurrent_phase(torch, card) -> None:
    """Phase 13: falcon-mamba-7b and recurrentgemma-2b served at full
    width and depth from seeded bf16 weights (a process of its own), and
    the six gates."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    tag = "phase 13"
    gc.collect()
    torch.cuda.empty_cache()
    (res,) = spawn_pods(serve_recurrent_path, 1, "cuda",
                        args=({"device": "cuda"},), timeout=600)
    for arch, r in res["models"].items():
        for wl in ("a", "b"):
            w = r[wl]
            check_served(tag, card, arch, r, wl)
            state, ring = w["state"]
            log(f"{tag}: {arch} ({wl}) per sequence at "
                f"{w['prompt'] + w['new']} positions: {state} B of "
                f"recurrent state (conv carries and scan states), {ring} B "
                f"of ring KV caches; {KV_REFERENCE_ARCH} holds "
                f"{w['kv_reference']} B of KV cache at that length")
            for key in ("tf_served", "tf_f32"):
                if key not in w:
                    continue
                tf, ctl = w[key], w[key]["control"]
                log(f"{tag}: {arch} ({wl}) in {tf['dtype']} compute, "
                    f"positions {tf['compared'][0]}-{tf['compared'][1] - 1}: "
                    f"teacher-forced decode against the forward max |diff| "
                    f"{tf['max_abs_diff']:.4g} (argmax agrees on "
                    f"{tf['argmax_agree']:.4f}); the control, a forward "
                    f"{ctl['tokens']} tokens long against it, max |diff| "
                    f"{ctl['max_abs_diff']:.4g} (argmax "
                    f"{ctl['argmax_agree']:.4f})")
            tf = w["tf_f32" if arch in TF_F32_COMPUTE else "tf_served"]
            check_teacher_forced(tag, f"{arch} ({wl}, {tf['dtype']} "
                                 f"compute)", tf)
        if "prefill_peak" in r["b"]:
            peak, before = r["b"]["prefill_peak"]
            log(f"{tag}: {arch} (b) prefill of {SERVE_LONG['prompts'][0]} "
                f"tokens: peak {peak} B allocated above the {before} B "
                f"held before it (the weights), limit {SCAN_PEAK_LIMIT} B "
                f"(one f32 (1, 4096, 8192, 16) tensor)")
            if peak >= SCAN_PEAK_LIMIT:
                fail(f"{tag}: {arch}: the prefill's peak {peak} B above "
                     f"the weights reaches {SCAN_PEAK_LIMIT} B: the scan "
                     f"does not hold one chunk at a time")
        ref = r["refused"]
        log(f"{tag}: {arch}: a {REFUSED_PROMPT}-token prompt refused "
            f"{ref['refused']} after {ref['decode_steps']} decode steps: "
            f"{ref['error']}")
        if not ref["refused"] or ref["decode_steps"]:
            fail(f"{tag}: {arch}: a {REFUSED_PROMPT}-token prompt was not "
                 f"refused before decoding: {ref}")
    check_smoke_and_launches(tag, res)


# ---------------------------------------------------------------------------
# phase 14: training the recurrent families
# ---------------------------------------------------------------------------

#: phase 14's models at full published width, cut in depth by phase 12's
#: rule (``zoo_reckoning``) at each model's own bytes per parameter: the
#: largest peak of a train step kind (the all-rungs ``grad_sync``) that
#: ``python -m repro_torch.launch.memory`` measured for it at 8 layers,
#: batch 8 x 1024, on an H100 80GB HBM3 at 700 W (48.046 and 49.245),
#: rounded up.  falcon-mamba-7b 12 of 64 layers fit (13 would need 73.26
#: GiB of the card's 79.18); recurrentgemma-2b 8 of 26 (its depth keeps
#: n_layers = 2 mod 3, so that its unrolled ``tail`` of two RG-LRU
#: layers trains; 11 would need 73.91).  Run at 6 and 5 layers since
#: phase 19 joined the script, to keep it inside its time limit
TRAIN_RECURRENT = {
    "falcon-mamba-7b": {"n_layers": 6, "batch": 8,
                        "bytes_per_param": 48.1},
    "recurrentgemma-2b": {"n_layers": 5, "batch": 8,
                          "bytes_per_param": 49.3}}
#: gate 4: falcon-mamba's scan transient during the backward (the peak
#: of ``SelectiveScan``'s backward above the allocation just before it,
#: ``launch.memory.scan_memory`` at the run's shapes) stays below this
#: many one-chunk (8, 256, 8192, 16) f32 tensors.  Reckoned from the
#: design before the first run: the reverse scan's inputs (the reversed
#: a and C * dy), the chunk's states and the scan's levels (about 3) are
#: live at once, with the (8, 1024, 8192) f32 gradients of u and dt
#: (half a chunk tensor): under 7, and 8 with room for the allocator's
#: rounding and cuBLAS's workspace.  Plain autograd saves more than
#: four (8, 1024, 8192, 16) f32 tensors, 16 one-chunk tensors
#: (tests/test_torch_recurrent_train.py).
SCAN_BWD_CHUNKS = 8


def recurrent_train_phase(torch, card) -> dict:
    """Phase 14: falcon-mamba-7b and recurrentgemma-2b trained at full
    width and reduced depth, one process each, as phase 12 trains its
    models (gates 1-3 there, and the depth rule), and gate 4 on mamba's
    scan.  Returns the kernels' launches per path."""
    tag = "phase 14"
    griffin = TRAIN_RECURRENT["recurrentgemma-2b"]["n_layers"]
    if griffin % 3 != 2:
        fail(f"{tag}: recurrentgemma-2b at {griffin} layers has no "
             f"two-layer tail to train")
    launches, results = train_models(torch, card, tag, TRAIN_RECURRENT)
    for arch, r in results.items():
        sc = r["scan"]
        chunks = sc["backward_peak"] / sc["chunk_tensor"]
        log(f"{tag}: {arch} on {card}: the scan at batch "
            f"{TRAIN_RECURRENT[arch]['batch']} x {ZOO_SEQ} alone: saves "
            f"{sc['saved']:,} B for its backward (chunk-start states "
            f"{sc['starts']:,} B), backward peak {sc['backward_peak']:,} B "
            f"above its start = {chunks:.4g} one-chunk f32 tensors of "
            f"{sc['chunk_tensor']:,} B; one full-width layer keeps "
            f"{sc['layer_saved']:,} B for its backward")
        if arch == "falcon-mamba-7b" and not chunks < SCAN_BWD_CHUNKS:
            fail(f"{tag}: {arch}: the scan's backward peaks at {chunks:.4g} "
                 f"one-chunk tensors, not under {SCAN_BWD_CHUNKS}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: serving the encoder-decoder and the VLM
# ---------------------------------------------------------------------------

#: phase 15's models at full published width and depth, their workloads
#: and gate 2's prompt.  seamless-m4t-medium: phase 10's (a) (F = 64
#: frames) and (b), one 4,096-token prompt (F = 512).  llava: (a'), 448 /
#: 384 / 200 / 448 tokens after its 576 patches (1,024 positions, which
#: the chunk rule accepts; (a)'s 512 gives 1,088, which it refuses), and
#: (b), one 1,472-token prompt (2,048 positions); gate 2 after 432 tokens
#: (576 + 432 + 16 = 1,024 positions for the forward)
FRONTEND_SERVE = {
    "seamless-m4t-medium": {"a": SERVE_A,
                            "b": {"prompts": (4096,), "new": 16,
                                  "batch": 1},
                            "tf_prompt": 512},
    "llava-next-mistral-7b": {"a": {"prompts": (448, 384, 200, 448),
                                    "new": 32, "batch": 4},
                              "b": {"prompts": (1472,), "new": 16,
                                    "batch": 1},
                              "tf_prompt": 432}}


def seeded_inputs(torch, model, B, S, seed):
    """A frontend stub's float inputs for ``B`` sequences of ``S`` tokens,
    N(0, 0.02^2) as the pipeline draws them, from ``seed`` on the model's
    device (none for a token-only model)."""
    g = torch.Generator(model.device).manual_seed(seed)
    return {k: torch.randn(d, generator=g, device=model.device) * 0.02
            for k, d in model.frontend_shapes(B, S).items()}


def frontend_teacher_forced(torch, np, model, prompt, seed):
    """Gate 2 with seeded non-zero frames / patch embeddings: prefill
    ``prompt`` (after the VLM's patches), then ``TF_STEPS`` decode steps
    at positions n_prefix + n + i, against ``lm_logits`` of one forward
    over the whole sequence with the same float inputs, at those
    positions only."""
    V, P, n = model.cfg.vocab_size, model.n_prefix, prompt.size
    rng = np.random.RandomState(seed)
    seq = np.concatenate([prompt, rng.randint(0, V, size=TF_STEPS)
                          .astype(np.int32)])[None]
    toks = torch.from_numpy(seq).to(model.device)
    inputs = seeded_inputs(torch, model, 1, n, seed)
    with torch.inference_mode():
        _, caches = model.prefill(toks[:, :n], P + n + TF_STEPS, **inputs)
        steps = []
        for i in range(TF_STEPS):
            logits, caches = model.decode_step(caches, P + n + i,
                                               toks[:, n + i:n + i + 1])
            steps.append(logits[0, 0])
        del caches
        want = model.logits(model(toks, **inputs)[:, P + n:])[0].float()
    return tf_compare(torch.stack(steps).float(), want, V,
                      P + n + TF_STEPS)


def frontend_live(torch, np, model, prompt, seed):
    """Gate 3: the last position's prefill logits of ``prompt`` with
    seeded frames / patch embeddings against those with zeros (the
    Server's); returns their largest absolute difference."""
    toks = torch.from_numpy(prompt[None]).to(model.device)
    inputs = seeded_inputs(torch, model, 1, prompt.size, seed)
    with torch.inference_mode():
        a, _ = model.prefill(toks, **inputs)
        b, _ = model.prefill(toks, **{k: torch.zeros_like(v)
                                      for k, v in inputs.items()})
    return float((a.float() - b.float()).abs().max())


def serve_frontend_path(group, spec):
    """Phase 15, in a process of its own: each model at full width and
    depth served on its workloads (a) and (b), gate 2 and gate 3 after
    them, the cache bytes per sequence; then gate 4 on the two SMOKE
    configs; the kernels' launch counts over the whole phase."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    out = {"models": {}, "smoke": {}}
    for arch, wls in FRONTEND_SERVE.items():
        cfg = ARCHS[arch]
        t0 = time.perf_counter()
        model = tserve.init_model(cfg, spec["device"], seed=0)
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0, "family": cfg.family,
               "n_layers": (cfg.n_enc_layers, cfg.n_layers),
               "n_params": sum(p.numel() for p in model.parameters())}
        for wl in ("a", "b"):
            w = wls[wl]
            res[wl] = serve_workload(torch, np, tserve, model, w)
            S = max(w["prompts"])
            frames = ({"F": model.frames_len(S)}
                      if cfg.family == "encdec" else {})
            caches = model.init_cache(1, model.n_prefix + S + w["new"],
                                      **frames)
            res[wl]["seq_bytes"] = {
                part: sum(t.numel() * t.element_size() for t in c.values())
                for part, c in caches.items()}
            res[wl]["frames"] = frames.get("F")
            del caches
        prompt = tserve.make_requests([wls["tf_prompt"]], 0,
                                      cfg.vocab_size)[0].prompt
        res["tf"] = frontend_teacher_forced(torch, np, model, prompt, seed=1)
        res["live"] = frontend_live(torch, np, model, prompt, seed=2)
        res["n_prefix"] = model.n_prefix
        res["patch_ring_bytes"] = (
            2 * cfg.n_layers * model.n_prefix * cfg.n_kv_heads * cfg.head_dim
            * torch.finfo(model.dtype).bits // 8)
        out["models"][arch] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in FRONTEND_SERVE:
        out["smoke"][arch] = smoke_card_vs_cpu(torch, np, tserve, arch,
                                               spec["device"])
    out["launches"] = ops.launch_counts()
    return out


def serve_frontend_phase(torch, card) -> None:
    """Phase 15: seamless-m4t-medium and llava-next-mistral-7b served at
    full width and depth from seeded bf16 weights (a process of its
    own), and the five gates."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    tag = "phase 15"
    gc.collect()
    torch.cuda.empty_cache()
    (res,) = spawn_pods(serve_frontend_path, 1, "cuda",
                        args=({"device": "cuda"},), timeout=600)
    for arch, r in res["models"].items():
        enc, dec = r["n_layers"]
        for wl in ("a", "b"):
            w = r[wl]
            check_served(tag, card, arch, r, wl)
            per = w["seq_bytes"]
            if r["family"] == "encdec":
                log(f"{tag}: {arch} ({wl}) {enc} encoder + {dec} decoder "
                    f"layers; per sequence at {w['prompt'] + w['new']} "
                    f"positions: {per['self']} B of self-attention ring "
                    f"KV, {per['cross']} B of cross K/V over "
                    f"{w['frames']} frames (written once in prefill, read "
                    f"every decode step: in the bound); prefill executed "
                    f"FLOPs (encoder over the frames) "
                    f"{w['prefill_executed']:.6g} beside 2 * N * tokens "
                    f"{w['prefill_flops']:.6g}")
            else:
                log(f"{tag}: {arch} ({wl}) per sequence at "
                    f"{w['prompt'] + w['new']} tokens after its "
                    f"{r['n_prefix']} patches: {sum(per.values())} B of "
                    f"ring KV, {r['patch_ring_bytes']} B of it the "
                    f"patches' positions")
        check_teacher_forced(tag, f"{arch} (seeded non-zero frontend "
                             f"inputs)", r["tf"])
        log(f"{tag}: {arch}: prefill logits with seeded frontend inputs "
            f"against zeros (the Server's): max |diff| {r['live']:.4g} "
            f"(must exceed {TF_TOL})")
        if not r["live"] > TF_TOL:
            fail(f"{tag}: {arch}: the frontend inputs move the logits by "
                 f"{r['live']:.4g}, not more than {TF_TOL}: the "
                 f"encoder / cross path (or the patches) is not live")
    check_smoke_and_launches(tag, res)


# ---------------------------------------------------------------------------
# phase 16: training the encoder-decoder and the VLM
# ---------------------------------------------------------------------------

#: phase 16's models at full published width.  seamless-m4t-medium at its
#: full depth (12 encoder + 12 decoder layers); llava cut in depth by
#: phase 12's rule at its own bytes per parameter: 7 of 32 layers (8
#: would need 76.71 GiB of the card's 79.18).  Both bytes per parameter:
#: the largest peak of a train step kind that ``python -m
#: repro_torch.launch.memory`` measured, batch 8 x 1024, on an H100
#: 80GB HBM3 at 700 W, rounded up: seamless 51.405 (its ``local`` step:
#: the backward through the 256,256-row LM head's logit chunks), llava
#: 43.886 at 6 layers and 43.760 at 7 (the all-rungs ``grad_sync``)
TRAIN_FRONTEND = {
    "seamless-m4t-medium": {"n_layers": 12, "batch": 8,
                            "bytes_per_param": 51.5},
    "llava-next-mistral-7b": {"n_layers": 7, "batch": 8,
                              "bytes_per_param": 43.9}}


def frontend_train_phase(torch, card) -> dict:
    """Phase 16: seamless-m4t-medium (full width and depth) and
    llava-next-mistral-7b (full width, reduced depth) trained one process
    each, as phase 12 trains its models (gates 1-3 there, and the depth
    rule), seamless's MFU also at its executed FLOPs.  Returns the
    kernels' launches per path."""
    from repro_torch.configs import ARCHS
    tag = "phase 16"
    full = ARCHS["seamless-m4t-medium"].n_layers
    if TRAIN_FRONTEND["seamless-m4t-medium"]["n_layers"] != full:
        fail(f"{tag}: seamless-m4t-medium is not trained at its full "
             f"depth of {full} decoder layers")
    launches, results = train_models(torch, card, tag, TRAIN_FRONTEND)
    for arch, r in results.items():
        if r["family"] != "encdec":
            continue
        med = _spread(r["ms"]["local"])[0]
        ex = r["executed_flops"] / (med * 1e-3) / BF16_DENSE_FLOPS
        yard = r["model_flops"] / (med * 1e-3) / BF16_DENSE_FLOPS
        log(f"{tag}: {arch}: local step MFU {ex:.6g} at its executed "
            f"FLOPs {r['executed_flops']:.6g} (the encoder over "
            f"{max(64, ZOO_SEQ // ARCHS[arch].audio_downsample)} frames, "
            f"3x the forward's matmuls) beside {yard:.6g} at the "
            f"yardstick's 6 * N * tokens {r['model_flops']:.6g}")
    return launches


# ---------------------------------------------------------------------------
# phase 17: serving under a within-pod ("data", "model") mesh
# ---------------------------------------------------------------------------

#: 17(a): these models at full published width, cut to ``MESH_LAYERS``
#: (2 until phase 18 joined the script: dbrx's (2, 2) decode step 8.3 s
#: there, its FSDP gathers through gloo), on these (D, M) meshes, the
#: D * M ranks sharing the one card (gloo, staged through pinned host
#: memory).  Their (2, 2) mesh runs in 17(b), a card a rank over NCCL
#: (here until phase 24 joined the script: every forward gathered the
#: FSDP halves through gloo, dbrx's decode step 6.9 s)
MESH_MODELS = ("qwen3-8b", "dbrx-132b")
MESH_LAYERS = 1
MESH_A_SHAPE = (1, 2)
#: gate 1: a seeded batch of 4 x 256 tokens prefilled (batch over "data"
#: at D = 2, sequence over "model"), then 4 teacher-forced decode steps;
#: the last position's logits of each, gathered, against an unsharded
#: port model of the same seed on the same card within rtol = atol =
#: TF_TOL
MESH_TF = {"batch": 4, "prompt": 256, "steps": 4}
#: gate 1's runs per model: qwen3-8b in its served bf16; dbrx-132b in f32
#: compute (its bf16 weights cast at use: a bf16 near-tie between two
#: experts, which the mesh's and the one card's roundings break apart,
#: swaps an expert and, under capacity, the drops of the pairs after it),
#: at capacity factor E / K (C >= T: nothing drops, held to the unsharded
#: model) and at its own 1.25 (held to ``moe_apply_blocked``: each mesh
#: block dispatches on its own)
MESH_TF_RUNS = {"qwen3-8b": {"bf16": (None, False, False)},
                "dbrx-132b": {"f32, cf E/K": ("float32", True, False),
                              "f32, cf 1.25": ("float32", False, True)}}
#: 17(a)'s Server workload (each rank's tokens compared), once, 1 new
#: token (two greedy steps checked): ranks sharing one card move every
#: collective through gloo on the host, and at D = 2 each forward
#: all-gathers the FSDP half of the rank's weights (dbrx-132b: 1.6 GB a
#: layer; on an H100 its decode step took 6.9-7.5 s on (2, 2) against
#: 26-31 ms on (1, 2)).  So at D = 2 gate 1 runs only at capacity 1.25:
#: the E / K run (nothing drops) holds the layout alone, which the 1.25
#: run holds too, with the blocks (17(b)'s (2, 2) keeps the rule)
MESH_A = {"prompts": (256, 200, 128, 256), "new": 1, "batch": 4}


def mesh_runs(arch, mesh) -> dict:
    """Gate 1's runs of ``arch`` on ``mesh``: the capacity E / K run only
    where D = 1."""
    return {name: run for name, run in MESH_TF_RUNS[arch].items()
            if mesh[0] == 1 or not run[1]}
#: 17(b), with four cards or more: dbrx-132b on a (1, 4) mesh over NCCL,
#: gate 1 at 8 layers (phase 11's depth), then served at its published
#: 40 layers on workload (a), twice
MESH_B = {"arch": "dbrx-132b", "mesh": (1, 4), "gate_layers": 8}
#: 17(b)'s second mesh: 17(a)'s models and gates on (2, 2), a card a rank
#: over NCCL — the batch over "data", each forward's FSDP gathers, the
#: Server's batch gathered over "data" with every rank's tokens compared
MESH_B_D2 = (2, 2)


def mesh_gathered(ctx, logits, B):
    """The last position's logits (B, V) whole on every rank: the
    vocabulary parts gathered over "model", the batch over "data"."""
    last = logits[:, -1]
    if ctx is None:
        return last
    return ctx.gather_batch(ctx.all_gather(last, "model", dim=-1), B)


def mesh_tf_logits(torch, np, model, run, blocked=None, steps=None):
    """Gate 1's run on ``model`` (sharded or not): ``run`` = (compute
    dtype or None, capacity factor E / K?, blocked?), ``blocked`` the
    (D, M) whose blocks ``moe_apply_blocked`` dispatches (an unsharded
    model held for a mesh at capacity 1.25), ``steps`` the decode steps
    (default ``MESH_TF``'s).  Returns the (steps + 1, B, V) f32 logits,
    whole, as a numpy array (a process's result goes by value); the
    model's config, dtype and ``moe.moe_apply`` are restored after."""
    from repro_torch.models import moe
    dtype, ek, use_blocked = run
    cfg, real_dtype, real_apply = model.cfg, model.dtype, moe.moe_apply
    change = {}
    if dtype:
        change["dtype"] = dtype
    if ek:
        change["capacity_factor"] = cfg.n_experts / cfg.experts_per_token
    model.cfg = dataclasses.replace(cfg, **change)
    model.dtype = getattr(torch, model.cfg.dtype)
    if use_blocked and blocked:
        moe.moe_apply = (lambda p, x, c: moe.moe_apply_blocked(
            p, x, c, *blocked))
    B, S, n = MESH_TF["batch"], MESH_TF["prompt"], MESH_TF["steps"]
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(B, S + n)).astype(np.int32)).to(
        model.device)
    n = steps or n
    try:
        with torch.inference_mode():
            logits, caches = model.prefill(toks[:, :S], S + n)
            rows = [mesh_gathered(model.ctx, logits, B)]
            for i in range(n):
                logits, caches = model.decode_step(caches, S + i,
                                                   toks[:, S + i:S + i + 1])
                rows.append(mesh_gathered(model.ctx, logits, B))
            del caches
            return torch.stack(rows).float().cpu().numpy()
    finally:
        model.cfg, model.dtype, moe.moe_apply = cfg, real_dtype, real_apply


def mesh_reference_path(group, spec):
    """The unsharded port models gate 1 holds the meshes to, on one card
    (a process of its own): {"arch/run[/DxM]": logits}, a blocked run
    once per mesh."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, layers in spec["models"]:
        cfg = dataclasses.replace(ARCHS[arch], n_layers=layers)
        model = tserve.init_model(cfg, spec["device"], seed=0)
        for name, run in MESH_TF_RUNS[arch].items():
            for mesh in (spec["meshes"] if run[2] else [None]):
                key = f"{arch}/{name}" + (f"/{mesh[0]}x{mesh[1]}"
                                          if mesh else "")
                out[key] = mesh_tf_logits(torch, np, model, run, mesh)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def expected_shard_bytes(model, ctx) -> int:
    """A rank's bf16 weight bytes reckoned from the specs alone: each
    leaf's size over the ranks each spec'd axis splits it into (where it
    divides; "model" by whole units, one K/V head per rank where the
    heads are fewer than M)."""
    total = 0
    for path, spec in model.param_shardings().items():
        full = model.full_shapes[path]
        n = math.prod(full)
        for dim, ax in zip(full, spec):
            if isinstance(ax, tuple):
                units = ax[1]
                n //= ctx.M if units % ctx.M == 0 else units
            elif ax is not None and dim % ctx.sizes[ax] == 0:
                n //= ctx.sizes[ax]
        total += 2 * n
    return total


def mesh_serve_path(ctx, spec):
    """One rank of 17(a)'s mesh: each model at full width, cut to
    ``MESH_LAYERS``, sharded from seed 0 (``init_model(ctx=)``), gate 1's
    runs (rank 0 keeps the logits), the Server on ``MESH_A``; the
    kernels' launch counts over the whole phase."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    out = {"rank": ctx.rank, "backend": ctx.world.backend, "models": {}}
    for arch in MESH_MODELS:
        cfg = dataclasses.replace(ARCHS[arch], n_layers=MESH_LAYERS)
        model = tserve.init_model(cfg, ctx.device, seed=0, ctx=ctx)
        r = {"param_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
             "shard_bytes": expected_shard_bytes(model, ctx), "tf": {}}
        for name, run in mesh_runs(arch, (ctx.D, ctx.M)).items():
            got = mesh_tf_logits(torch, np, model, run,
                                 steps=MESH_TF["steps"])
            if ctx.rank == 0:
                r["tf"][name] = got
        r["a"] = serve_once(torch, np, tserve, model, MESH_A)
        out["models"][arch] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = ops.launch_counts()
    return out


def mesh_big_reference_path(group, spec):
    """17(b)'s reference, on one card: dbrx-132b unsharded at
    ``gate_layers`` from seed 0, gate 1's dbrx runs."""
    return mesh_reference_path(group, dict(spec, models=[
        (MESH_B["arch"], MESH_B["gate_layers"])], meshes=[MESH_B["mesh"]]))


def mesh_big_path(ctx, spec):
    """One rank of 17(b): dbrx-132b sharded at ``gate_layers`` for gate 1,
    then at its published depth served on workload (a) twice."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    arch = MESH_B["arch"]
    r = {"tf": {}}
    cfg = dataclasses.replace(ARCHS[arch], n_layers=MESH_B["gate_layers"])
    model = tserve.init_model(cfg, ctx.device, seed=0, ctx=ctx)
    for name, run in MESH_TF_RUNS[arch].items():
        got = mesh_tf_logits(torch, np, model, run)
        if ctx.rank == 0:
            r["tf"][name] = got
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = tserve.init_model(ARCHS[arch], ctx.device, seed=0, ctx=ctx)
    torch.cuda.synchronize()
    r.update(init_s=time.perf_counter() - t0, n_layers=model.cfg.n_layers,
             n_params=sum(p.numel() for p in model.parameters()),
             param_bytes=sum(p.numel() * p.element_size()
                             for p in model.parameters()),
             shard_bytes=expected_shard_bytes(model, ctx),
             a=serve_workload(torch, np, tserve, model, SERVE_A))
    return {"rank": ctx.rank, "backend": ctx.world.backend,
            "models": {arch: r}, "launches": ops.launch_counts()}


def check_mesh_gates(tag, ref, res, mesh, archs, card):
    """Gates 1-4 of one mesh's ranks ``res``: the logits of rank 0
    against ``ref``, each rank's served tokens identical, its weight
    bytes its shards' and no ACE-Sync kernel launched."""
    D, M = mesh
    r0 = res[0]
    for arch in archs:
        for name in mesh_runs(arch, mesh):
            key = f"{arch}/{name}"
            got = r0["models"][arch]["tf"][name]
            want = ref.get(f"{key}/{D}x{M}", ref.get(key))[:len(got)]
            diff = abs(got - want)
            ok = bool((diff <= TF_TOL + TF_TOL * abs(want)).all())
            blocked = f"{key}/{D}x{M}" in ref
            log(f"{tag}: {arch} on a ({D}, {M}) mesh, {name}: the last "
                f"position's logits of the prefill and "
                f"{len(got) - 1} teacher-forced decode steps against "
                f"{'moe_apply_blocked on ' if blocked else ''}the "
                f"unsharded model on one card: max |diff| "
                f"{float(diff.max()):.4g}, argmax agrees on "
                f"{float((got.argmax(-1) == want.argmax(-1)).mean()):.4f}"
                f" (rtol = atol = {TF_TOL}) [{card}]")
            if not ok or got.shape != want.shape:
                fail(f"{tag}: {arch} on ({D}, {M}), {name}: the mesh's "
                     f"logits differ from the reference's beyond "
                     f"{TF_TOL}")
    for r in res:
        for arch, m in r["models"].items():
            if m["param_bytes"] != m["shard_bytes"]:
                fail(f"{tag}: {arch} rank {r['rank']} holds "
                     f"{m['param_bytes']} weight bytes, its shards "
                     f"{m['shard_bytes']}")
            w = m["a"]
            if (not all(w["tokens_ok"]) or not w["finite"]
                    or w["tokens"] != r0["models"][arch]["a"]["tokens"]):
                fail(f"{tag}: {arch} on ({D}, {M}), rank {r['rank']}: "
                     f"tokens per request {w['tokens_ok']}, finite "
                     f"{w['finite']}, or tokens not rank 0's")
        launched = {k: n for k, n in r["launches"].items() if n}
        if launched:
            fail(f"{tag}: serving launched ACE-Sync kernels: {launched}")


def log_mesh_served(tag, arch, mesh, res, card) -> None:
    """Each rank's served line of one model on one mesh."""
    for r in res:
        w = r["models"][arch]["a"]
        med, lo, hi = w["decode_ms"]
        log(f"{tag}: {arch} on a {mesh} mesh over {r['backend']}, rank "
            f"{r['rank']} on {card}: {w['weight_bytes']} bf16 weight "
            f"bytes; batch {w['batch']} x prompt {w['prompt']}, {w['new']}"
            f" new; prefill {w['prefill_ms']:.3f} ms "
            f"({w['prefill_share']:.6g} of {w['cards']} x 989 TFLOP/s at "
            f"2*N*tokens); decode step ms median {med:.3f} min {lo:.3f} "
            f"max {hi:.3f}, bound per card {w['decode_bound_ms']:.6g} ms "
            f"(its weights + {w['kv_bytes']} cache bytes at 3.35 TB/s); "
            f"{w['tok_per_s']:.2f} tokens/s; peak "
            f"{w['peak_alloc_gib']:.3f} GiB allocated, "
            f"{w['peak_reserved_gib']:.3f} GiB reserved"
            + ("" if "cold" not in w else
               f"; cold run: prefill {w['cold']['prefill_ms']:.3f} ms, "
               f"step median {w['cold']['decode_ms'][0]:.3f} ms"))


def mesh_serve_run(tag, mesh, card) -> None:
    """17(a)'s models at ``MESH_LAYERS`` served on ``mesh`` (ranks sharing
    the card over gloo, or a card a rank over NCCL) beside the unsharded
    models they are held to (a process of its own on the first card):
    gates 1-4, each rank's served lines."""
    from repro_torch.launch.mesh import spawn_mesh, spawn_pods
    spec = {"device": "cuda", "meshes": [mesh],
            "models": [(a, MESH_LAYERS) for a in MESH_MODELS]}
    box = {}

    def reference():
        try:
            box["ref"] = spawn_pods(mesh_reference_path, 1, "cuda",
                                    args=(spec,), timeout=600)[0]
        except BaseException as e:      # re-raised in the phase's thread
            box["error"] = e
    ref_thread = threading.Thread(target=reference)
    ref_thread.start()
    try:
        res = spawn_mesh(mesh_serve_path, *mesh, "cuda", args=(spec,),
                         timeout=600)
    finally:
        ref_thread.join()
    if "error" in box:
        raise box["error"]
    check_mesh_gates(tag, box["ref"], res, mesh, MESH_MODELS, card)
    for arch in MESH_MODELS:
        log_mesh_served(tag, arch, mesh, res, card)
    log(f"{tag}: on {mesh}, tokens identical on every rank, weight bytes "
        f"the shards', K1-K16 launched 0 times")


def serve_mesh_phase(torch, card) -> None:
    """Phase 17: (a) qwen3-8b and dbrx-132b at full width, 1 layer, on a
    (1, 2) mesh of ranks sharing the card, held to the unsharded model;
    (b) with four cards, over NCCL, dbrx-132b on (1, 4), gated at 8
    layers and served at 40, and (a)'s models on (2, 2)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # the unsharded models run beside the mesh (together ~45 GB of the
    # card at their peaks)
    mesh_serve_run("phase 17 (a)", MESH_A_SHAPE, card)
    mesh_big_phase(torch)


def mesh_big_phase(torch) -> None:
    """Phase 17(b): dbrx-132b on a (1, 4) mesh of four cards over NCCL,
    then 17(a)'s models on (2, 2); one line and nothing else on fewer
    cards."""
    import gc
    from repro_torch.launch.mesh import spawn_mesh, spawn_pods
    tag = "phase 17 (b)"
    n = torch.cuda.device_count()
    if n < 4:
        log(f"{tag}: {n} card(s): dbrx-132b at 40 layers on a (1, 4) mesh "
            f"and qwen3-8b and dbrx-132b on (2, 2) need four; not run")
        return
    cards = four_cards()
    gc.collect()
    torch.cuda.empty_cache()
    spec = {"device": "cuda"}
    (ref,) = spawn_pods(mesh_big_reference_path, 1, "cuda", args=(spec,),
                        timeout=900)
    res = spawn_mesh(mesh_big_path, *MESH_B["mesh"], "cuda", args=(spec,),
                     timeout=1200)
    arch = MESH_B["arch"]
    check_mesh_gates(tag, ref, res, MESH_B["mesh"],
                     [arch], cards)
    m = res[0]["models"][arch]
    log(f"{tag}: {arch} at {m['n_layers']} layers, {m['n_params']} "
        f"parameters per rank, init "
        f"{max(r['models'][arch]['init_s'] for r in res):.2f} s")
    log_mesh_served(tag, arch, MESH_B["mesh"], res, cards)
    log(f"{tag}: tokens identical on every rank, weight bytes the "
        f"shards', K1-K16 launched 0 times")
    del ref, res
    gc.collect()
    mesh_serve_run(tag, MESH_B_D2, cards)


# ---------------------------------------------------------------------------
# phase 18: training on a within-pod ("data", "model") mesh
# ---------------------------------------------------------------------------

#: the largest step peak per parameter of a mesh rank that phase 18
#: measured (qwen3-8b, 2 layers on (1, 2), whose embedding half is 62% of
#: a rank's parameters: 51.34 B on an H100 80GB HBM3 at 700 W), rounded up
MESH_BYTES_PER_PARAM = 52.0
#: 18(a): the D * M ranks share the one card (gloo, staged through pinned
#: host memory; the times are the host's).  Full width, cut in depth: the
#: ranks' summed peak, reckoned at ``MESH_BYTES_PER_PARAM`` per parameter
#: of each rank, leaves ``ZOO_FREE_GIB`` of the card.  qwen3-8b does not
#: fit four ranks on one card even at 1 layer (each holds half its
#: 622M-entry embedding: 74.6 GB reckoned; it ran out of memory), so
#: (2, 2) ran qwen3-moe-30b-a3b (half of a 311M-entry embedding a rank),
#: and qwen3-8b trains on (2, 2) in (b).  At D = 2 every step gathers the
#: FSDP halves through gloo on the host (qwen3-moe's local step 6.6 s on
#: (2, 2) against 0.68 s on (1, 2)): since phase 22 joined the script
#: qwen3-moe's (2, 2) run is in (b), over NCCL at its reckoned depth (and
#: on the CPU, tests/test_torch_mesh_train_ref_2x2.py); a spec's "steps",
#: "H" and "loop_grad_sync" (False: the all-rungs round alone) cut a run,
#: and at D = 2 gate 1 runs at capacity 1.25 only
MESH_TRAIN_A = ({"arch": "qwen3-8b", "n_layers": 2, "mesh": (1, 2)},
                {"arch": "qwen3-moe-30b-a3b", "n_layers": 1, "mesh": (1, 2)})
#: 18(a)'s batch (global) x sequence
MESH_TRAIN_A_SHAPE = (4, 512)
#: 18(b), with four cards or more, over NCCL: depth by
#: ``launch.memory.mesh_train_depth`` at ``MESH_BYTES_PER_PARAM``, leaving
#: ``ZOO_FREE_GIB`` of each card; qwen3-moe-30b-a3b's (2, 2) run (FSDP and
#: 64 experts a rank), 18(a)'s until phase 22 joined the script
MESH_TRAIN_B = ({"arch": "dbrx-132b", "mesh": (1, 4)},
                {"arch": "qwen3-8b", "mesh": (2, 2)},
                {"arch": "qwen3-moe-30b-a3b", "mesh": (2, 2)})
MESH_TRAIN_B_SHAPE = (8, 1024)
#: the loop's steps (replan every 4: local x 3, delta_sync, the replan,
#: local; a mesh's "steps" and "H" where it gives them), then a grad_sync
#: under the loop's plan and an all-rungs one
MESH_TRAIN_STEPS = 5
#: gate 1, f32 compute: each leaf's gathered gradient within this much of
#: its norm, the loss within this much of its value
MESH_GATE1_RTOL = 1e-3
#: gate 1's runs: (name, capacity factor E / K?, against
#: ``moe_apply_blocked``?)
MESH_GATE1_RUNS = {"dense": (("f32", False, False),),
                   "moe": (("f32, cf E/K", True, False),
                           ("f32, cf 1.25", False, True))}


def mesh_train_config(arch, n_layers, batch, seq, H=None):
    """(the config cut to ``n_layers`` (an encoder-decoder's encoder with
    it), its RunConfig as phase 12's, the sync interval ``H`` where
    given)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.launch.memory import cut_depth
    cfg = cut_depth(ARCHS[arch], n_layers)
    ace = ACESyncConfig(replan_every=4)
    if H:
        ace = dataclasses.replace(ace, sync_interval_init=H)
    run = RunConfig(model=cfg, shape=ShapeConfig("session", seq, batch,
                                                 "train"),
                    total_steps=100, warmup_steps=2, ckpt_every=0,
                    ckpt_dir=str(CKPT_ROOT / "mesh_train"), acesync=ace)
    return cfg, run


def gate1_runs(family, mesh) -> tuple:
    """Gate 1's runs of a ``family`` model on ``mesh``: at D = 2 only
    those against ``moe_apply_blocked``, where the family has them."""
    runs = MESH_GATE1_RUNS[family]
    return tuple(r for r in runs if mesh[0] == 1 or r[2]) or runs


def gate1_model(torch, model, run_spec, blocked=None):
    """Switch ``model`` to gate 1's run ``run_spec`` (f32 compute, the
    capacity factor, ``moe_apply_blocked`` over the ``blocked`` (D, M)
    for an unsharded model); returns the undo."""
    from repro_torch.models import moe
    _, ek, use_blocked = run_spec
    cfg, dtype, apply = model.cfg, model.dtype, moe.moe_apply
    change = {"dtype": "float32"}
    if ek:
        change["capacity_factor"] = cfg.n_experts / cfg.experts_per_token
    model.cfg = dataclasses.replace(cfg, **change)
    model.dtype = torch.float32
    if use_blocked and blocked:
        moe.moe_apply = (lambda p, x, c: moe.moe_apply_blocked(
            p, x, c, *blocked))

    def undo():
        model.cfg, model.dtype, moe.moe_apply = cfg, dtype, apply
    return undo


def gate1_key(arch, n_layers, run_spec, mesh) -> str:
    """The name of gate 1's reference run: the model, its depth, the run
    and, for a blocked run, the mesh whose blocks it dispatches."""
    key = f"{arch}@{n_layers}/{run_spec[0]}"
    return key + (f"/{mesh[0]}x{mesh[1]}" if run_spec[2] and mesh else "")


def loss_and_grads(torch, model, batch):
    """The loss and the leaves' gradients (on a mesh rank: reduced to the
    rank's shards of the global gradient)."""
    from repro_torch import tree as T
    leaves = T.leaves(model.param_tree())
    with torch.enable_grad():
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves)
    if model.ctx is not None:
        grads = model.reduce_grads(grads)
    return float(loss.detach()), grads


def mesh_train_ref_path(group, spec):
    """Gate 1's unsharded models on one card (a process of its own, before
    the meshes): each (arch, depth) from seed 0 as the Trainer draws it,
    each run's loss and gradients on the meshes' first batch; the
    gradients go to ``spec["dir"]/<arch>/<run>[/DxM]/<leaf>.npy``."""
    import gc
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, n_layers, meshes in spec["models"]:
        cfg, run = mesh_train_config(arch, n_layers, *MESH_TRAIN_A_SHAPE)
        model = build_model(cfg, run, device="cuda")
        model.init_params(torch.Generator(device="cuda").manual_seed(0))
        batch = next(TokenPipeline(model, run.shape, seed=0))
        paths = [T.path_str(q) for q, _ in
                 T.leaves_with_path(model.param_tree())]
        for rs in MESH_GATE1_RUNS[cfg.family]:
            for mesh in [m for m in meshes if rs in gate1_runs(
                    cfg.family, m)][:None if rs[2] else 1]:
                key = gate1_key(arch, n_layers, rs, mesh)
                undo = gate1_model(torch, model, rs, mesh)
                try:
                    loss, grads = loss_and_grads(torch, model, batch)
                finally:
                    undo()
                d = Path(spec["dir"]) / "".join(
                    ch if ch.isalnum() else "_" for ch in key)
                d.mkdir(parents=True, exist_ok=True)
                for q, g in zip(paths, grads):
                    np.save(d / (q.replace("/", ".") + ".npy"),
                            g.cpu().numpy())
                out[key] = {"loss": loss, "dir": str(d)}
                del grads
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_gate1(torch, np, sess, ctx, ref):
    """Gate 1 on a rank: each of the model's runs' loss and the rank's
    reduced gradient shards against the unsharded model's (``ref``:
    {key: {"loss", "dir"}}); per leaf the norms of the difference and of
    the reference summed over the world, each shard once.  Returns
    {run: (loss, reference loss, {leaf: relative error})}."""
    from repro_torch import tree as T
    model, tr = sess.model, sess.trainer
    batch = {k: torch.from_numpy(v).to(ctx.device)
             for k, v in sess.pipeline.host_batch(0).items()}
    paths = [T.path_str(q) for q, _ in T.leaves_with_path(model.param_tree())]
    out = {}
    for rs in gate1_runs(model.cfg.family, (ctx.D, ctx.M)):
        key = gate1_key(model.cfg.name, model.cfg.n_layers, rs,
                        (ctx.D, ctx.M))
        undo = gate1_model(torch, model, rs)
        try:
            loss, grads = loss_and_grads(torch, model, batch)
        finally:
            undo()
        rows = []
        for q, g in zip(paths, grads):
            w = np.load(Path(ref[key]["dir"]) / (q.replace("/", ".")
                                                 + ".npy"), mmap_mode="r")
            w = torch.from_numpy(np.ascontiguousarray(
                w[model.shard_index(q)])).to(ctx.device)
            rows.append(torch.stack([((g.float() - w) ** 2).sum(),
                                     (w ** 2).sum()]))
            del w
        sums = tr._mesh_sum(torch.stack(rows))
        rel = (sums[:, 0].sqrt() / sums[:, 1].sqrt().clamp_min(1e-30)).cpu()
        out[rs[0]] = (loss, ref[key]["loss"],
                      dict(zip(paths, rel.tolist())))
        del grads
    return out


def checked_sync(torch, T, S, current, record):
    """``sync_tree`` wrapped for gate 2: before the trainer's round, the
    one-pod ``sync_tree`` of the step's host plan on this rank's own
    grads, errors and local layout (no apply; the apply function, which
    is elementwise, run on its whole leaves after) — each output leaf's
    bit hash — then the trainer's round, whose output leaves must hash
    alike.  The reference round's buffers are freed before the trainer's
    starts.  With a pod group (pods x mesh) the reference round is the
    pod-only round over it, and the record holds the bytes the trainer's
    round moved over the group beside the priced ones (``tier_priced``:
    gather + ring, FULL, the plan's payload and FULL bytes, FULL's
    padding bound); on a two-tier fleet (``pods.n_edge`` > 1) the cross
    tier's bytes are those of the group and its ``cross`` sub-group, and
    the record's "intra" holds the ``intra`` sub-group's beside the priced
    intra bytes and their padding bound."""
    real = S.sync_tree

    def leaf_hashes(ts):
        return torch.stack([bits_hash(torch, t) for t in ts]).tolist()

    def sync_tree(tree, errors, plan, *, gamma, block, apply_fn=None,
                  apply_aux=(), apply_scalars=(), **kw):
        pods = kw.get("pods")
        log0 = 0 if pods is None else len(pods.log)
        agg, err = real(tree, errors, current["plan"], gamma=gamma,
                        block=block, **{k: kw[k] for k in ("pods",
                                                           "fixed_bits")
                                        if k in kw})
        want = leaf_hashes(T.leaves(err))
        if apply_fn is None:
            want += leaf_hashes(T.leaves(agg))
        else:
            aux = [T.leaves(a) for a in apply_aux]
            outs = [[] for _ in aux]
            for i, g in enumerate(T.leaves(agg)):
                rows = apply_fn(g.reshape(1, -1),
                                tuple(a[i].float().reshape(1, -1)
                                      for a in aux), apply_scalars)
                for j, r in enumerate(rows):
                    outs[j].append(bits_hash(torch, r.to(aux[j][i].dtype)))
            want += [int(h) for o in outs for h in o]
        del agg, err
        since = 0 if pods is None else len(pods.log)
        # the check's own round moved bytes over the pods: phase 24 (b)
        # leaves them out of the step's
        current.setdefault("skip", []).append((log0, since))
        out, new_err = real(tree, errors, plan, gamma=gamma, block=block,
                            apply_fn=apply_fn, apply_aux=apply_aux,
                            apply_scalars=apply_scalars, **kw)
        got = leaf_hashes(T.leaves(new_err))
        got += (leaf_hashes(T.leaves(out)) if apply_fn is None else
                [h for o in out for h in leaf_hashes(T.leaves(o))])
        entry = {"kind": current["kind"], "leaves": len(got),
                 "differ": sum(a != b for a, b in zip(got, want))}
        if pods is not None and pods.size > 1:
            new = [x for x in pods.log[since:]
                   if x["tier"] in (pods.tier, "cross")]
            pay, full, intra, pad, ipad = tier_priced(plan, pods.size,
                                                      pods.n_edge)
            entry["bytes"] = (
                sum(x["bytes"] for x in new if x["op"] in ("gather",
                                                           "ring")),
                sum(x["bytes"] for x in new if x["op"] == "full"), pay,
                full, pad)
            if pods.n_edge > 1:
                entry["intra"] = (sum(x["bytes"] for x in pods.log[since:]
                                      if x["tier"] == "intra"), intra, ipad)
        record.append(entry)
        return out, new_err
    return sync_tree


def mesh_train_path(ctx, spec, session=None, stops=(), on_step=None):
    """One rank of phase 18: ``spec["arch"]`` at full width and
    ``spec["n_layers"]``, sharded on the mesh, trained from seed 0
    through TrainSession (``session()`` builds it where given, phase
    18's config otherwise): gate 1 (a) on the first batch, then
    ``spec["steps"]`` (``MESH_TRAIN_STEPS``) steps of the loop, a
    grad_sync under its plan and an all-rungs one, each on CUDA events,
    the sync rounds checked (gate 2), the kernels' launches counted from
    0 before the loop; ``stops``: (n, fn) pairs, ``fn(sess, out)`` called
    after the loop's first n steps (n = 0: before the loop);
    ``on_step(sess, result, plan, kind)`` called after every step; with
    ``spec["memory"]``, ``launch.memory.step_memory`` after.  The
    all-rungs round puts the levels ``spec["rungs"]`` on the groups
    (round robin where not given) and runs once under the trainer's own
    exec plan or, with ``spec["rings"]``, once per ring setting (-1:
    one-shot, K: K chunks), or with ``spec["rounds"]`` once per (tier
    grid, ring setting) pair on a two-tier fleet (the tier grid as
    ``planexec.hier_override`` takes it: -1 flat, 1 / 2 two-tier with the
    bf16 / INT8 intra stage)."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.core import planexec
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops
    from repro_torch.launch.memory import state_bytes, step_memory
    from repro_torch.launch.session import TrainSession
    from repro_torch.models import flops
    from repro_torch.models.registry import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if session is None:
        cfg, run = mesh_train_config(spec["arch"], spec["n_layers"],
                                     *spec["shape"], H=spec.get("H"))
        sess = TrainSession(build_model(cfg, run, device=ctx.device,
                                        ctx=ctx), run, strategy="acesync")
    else:
        sess = session()
    sess.init()
    torch.cuda.synchronize()
    out = {"rank": ctx.rank, "backend": ctx.world.backend,
           "init_s": time.perf_counter() - t0,
           "state_bytes": state_bytes(sess.state),
           "n_params": sum(p.numel() for p in sess.model.parameters())}
    if spec.get("ref"):
        out["gate1"] = mesh_gate1(torch, np, sess, ctx, spec["ref"])
    tr = sess.trainer
    current, record, times, step = {}, [], [], tr.step

    def timed(state, batch, plan, kind="grad_sync"):
        current.update(plan=plan, kind=kind)
        before = sum(ops.launch_counts().get(k, 0) for k in KERNELS)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = step(state, batch, plan, kind)
        e1.record()
        times.append((kind, e0, e1, sum(ops.launch_counts().get(k, 0)
                                        for k in KERNELS) - before))
        if on_step:
            on_step(sess, res, plan, kind)
        return res

    tr.step = timed
    S.sync_tree = checked_sync(torch, T, S, current, record)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    done = 0
    for n, fn in sorted(stops, key=lambda x: x[0]) + [
            (spec.get("steps", MESH_TRAIN_STEPS), None)]:
        if n > done:
            sess.run(n - done, log_every=0)
            done = n
        if fn:
            fn(sess, out)
    sess.finish()
    state = sess.take_state()
    extra = []
    if spec.get("loop_grad_sync", True):
        state, m = tr.step(state, next(sess.pipeline), sess.loop.plan,
                           "grad_sync")
        extra.append(("grad_sync", m))
    rr = tr.scheduler.plan_from_levels(
        list(spec.get("rungs") or (i % 8 for i in range(len(tr.sizes)))),
        (1.0,) if tr.n_pods == 1 else sess.loop.plan.omega)
    rounds = spec.get("rounds") or [(None, r)
                                     for r in spec.get("rings", (None,))]
    from repro_torch.analysis.cost import collectives
    out["step_logs"] = {}
    for hier, ring in rounds:
        plan, kind = rr, "grad_sync_all_rungs"
        if ring is not None:
            plan = planexec.build_exec_plan(
                rr, layout=tr.leaf_layout, n_pods=tr.n_pods, ring=ring,
                n_edge=tr.n_edge, hier=hier,
                segments=planexec.config_segments(
                    sess.run_config.acesync), device=ctx.device)
            kind += f"_k{max(ring, 0)}"
            if hier is not None:
                kind += "_flat" if hier < 0 else f"_intra{hier}"
        log, a = ctx.world.log, len(ctx.world.log)
        current["skip"] = []
        state, m = tr.step(state, next(sess.pipeline), plan, "grad_sync")
        extra.append((kind, m))
        out["step_logs"][kind] = collectives(
            [e for i, e in enumerate(log[a:], a)
             if not any(x <= i < y for x, y in current["skip"])])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t1
    out["launches"] = ops.launch_counts()
    out["peak_alloc"] = torch.cuda.max_memory_allocated()
    out["card_bytes"] = torch.cuda.get_device_properties(
        ctx.device).total_memory
    out["losses"] = sess.losses + [float(m["loss"]) for _, m in extra]
    out["grad_norms"] = [h["grad_norm"] for h in sess.history
                         if "grad_norm" in h] + [float(m["grad_norm"])
                                                 for _, m in extra]
    out["kinds"] = [k for h in sess.history for k in h["kinds"]] + [
        k for k, _ in extra]
    out["plan"] = list(sess.loop.plan.level_idx)
    out["replans"] = sess.loop.device_replans
    out["step"] = int(state["step"])
    out["importance"] = [int(bits_hash(torch, x)) for x in T.leaves(
        dict(zip(state["ace"].importance._fields, state["ace"].importance)))]
    out["finite"] = all(bool(torch.isfinite(p).all())
                        for p in T.leaves(state["params"]))
    out["sync"] = record
    out["ms"], out["sync_launches"] = {}, []
    first = len(times) - len(extra)
    for i, (kind, e0, e1, n) in enumerate(times):
        kind = extra[i - first][0] if i >= first else kind
        out["ms"].setdefault(kind, []).append(e0.elapsed_time(e1))
        if kind != "local":
            out["sync_launches"].append((kind, n))
    shape = sess.run_config.shape
    out["model_flops"] = flops.model_flops(sess.model.cfg, shape,
                                           sess.model.active_param_count())
    if sess.model.cfg.family == "encdec":
        out["executed_flops"] = flops.executed_flops(sess.model.cfg, shape)
    out["tokens"] = shape.global_batch * shape.seq_len
    if spec.get("memory"):
        # the state is handed over, as TrainSession.run hands it to the
        # loop: each step kind frees the state it replaces
        del m, extra
        sess.state, state = state, None
        mem = step_memory(tr, sess.take_state(), next(sess.pipeline), rr,
                          sess.loop.plan)
        out["memory"] = {k: mem[k] for k in ("n_params", "per_param",
                                             "peak")}
    return out


def mesh_train_paths(ctx, specs):
    """Phase 18 (a), one rank: :func:`mesh_train_path` for each model of
    ``specs`` on this mesh in turn, the memory of one freed before the
    next (each resets the peak it reports)."""
    import gc
    import torch
    from repro_torch.core import sync as S
    out = []
    for spec in specs:
        plain = S.sync_tree
        try:
            out.append(mesh_train_path(ctx, spec))
        finally:
            S.sync_tree = plain
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_mesh_train(tag, card, spec, res, cards=1) -> dict:
    """Gates 1-4 of one mesh's ranks and their lines; returns the
    kernels' launches summed over the ranks."""
    from repro_torch.models import flops
    arch, (D, M) = spec["arch"], spec["mesh"]
    name = f"{arch} on ({D}, {M})"
    r0 = res[0]
    for r in res:
        if not r["finite"] or not all(math.isfinite(x)
                                      for x in r["losses"]):
            fail(f"{tag}: {name} rank {r['rank']}: non-finite losses "
                 f"{r['losses']} or parameters")
        # gate 3: the same trajectory on every rank
        for key in ("losses", "grad_norms", "plan", "step", "importance",
                    "kinds"):
            if r[key] != r0[key]:
                fail(f"{tag}: {name}: rank {r['rank']}'s {key} "
                     f"{r[key]} differ from rank 0's {r0[key]}")
        # gate 2: every sync round bit-identical to the one-pod round
        bad = [x for x in r["sync"] if x["differ"]]
        if bad or not r["sync"]:
            fail(f"{tag}: {name} rank {r['rank']}: sync rounds not the "
                 f"one-pod round on the rank's shards: {bad or 'none run'}")
        # gate 4: K1-K4 on every rank
        missing = [k for k in KERNELS if r["launches"].get(k, 0) < 1]
        if missing:
            fail(f"{tag}: {name} rank {r['rank']}: kernels never "
                 f"launched: {missing}")
        free = (r["card_bytes"] - r["peak_alloc"] * (D * M if cards == 1
                                                     else 1)) / 2**30
        if free < 0:
            fail(f"{tag}: {name}: peak {r['peak_alloc']} B a rank "
                 f"overflows the card")
        if "gate1" in r:
            for run, (loss, want, rel) in r["gate1"].items():
                worst = max(rel, key=rel.get)
                ok = (abs(loss - want) <= MESH_GATE1_RTOL * abs(want)
                      and rel[worst] <= MESH_GATE1_RTOL)
                if r["rank"] == 0:
                    log(f"{tag}: {name}, gate 1 ({run}): loss {loss:.7g} "
                        f"against the unsharded model's {want:.7g}; the "
                        f"gathered gradients' largest |diff| / |ref| "
                        f"{rel[worst]:.4g} ({worst}), within "
                        f"{MESH_GATE1_RTOL} [{card}]")
                if not ok:
                    fail(f"{tag}: {name} rank {r['rank']}, gate 1 ({run}): "
                         f"loss {loss} vs {want}, {worst} at {rel[worst]}")
    log(f"{tag}: {name}: steps {r0['kinds']}, losses "
        f"{[round(x, 4) for x in r0['losses']]}, grad norms "
        f"{[round(x, 4) for x in r0['grad_norms']]}, plan {r0['plan']} "
        f"({r0['replans']} device replan(s)) identical on all {D * M} "
        f"ranks; {sum(len(r['sync']) for r in res)} sync rounds "
        f"bit-identical to the one-pod round on each rank's shards; K1-K4 "
        f"launches per rank {[[r['launches'].get(k, 0) for k in KERNELS] for r in res]}; "
        f"K1-K4 launches of each sync step (rank 0) {r0['sync_launches']}")
    for r in res:
        ms = dict(r["ms"])
        line = []
        for kind, xs in ms.items():
            med, lo, hi = _spread(xs)
            line.append(f"{kind} {med:.3f} ({lo:.3f}-{hi:.3f})")
        med = _spread(ms["local"])[0]
        mfu = flops.mfu(r["model_flops"], med * 1e-3, cards=D * M)
        extra = ""
        if "executed_flops" in r:
            extra = (f"; executed {r['executed_flops']:.4g} FLOPs: MFU "
                     f"{flops.mfu(r['executed_flops'], med * 1e-3, D * M):.6g}")
        if "memory" in r:
            pp = r["memory"]["per_param"]
            extra += ("; bytes per parameter " + ", ".join(
                f"{k} {v:.2f}" for k, v in sorted(pp.items())))
        log(f"{tag}: {name} over {r['backend']}, rank {r['rank']} on "
            f"{card}: {r['n_params']:,} parameters, train state "
            f"{r['state_bytes']:,} B, init {r['init_s']:.2f} s; step ms "
            f"median (min-max): {'; '.join(line)}; local "
            f"{r['tokens'] / (med * 1e-3):.1f} tokens/s, MFU {mfu:.6g} at "
            f"6 * N_active * tokens ({r['model_flops']:.4g} FLOPs) of "
            f"{D * M} x 989 TFLOP/s; peak {r['peak_alloc'] / 2**30:.3f} "
            f"GiB allocated ({r['peak_alloc'] / r['n_params']:.2f} B per "
            f"parameter){extra}")
    return {k: sum(r["launches"].get(k, 0) for r in res)
            for k in r0["launches"]}


def mesh_train_reckoning(tag, cfgs, card_bytes, shared, batch,
                         seq) -> None:
    """Each mesh's reckoned peak per card (``MESH_BYTES_PER_PARAM`` per
    parameter of each rank, plus a rank's scan bytes at the step's
    ``batch`` x ``seq``: ``launch.memory.mesh_train_bytes``; the ranks'
    sum where they share the card) must leave ``ZOO_FREE_GIB`` of it."""
    from repro_torch.launch.memory import mesh_train_bytes
    for cfg, (D, M) in cfgs:
        per = mesh_train_bytes(cfg, D, M, MESH_BYTES_PER_PARAM, batch, seq)
        peak = sum(per) if shared else max(per)
        free = (card_bytes - peak) / 2**30
        log(f"{tag}: {cfg.name} at {cfg.n_layers} layers on ({D}, {M}): "
            f"{peak / 2**30:.2f} GiB reckoned per card "
            f"({MESH_BYTES_PER_PARAM} B x each rank's parameters, its "
            f"scan at {batch} x {seq}"
            f"{', the ranks summed' if shared else ''}), {free:.2f} GiB "
            f"of {card_bytes / 2**30:.2f} free")
        if free < ZOO_FREE_GIB:
            fail(f"{tag}: {cfg.name} at {cfg.n_layers} layers on ({D}, {M}) "
                 f"does not fit with {ZOO_FREE_GIB} GiB to spare")


def mesh_train_phase(torch, card) -> dict:
    """Phase 18: (a) training on meshes of ranks sharing the card, gates
    1-4; (b) with four cards, dbrx-132b on (1, 4) and qwen3-8b on (2, 2)
    over NCCL, gates 2-4.  Returns the kernels' launches per path."""
    import gc
    from repro_torch.launch.mesh import spawn_mesh, spawn_pods
    tag = "phase 18 (a)"
    gc.collect()
    torch.cuda.empty_cache()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    B, S = MESH_TRAIN_A_SHAPE
    mesh_train_reckoning(tag, [(mesh_train_config(
        c["arch"], c["n_layers"], B, S)[0], c["mesh"])
        for c in MESH_TRAIN_A], card_bytes, True, B, S)
    models = {}
    for c in MESH_TRAIN_A:
        models.setdefault((c["arch"], c["n_layers"]), []).append(c["mesh"])
    gdir = CKPT_ROOT / "mesh_train_grads"
    t0 = time.perf_counter()
    (ref,) = spawn_pods(mesh_train_ref_path, 1, "cuda", args=(
        {"dir": str(gdir), "models": [(a, n, m) for (a, n), m in
                                      models.items()]},), timeout=600)
    log(f"{tag}: gate 1's unsharded models and their saved gradients "
        f"{time.perf_counter() - t0:.2f} s")
    launches, meshes = {}, {}
    for c in MESH_TRAIN_A:
        meshes.setdefault(c["mesh"], []).append(c)
    for mesh, cs in meshes.items():
        # the mesh's models in turn in one spawn (a fresh process costs
        # seconds before its first step)
        specs = [dict(c, shape=MESH_TRAIN_A_SHAPE, ref=ref) for c in cs]
        res = spawn_mesh(mesh_train_paths, *mesh, "cuda", args=(specs,),
                         timeout=600)
        for i, c in enumerate(cs):
            launches[f"mesh_{c['arch']}_{mesh[0]}x{mesh[1]}"] = \
                check_mesh_train(tag, card, c, [r[i] for r in res])
        log(f"{tag}: {time.perf_counter() - t0:.2f} s so far")
    shutil.rmtree(gdir, ignore_errors=True)
    launches.update(mesh_train_big_phase(torch))
    return launches


def mesh_train_big_phase(torch) -> dict:
    """Phase 18(b): dbrx-132b on (1, 4), qwen3-8b and qwen3-moe-30b-a3b
    on (2, 2), a card a rank, over NCCL, at the depths the reckoning
    gives; one line and nothing else on fewer cards."""
    tag = "phase 18 (b)"
    n = torch.cuda.device_count()
    if n < 4:
        log(f"{tag}: {n} card(s): dbrx-132b on a (1, 4) mesh, qwen3-8b and "
            f"qwen3-moe-30b-a3b on (2, 2) train on four; not run")
        return {}
    return mesh_train_big(torch, tag, MESH_TRAIN_B, four_cards(), "mesh_b_")


def mesh_train_big(torch, tag, cases, cards, prefix) -> dict:
    """Each of ``cases`` trained a card a rank over NCCL at batch
    ``MESH_TRAIN_B_SHAPE``, at its ``n_layers`` or the most layers
    ``launch.memory.mesh_train_depth`` fits in each card less
    ``ZOO_FREE_GIB`` (its scan counted), phase 18's gates 2-4 and
    lines.  Returns the kernels' launches per path ``prefix`` +
    ``<arch>_<D>x<M>``."""
    import gc
    from repro_torch.configs import ARCHS
    from repro_torch.launch.memory import mesh_train_depth
    from repro_torch.launch.mesh import spawn_mesh
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    limit = card_bytes - ZOO_FREE_GIB * 2**30
    B, S = MESH_TRAIN_B_SHAPE
    launches = {}
    for c in cases:
        gc.collect()
        torch.cuda.empty_cache()
        layers = c.get("n_layers") or mesh_train_depth(
            ARCHS[c["arch"]], *c["mesh"], limit, MESH_BYTES_PER_PARAM,
            batch=B, seq=S)
        if layers < 1:
            fail(f"{tag}: {c['arch']} on {c['mesh']}: not one layer fits")
        cfg, _ = mesh_train_config(c["arch"], layers, B, S)
        mesh_train_reckoning(tag, [(cfg, c["mesh"])], card_bytes, False, B,
                             S)
        spec = dict(c, n_layers=layers, shape=MESH_TRAIN_B_SHAPE,
                    memory=True)
        # the ranks' allocator grows its segments in place: with fixed
        # segments qwen3-8b's 24-layer ranks left 17.8-28.6 GiB reserved
        # but unallocated and could not place the sync round's 5.47 GiB
        # buffer
        saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            res = spawn_mesh(mesh_train_path, *c["mesh"], "cuda",
                             args=(spec,), timeout=900)
        finally:
            if saved is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
        D, M = c["mesh"]
        launches[f"{prefix}{c['arch']}_{D}x{M}"] = check_mesh_train(
            tag, cards, dict(c, n_layers=layers), res, cards=4)
    return launches


# ---------------------------------------------------------------------------
# phase 19: checkpoints on a within-pod ("data", "model") mesh
# ---------------------------------------------------------------------------

#: 19(a): paper-350m at full width and phase 9a's depth, batch 8 x 1024,
#: deterministic, in one fleet of four processes sharing the card over
#: gloo (one spawn: a fresh process costs seconds before its first step).
#: Fleet ranks 0-1 run ``steps`` uninterrupted steps on ``mesh``
#: checkpointing every ``ckpt_every``; ranks 2-3, fresh processes in a
#: group of their own that never trained, resume on ``mesh`` from step
#: ``resume`` to ``steps``; the last checkpoint is restored on every
#: shape of ``restore_on`` (the fleet's first ranks; None: one card
#: without a mesh, rank 0; (2, 1), 8 s through gloo, left out since
#: phase 22 joined the script), and on ``mesh`` after rank 0 corrupts a
#: leaf
MESH_CKPT_A = {"n_layers": RESTART["n_layers"], "batch": 8, "seq": 1024,
               "steps": 4, "ckpt_every": 2, "resume": 2, "mesh": (1, 2),
               "restore_on": ((2, 2), None)}
#: 19(b), with four cards, over NCCL: paper-350m at full depth on (2, 2),
#: ``steps`` steps checkpointing every ``ckpt_every``; the last
#: checkpoint restored on (1, 4) and on one card
MESH_CKPT_B = {"n_layers": None, "batch": 8, "seq": 1024, "steps": 4,
               "ckpt_every": 2, "mesh": (2, 2), "restore_on": ((1, 4), None)}


def mesh_ckpt_session(torch, spec, ctx, ckpt_dir):
    """A TrainSession of paper-350m at full width and ``spec``'s depth
    on ``ctx``'s mesh (None: one card), deterministic, checkpointing to
    ``ckpt_dir`` every ``spec["ckpt_every"]`` steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ACESyncConfig, RunConfig, ShapeConfig
    from repro_torch.launch.session import TrainSession, apply_determinism
    from repro_torch.models.registry import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ARCHS["paper-350m"]
    if spec["n_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    run = RunConfig(model=cfg, shape=ShapeConfig("session", spec["seq"],
                                                 spec["batch"], "train"),
                    total_steps=100, warmup_steps=2, ckpt_dir=str(ckpt_dir),
                    ckpt_every=spec["ckpt_every"],
                    acesync=ACESyncConfig(replan_every=4),
                    deterministic=True)
    apply_determinism(run)
    dev = "cuda" if ctx is None else ctx.device
    return TrainSession(build_model(cfg, run, device=dev, ctx=ctx), run,
                        strategy="acesync", blocking_replans=True)


def mesh_ckpt_timed_init(torch, sess) -> float:
    """Restore (or initialise) the session's state; its seconds."""
    t0 = time.perf_counter()
    sess.init()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mesh_ckpt_bits(torch, sess) -> dict:
    """The rank's state hashes per leaf (reference order), the loop's
    host state and the losses."""
    from repro_torch import tree as T
    lp = sess.loop
    return {"hashes": [int(bits_hash(torch, x)) for _, x in
                       T.reference_leaves_with_path(sess.state)],
            "host": (list(lp.plan.level_idx), lp.plan.sync_interval, lp._H,
                     lp._steps_since_sync,
                     sess.trainer.scheduler.sync_interval,
                     int(sess.state["step"])),
            "losses": sess.losses}


def same_bytes(a: Path, b: Path) -> bool:
    """Two files hold the same bytes."""
    import numpy as np
    return (a.stat().st_size == b.stat().st_size
            and np.array_equal(np.fromfile(a, np.uint8),
                               np.fromfile(b, np.uint8)))


def mesh_ckpt_train_path(ctx, spec):
    """Phase 19, one rank of a training run: ``spec["dir"]``'s run of
    ``spec["steps"]`` steps (resuming from the checkpoint there, if any)
    and one all-rungs ``grad_sync`` after it, the kernels' launches
    counted from 0 before the run."""
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import ops
    sess = mesh_ckpt_session(torch, spec, ctx, spec["dir"])
    out = {"rank": ctx.rank, "backend": ctx.world.backend}
    ops.reset_launch_counts()
    out["init_s"] = mesh_ckpt_timed_init(torch, sess)
    out["start"] = int(sess.state["step"])
    t0 = time.perf_counter()
    sess.run(spec["steps"] - out["start"], log_every=0)
    sess.finish()
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["step_s"] = [round(h["dt"], 3) for h in sess.history]
    out["save"] = dict(sess.loop.ckpt.last_save)
    out.update(mesh_ckpt_bits(torch, sess))
    tr = sess.trainer
    rr = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.sizes))], (1.0,))
    state, _ = tr.step(sess.take_state(), next(sess.pipeline), rr,
                       "grad_sync")
    out["all_rungs"] = [int(bits_hash(torch, x)) for _, x in
                        T.reference_leaves_with_path(state)]
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    return out


def mesh_ckpt_fleet_path(world, spec):
    """Phase 19 (a), one process of the fleet of four (``MESH_CKPT_A``):
    its part in the uninterrupted run (``A``), the resumed run (``B``),
    the restores of A's last checkpoint and, after rank 0 compared A's and
    B's last files and bit-rotted one of A's, the fallback; each stage
    ends at a barrier of the fleet.  ``stamps``: the wall clock at this
    process's entry and at the end of each stage."""
    import gc
    import torch
    from repro_torch.launch.mesh import sub_mesh
    from repro_torch.runtime import faults as F
    stamps = {"entry": time.time()}
    D, M = spec["mesh"]
    n = D * M
    runs = [sub_mesh(world, range(n), D, M),
            sub_mesh(world, range(n, 2 * n), D, M)]
    shapes = {s: sub_mesh(world, range(s[0] * s[1]), *s)
              for s in spec["restore_on"] if s is not None}
    dA, dB = Path(spec["dir"]) / "A", Path(spec["dir"]) / "B"
    out = {"rank": world.rank, "stamps": stamps, "restores": {}}

    def stage(name):
        gc.collect()
        torch.cuda.empty_cache()
        world.barrier()
        stamps[name] = time.time()

    if runs[0] is not None:
        out["a"] = mesh_ckpt_train_path(runs[0], dict(spec, dir=str(dA)))
    stage("a")
    if world.rank == 0:
        # B's copy of A's resume checkpoint: hard links (a save writes new
        # files into a directory of its own, and nothing writes into them)
        resumed = f"step_{spec['resume']:08d}"
        shutil.copytree(dA / resumed, dB / resumed, copy_function=os.link)
    world.barrier()
    if runs[1] is not None:
        out["b"] = mesh_ckpt_train_path(runs[1], dict(spec, dir=str(dB)))
    stage("b")
    for shape in spec["restore_on"]:
        name = "one card" if shape is None else f"({shape[0]}, {shape[1]})"
        ctx = None if shape is None else shapes[shape]
        if ctx is not None or (shape is None and world.rank == 0):
            t0 = time.perf_counter()
            out["restores"][name] = mesh_ckpt_restore_path(
                ctx, dict(spec, dir=str(dA)))
            out["restores"][name]["wall_s"] = time.perf_counter() - t0
        stage(name)
    if world.rank == 0:
        a, b = (d / f"step_{spec['steps']:08d}" for d in (dA, dB))
        names = sorted(x for x in os.listdir(a) if x.startswith("leaf_"))
        out["files_equal"] = (
            names == sorted(x for x in os.listdir(b)
                            if x.startswith("leaf_"))
            and all(same_bytes(a / x, b / x) for x in names))
        biggest = max(names, key=lambda x: (a / x).stat().st_size)
        out["corrupted"] = F.corrupt_checkpoint_leaf(
            str(dA), int(biggest.split("_")[1].split(".")[0]),
            step=spec["steps"])
    world.barrier()
    if runs[0] is not None:
        sess = mesh_ckpt_session(torch, spec, runs[0], dA)
        sess.init()
        out["fallback"] = (int(sess.state["step"]),
                           list(sess.loop.ckpt.corrupt_steps))
        del sess
    stage("fallback")
    return out


def mesh_ckpt_restore_path(ctx, spec):
    """Phase 19, one rank (``ctx`` None: one card without a mesh) of a
    restore of the checkpoint in ``spec["dir"]``: its seconds, and on
    rank 0 the CRCs of the state the ranks' shards assemble to
    (:func:`mesh_ckpt_assembled`; the shards go to rank 0 over the
    world's host group, :func:`gather_shards`, not through the result
    queue's pipe)."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    sess = mesh_ckpt_session(torch, spec, ctx, spec["dir"])
    out = {"rank": 0 if ctx is None else ctx.rank,
           "restore_s": mesh_ckpt_timed_init(torch, sess)}
    out["step"] = int(sess.state["step"])
    shards = convert.rank_shards(sess.state, sess.trainer)
    del sess
    t0 = time.perf_counter()
    every = ([shards] if ctx is None or ctx.world.size == 1
             else gather_shards(torch, dist, ctx.world, shards))
    del shards
    if out["rank"] == 0:
        out["crcs"] = mesh_ckpt_assembled(every)
    out["assemble_s"] = time.perf_counter() - t0
    return out


def gather_shards(torch, dist, group, mine):
    """Every rank's ``convert.rank_shards`` (``mine`` on this rank), on
    rank 0 in rank order (None on the others): each leaf's index and
    shapes as objects, its shard as a tensor over the group's host
    group."""
    import numpy as np
    meta = {k: (index, shape, part.shape, part.dtype.str)
            for k, (part, index, shape) in mine.items()}
    metas = [None] * group.size if group.rank == 0 else None
    dist.gather_object(meta, metas, dst=group.ranks[0],
                       group=group.host_pg)
    if group.rank != 0:
        for part, _, _ in mine.values():
            dist.send(torch.from_numpy(np.ascontiguousarray(part)),
                      dst=group.ranks[0], group=group.host_pg)
        return None
    every = [mine]
    for r in range(1, group.size):
        got = {}
        for k, (index, shape, pshape, dt) in metas[r].items():
            buf = torch.from_numpy(np.empty(pshape, np.dtype(dt)))
            dist.recv(buf, src=group.ranks[r], group=group.host_pg)
            got[k] = (buf.numpy(), index, shape)
        every.append(got)
    return every


def _one_card_restore(group, spec):
    return mesh_ckpt_restore_path(None, spec)


def mesh_ckpt_assembled(shards) -> list:
    """The CRC-32 of each leaf of the state the ranks' shards
    (``convert.rank_shards`` of each) assemble to
    (``convert.reference_from_shards``)."""
    import zlib
    from repro_torch import convert
    whole = convert.reference_from_shards(shards)
    return [zlib.crc32(memoryview(whole[k]).cast("B")) for k in sorted(whole)]


def log_mesh_ckpt_restore(tag, card, spec, name, res, wall) -> list:
    """Check and print the restore of one shape (its ranks' results and
    the processes' wall seconds); returns rank 0's CRCs of the assembled
    state."""
    steps = {r["step"] for r in res}
    if steps != {spec["steps"]}:
        fail(f"{tag}: restored on {name} at steps {steps}, not "
             f"{spec['steps']}")
    log(f"{tag}: step {spec['steps']} restored on {name}: seconds per rank "
        f"{[round(r['restore_s'], 3) for r in res]}, shards gathered and "
        f"assembled on rank 0 in {res[0]['assemble_s']:.2f} s; wall "
        f"{wall:.2f} s [{card}]")
    return res[0]["crcs"]


def mesh_ckpt_restores(tag, card, spec, ckpt_dir, shapes) -> dict:
    """Restore ``ckpt_dir``'s newest checkpoint on every shape of
    ``shapes`` (None: one card without a mesh), each in processes of its
    own; their lines, and the assembled state's CRCs per shape."""
    from repro_torch.launch.mesh import spawn_mesh, spawn_pods
    rspec = dict(spec, dir=str(ckpt_dir))
    out = {}
    for shape in shapes:
        t0 = time.perf_counter()
        if shape is None:
            res = spawn_pods(_one_card_restore, 1, "cuda", args=(rspec,),
                             timeout=600)
        else:
            res = spawn_mesh(mesh_ckpt_restore_path, *shape, "cuda",
                             args=(rspec,), timeout=600)
        name = "one card" if shape is None else f"({shape[0]}, {shape[1]})"
        out[name] = log_mesh_ckpt_restore(tag, card, spec, name, res,
                                          time.perf_counter() - t0)
    return out


def log_mesh_ckpt_save(tag, card, name, res) -> None:
    """The last save's bytes and seconds, per rank."""
    s0 = res[0]["save"]
    log(f"{tag}: {name} save of step {s0['step']}: {s0['bytes']:,} B a "
        f"checkpoint; per rank: bytes written "
        f"{[r['save']['rank_bytes'] for r in res]}, copy_s "
        f"{[round(r['save']['copy_s'], 3) for r in res]}, write_s "
        f"{[round(r['save']['write_s'], 3) for r in res]}; rank 0's CRC "
        f"read-back crc_s {s0['crc_s']:.3f} ({s0['bytes'] / s0['write_s'] / 1e9:.3f} "
        f"GB/s written, fsync'd) [{card}]")
    if sum(r["save"]["rank_bytes"] for r in res) != s0["bytes"]:
        fail(f"{tag}: {name}: the ranks wrote "
             f"{sum(r['save']['rank_bytes'] for r in res)} B of a "
             f"{s0['bytes']} B checkpoint (each entry once)")


def mesh_ckpt_phase(torch, card, restart_save) -> dict:
    """Phase 19 (a), one fleet of four processes sharing the card
    (:func:`mesh_ckpt_fleet_path`): paper-350m at phase 9a's depth trains
    on (1, 2) with checkpoints, two fresh processes resume from step
    ``resume`` and must replay it bit for bit (gate 1); the last checkpoint restores
    on each shape of ``restore_on`` ((2, 2) and one card), each assembling
    to one state (gate 2); a corrupt leaf makes every (1, 2) rank fall back to the same step
    (gate 3); K1-K4 launch on the training path (gate 4).  (b) on four
    cards.  Returns the kernels' launches per path."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    tag = "phase 19 (a)"
    spec = MESH_CKPT_A
    gc.collect()
    torch.cuda.empty_cache()
    # A's three checkpoints, B's two and the copy in B
    _disk_check(tag, spec["n_layers"], 6)
    root = CKPT_ROOT / "mesh_ckpt"
    n = spec["mesh"][0] * spec["mesh"][1]
    t0, w0 = time.perf_counter(), time.time()
    try:
        res = spawn_pods(mesh_ckpt_fleet_path, 2 * n, "cuda",
                         args=(dict(spec, dir=str(root)),), timeout=600)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    a = [r["a"] for r in res[:n]]
    b = [r["b"] for r in res[n:]]
    st = [r["stamps"] for r in res]
    since = [round(max(x[k] for x in st) - w0, 2)
             for k in ["entry", "a", "b"] + [
                 f"({s[0]}, {s[1]})" if s else "one card"
                 for s in spec["restore_on"]] + ["fallback"]]
    log(f"{tag}: one fleet of {2 * n} processes over {a[0]['backend']}, "
        f"{wall:.2f} s; seconds from the spawn to every process in, then "
        f"to the end of the uninterrupted run, the resumed run, each "
        f"restore and the fallback: {since}")
    log(f"{tag}: {spec['steps']} uninterrupted steps on {spec['mesh']} "
        f"(fleet ranks 0-{n - 1}): {a[0]['run_s']:.2f} s (seconds a step "
        f"{a[0]['step_s']}), losses {[round(x, 4) for x in a[0]['losses']]}")
    log_mesh_ckpt_save(tag, card, f"{spec['mesh']}", a)
    # gate 1: the resumed run replays the uninterrupted one on every rank
    for ra, rb in zip(a, b):
        if rb["start"] != spec["resume"]:
            fail(f"{tag}: rank {rb['rank']} resumed at step {rb['start']}")
        if rb["hashes"] != ra["hashes"] or rb["host"] != ra["host"] \
                or rb["all_rungs"] != ra["all_rungs"] \
                or rb["losses"] != ra["losses"][spec["resume"]:]:
            bad = [i for i, (x, y) in enumerate(zip(ra["hashes"],
                                                    rb["hashes"])) if x != y]
            fail(f"{tag}: rank {rb['rank']}: the resumed run differs from "
                 f"the uninterrupted one (leaves {bad}, host {rb['host']} "
                 f"vs {ra['host']}, losses {rb['losses']} vs "
                 f"{ra['losses'][spec['resume']:]})")
    if not res[0]["files_equal"]:
        fail(f"{tag}: the resumed run's step-{spec['steps']} files differ "
             f"from the uninterrupted run's")
    log(f"{tag}: resumed from step {spec['resume']} by fleet ranks "
        f"{n}-{2 * n - 1}, a group of their own (restore seconds per rank "
        f"{[round(r['init_s'], 3) for r in b]}, then {b[0]['run_s']:.2f} s "
        f"to step {spec['steps']}, a step {b[0]['step_s']}): every state leaf's hash, the plan, H "
        f"and the losses bit-identical on every rank to the uninterrupted "
        f"run's at step {spec['steps']} and after an all-rungs grad_sync, "
        f"its step-{spec['steps']} leaf files byte for byte [{card}]")
    log_mesh_ckpt_save(tag, card, f"{spec['mesh']} resumed", b)
    # gate 2: every restore assembles to the one-card restore's state
    crcs = {}
    for shape in spec["restore_on"]:
        name = "one card" if shape is None else f"({shape[0]}, {shape[1]})"
        got = [r["restores"][name] for r in res if name in r["restores"]]
        crcs[name] = log_mesh_ckpt_restore(
            tag, card, spec, name, got, max(g["wall_s"] for g in got))
    want = crcs["one card"]
    bad = [name for name, c in crcs.items() if c != want]
    if bad:
        fail(f"{tag}: restores on {bad} do not assemble to the one-card "
             f"restore's state")
    log(f"{tag}: the restores on {sorted(crcs)} assemble to one state "
        f"({len(want)} leaves, CRC-32 each)")
    # gate 3: the corruption, the same fallback on every rank
    want_fall = (spec["steps"] - spec["ckpt_every"], [spec["steps"]])
    falls = [r["fallback"] for r in res[:n]]
    if not res[0]["corrupted"] or any(f != want_fall for f in falls):
        fail(f"{tag}: after corrupting {res[0].get('corrupted')}: "
             f"fallbacks {falls}, expected {want_fall}")
    log(f"{tag}: {res[0]['corrupted']} bit-rotted: every rank of "
        f"{spec['mesh']} restored step {want_fall[0]} and recorded "
        f"{want_fall[1]} as corrupt")
    # gate 4: K1-K4 on the training path
    launches = {k: sum(r["launches"].get(k, 0) for r in a + b)
                for k in a[0]["launches"]}
    missing = [k for k in KERNELS if launches.get(k, 0) < 1]
    if missing:
        fail(f"{tag}: kernels never launched on the training path: "
             f"{missing}")
    if restart_save:
        s = restart_save
        log(f"{tag}: beside phase 9a's one-card save of the same model: "
            f"{s['bytes']:,} B, copy_s {s['copy_s']:.3f}, write_s "
            f"{s['write_s']:.3f}, crc_s {s.get('crc_s', float('nan')):.3f} "
            f"[{card}]")
    log(f"{tag}: launches on the training path {launches}; "
        f"{time.perf_counter() - t0:.2f} s")
    return {"mesh_ckpt": launches, **mesh_ckpt_big_phase(torch)}


def mesh_ckpt_big_phase(torch) -> dict:
    """Phase 19(b): paper-350m at full depth on (2, 2) over NCCL, a card
    a rank, with checkpoints; the last restored on (1, 4) and one card,
    assembling to one state.  One line and nothing else on fewer cards.
    Returns the kernels' launches on its training path."""
    from repro_torch.launch.mesh import spawn_mesh
    tag = "phase 19 (b)"
    n = torch.cuda.device_count()
    spec = MESH_CKPT_B
    if n < 4:
        log(f"{tag}: {n} card(s): paper-350m's mesh checkpoints at full "
            f"depth run on four; not run")
        return {}
    cards = four_cards()
    _disk_check(tag, spec["n_layers"], 2)
    d = CKPT_ROOT / "mesh_ckpt_big"
    t0 = time.perf_counter()
    try:
        a = spawn_mesh(mesh_ckpt_train_path, *spec["mesh"], "cuda",
                       args=(dict(spec, dir=str(d)),), timeout=900)
        log(f"{tag}: {spec['steps']} steps on {spec['mesh']} over "
            f"{a[0]['backend']}: {a[0]['run_s']:.2f} s")
        log_mesh_ckpt_save(tag, cards, f"{spec['mesh']}", a)
        crcs = mesh_ckpt_restores(tag, cards, spec, d, spec["restore_on"])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if len({tuple(c) for c in crcs.values()}) != 1:
        fail(f"{tag}: the restores on {sorted(crcs)} do not assemble to "
             f"one state")
    log(f"{tag}: the restores on {sorted(crcs)} assemble to one state; "
        f"{time.perf_counter() - t0:.2f} s")
    return {"mesh_ckpt_b": {k: sum(r["launches"].get(k, 0) for r in a)
                            for k in a[0]["launches"]}}


# ---------------------------------------------------------------------------
# phase 20: the recurrent families on a within-pod ("data", "model") mesh
# ---------------------------------------------------------------------------

#: 20(a) serving: each model at full width cut to these layers (mamba 2,
#: the hybrid one (rec, rec, attn) group), sharded from seed 0 on (1, 2);
#: gate 1 holds rank 0's gathered logits (a 4 x 256 prefill, then 16
#: teacher-forced decode steps) to the unsharded model of the same seed
#: (rank 0, one card, ``ctx`` None) within rtol = atol = the run's bound:
#: phase 17's ``TF_TOL`` in the served bf16, phase 18's gate-1 bound in
#: f32 compute; then the Server on phase 17's ``MESH_A`` once, tokens
#: identical on every rank
MESH_REC_SERVE = {"falcon-mamba-7b": 2, "recurrentgemma-2b": 3}
#: the fleet's serving meshes other than (1, 2): recurrentgemma-2b on
#: (1, 4), all four processes — its 10 heads over model = 4, the flat
#: H * Dh columns split as the reference splits them, each rank gathering
#: the heads its part touches (on (1, 2) until phase 24 joined the script)
SERVE_MESH = {"recurrentgemma-2b": (1, 4)}


def serve_mesh(arch: str) -> tuple:
    return SERVE_MESH.get(arch, (1, 2))
MESH_REC_TF = {"batch": 4, "prompt": 256, "steps": 16}
#: gate 1's runs: (compute dtype, None: the served bf16; rtol = atol)
MESH_REC_TF_RUNS = {"bf16": (None, TF_TOL), "f32": ("float32",
                                                     MESH_GATE1_RTOL)}
#: 20(a) training, f32 compute, batch 4 x 512 (phase 18 (a)'s), ranks
#: sharing the card: falcon-mamba-7b at 1 layer on (1, 2) (which
#: checkpoints at its last loop step; its (2, 2) run, 2.2 s a local step
#: through gloo, is in 20(b), over NCCL, and on the CPU since phase 22
#: joined the script), recurrentgemma-2b at one group on (1, 2).  ``MESH_REC_STEPS`` loop
#: steps (H = 4: three ``local``, then a ``delta_sync``; no replan), then
#: a ``grad_sync`` under the loop's plan and an all-rungs one; a run's
#: "steps" (at D = 2, where every step gathers the FSDP halves through
#: gloo: the ``MESH_REC_LOCAL`` local steps gate 2 compares) and
#: "loop_grad_sync" (False: the all-rungs round alone) cut that
MESH_REC_TRAIN = ({"arch": "falcon-mamba-7b", "n_layers": 1, "mesh": (1, 2),
                   "ckpt": True},
                  {"arch": "recurrentgemma-2b", "n_layers": 3,
                   "mesh": (1, 2)})
MESH_REC_SHAPE = (4, 512)
MESH_REC_STEPS = 4
#: the local steps before the first sync: the state is held to the
#: one-card run's there (a sync round blocks the rank's shards, the
#: reference's nested layout, where one card blocks whole leaves)
MESH_REC_LOCAL = 3
#: gate 2's bound, f32: a step's loss and grad norm relative to the
#: one-card run's, a state leaf's difference relative to its norm (phase
#: 18's gate 1)
MESH_REC_RTOL = MESH_GATE1_RTOL
#: the state trees the local steps change (the anchor and the residuals
#: are their initial values until the first sync)
MESH_REC_TREES = ("params/", "m/", "v/")
#: 20(b), with four cards, over NCCL: falcon-mamba-7b served at all 64
#: layers on (1, 4) (workload (a) twice) and trained there and on (2, 2)
#: (FSDP and d_inner over "model"; 20(a)'s until phase 22 joined the
#: script) at ``mesh_train_depth``'s layers; recurrentgemma-2b trained at
#: all 26 layers on (2, 2); batch 8 x 1024, phase 18 (b)'s gates and lines
MESH_REC_B_SERVE = {"arch": "falcon-mamba-7b", "mesh": (1, 4)}
MESH_REC_B_TRAIN = ({"arch": "falcon-mamba-7b", "mesh": (1, 4)},
                    {"arch": "falcon-mamba-7b", "mesh": (2, 2)},
                    {"arch": "recurrentgemma-2b", "mesh": (2, 2),
                     "n_layers": 26})


#: 21(a), the encoder-decoder and the VLM, part "21" of the fleet that
#: 20(a) starts (one spawn): seamless-m4t-medium at 2 + 2 layers and
#: llava-next-mistral-7b at 2 (its 576 stub patches before the tokens),
#: full width, sharded from seed 0 and served on (1, 2) with seeded
#: non-zero frames / patches (gate 1 as 20(a)'s: bf16 within phase 17's
#: ``TF_TOL``, f32 compute within phase 18's bound); the Server on
#: ``MESH_A`` with zero frontend inputs, as the reference serves them (a
#: smoke run: zero frames make the encoder's output exactly 0)
MESH_FRONT_SERVE = {"seamless-m4t-medium": 2, "llava-next-mistral-7b": 2}
#: 21(a) training, f32 compute, 20(a)'s loop and gates, each held to a
#: one-card run: seamless 4 x 512 on (1, 2) (checkpointed at its last
#: loop step; restored on (2, 1) by fleet ranks 2-3 and as one card by
#: fleet rank 2); llava 4 x 1024 (576 patches and 448 tokens: at 512
#: positions no token would be scored) on (1, 2) — their D = 2 training
#: (2.1-5.5 s a step through gloo here) runs on four cards in 21(b) and
#: on the CPU
MESH_FRONT_TRAIN = (
    {"arch": "seamless-m4t-medium", "n_layers": 2, "mesh": (1, 2),
     "ckpt": True, "shape": (4, 512)},
    {"arch": "llava-next-mistral-7b", "n_layers": 2, "mesh": (1, 2),
     "shape": (4, 1024)})
#: 21(b), with four cards, over NCCL: each model served at its published
#: depth on (1, 4), gated against one card (phase 17 (b)'s gate 1 on the
#: gathered logits), then trained on (2, 2) at 8 x 1024 — seamless at all
#: 12 + 12 layers, llava at ``mesh_train_depth``'s
MESH_FRONT_B_SERVE = ("seamless-m4t-medium", "llava-next-mistral-7b")
MESH_FRONT_B_TRAIN = ({"arch": "seamless-m4t-medium", "mesh": (2, 2)},
                      {"arch": "llava-next-mistral-7b", "mesh": (2, 2)})


def mesh_rec_tf_logits(torch, np, model, dtype):
    """Gate 1's run on ``model`` (sharded or not), in ``dtype`` compute
    (None: the served bf16): the last position's logits of a seeded 4 x
    256 prefill (a frontend's seeded non-zero frames / patches with it,
    the VLM's decode after its patches) and of each teacher-forced
    decode step, whole on every rank, (steps + 1, B, V) f32 on the
    card."""
    B, S, n = (MESH_REC_TF[k] for k in ("batch", "prompt", "steps"))
    cfg, real = model.cfg, model.dtype
    if dtype:
        model.cfg = dataclasses.replace(cfg, dtype=dtype)
        model.dtype = getattr(torch, dtype)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(B, S + n)).astype(np.int32)).to(
        model.device)
    extra = seeded_inputs(torch, model, B, S, 7)
    P = model.n_prefix
    try:
        with torch.inference_mode():
            logits, caches = model.prefill(toks[:, :S], P + S + n, **extra)
            rows = [mesh_gathered(model.ctx, logits, B)]
            for i in range(n):
                logits, caches = model.decode_step(caches, P + S + i,
                                                   toks[:, S + i:S + i + 1])
                rows.append(mesh_gathered(model.ctx, logits, B))
            return torch.stack(rows).float()
    finally:
        model.cfg, model.dtype = cfg, real


def mesh_rec_serve_path(meshes, world, models):
    """A fleet part's serving, each model on its mesh of ``meshes``
    (:func:`serve_mesh`; None: this process is not on it) and, on fleet
    rank 0, the unsharded models gate 1 holds it to: per model of
    ``models`` ({arch: layers}; an encoder-decoder's encoder cut with its
    decoder) the rank's weight bytes against its shards', its Server
    lines and gate 1's readings; the kernels' launches over the serving
    (which must be none)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.memory import cut_depth
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    out = {}
    for arch, layers in models.items():
        cfg = cut_depth(ARCHS[arch], layers)
        ctx = meshes[serve_mesh(arch)]
        r = {}
        tf = {}
        if ctx is not None:
            model = tserve.init_model(cfg, ctx.device, seed=0, ctx=ctx)
            r = {"param_bytes": sum(p.numel() * p.element_size()
                                    for p in model.parameters()),
                 "shard_bytes": expected_shard_bytes(model, ctx),
                 "backend": ctx.world.backend}
            for name, (dtype, _) in MESH_REC_TF_RUNS.items():
                tf[name] = mesh_rec_tf_logits(torch, np, model, dtype)
            r["a"] = serve_once(torch, np, tserve, model, MESH_A)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        world.barrier()
        if world.rank == 0:
            model = tserve.init_model(cfg, "cuda", seed=0)
            r["tf"] = {}
            for name, (dtype, tol) in MESH_REC_TF_RUNS.items():
                want = mesh_rec_tf_logits(torch, np, model, dtype)
                diff = (tf[name] - want).abs()
                r["tf"][name] = {
                    "max_diff": float(diff.max()),
                    "ok": bool((diff <= tol + tol * want.abs()).all()),
                    "argmax": float((tf[name].argmax(-1) == want.argmax(-1))
                                    .float().mean())}
            del model, want, diff
            gc.collect()
            torch.cuda.empty_cache()
        del tf
        out[arch] = r
        world.barrier()
    out_launches = ops.launch_counts()
    return {"models": out, "launches": out_launches}


def mesh_rec_session(torch, spec, ctx, ckpt_dir=None):
    """A TrainSession of ``spec``'s arch at full width and its depth, f32
    compute, batch ``spec["shape"]`` (``MESH_REC_SHAPE``), on ``ctx``'s
    mesh (None: one card), from seed 0, checkpointing every
    ``MESH_REC_STEPS`` steps to ``ckpt_dir`` where given."""
    from repro_torch.configs.base import ACESyncConfig
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model
    cfg, run = mesh_train_config(spec["arch"], spec["n_layers"],
                                 *spec.get("shape", MESH_REC_SHAPE))
    cfg = dataclasses.replace(cfg, dtype="float32")
    run = dataclasses.replace(
        run, model=cfg, acesync=ACESyncConfig(replan_every=100),
        ckpt_every=MESH_REC_STEPS if ckpt_dir else 0,
        ckpt_dir=str(ckpt_dir or run.ckpt_dir))
    dev = "cuda" if ctx is None else ctx.device
    return TrainSession(build_model(cfg, run, device=dev, ctx=ctx), run,
                        strategy="acesync")


def _tree_leaves(torch, state, layout):
    """{path: (tensor, its index in the global leaf, whether this process
    counts it)} of the state leaves of ``MESH_REC_TREES`` (``layout``: the
    trainer's ``state_layout``; None: whole leaves)."""
    from repro_torch import tree as T
    leaves = T.reference_leaves_with_path(state)
    shards = layout(state) if layout else [None] * len(leaves)
    return {T.path_str(p): (x, None if sh is None else sh.index,
                            sh is None or sh.writes)
            for (p, x), sh in zip(leaves, shards)
            if T.path_str(p).startswith(MESH_REC_TREES)}


def mesh_rec_reference(torch, spec):
    """The one-card run gate 2 holds a mesh to (fleet rank 0, alone on
    the card): the metrics of the loop's steps, and the host copy of its
    ``MESH_REC_TREES`` leaves after the ``MESH_REC_LOCAL`` local steps."""
    import gc
    sess = mesh_rec_session(torch, spec, None)
    sess.init()
    sess.run(MESH_REC_LOCAL, log_every=0)
    snap = {k: x.detach().to("cpu", copy=True)
            for k, (x, _, _) in _tree_leaves(torch, sess.state,
                                              None).items()}
    sess.run(MESH_REC_STEPS - MESH_REC_LOCAL, log_every=0)
    out = {"losses": sess.losses,
           "grad_norms": [h["grad_norm"] for h in sess.history
                          if "grad_norm" in h],
           "kinds": [k for h in sess.history for k in h["kinds"]],
           "plan": list(sess.loop.plan.level_idx), "snap": snap}
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_rec_compare(torch, dist, world, ctx, mine, snap):
    """Gate 2's state comparison after the local steps: every mesh rank's
    ``MESH_REC_TREES`` shards (``mine``: :func:`_tree_leaves`) against
    fleet rank 0's one-card snapshot ``snap`` (host tensors).  Rank 0
    sends each rank the reference's slices over the fleet's host group;
    each rank sums (diff^2, ref^2) per leaf over its shards on its card;
    rank 0 adds up the ranks' (each shard once: the rank that writes it)
    into each leaf's |diff| / |ref|.  Returns {path: relative error} on
    fleet rank 0 (None elsewhere)."""
    import numpy as np
    meta = None
    if mine is not None:
        meta = {k: tuple((s.start, s.stop) for s in idx)
                for k, (_, idx, _) in mine.items()}
    metas = [None] * world.size if world.rank == 0 else None
    dist.gather_object(meta, metas, dst=world.ranks[0], group=world.host_pg)
    if world.rank == 0:
        for r in range(1, world.size):
            for k, idx in (metas[r] or {}).items():
                part = snap[k][tuple(slice(a, b) for a, b in idx)]
                dist.send(part.contiguous(), dst=world.ranks[r],
                          group=world.host_pg)
    sums = None
    if mine is not None:
        sums = {}
        for k, (x, idx, counts) in mine.items():
            if world.rank == 0:
                ref = snap[k][idx].to(x.device)
            else:
                buf = torch.empty(tuple(x.shape), dtype=x.dtype)
                dist.recv(buf, src=world.ranks[0], group=world.host_pg)
                ref = buf.to(x.device)
            d = x.detach().float() - ref.float()
            sums[k] = (float((d * d).sum()), float((ref.float() ** 2).sum()),
                       counts)
            del ref, d
    every = [None] * world.size if world.rank == 0 else None
    dist.gather_object(sums, every, dst=world.ranks[0], group=world.host_pg)
    if world.rank != 0:
        return None
    total = {}
    for s in every:
        for k, (dd, rr, counts) in (s or {}).items():
            if counts:
                a, b = total.get(k, (0.0, 0.0))
                total[k] = (a + dd, b + rr)
    return {k: float(np.sqrt(a) / max(np.sqrt(b), 1e-30))
            for k, (a, b) in total.items()}


def mesh_rec_train(torch, world, ctx, spec, ref, out, stage):
    """One 20(a) training run on ``ctx``'s mesh (None: this process is
    not on it), fleet rank 0 holding the one-card run ``ref``: phase
    18's rank (:func:`mesh_train_path`) on :func:`mesh_rec_session`'s
    session for ``MESH_REC_STEPS`` loop steps, stopping after the
    ``MESH_REC_LOCAL`` local steps for gate 2's state comparison (every
    process of the fleet takes part) and, where ``spec["ckpt"]``, after
    the loop for the checkpointed shards' hashes."""
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.core import sync as S
    name = f"{spec['arch']}_{spec['mesh'][0]}x{spec['mesh'][1]}"
    snap = ref["snap"] if world.rank == 0 else None
    res = {}
    if ctx is None:
        mesh_rec_compare(torch, dist, world, None, None, snap)
    else:
        ckpt = (CKPT_ROOT / "mesh_rec" / name) if spec.get("ckpt") else None

        def compare(sess, r):
            mine = _tree_leaves(torch, sess.state, sess.trainer.state_layout)
            r["state_rel"] = mesh_rec_compare(torch, dist, world, ctx, mine,
                                              snap)

        def hashes(sess, r):
            sess.finish()
            r["save"] = dict(sess.loop.ckpt.last_save)
            r["ckpt_hashes"] = [
                (T.path_str(q), tuple((s.start, s.stop) for s in sh.index),
                 int(bits_hash(torch, x)))
                for (q, x), sh in zip(T.reference_leaves_with_path(
                    sess.state), sess.trainer.state_layout(sess.state))]

        stops = [(MESH_REC_LOCAL, compare)]
        if ckpt:
            stops.append((MESH_REC_STEPS, hashes))
        plain = S.sync_tree
        try:
            res = mesh_train_path(
                ctx, dict(spec, steps=spec.get("steps", MESH_REC_STEPS)),
                session=lambda: mesh_rec_session(torch, spec, ctx, ckpt),
                stops=stops)
        finally:
            S.sync_tree = plain
    stage(name)
    out[name] = res


def mesh_rec_restore(torch, spec, lists):
    """Gate 4 in a process of its own (fleet rank 2): the (1, 2) run's
    checkpoint restored as one card; for each rank's list of (leaf,
    index, hash) at the checkpointed step, the restored leaf's hash at
    that index.  Returns the restore's step and seconds and the leaves
    whose hashes differ."""
    from repro_torch import tree as T
    name = f"{spec['arch']}_{spec['mesh'][0]}x{spec['mesh'][1]}"
    sess = mesh_rec_session(torch, spec, None, CKPT_ROOT / "mesh_rec" / name)
    t0 = time.perf_counter()
    sess.init()
    torch.cuda.synchronize()
    out = {"restore_s": time.perf_counter() - t0,
           "step": int(sess.state["step"]), "bad": [], "n": 0}
    whole = {T.path_str(p): x
             for p, x in T.reference_leaves_with_path(sess.state)}
    for r, got in enumerate(lists):
        for path, idx, h in got or ():
            part = whole[path][tuple(slice(a, b) for a, b in idx)]
            out["n"] += 1
            if int(bits_hash(torch, part)) != h:
                out["bad"].append((r, path))
    del sess, whole
    return out


def mesh_rec_restored(torch, spec, ctx):
    """Gate 4's other restore: ``spec``'s checkpoint restored on ``ctx``'s
    mesh (another shape than the one that wrote it); this rank's
    restore seconds and (leaf, index, hash) of its restored shards."""
    from repro_torch import tree as T
    name = f"{spec['arch']}_{spec['mesh'][0]}x{spec['mesh'][1]}"
    sess = mesh_rec_session(torch, spec, ctx, CKPT_ROOT / "mesh_rec" / name)
    t0 = time.perf_counter()
    sess.init()
    torch.cuda.synchronize()
    out = {"restore_s": time.perf_counter() - t0,
           "step": int(sess.state["step"]),
           "hashes": [(T.path_str(q), tuple((s.start, s.stop)
                                            for s in sh.index),
                       int(bits_hash(torch, x)))
                      for (q, x), sh in zip(
                          T.reference_leaves_with_path(sess.state),
                          sess.trainer.state_layout(sess.state))]}
    del sess
    return out


#: the parts of the fleet of four processes that phases 20 (a) and 21 (a)
#: share (one spawn): the models each serves on (1, 2), its training runs
#: and the meshes its checkpointed run is restored on besides one card
FLEET_PARTS = {"20": {"serve": MESH_REC_SERVE, "train": MESH_REC_TRAIN,
                      "restore_on": ()},
               "21": {"serve": MESH_FRONT_SERVE, "train": MESH_FRONT_TRAIN,
                      "restore_on": ((2, 1),)}}


def mesh_fleet_path(world, parts):
    """Phases 20 (a) and 21 (a), one process of a fleet of four sharing
    the card (meshes of its ranks by ``launch.mesh.sub_mesh``), each part
    of ``parts`` (keys of ``FLEET_PARTS``) in turn: the serving on (1, 2)
    (ranks 0-1) held to fleet rank 0's unsharded models; then per
    training run fleet rank 0's one-card run (once per model), the mesh's
    run held to it; the checkpointed run's checkpoint restored on each
    mesh of ``restore_on`` (ranks 2-3 for (2, 1)) and by fleet rank 2 as
    one card.  ``stamps``: the wall clock at this process's entry and at
    the end of each stage."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import sub_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stamps = {"entry": time.time()}
    meshes = {(1, 2): sub_mesh(world, range(2), 1, 2),
              (2, 2): sub_mesh(world, range(4), 2, 2),
              (2, 1): sub_mesh(world, range(2, 4), 2, 1),
              (1, 4): sub_mesh(world, range(4), 1, 4)}
    out = {"rank": world.rank, "stamps": stamps}

    def stage(name):
        gc.collect()
        torch.cuda.empty_cache()
        world.barrier()
        stamps[name] = time.time()

    for part in parts:
        spec = FLEET_PARTS[part]
        res = out[part] = {"train": {}, "ref": {}, "restore": {}}
        res["serve"] = mesh_rec_serve_path(meshes, world, spec["serve"])
        stage(f"{part}: serve")
        refs = {}
        for t in spec["train"]:
            key = (t["arch"], t["n_layers"])
            if key not in refs:
                refs.clear()
                refs[key] = (mesh_rec_reference(torch, t) if world.rank == 0
                             else None)
                if world.rank == 0:
                    res["ref"][t["arch"]] = {k: v for k, v in
                                             refs[key].items()
                                             if k != "snap"}
                stage(f"{part}: one card {t['arch']}")
            mesh_rec_train(torch, world, meshes[t["mesh"]], t, refs[key],
                           res["train"], lambda n: stage(f"{part}: {n}"))
            if not t.get("ckpt"):
                continue
            name = f"{t['arch']}_{t['mesh'][0]}x{t['mesh'][1]}"
            lists = {"": res["train"][name].get("ckpt_hashes")}
            for mesh in spec["restore_on"]:
                got = None
                if meshes[mesh] is not None:
                    got = mesh_rec_restored(torch, t, meshes[mesh])
                    res["restore"][mesh] = {k: got[k] for k in
                                            ("restore_s", "step")}
                    lists[mesh] = got["hashes"]
                del got
                stage(f"{part}: restore on {mesh}")
            every = [None] * world.size if world.rank == 2 else None
            dist.gather_object(lists, every, dst=world.ranks[2],
                               group=world.host_pg)
            if world.rank == 2:
                res["restore"]["one card"] = mesh_rec_restore(
                    torch, t, [x for r in every for x in r.values()])
                res["restore"]["counts"] = {
                    str(k): sum(1 for r in every if r.get(k))
                    for k in ("",) + tuple(spec["restore_on"])}
            for r in res["train"].values():
                r.pop("ckpt_hashes", None)
            stage(f"{part}: restore on one card")
        refs.clear()
    return out


def mesh_fleet_phase(torch) -> dict:
    """Phases 20 (a) and 21 (a): one fleet of four processes sharing the
    card (:func:`mesh_fleet_path`), one spawn for both; returns each
    part's results per process, the fleet's wall seconds and each stage's
    seconds from the spawn."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    gc.collect()
    torch.cuda.empty_cache()
    t0, w0 = time.perf_counter(), time.time()
    try:
        res = spawn_pods(mesh_fleet_path, 4, "cuda",
                         args=(tuple(FLEET_PARTS),), timeout=900)
    finally:
        shutil.rmtree(CKPT_ROOT / "mesh_rec", ignore_errors=True)
    wall = time.perf_counter() - t0
    st = [r["stamps"] for r in res]
    since = {k: round(max(x[k] for x in st) - w0, 2) for k in st[0]}
    log(f"phases 20-21 (a): one fleet of 4 processes, {wall:.2f} s; "
        f"seconds from the spawn to every process in and to the end of "
        f"each stage: {since}")
    return {"res": res, "wall": wall, "since": since}


def log_mesh_rec_train(tag, card, t, res, ref) -> dict:
    """Gates 2 and 3 of one training run: phase 18's checks and lines
    (:func:`check_mesh_train`), then its loop steps and fleet rank 0's
    ``state_rel`` against the one-card run ``ref``; returns the kernels'
    launches summed over its ranks."""
    arch, (D, M) = t["arch"], t["mesh"]
    name = f"{arch} on ({D}, {M})"
    launches = check_mesh_train(tag, f"{card}; f32 compute", t, res)
    r0 = res[0]
    # a run cut to its first (local) steps is held to those of the
    # one-card run, its plan to the one-card run's after the whole loop
    n = t.get("steps", MESH_REC_STEPS)
    whole = n == MESH_REC_STEPS
    kinds = ref["kinds"] if whole else ref["kinds"][:n]
    if r0["kinds"][:len(kinds)] != kinds or (whole
                                             and r0["plan"] != ref["plan"]):
        fail(f"{tag}: {name}: steps {r0['kinds']} / plan {r0['plan']} "
             f"not the one-card run's {ref['kinds']} / {ref['plan']}")
    worst = 0.0
    for key in ("losses", "grad_norms"):
        for got, want in zip(r0[key][:n], ref[key][:n]):
            rel = abs(got - want) / max(abs(want), 1e-30)
            worst = max(worst, rel)
            if rel > MESH_REC_RTOL:
                fail(f"{tag}: {name}: {key} {r0[key][:n]} against the "
                     f"one-card run's {ref[key][:n]}")
    rel = r0["state_rel"]
    leaf = max(rel, key=rel.get)
    if rel[leaf] > MESH_REC_RTOL:
        fail(f"{tag}: {name}: after {MESH_REC_LOCAL} local steps, state "
             f"leaf {leaf} differs from the one-card run's by {rel[leaf]} "
             f"of its norm")
    log(f"{tag}: {name}, gate 2: the {n} loop steps ({kinds}) — "
        f"losses {[round(x, 5) for x in r0['losses'][:n]]}, grad norms "
        f"within {worst:.3g} of the one-card run's; after the "
        f"{MESH_REC_LOCAL} local steps every params / m / v shard within "
        f"{rel[leaf]:.3g} of its leaf's norm ({leaf}; bound "
        f"{MESH_REC_RTOL}, f32 compute) [{card}]")
    return launches


def check_fleet_part(tag, card, part, fleet) -> dict:
    """The gates and lines of one part of the fleet: serving (gate 1 in
    bf16 and f32 against the unsharded models, tokens identical on every
    rank, weight bytes the shards', no kernel launched), each training
    run (gates 2-3: :func:`log_mesh_rec_train`), the checkpointed run's
    restores (gate 4).  Returns the kernels' launches per path."""
    spec = FLEET_PARTS[part]
    res = [r[part] for r in fleet["res"]]
    ranks_of = {r["rank"]: x for r, x in zip(fleet["res"], res)}
    stages = [k for k in fleet["since"] if k.startswith(f"{part}: ")]
    first = list(fleet["since"]).index(stages[0]) - 1
    start = list(fleet["since"].values())[first]
    log(f"{tag}: {fleet['since'][stages[-1]] - start:.2f} s of the shared "
        f"fleet (its stages {stages[0]!r} to {stages[-1]!r})")
    launches = {}
    prefix = "mesh_rec" if part == "20" else "mesh_front"
    for arch, layers in spec["serve"].items():
        mesh = serve_mesh(arch)
        ranks = [dict(ranks_of[i]["serve"]["models"][arch], rank=i,
                      models={arch: ranks_of[i]["serve"]["models"][arch]})
                 for i in range(mesh[0] * mesh[1])]
        for name, tf in ranks_of[0]["serve"]["models"][arch]["tf"].items():
            tol = MESH_REC_TF_RUNS[name][1]
            log(f"{tag}: {arch} ({layers} layers) on {mesh}, gate 1, "
                f"{name}: the last position's logits of a "
                f"{MESH_REC_TF['batch']} x {MESH_REC_TF['prompt']} prefill "
                f"and {MESH_REC_TF['steps']} teacher-forced decode steps "
                f"against the unsharded model on one card: max |diff| "
                f"{tf['max_diff']:.4g}, argmax agrees on "
                f"{tf['argmax']:.4f} (rtol = atol = {tol}) [{card}]")
            if not tf["ok"]:
                fail(f"{tag}: {arch} on {mesh}, {name}: the mesh's logits "
                     f"differ from the unsharded model's beyond {tol}")
        for r in ranks:
            w = r["a"]
            if (not all(w["tokens_ok"]) or not w["finite"]
                    or w["tokens"] != ranks[0]["a"]["tokens"]):
                fail(f"{tag}: {arch} rank {r['rank']}: tokens per request "
                     f"{w['tokens_ok']}, finite {w['finite']}, or tokens "
                     f"not rank 0's")
            if r["param_bytes"] != r["shard_bytes"]:
                fail(f"{tag}: {arch} rank {r['rank']} holds "
                     f"{r['param_bytes']} weight bytes, its shards "
                     f"{r['shard_bytes']}")
        log_mesh_served(tag, arch, mesh, ranks, card)
    serve_launch = {k: sum(r["serve"]["launches"].get(k, 0) for r in res)
                    for k in res[0]["serve"]["launches"]}
    if any(serve_launch.values()):
        fail(f"{tag}: serving launched ACE-Sync kernels: {serve_launch}")
    launches[f"{prefix}_serve"] = serve_launch
    for t in spec["train"]:
        name = f"{t['arch']}_{t['mesh'][0]}x{t['mesh'][1]}"
        n = t["mesh"][0] * t["mesh"][1]
        got = [r["train"][name] for r in res[:n]]
        launches[f"{prefix}_{name}"] = log_mesh_rec_train(
            tag, card, t, got, res[0]["ref"][t["arch"]])
        if not t.get("ckpt"):
            continue
        rs = res[2]["restore"]["one card"]
        log_mesh_ckpt_save(tag, card, f"{t['arch']} on {t['mesh']}", got)
        if rs["step"] != MESH_REC_STEPS or rs["bad"] or not rs["n"]:
            fail(f"{tag}: {t['arch']} on {t['mesh']}: the checkpoint "
                 f"restored as one card at step {rs['step']}, shards "
                 f"differing {rs['bad']}")
        counts = res[2]["restore"]["counts"]
        for mesh in spec["restore_on"]:
            on = [r["restore"].get(mesh) for r in res]
            on = [x for x in on if x]
            if (len(on) != mesh[0] * mesh[1] or counts[str(mesh)] != len(on)
                    or any(x["step"] != MESH_REC_STEPS for x in on)):
                fail(f"{tag}: {t['arch']}: the restore on {mesh}: {on}")
            secs = ", ".join(f"{x['restore_s']:.2f}" for x in on)
            log(f"{tag}: {t['arch']} on {t['mesh']}, gate 4: the step-"
                f"{MESH_REC_STEPS} checkpoint restored on a {mesh} mesh "
                f"(fleet ranks 2-3) in {secs} s a rank, every restored "
                f"shard bit for bit the one-card restore's at its index "
                f"[{card}]")
        log(f"{tag}: {t['arch']} on {t['mesh']}, gate 4: the step-"
            f"{MESH_REC_STEPS} checkpoint restored as one card by fleet "
            f"rank 2 (a process of its own) in {rs['restore_s']:.2f} s: all "
            f"{rs['n']} shards of the writing ranks' state"
            f"{' and of the restoring meshes' if spec['restore_on'] else ''}"
            f" bit for bit [{card}]")
    return launches


def mesh_rec_phase(torch, card, fleet) -> dict:
    """Phase 20: (a) the recurrent families on meshes of ranks sharing the
    card, part "20" of the shared fleet (:func:`mesh_fleet_phase`):
    serving gated against the unsharded models (gate 1) with no kernel
    launched (gate 3), training held to a one-card run and every sync
    round to the one-pod round (gate 2), K1-K4 on every training rank
    (gate 3), the (1, 2) checkpoint restored bit for bit on one card
    (gate 4); (b) with four cards, over NCCL.  Returns the kernels'
    launches per path."""
    tag = "phase 20 (a)"
    launches = check_fleet_part(tag, card, "20", fleet)
    log(f"{tag}: launches by path {launches}")
    launches.update(mesh_rec_big_phase(torch))
    return launches


def mesh_rec_big_serve_path(ctx, spec):
    """20(b)'s serving on one rank: falcon-mamba-7b at its published
    depth, sharded from seed 0, workload (a) twice."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    arch = spec["arch"]
    t0 = time.perf_counter()
    model = tserve.init_model(ARCHS[arch], ctx.device, seed=0, ctx=ctx)
    torch.cuda.synchronize()
    r = {"init_s": time.perf_counter() - t0,
         "n_layers": model.cfg.n_layers,
         "param_bytes": sum(p.numel() * p.element_size()
                            for p in model.parameters()),
         "shard_bytes": expected_shard_bytes(model, ctx),
         "a": serve_workload(torch, np, tserve, model, SERVE_A)}
    return {"rank": ctx.rank, "backend": ctx.world.backend,
            "models": {arch: r}, "launches": ops.launch_counts()}


def mesh_rec_big_phase(torch) -> dict:
    """Phase 20 (b): with four cards, over NCCL — falcon-mamba-7b served
    at 64 layers on (1, 4) and trained there and on (2, 2) at
    ``mesh_train_depth``'s layers, recurrentgemma-2b trained at 26 on
    (2, 2) (phase 18 (b)'s
    gates 2-4 and lines); one line and nothing else on fewer cards."""
    from repro_torch.launch.mesh import spawn_mesh
    tag = "phase 20 (b)"
    n = torch.cuda.device_count()
    if n < 4:
        log(f"{tag}: {n} card(s): falcon-mamba-7b on (1, 4) and (2, 2) "
            f"meshes and recurrentgemma-2b on (2, 2) serve and train on "
            f"four; not run")
        return {}
    cards = four_cards()
    spec = MESH_REC_B_SERVE
    res = spawn_mesh(mesh_rec_big_serve_path, *spec["mesh"], "cuda",
                     args=(spec,), timeout=900)
    for r in res:
        m = r["models"][spec["arch"]]
        w = m["a"]
        if (not all(w["tokens_ok"]) or not w["finite"] or w["tokens"]
                != res[0]["models"][spec["arch"]]["a"]["tokens"]
                or m["param_bytes"] != m["shard_bytes"]
                or any(r["launches"].values())):
            fail(f"{tag}: {spec['arch']} on {spec['mesh']} rank "
                 f"{r['rank']}: tokens, finiteness, weight bytes or kernel "
                 f"launches wrong")
    log_mesh_served(tag, spec["arch"], spec["mesh"], res, cards)
    return mesh_train_big(torch, tag, MESH_REC_B_TRAIN, cards, "mesh_rec_b_")


def mesh_front_big_reference_path(group, spec):
    """21(b)'s reference, on one card: each model of
    ``MESH_FRONT_B_SERVE`` unsharded at its published depth from seed 0,
    gate 1's runs (numpy)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in MESH_FRONT_B_SERVE:
        model = tserve.init_model(ARCHS[arch], "cuda", seed=0)
        for name, (dtype, _) in MESH_REC_TF_RUNS.items():
            out[f"{arch}/{name}"] = mesh_rec_tf_logits(
                torch, np, model, dtype).cpu().numpy()
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_front_big_serve_path(ctx, spec):
    """21(b)'s serving on one rank: each model of ``MESH_FRONT_B_SERVE``
    at its published depth, sharded from seed 0: gate 1's runs (rank 0
    keeps the logits), then workload (a) twice (zero frontend inputs)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    out = {"rank": ctx.rank, "backend": ctx.world.backend, "models": {}}
    for arch in MESH_FRONT_B_SERVE:
        t0 = time.perf_counter()
        model = tserve.init_model(ARCHS[arch], ctx.device, seed=0, ctx=ctx)
        torch.cuda.synchronize()
        r = {"init_s": time.perf_counter() - t0, "tf": {},
             "param_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
             "shard_bytes": expected_shard_bytes(model, ctx)}
        for name, (dtype, _) in MESH_REC_TF_RUNS.items():
            got = mesh_rec_tf_logits(torch, np, model, dtype)
            if ctx.rank == 0:
                r["tf"][name] = got.cpu().numpy()
        spec_a = (FRONTEND_SERVE[arch]["a"] if model.n_prefix else SERVE_A)
        r["a"] = serve_workload(torch, np, tserve, model, spec_a)
        out["models"][arch] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = ops.launch_counts()
    return out


def mesh_front_big_phase(torch) -> dict:
    """Phase 21 (b): with four cards, over NCCL — seamless-m4t-medium and
    llava-next-mistral-7b served at their published depths on (1, 4),
    gated against one card on seeded non-zero frames / patches, then
    trained on (2, 2) at 8 x 1024 (seamless at 12 + 12 layers, llava at
    ``mesh_train_depth``'s), phase 18 (b)'s gates and lines; one line and
    nothing else on fewer cards."""
    import gc
    from repro_torch.launch.mesh import spawn_mesh, spawn_pods
    tag = "phase 21 (b)"
    n = torch.cuda.device_count()
    if n < 4:
        log(f"{tag}: {n} card(s): seamless-m4t-medium and "
            f"llava-next-mistral-7b on (1, 4) and (2, 2) meshes serve and "
            f"train on four; not run")
        return {}
    cards = four_cards()
    gc.collect()
    torch.cuda.empty_cache()
    (ref,) = spawn_pods(mesh_front_big_reference_path, 1, "cuda",
                        args=({},), timeout=900)
    mesh = (1, 4)
    res = spawn_mesh(mesh_front_big_serve_path, *mesh, "cuda", args=({},),
                     timeout=900)
    for arch in MESH_FRONT_B_SERVE:
        for name, (_, tol) in MESH_REC_TF_RUNS.items():
            want = ref[f"{arch}/{name}"]
            got = res[0]["models"][arch]["tf"][name]
            diff = abs(got - want)
            log(f"{tag}: {arch} at its published depth on {mesh}, gate 1, "
                f"{name}: the last position's logits of a "
                f"{MESH_REC_TF['batch']} x {MESH_REC_TF['prompt']} prefill "
                f"(seeded non-zero frontend inputs) and "
                f"{MESH_REC_TF['steps']} teacher-forced decode steps "
                f"against the unsharded model on one card: max |diff| "
                f"{float(diff.max()):.4g}, argmax agrees on "
                f"{float((got.argmax(-1) == want.argmax(-1)).mean()):.4f} "
                f"(rtol = atol = {tol}) [{cards}]")
            if got.shape != want.shape or not bool(
                    (diff <= tol + tol * abs(want)).all()):
                fail(f"{tag}: {arch} on {mesh}, {name}: the mesh's logits "
                     f"differ from the unsharded model's beyond {tol}")
        for r in res:
            m = r["models"][arch]
            w = m["a"]
            if (not all(w["tokens_ok"]) or not w["finite"] or w["tokens"]
                    != res[0]["models"][arch]["a"]["tokens"]
                    or m["param_bytes"] != m["shard_bytes"]
                    or any(r["launches"].values())):
                fail(f"{tag}: {arch} on {mesh} rank {r['rank']}: tokens, "
                     f"finiteness, weight bytes or kernel launches wrong")
        log(f"{tag}: {arch}: init "
            f"{max(r['models'][arch]['init_s'] for r in res):.2f} s")
        log_mesh_served(tag, arch, mesh, res, cards)
    return mesh_train_big(torch, tag, MESH_FRONT_B_TRAIN, cards,
                          "mesh_front_b_")


def mesh_front_phase(torch, card, fleet) -> dict:
    """Phase 21: (a) the encoder-decoder and the VLM on meshes of ranks
    sharing the card, part "21" of the fleet phase 20 (a) shares
    (:func:`mesh_fleet_phase`): served on (1, 2) on seeded non-zero
    frames / patches against the unsharded models (gate 1), no kernel
    launched; trained on (1, 2), each held to a one-card run,
    every sync round to the one-pod round (gate 2), K1-K4 on every rank
    (gate 3); the (1, 2) checkpoint restored on (2, 1) and on one card
    bit for bit (gate 4); (b) with four cards, over NCCL.  Returns the
    kernels' launches per path."""
    tag = "phase 21 (a)"
    launches = check_fleet_part(tag, card, "21", fleet)
    log(f"{tag}: launches by path {launches}")
    launches.update(mesh_front_big_phase(torch))
    return launches


# ---------------------------------------------------------------------------
# phase 22: pods x ("data", "model") — a fleet of meshes
# ---------------------------------------------------------------------------

#: 22(a): P = 2 pods, each a (1, 2) mesh, the four ranks sharing the card
#: over gloo: paper-350m at full width and 2 layers (4 until phase 23
#: joined the script), global batch 8 x
#: 1024, ``acesync`` with ``replan_every`` 4, 8 loop steps, a checkpoint at
#: step 4 (``ckpt_every`` 4), then an all-rungs grad_sync one-shot and one
#: ringed in 2 chunks (the flat encoders K12-K15)
FLEET_MESH_A = {"arch": "paper-350m", "n_layers": 2, "pods": 2,
                "mesh": (1, 2), "shape": (8, 1024), "steps": 8,
                "ckpt_every": 4, "restore": 4, "loop_grad_sync": False,
                "rungs": ALL_RUNGS, "rings": (-1, 2)}
#: 22(b), with four cards, over NCCL: qwen3-8b at full width, P = 2 x
#: (1, 2), a card a rank, at ``launch.memory.mesh_train_depth``'s depth
#: for (1, 2) reckoned at ``FLEET_BYTES_PER_PARAM``; no checkpoint (tens
#: of GB at that depth; (a) restores)
FLEET_MESH_B = {"arch": "qwen3-8b", "pods": 2, "mesh": (1, 2),
                "shape": (8, 1024), "steps": 8, "ckpt_every": 0,
                "loop_grad_sync": False, "rings": (-1, 2)}
#: a fleet rank's step peak per parameter, reckoned: phase 18's one-pod
#: mesh peak plus the pod exchange's gathered payloads and decode
#: accumulators at P = 2 (a few bytes per parameter of the rank)
FLEET_BYTES_PER_PARAM = MESH_BYTES_PER_PARAM + 8.0
#: the kernels every fleet rank must launch: K1-K8 and K12-K15
FLEET_KERNELS = (tuple(KERNELS) + tuple(DECODE)[:4]
                 + tuple(k for k in FLAT if k != "dequant_int8"))


def fleet_mesh_path(world, spec):
    """Phases 22 and 23, one rank of P pods of (D, M) meshes (world rank
    p * D * M + d * M + m; with ``spec["edge"]`` = E > 1 the pods are a
    two-tier fleet of P / E clusters, p = c * E + e): phase 18's rank
    (:func:`mesh_train_path`) on a TrainSession of its pod's mesh and its
    (d, m)'s pod group, whose checked rounds are the pod-only (two-tier)
    ``sync_tree`` over that group (gate 1) and record its bytes per tier
    beside the priced ones (gate 3); each step's H, levels, tier grid,
    omega and clusters, and the parameter shards' hashes after each
    delta_sync (gate 2: the pods' moments differ, so a grad_sync's AdamW
    does not give the same parameters); with ``spec["restore"]``, the
    state's shard hashes at that step's save, then, the fleet's state
    freed, mesh rank 0 of each pod restores that checkpoint as one pod of
    a fleet of P whole-model processes (gate 5; hierarchical, C x E, on a
    two-tier fleet)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core import sync as S
    from repro_torch.core.trainer import Trainer
    from repro_torch.launch.mesh import PodGroup, split_fleet_mesh
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model
    P, (D, M), E = spec["pods"], spec["mesh"], spec.get("edge", 1)
    strategy = spec.get("strategy", "acesync")
    ctx, pods = split_fleet_mesh(world, P, D, M, n_edge=E)
    cfg, run = mesh_train_config(spec["arch"], spec["n_layers"],
                                 *spec["shape"], H=spec.get("H"))
    run = dataclasses.replace(
        run, ckpt_every=spec["ckpt_every"], ckpt_dir=spec["dir"],
        acesync=dataclasses.replace(run.acesync, replan_every=spec.get(
            "replan_every", run.acesync.replan_every)))
    steps, saved = [], {}

    def on_step(sess, res, plan, kind):
        omega = plan.omega
        rec = {"step": sess.loop._host_step, "kind": kind, "H": sess.loop._H,
               "levels": list(getattr(plan, "level_idx", ())),
               "hier": list(getattr(plan, "hier", None) or ()),
               "clusters": list(sess.loop.clusters.assignments or ()),
               "updates": sess.loop.clusters.updates,
               "omega": [float(w) for w in (omega.tolist()
                                            if torch.is_tensor(omega)
                                            else omega)]}
        if kind == "delta_sync":
            rec["hashes"] = [int(bits_hash(torch, x))
                             for x in T.leaves(res[0]["params"])]
        steps.append(rec)

    def hash_saves(sess, out):
        tr, save = sess.trainer, sess.loop.ckpt.save

        def hashed_save(step_no, state, extras=None, blocking=False):
            if step_no == spec.get("restore"):
                saved["shards"] = [(int(bits_hash(torch, x)), sh.index)
                                   for (_, x), sh in zip(
                                       T.reference_leaves_with_path(state),
                                       tr.state_layout(state))]
            return save(step_no, state, extras=extras, blocking=blocking)

        sess.loop.ckpt.save = hashed_save

    plain = S.sync_tree
    try:
        out = mesh_train_path(
            ctx, spec, stops=((0, hash_saves),), on_step=on_step,
            session=lambda: TrainSession(
                build_model(cfg, run, device=ctx.device, ctx=ctx), run,
                strategy=strategy, pods=pods,
                n_edge_devices=spec.get("edge_devices", 8)))
    finally:
        S.sync_tree = plain
    tiers = {}
    for x in pods.log:
        b, sec = tiers.get(x["tier"], (0, 0.0))
        tiers[x["tier"]] = (b + x["bytes"], sec + x["seconds"])
    out.update(rank=world.rank, pod=pods.rank, coords=(ctx.d, ctx.m),
               steps=steps, layers=cfg.n_layers,
               width=(cfg.d_model, cfg.vocab_size), tiers=tiers)
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("restore"):
        # every rank's saved (hash, index) per leaf, then mesh rank 0 of
        # each pod restores that step as a pod of P whole-model processes
        every = [None] * world.size
        dist.all_gather_object(every, saved.get("shards"),
                               group=world.host_pg)
        members = [p * D * M for p in range(P)]
        sub = world.regroup(members)
        # a two-tier fleet's tier groups: every process creates them
        (sub or PodGroup(0, P, world.device, world.backend,
                         ranks=members)).split_tiers(E)
        if sub is not None:
            t2 = time.perf_counter()
            model = build_model(cfg, run, device=ctx.device)
            one = Trainer(model, run, strategy=strategy, pods=sub)
            restored, _ = Checkpointer(spec["dir"], pods=sub).restore(
                one.init_state(run.seed), step=spec["restore"])
            torch.cuda.synchronize()
            mine = every[sub.rank * D * M:(sub.rank + 1) * D * M]
            bad = [i for i, (_, x) in enumerate(
                T.reference_leaves_with_path(restored))
                for sh in mine if int(bits_hash(
                    torch, x[sh[i][1]])) != sh[i][0]]
            out["restored"] = {"seconds": time.perf_counter() - t2,
                               "bad": bad, "leaves": len(mine[0]),
                               "step": int(restored["step"]),
                               "n_edge": one.n_edge}
            del restored, one, model
            gc.collect()
            torch.cuda.empty_cache()
        world.barrier()
    return out


def check_fleet_mesh(tag, card, spec, res, cards=1) -> dict:
    """Phases 22's and 23's gates on the ranks' results and their lines;
    returns the kernels' launches summed over the ranks."""
    from repro_torch.models import flops
    P, (D, M), E = spec["pods"], spec["mesh"], spec.get("edge", 1)
    fleet = f"P = {P}" if E == 1 else f"C = {P // E} x E = {E}"
    name = f"{spec['arch']} ({spec['n_layers']} layers) on {fleet} x {(D, M)}"
    kernels = spec.get("kernels", FLEET_KERNELS)
    r0 = res[0]
    keys = ("step", "kind", "H", "levels", "hier", "omega", "clusters")
    for r in res:
        if not r["finite"] or not all(math.isfinite(x) for x in r["losses"]):
            fail(f"{tag}: {name} rank {r['rank']}: non-finite losses "
                 f"{r['losses']} or parameters")
        # gate 1: every round bit-identical to the pod-only sync_tree
        bad = [x for x in r["sync"] if x["differ"]]
        if bad or not r["sync"]:
            fail(f"{tag}: {name} rank {r['rank']}: sync rounds not the pod "
                 f"round on the rank's shards: {bad or 'none run'}")
        # gate 3: each (d, m)'s bytes per tier
        for x in r["sync"]:
            got_pay, got_full, pay, full, pad = x["bytes"]
            if got_pay != pay or not (got_full == full
                                      or 0 <= got_full - full < pad):
                fail(f"{tag}: {name} rank {r['rank']}: {x['kind']} moved "
                     f"{got_pay} B (gather + ring) and {got_full} B FULL "
                     f"over its cross tier; priced {pay}, FULL {full} "
                     f"(+{pad})")
            got, want, ipad = x.get("intra", (0, 0, 0))
            if not (got == want or 0 <= got - want < ipad):
                fail(f"{tag}: {name} rank {r['rank']}: {x['kind']} moved "
                     f"{got} B over its intra tier, priced {want} "
                     f"(+{ipad})")
        # gate 4: H, the plan, its tier grid, omega, the clusters and the
        # losses on every rank
        if ([{k: s[k] for k in keys} for s in r["steps"]]
                != [{k: s[k] for k in keys} for s in r0["steps"]]
                or r["losses"] != r0["losses"]):
            fail(f"{tag}: {name} rank {r['rank']}: H, plan, tier grid, "
                 f"omega, clusters or losses differ from rank 0's")
        # gate 2: the shards bit-identical across the pods after each
        # delta_sync
        mate = res[r["rank"] % (D * M)]
        for a, b in zip(r["steps"], mate["steps"]):
            if a.get("hashes") != b.get("hashes"):
                fail(f"{tag}: {name} rank {r['rank']}: parameter shards "
                     f"differ from pod 0's after the {a['kind']} of step "
                     f"{a['step']}")
        # gate 6: the path's kernels on every rank
        missing = [k for k in kernels if r["launches"].get(k, 0) < 1]
        if missing:
            fail(f"{tag}: {name} rank {r['rank']}: kernels never "
                 f"launched: {missing}")
    syncs = sum(1 for s in r0["steps"] if s["kind"] == "delta_sync")
    if E > 1 and (not syncs or not any(r0["steps"][0]["hier"])
                  or len({s["updates"] for s in r0["steps"]}) < 2):
        fail(f"{tag}: {name}: {syncs} delta_syncs, tier grid "
             f"{r0['steps'][0]['hier']}, clustering updates "
             f"{[s['updates'] for s in r0['steps']]}: no two-tier sync or "
             f"no re-clustering")
    # gate 5: the restore as P pods x one card
    target = f"{P} pods x one card" if E == 1 else (
        f"a {P // E} x {E} hierarchical fleet of one-card members")
    if spec.get("restore"):
        done = [r["restored"] for r in res if r.get("restored")]
        if len(done) != P or any(x["bad"] or x["step"] != spec["restore"]
                                 or x.get("n_edge", 1) != E for x in done):
            fail(f"{tag}: {name}: the step-{spec['restore']} checkpoint "
                 f"restored as {target} differs from the shards written: "
                 f"{done}")
        log(f"{tag}: {name}: the step-{spec['restore']} checkpoint restored "
            f"as {target}, {done[0]['leaves']} leaves, every rank's shards "
            f"bit for bit; {[round(x['seconds'], 3) for x in done]} s "
            f"[{card}]")
    log(f"{tag}: {name} over {r0['backend']}: kinds "
        f"{r0['kinds']}, H {[s['H'] for s in r0['steps']]}"
        f", losses {[round(x, 4) for x in r0['losses']]}, "
        f"{r0['replans']} device replan(s), tier grids "
        f"{[s['hier'] for s in r0['steps'] if s['kind'] == 'delta_sync']}, "
        f"clusters {r0['steps'][-1]['clusters']} after "
        f"{r0['steps'][-1]['updates']} updates, identical on all "
        f"{len(res)} ranks; {syncs} delta_syncs, every shard "
        f"bit-identical across the pods after each; "
        f"{sum(len(r['sync']) for r in res)} "
        f"rounds bit-identical to the pod-only sync_tree on each rank's "
        f"shards; bytes per tier = the priced bytes of each (d, m)'s local "
        f"layout; {', '.join(kernels)} launched per rank "
        f"{[[r['launches'].get(k, 0) for k in kernels] for r in res]}")
    for r in res:
        line = []
        for kind, xs in r["ms"].items():
            med, lo, hi = _spread(xs)
            line.append(f"{kind} {med:.3f} ({lo:.3f}-{hi:.3f})")
        med = _spread(r["ms"]["local"])[0]
        mfu = flops.mfu(r["model_flops"], med * 1e-3, cards=len(res))
        tiers = "; ".join(
            f"{t} {b:,} B in {sec:.3f} s ({b / sec if sec else math.nan:.6g}"
            f" B/s)" for t, (b, sec) in sorted(r["tiers"].items()))
        log(f"{tag}: {name}, rank {r['rank']} (pod {r['pod']}, (d, m) "
            f"{tuple(r['coords'])}) on {card}: {r['n_params']:,} "
            f"parameters, state {r['state_bytes']:,} B, init "
            f"{r['init_s']:.2f} s, trained in {r['train_s']:.2f} s; step "
            f"ms median (min-max): {'; '.join(line)}; local MFU {mfu:.6g} "
            f"over {len(res)} x 989 TFLOP/s; bytes received and host time "
            f"per tier: {tiers}; peak "
            f"{r['peak_alloc'] / 2**30:.3f} GiB allocated "
            f"({r['peak_alloc'] / r['n_params']:.2f} B per parameter)")
    return {k: sum(r["launches"].get(k, 0) for r in res)
            for k in r0["launches"]}


def fleet_mesh_one_card(torch, card, tag, spec) -> dict:
    """The one-card part of phase 22 or 23: ``spec``'s fleet of meshes,
    its ranks sharing the card over gloo (one spawn), gates 1-6.  Returns
    the kernels' launches summed over the ranks."""
    import gc
    from repro_torch.launch.mesh import spawn_pods
    # the loop's checkpoints (phase 22's at steps 4 and 8), each P rows
    _disk_check(tag, spec["n_layers"], 2 * spec["pods"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        res = spawn_pods(fleet_mesh_path, spec["pods"] * spec["mesh"][0]
                         * spec["mesh"][1], "cuda", args=(spec,),
                         timeout=600)
    finally:
        shutil.rmtree(spec["dir"], ignore_errors=True)
    if (res[0]["width"] != (1024, 50304)
            or res[0]["layers"] != spec["n_layers"]):
        fail(f"{tag}: ran {res[0]['layers']} layers at {res[0]['width']}")
    launches = check_fleet_mesh(tag, card, spec, res)
    log(f"{tag}: wall {time.perf_counter() - t0:.2f} s")
    if spec["arch"] == FLEET_MESH_A["arch"] and "edge" not in spec:
        PHASE24["b"] = res[0]["step_logs"]["grad_sync_all_rungs_k0"]
    return launches


def fleet_mesh_phase(torch, card) -> dict:
    """Phase 22: (a) P = 2 pods x (1, 2) of paper-350m, the four ranks
    sharing the card over gloo (one spawn), gates 1-6; (b) with four
    cards.  Returns the kernels' launches per path."""
    launches = {"fleet_mesh": fleet_mesh_one_card(
        torch, card, "phase 22 (a)",
        dict(FLEET_MESH_A, dir=str(CKPT_ROOT / "fleet_mesh")))}
    launches.update(fleet_mesh_big_phase(torch))
    return launches


def fleet_mesh_big_phase(torch) -> dict:
    """Phase 22(b): qwen3-8b on P = 2 x (1, 2), a card a rank, over NCCL,
    at the depth ``launch.memory.mesh_train_depth`` gives (1, 2) at
    ``FLEET_BYTES_PER_PARAM``; gates 1-4 and 6.  One line and nothing
    else on fewer cards."""
    import gc
    from repro_torch.configs import ARCHS
    from repro_torch.launch.memory import mesh_train_depth
    from repro_torch.launch.mesh import spawn_pods
    tag = "phase 22 (b)"
    spec = dict(FLEET_MESH_B, dir=str(CKPT_ROOT / "fleet_mesh_b"))
    n = spec["pods"] * spec["mesh"][0] * spec["mesh"][1]
    if torch.cuda.device_count() < n:
        log(f"{tag}: {torch.cuda.device_count()} card(s): qwen3-8b on "
            f"P = 2 x (1, 2) trains on {n}; not run")
        return {}
    cards = four_cards()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    B, S = spec["shape"]
    layers = mesh_train_depth(ARCHS[spec["arch"]], *spec["mesh"],
                              card_bytes - ZOO_FREE_GIB * 2**30,
                              FLEET_BYTES_PER_PARAM, batch=B // spec["pods"],
                              seq=S)
    if layers < 1:
        fail(f"{tag}: {spec['arch']}: not one layer fits")
    spec["n_layers"] = layers
    log(f"{tag}: {spec['arch']} at {layers} layers (the most that fit "
        f"(1, 2) at {FLEET_BYTES_PER_PARAM} B per parameter of a rank, "
        f"{ZOO_FREE_GIB} GiB of each card to spare)")
    gc.collect()
    torch.cuda.empty_cache()
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        res = spawn_pods(fleet_mesh_path, n, "cuda", args=(spec,),
                         timeout=900)
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
        shutil.rmtree(spec["dir"], ignore_errors=True)
    if res[0]["backend"] != "nccl":
        fail(f"{tag}: the fleet ran over {res[0]['backend']}, not NCCL")
    out = {"fleet_mesh_b": check_fleet_mesh(tag, cards, spec, res, cards=4)}
    log(f"{tag}: wall {time.perf_counter() - t0:.2f} s")
    return out


#: 23(a): a two-tier fleet of meshes, C = 2 clusters x E = 2 members, each
#: member a (1, 2) mesh, the eight ranks sharing the card over gloo:
#: paper-350m at full width and 2 layers, global batch 8 x 1024,
#: ``acesync_hier`` over 16 edge devices, ``sync_interval_init`` 3 and
#: ``replan_every`` 3 (the replans re-cluster), 7 loop steps with a
#: checkpoint at step 4 (``ckpt_every`` 4), then all-rungs grad_syncs with
#: the two-tier rungs at the INT8 intra stage and the cross tier one-shot
#: and ringed in 2 chunks (the flat encoders K12-K13), and one flat over
#: the four members (the fixed-point folds K9-K11); no four-card part:
#: eight ranks on four cards would put two ranks of one NCCL communicator
#: on one card
FLEET_HIER_MESH_A = {"arch": "paper-350m", "n_layers": 2, "pods": 4,
                     "edge": 2, "mesh": (1, 2), "shape": (8, 1024),
                     "steps": 7, "H": 3, "replan_every": 3,
                     "edge_devices": 16, "strategy": "acesync_hier",
                     "ckpt_every": 4, "restore": 4, "loop_grad_sync": False,
                     "rungs": ALL_RUNGS,
                     "rounds": ((2, -1), (2, 2), (-1, -1))}
#: the kernels every rank of 23(a) must launch: K1-K6, K8-K13 (phase 8's)
FLEET_HIER_KERNELS = (tuple(KERNELS) + tuple(k for k in DECODE
                                             if k != "sign_vote_accum")
                      + ("quantize_int8", "ef_int4"))


def fleet_hier_mesh_phase(torch, card) -> dict:
    """Phase 23 (a): the two-tier fleet of meshes of ``FLEET_HIER_MESH_A``,
    its eight ranks sharing the card over gloo (one spawn), phase 22's
    rank code and gates 1-6 with the bytes of every tier, and the
    re-clustering.  Returns the kernels' launches per path."""
    return {"fleet_hier_mesh": fleet_mesh_one_card(
        torch, card, "phase 23 (a)",
        dict(FLEET_HIER_MESH_A, dir=str(CKPT_ROOT / "fleet_hier_mesh"),
             kernels=FLEET_HIER_KERNELS))}


# ---------------------------------------------------------------------------
# phase 24: the dry run
# ---------------------------------------------------------------------------

#: what phases 5 and 22 (a) leave for phase 24: "a", the card's side of
#: (a) (:func:`dryrun_card_step`); "b", rank 0's collectives of phase 22
#: (a)'s one-shot all-rungs round by op and tier
PHASE24: dict = {}
#: 24 (c): the dry run's CLI on these cells, each a process of its own
#: (arch, shape, with --multi-pod)
DRYRUN_CELLS = (("qwen3-8b", "train_4k", False),
                ("dbrx-132b", "train_4k", True))
DRYRUN_OUT = ROOT / "build" / "dryrun_smoke"
#: 24 (a)'s bound on the dry run's counted peak of the step's allocations
#: against the allocator's (``max_memory_allocated`` above the step's
#: start), relative: measured -0.0089% on an H100 (PERF.md §6)
PEAK_RTOL = 0.01


def dryrun_runs() -> dict:
    """The RunConfigs of 24 (a) (phase 5's: paper-350m at full width and
    depth, 8 x 1024) and (b) (phase 22 (a)'s: 2 layers)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ACESyncConfig, RunConfig, ShapeConfig
    a = RunConfig(model=ARCHS["paper-350m"],
                  shape=ShapeConfig("session", 1024, 8, "train"),
                  total_steps=100, warmup_steps=2,
                  acesync=ACESyncConfig(replan_every=4))
    spec = FLEET_MESH_A
    _, b = mesh_train_config(spec["arch"], spec["n_layers"], *spec["shape"])
    return {"a": a, "b": b}


def dryrun_side(path: str) -> None:
    """Phase 24's dry runs of (a) and (b) on the meta device, in a process
    of its own beside the card's phases (it touches no card): (a) phase
    5's all-rungs ``grad_sync`` on one pod, (b) phase 22 (a)'s one-shot
    all-rungs round on rank (0, 0) of pod 0 of P = 2 x (1, 2).  Writes
    their records to ``path`` as JSON."""
    from repro_torch.core import planexec
    from repro_torch.launch.dryrun import dry_step
    runs = dryrun_runs()

    def rungs(levels, omega):
        return lambda tr: tr.scheduler.plan_from_levels(
            list(levels or (i % 8 for i in range(len(tr.sizes)))), omega)

    def one_shot(tr):
        rr = rungs(FLEET_MESH_A["rungs"], (0.5, 0.5))(tr)
        return planexec.build_exec_plan(
            rr, layout=tr.leaf_layout, n_pods=tr.n_pods, ring=-1,
            n_edge=tr.n_edge, hier=None,
            segments=planexec.config_segments(runs["b"].acesync),
            device=tr.device)

    out = {}
    for key, kw in (("a", {"plan": rungs(None, (1.0,))}),
                    ("b", {"plan": one_shot, "P": 2, "D": 1, "M": 2})):
        run = runs[key]
        out[key] = dry_step(run.model, run.shape, run=run, kind="grad_sync",
                            **kw)
    with open(path, "w") as f:
        json.dump(out, f)


def start_dryrun_side() -> dict:
    """Start phase 24's processes on the CPU after phase 2 (none sees the
    card): :func:`dryrun_side` and the CLI on each of ``DRYRUN_CELLS``.
    They run beside the card's phases; an exit of this script stops
    them."""
    import atexit
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(SRC)]))
    side = {"procs": {}}

    def start(name, cmd):
        logf = open(DRYRUN_OUT / f"{name}.log", "w")
        side["procs"][name] = (subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT),
            logf)

    start("side", [sys.executable, "-c",
                   "import chip_smoke as c; c.dryrun_side("
                   f"{str(DRYRUN_OUT / 'side.json')!r})"])
    for arch, shape, multi in DRYRUN_CELLS:
        start(f"{arch}_{shape}", [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--out", str(DRYRUN_OUT)]
            + (["--multi-pod"] if multi else []))

    def stop():
        for p, logf in side["procs"].values():
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    atexit.register(stop)
    return side


def _wait(side, name, timeout=600) -> float:
    """Wait for phase 24's process ``name`` (it must exit 0); the seconds
    phase 24 waited for it beside the card's phases (0: it had ended)."""
    p, logf = side["procs"][name]
    t0 = time.perf_counter()
    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"phase 24: {name} did not end in {timeout} s")
    logf.close()
    if rc != 0:
        tail = (DRYRUN_OUT / f"{name}.log").read_text()[-3000:]
        fail(f"phase 24: {name} exited {rc}:\n{tail}")
    return time.perf_counter() - t0


def dryrun_phase(torch, card, side) -> dict:
    """Phase 24, the dry run: (a) phase 5's all-rungs step counted on the
    meta device against the same step on the card — FLOPs, every
    kernel's launches, the state bytes equal, the counted peak within
    ``PEAK_RTOL`` of the allocator's; (b) phase 22 (a)'s one-shot
    all-rungs round on rank 0: the counted collective bytes and counts by
    op and tier equal to what its groups logged; (c) the CLI's records
    of ``DRYRUN_CELLS`` ok.  Returns the kernels' launches of (a)'s step
    on the card (path ``dryrun``)."""
    tag = "phase 24"
    _wait(side, "side")
    with open(DRYRUN_OUT / "side.json") as f:
        dry = json.load(f)
    card_a, a = PHASE24["a"], dry["a"]
    w = a["walker"]
    log(f"{tag} (a): paper-350m's all-rungs grad_sync (24 layers, 8 x "
        f"1024) counted on the meta device in {a['trace_s']:.2f} s: "
        f"{w['flops_per_device']:.6e} FLOPs, "
        f"{w['bytes_per_device']:.6e} bytes by aten op, state "
        f"{a['memory']['state_bytes']} B, counted peak of the step's "
        f"allocations {a['memory']['transient_peak_bytes']} B; on the "
        f"card: {card_a['flops']:.6e} FLOPs, state "
        f"{card_a['state_leaf_bytes']} B in its leaves "
        f"({card_a['state_bytes']} B of storage: the anchor's packed rung "
        f"buffers' pad rows), allocator's peak above the step's "
        f"start {card_a['peak']} B (the counters on the card's tensors "
        f"count {card_a['counted_peak_on_card']} B), step "
        f"{card_a['seconds']:.2f} s under the counters [{card}]")
    if w["flops_per_device"] != card_a["flops"]:
        ops_d, ops_c = w["op_flops"], card_a["op_flops"]
        diff = {k: (ops_d.get(k), ops_c.get(k))
                for k in set(ops_d) | set(ops_c)
                if ops_d.get(k) != ops_c.get(k)}
        fail(f"{tag} (a): FLOPs {w['flops_per_device']} counted, "
             f"{card_a['flops']} on the card; by op {diff}")
    got = {k: v["launches"] for k, v in w["kernels"].items()}
    want = {k: v for k, v in card_a["launches"].items() if v}
    if got != want:
        fail(f"{tag} (a): launches counted {got}, on the card {want}")
    # the dry run's state is fresh, each leaf its own storage; after a
    # delta_sync the card's anchor leaves are views of the rungs' packed
    # buffers, whose pad rows ``state_bytes`` counts too
    if a["memory"]["state_bytes"] != card_a["state_leaf_bytes"]:
        fail(f"{tag} (a): state bytes counted "
             f"{a['memory']['state_bytes']}, the card's leaves "
             f"{card_a['state_leaf_bytes']}")
    rel = (a["memory"]["transient_peak_bytes"] - card_a["peak"]) \
        / card_a["peak"]
    log(f"{tag} (a): FLOPs, the launches of {sorted(got)} and the state "
        f"bytes equal; the counted peak {rel:+.4%} of the allocator's "
        f"(bound {PEAK_RTOL:.0%})")
    if abs(rel) > PEAK_RTOL:
        fail(f"{tag} (a): the counted peak is {rel:+.4%} of the "
             f"allocator's")
    b = dry["b"]["walker"]
    card_b = PHASE24["b"]
    log(f"{tag} (b): phase 22 (a)'s one-shot all-rungs round, rank 0 of "
        f"P = 2 x (1, 2): counted {b['collective_bytes_per_device']} "
        f"bytes in {b['collective_counts']} collectives; its groups "
        f"logged {card_b[0]} in {card_b[1]} [{card}]")
    if (b["collective_bytes_per_device"], b["collective_counts"]) != \
            tuple(card_b):
        fail(f"{tag} (b): the counted collectives differ from the logged")
    for arch, shape, multi in DRYRUN_CELLS:
        secs = _wait(side, f"{arch}_{shape}")
        mesh = "2x16x16" if multi else "16x16"
        with open(DRYRUN_OUT / f"{mesh}_{arch}_{shape}_acesync.json") as f:
            rec = json.load(f)
        if not rec["ok"]:
            fail(f"{tag} (c): {mesh} {arch} x {shape}: {rec.get('error')}")
        log(f"{tag} (c): the CLI on {mesh} {arch} x {shape}: ok, built in "
            f"{rec['build_s']:.2f} s, traced in {rec['trace_s']:.2f} s "
            f"beside the card's phases (phase 24 waited {secs:.2f} s for "
            f"it); {rec['bytes_per_device'] / 1e9:.3f} GB a device, "
            f"{rec['walker']['flops_per_device']:.4e} FLOPs a device")
    return {"dryrun": card_a["launches"]}


#: the parts ``--phases`` can run alone (each needs four cards)
FOUR_CARD_PHASES = {"17b": "mesh_big_phase", "18b": "mesh_train_big_phase",
                    "19b": "mesh_ckpt_big_phase",
                    "20b": "mesh_rec_big_phase",
                    "21b": "mesh_front_big_phase",
                    "22b": "fleet_mesh_big_phase"}


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="",
                    help="run only these four-card parts, comma-separated "
                         f"(of {', '.join(FOUR_CARD_PHASES)})")
    only = [x for x in ap.parse_args(argv).phases.split(",") if x]
    bad = [x for x in only if x not in FOUR_CARD_PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not next to this script ({SRC})")
    # every process the script starts imports torch and the port afresh:
    # their bytecode is cached under build/ (where PYTHONDONTWRITEBYTECODE
    # is set, each process would compile every module again, seconds a
    # process)
    cache = str(ROOT / "build" / "pycache")
    sys.pycache_prefix = cache
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.path.insert(0, str(SRC))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    log(f"phase 1: {torch.cuda.get_device_name(0)} (torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")

    from repro_torch.kernels import build, ops, ref
    t0 = time.perf_counter()
    build.load()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.last_build.get('seconds', 0.0):.2f} s) -> "
        f"{build.last_build.get('path')}")

    phase_s = {}
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True)
    side = None if only else start_dryrun_side()

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 2)
        log(f"{name}: {phase_s[name]} s")
        return res

    if only:
        by_path = {}
        for name in only:
            by_path.update(timed_phase(
                f"phase {name}", globals()[FOUR_CARD_PHASES[name]], torch)
                or {})
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        from repro_torch.launch.mesh import stop_start_server
        stop_start_server()
        print(card, flush=True)
        print(json.dumps({"phases": phase_s, "launches": by_path}),
              flush=True)
        return 0
    results = timed_phase("phase 3", kernel_phase, np, torch, ops, ref, dev)
    timed_phase("phase 4", small_agreement, torch)
    by_path = {"one_pod": timed_phase("phase 5", main_path, torch, ops)}
    results.update(timed_phase("phase 6", decode_phase, np, torch, ops, ref,
                               dev))
    results.update(timed_phase("phase 6b", flat_phase, torch, ops, ref, dev))
    runs, link = timed_phase("phase 7", multipod_phase, torch)
    by_path.update(runs)
    by_path["hier"] = timed_phase("phase 8", hier_phase, torch)
    by_path["restart"], restart_save = timed_phase("phase 9a",
                                                   restart_phase, torch)
    by_path["elastic"] = timed_phase("phase 9b", elastic_phase, torch)
    timed_phase("phase 10", serve_phase, torch, card)
    timed_phase("phase 11", serve_moe_phase, torch, card)
    by_path.update(timed_phase("phase 12", zoo_phase, torch, card))
    timed_phase("phase 13", serve_recurrent_phase, torch, card)
    by_path.update(timed_phase("phase 14", recurrent_train_phase, torch,
                               card))
    timed_phase("phase 15", serve_frontend_phase, torch, card)
    by_path.update(timed_phase("phase 16", frontend_train_phase, torch,
                               card))
    timed_phase("phase 17", serve_mesh_phase, torch, card)
    by_path.update(timed_phase("phase 18", mesh_train_phase, torch, card))
    by_path.update(timed_phase("phase 19", mesh_ckpt_phase, torch, card,
                               restart_save))
    fleet = timed_phase("phases 20-21 (a), one fleet", mesh_fleet_phase,
                        torch)
    by_path.update(timed_phase("phase 20", mesh_rec_phase, torch, card,
                               fleet))
    by_path.update(timed_phase("phase 21", mesh_front_phase, torch, card,
                               fleet))
    del fleet
    by_path.update(timed_phase("phase 22", fleet_mesh_phase, torch, card))
    by_path.update(timed_phase("phase 23", fleet_hier_mesh_phase, torch,
                               card))
    by_path.update(timed_phase("phase 24", dryrun_phase, torch, card, side))
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    # the processes' start server and its resource tracker end with this
    # process; stop them before the result lines instead
    from repro_torch.launch.mesh import stop_start_server
    stop_start_server()
    log(f"pod link (phase 7, P = 2 ping-pong): latency "
        f"{link['latency_s']:.6g} s per hop, rate "
        f"{link['rate_bytes_per_s']:.6g} B/s; phase seconds {phase_s}")

    kernels = []
    table = [(n, SOURCE, rep) for n, (rep, _, _) in KERNELS.items()]
    table += [(n, DECODE_SOURCE, rep) for n, (rep, _) in DECODE.items()]
    table += [(n, SOURCE, rep) for n, (rep, _, _) in FLAT.items()]
    for name, source, replaces in table:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # phase 5 (one pod) + phase 7 (every pod at P = 2 and 3) +
            # phase 8 (every member of the 2 x 2 fleet) + phase 9 (the
            # restart runs on one pod, every pod of the elastic run) +
            # phases 12, 14 and 16 (each trained model's process, phase
            # 12's determinism runs) + phases 18-23 (every mesh rank) +
            # phase 24 (a)'s step
            "launches": sum(n.get(name, 0) for n in by_path.values()),
            "launches_by_path": {path: n.get(name, 0)
                                 for path, n in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            "parity": "bit-exact", "bytes": r["bytes"],
            "gbps": r["gbps"]})
    print(card, flush=True)
    paths = {"one_pod": {"pods": 1, "layers": 24},
             "dryrun": {"pods": 1, "layers": 24, "batch": 8, "seq": 1024,
                        "step": "phase 5's all-rungs grad_sync, counted"}}
    paths.update({path: {"pods": spec["pods"], "edge": spec.get("edge", 1),
                         "layers": spec["n_layers"] or 24}
                  for path, spec in dict(PATHS, restart=RESTART,
                                         elastic=ELASTIC).items()})
    paths.update({f"zoo_{arch}": {"pods": 1, "arch": arch,
                                  "layers": spec["n_layers"],
                                  "batch": spec["batch"]}
                  for arch, spec in dict(TRAIN_ZOO, **TRAIN_RECURRENT,
                                         **TRAIN_FRONTEND).items()})
    paths["zoo_determinism"] = dict(paths[f"zoo_{ZOO_DET['arch']}"],
                                    layers=ZOO_DET["n_layers"], runs=2,
                                    steps=ZOO_DET["steps"])
    paths.update({f"mesh_{c['arch']}_{c['mesh'][0]}x{c['mesh'][1]}": {
        "arch": c["arch"], "layers": c["n_layers"], "mesh": c["mesh"],
        "batch": MESH_TRAIN_A_SHAPE[0], "seq": MESH_TRAIN_A_SHAPE[1]}
        for c in MESH_TRAIN_A})
    paths.update({p: {"arch": p.split("_")[2], "mesh": p.split("_")[3],
                      "cards": 4, "batch": MESH_TRAIN_B_SHAPE[0],
                      "seq": MESH_TRAIN_B_SHAPE[1]}
                  for p in by_path if p.startswith("mesh_b_")})
    paths.update({p: {"arch": "paper-350m", "layers": s["n_layers"] or 24,
                      "mesh": s["mesh"], "batch": s["batch"],
                      "seq": s["seq"], "cards": 1 if p == "mesh_ckpt" else 4}
                  for p, s in (("mesh_ckpt", MESH_CKPT_A),
                               ("mesh_ckpt_b", MESH_CKPT_B))
                  if p in by_path})
    paths.update({f"mesh_rec_{t['arch']}_{t['mesh'][0]}x{t['mesh'][1]}": {
        "arch": t["arch"], "layers": t["n_layers"], "mesh": t["mesh"],
        "batch": MESH_REC_SHAPE[0], "seq": MESH_REC_SHAPE[1],
        "compute": "float32"} for t in MESH_REC_TRAIN})
    paths["mesh_rec_serve"] = {"archs": MESH_REC_SERVE,
                               "mesh": {a: serve_mesh(a)
                                        for a in MESH_REC_SERVE},
                               "launches": "none"}
    paths.update({p: {"arch": p.split("_")[3], "mesh": p.split("_")[4],
                      "cards": 4, "batch": MESH_TRAIN_B_SHAPE[0],
                      "seq": MESH_TRAIN_B_SHAPE[1]}
                  for p in by_path if p.startswith(("mesh_rec_b_",
                                                    "mesh_front_b_"))})
    paths.update({f"mesh_front_{t['arch']}_{t['mesh'][0]}x{t['mesh'][1]}": {
        "arch": t["arch"], "layers": t["n_layers"], "mesh": t["mesh"],
        "batch": t["shape"][0], "seq": t["shape"][1], "compute": "float32"}
        for t in MESH_FRONT_TRAIN})
    paths["mesh_front_serve"] = {"archs": MESH_FRONT_SERVE, "mesh": (1, 2),
                                 "launches": "none"}
    paths.update({p: {"arch": s["arch"], "pods": s["pods"],
                      "edge": s.get("edge", 1), "mesh": s["mesh"],
                      "layers": s.get("n_layers"),
                      "batch": s["shape"][0], "seq": s["shape"][1],
                      "cards": 4 if p == "fleet_mesh_b" else 1}
                  for p, s in (("fleet_mesh", FLEET_MESH_A),
                               ("fleet_mesh_b", FLEET_MESH_B),
                               ("fleet_hier_mesh", FLEET_HIER_MESH_A))
                  if p in by_path})
    print(json.dumps({"kernels": kernels, "paths": paths,
                      "link": {k: link[k] for k in ("latency_s",
                                                    "rate_bytes_per_s")}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
