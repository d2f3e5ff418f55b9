#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the package's main paths once — whole hyper-parameter studies
through ``Study.run`` → engine → ``TorchTrainer`` → the kernels, and
decode through the serve step — at full width: the paper's ResNet56
(``ResNet(n=9, width=16)``, batch 128, momentum), qwen2-0.5b (24 layers,
d_model 896, 14 / 2 heads, vocab 151,936, bf16, batch 4 × 1024 tokens,
AdamW), mamba2-2.7b (d_model 2560, 80 SSD heads of 64, state 128, chunk
128, vocab 50,280, bf16, batch 1 × 2048 tokens, AdamW; the study at 4 of
its 64 layers with its checkpoints on the disk tier), qwen2-moe-a2.7b
(d_model 2048, 60 experts top-4 and 4 shared, bf16; served at 2 layers,
its study at 1), recurrentgemma-2b (d_model 2560, RG-LRU width 2560, 10 /
1 heads of 256, window 2048, vocab 256,000, bf16, batch 1 × 4096 tokens;
studied and served at 5 of its 26 layers), hubert-xlarge (48 layers,
audio frames) and qwen2-vl-7b (patches and text, M-RoPE; 2 of its 28
layers), random weights from a seed, and holds every kernel of
those paths against its plain PyTorch version on the card; the
launcher's rank step (what each ``torchrun`` rank runs) with the kernels
on its local heads, on a one-rank NCCL group, and the kernel bindings on
two head shards against the whole call; then the dry
run: every architecture's reduced step on the card, and qwen2-0.5b's
production cases over fake tensors on a fake 256-rank mesh.  Needs one CUDA device and
no network; fails (non-zero exit, no result line) without a GPU or outside
a checkout of the repository.
Imports nothing of JAX and nothing of the JAX package.  Each phase is a
function, so the device tensors it made are freed when it returns.
The checkpoint store's serialized tiers live in a directory outside the
checkout (``store_dir``: the first of ``$TMPDIR``, ``$TEMP``, ``$TMP``,
``/tmp``, ``/var/tmp``, ``/usr/tmp``, ``/dev/shm`` with room for the
mamba2 studies' blobs, a memory-backed one with host memory for the blobs
held at once before any disk; its path, file system, free bytes and the
host's memory are printed; none with room is a failure, never the memory
tier), removed when the script ends.
Phases, each printing one JSON line:

1. ``device``   — the card, as ``nvidia-smi`` names it, with its power limit;
   the CUDA kernels' ``nvcc`` build starts here, in the background.
2. ``kernels``  — B1.  The per-leaf Triton kernel of the first port
   (``src/repro_torch/kernels/optim.py``, compiled at first launch):
   sgd / momentum / adam / adamw × M ∈ {1, 4} members with divergent
   hyper-parameters × f32 and bf16 leaves × ResNet56 leaf shapes and a
   ragged one against the plain version (f32: atol 1e-6 + rtol 1e-6, the
   same f32 formulas with other contractions; bf16: one bf16 ulp, f32 math
   rounded once), run twice and required bit-equal.  The tree kernel
   (``csrc/optim.cu``, one launch per tree) bit-equal (``torch.equal``) to
   the per-leaf kernel over the same grid as one-leaf trees and as trees of
   all four shapes, contiguous and with HWIO-strided gradients, and a tree
   of f32 and bf16 leaves; then on ResNet56's tree at its shapes and
   strides (twice each, bit-equal; against the plain version), timed by
   CUDA events and by the profiler beside the per-leaf kernel, the plain
   version, a ``torch._foreach_*`` yardstick (used nowhere in the package)
   and the bytes / 3.35 TB/s bound.
3. ``small``    — ResNet8 on the card: kernel update vs plain update after 6
   steps (atol 1e-4), fused chain vs per-step loop bit for bit.
4. ``study``    — the SHA study of ``examples/torch_hpo_resnet.py`` at full
   width, stage-based and trial-based; launch counts are zeroed just before
   and read just after: one tree-kernel launch per step, no per-leaf
   launch (``main_path``).
5. ``step`` / ``profile`` — where a ResNet56 step's time goes, and the
   device's busy and idle share over one 8-step chunk.
6. ``attention_kernels`` — the flash-attention kernels B2 (forward), B3
   (dq) and B4 (per-query-head dk / dv), built by ``nvcc`` from
   ``src/repro_torch/kernels/csrc/flash_attention.cu``: bf16 on the tensor
   cores (``fa_fwd_tc``, ``fa_bwd_dq_tc``, ``fa_bwd_dkv_tc``), f32 on the
   CUDA cores (``fa_fwd``, ``fa_bwd_dq``, ``fa_bwd_dkv``).  Against their
   plain versions over MHA / GQA 4:1 / MQA / ragged 96 and 160 / head dim
   32, 64, 80, 128, 256 × causal, non-causal, window 48 × f32 and bf16
   (forward f32 2e-5;
   bf16 ``out``, ``dq``, ``dk_h``, ``dv_h`` by ``rounding_rule`` against
   the plain version on the inputs cast to f32 — one bf16 ulp + 2^-16 ×
   scale + what rounding p or dS to bf16 before a product can move, 2^-8
   × (p/l)|v|, |dS||K|, |dS|ᵀ|Q|, pᵀ|dO| —, lse atol 2e-5 + rtol 2e-5;
   gradients also f32 atol 2e-4 + rtol 2e-3, bf16 2e-2), each run twice
   and required bit-equal, executed tiles equal to ``fa_tile_counts`` at
   the tiles of the kernel the dtype routes to (every bf16 case on the
   tensor-core kernels, every f32 one on the others, counted); then at the
   main path's own shape, qwen2-0.5b's (B 4, S 1024, Hq 14, Hkv 2, hd 64,
   causal, bf16), and at qwen3-8b's hd-128 attention (B 1, S 2048, Hq 32,
   Hkv 8, causal): again against the plain versions on the same inputs by
   the same rules, twice bit-equal, tiles counted, and the backward within
   2e-2 of the library's; timed there beside the plain versions, each
   kernel's bound, the backward's bound as a whole, and the library's flash
   forward and flash backward (yardsticks the package never calls), the
   earlier CUDA-core kernels' times beside, marked as figures from the
   record; and at qwen2-moe-a2.7b's MHA hd-128 attention (B 4, S 1024, Hq
   16, Hkv 16, causal) by the same rules, beside SDPA; then (``wide``) at
   recurrentgemma-2b's local attention (B 1, S 4096, Hq 10, Hkv 1, hd 256,
   causal, window 2048), hubert-xlarge's (B 4, S 1024, 16 / 16, hd 80,
   non-causal) and qwen2-vl-7b's (B 2, S 2048, 28 / 4, hd 128, causal) by
   the same rules, beside SDPA (over a boolean mask with a window), their
   bounds 4·B·Hq·hd·(live pairs) operations (backward 2.5×); the line
   carries each kernel's registers and spills from ``ptxas -v``.
   ``lm_small``:
   qwen2-0.5b reduced (f32) on the card, loss and
   gradients through the kernels against the plain attention path (atol
   1e-5 / 1e-4), B2–B4 on the CUDA-core kernels only.
7. ``lm_study`` — the SHA study of ``examples/torch_hpo_lm.py`` at full
   width, stage-based then trial-based (the first run's checkpoints are
   dropped before the second starts); every launch count is zeroed just
   before and read just after: B2 = 24 × (steps + evaluations) = 1,392,
   B3 = B4 = 24 × steps = 1,152, every one on the tensor-core kernels, B1
   = one tree-kernel launch per step, no per-leaf or SSD launch, no
   fallback, fewer
   steps stage-based, the same best trial and every reported metric
   bit-equal across modes.
8. ``lm_update`` / ``lm_step`` / ``lm_profile`` — the AdamW update of the
   whole bf16 tree by the tree kernel against its plain version, bit-equal
   to the per-leaf kernel, timed beside it and a ``torch._fused_adamw_``
   yardstick; where a qwen2-0.5b step's time goes; the device's busy and
   idle share over one 4-step chunk.
9. ``ssd_kernels`` — the SSD kernels B5 (forward) and B6 (backward),
   built by ``nvcc`` from ``src/repro_torch/kernels/csrc/ssd_scan.cu``
   (beside the attention kernels' build), against their plain versions on
   the SSD grid of ``tests/test_kernels.py`` plus a ragged case with the
   model's decays × f32 and bf16 (forward f32 2e-5, bf16 2e-2; gradients
   2e-3, 2e-2 where rounded to bf16), then at the main path's own shape,
   one mamba2-2.7b layer (B 1, nc 16, Q 128, H 80, P 64, N 128): bf16 with
   the model's decays, so that ``cum`` falls to about −1,000 and ``exp``
   above the diagonal would overflow, and bf16 and f32 with the JAX tests'
   small decays, so that the tiles far off the diagonal carry weight (bf16
   outputs within one bf16 ulp beyond 2^-16 of the tensor's largest value,
   f32 outputs within 1e-5 of it); every output finite, each kernel run
   twice and bit-equal; timed beside the plain versions and the bound.  B5
   and B6 in bf16 run on the tensor cores (``ssd_fwd_tc``, ``ssd_bwd_tc``,
   counted in ``launches_tc``: every bf16 case) and are also held against,
   and timed (by CUDA events and by device time) beside, the CUDA-core
   kernels they replace (``ssd_fwd``, ``ssd_bwd``, which f32 keeps),
   within the grid's 2e-2; B6's head-sum scratch's bytes are printed.
   ``mamba2_small``: mamba2-2.7b reduced (f32), loss and gradients through
   the kernels against the plain SSD path (atol 1e-5 / 1e-4), B5 and B6 on
   the CUDA-core kernels only.
10. ``mamba2_study`` — the SHA study of ``examples/torch_hpo_lm.py`` with
   mamba2-2.7b at full width and ``MAMBA_STUDY["layers"]`` (4) of its 64
   layers, stage-based then trial-based, each on a directory store
   (1.7 GB a checkpoint: the
   card holds the running state only; the first run's checkpoints are
   dropped before the second starts); every launch count is zeroed just
   before and read just after: B5 = L × (steps + evaluations), B6 = L ×
   steps (every one of both on the tensor cores), B1 = one tree-kernel
   launch per step, no attention launch, no fallback, fewer steps
   stage-based, the same best trial and every reported metric bit-equal
   across modes; per mode the checkpoint plane's saves, bytes written,
   full and delta commits, dedup ratio, save / load / flush seconds, the
   most bytes on disk, the peak device memory (below the card's) and the
   wall seconds; the newest held checkpoint read back, uploaded, finite,
   its digests the header's.
11. ``mamba2_step`` / ``mamba2_profile`` — the study's model (its
   trainer, its parameters drawn once): step
   time, tokens/s, the share of B5 + B6 in a step, the AdamW update alone,
   peak memory; the device's busy and idle share over one 2-step chunk and
   its top device time by kernel name.  ``mamba2_update``: B1 on its
   tree (bf16 and f32 leaves, one launch) bit-equal to the
   per-leaf kernel, timed beside it, its bound and ``torch._fused_adamw_``.
12. ``fold`` (run after ``ssd_kernels``) — B7, the member-folding rules
   of ``src/repro_torch/kernels/ops.py``: B2–B6 in bf16 at the main
   paths' shapes with 2 members (qwen2-0.5b's attention B 4 → 8,
   mamba2-2.7b's SSD B 1 → 2) through the raw launchers' vmap rules: one
   launch per kernel per group call, bit-equal (``torch.equal``) to one
   launch per member, and held to the plain version by each kernel's
   main-shape rule; ``vmap(grad)`` through ``ops.flash_attention`` with
   one KV for both members: one note, one launch each of B2–B4, each
   member's gradients bit-equal to its solo ones.
13. ``resnet_group_study`` — ResNet56's SHA study over
   ``examples/torch_hpo_resnet.py::group_space`` (2 workers), stage-based,
   without and with ``batch_siblings`` in one call: ≥ 1 batched group,
   the same ``steps_run`` and best trial, B1 launches = steps − Σ (members
   − 1) × group steps (the groups the dispatcher handed the trainer, held
   to ``EngineStats.batched_groups`` / ``batched_stages``), no fallback,
   no functorch fallback warning (a hidden per-member loop); every
   reported metric bit-equal or within 5e-3 (the largest difference
   printed); wall seconds and peak memory of both.
14. ``lm_group_study`` — the same for qwen2-0.5b over
   ``examples/torch_hpo_lm.py::group_space`` (1 worker): B2 = 24 × (launch
   steps + evaluations), B3 = B4 = 24 × launch steps, all on the tensor
   cores; metrics bit-equal or within 2e-2.
15. ``group_step`` — one member-stacked chunk (the vectorised tier) against
   solo chunks at ``GROUP_STEP``'s depths (cut for the script's budget):
   ResNet20 (``ResNet(n=3, width=16)``, batch 128) and qwen2-0.5b
   at full width and 12 layers at M = 2 and 4, mamba2-2.7b at full width
   and 2 layers at M = 2 (B5 and B6 folded); per member-step the
   host-clock ms, device busy ms, idle share and CUDA launches, the peak
   memory, and a group chunk's launches held exact (each kernel once a
   step whatever M).
16. ``ckpt_plane`` (run after ``step``) — the serialized tiers from device
   tensors: a full commit of a ResNet56-shaped f32 tree with a bf16 copy
   and the state's scalars, a delta child with one leaf changed (one delta
   commit, reference chunks), a chain that reaches ``max_delta_depth`` 2
   and rebases; every leaf read back and uploaded ``torch.equal`` to its
   original, the chunk digests of the read-back bytes the header's; then
   on a 1 GiB tree the device-to-host rate of ``put_async``'s pinned copy,
   host-to-device from it and from a blob read back, and seconds per GB
   committed, inline and with ``serializer_procs`` threads.
17. ``resnet_tiered_study`` — phase 4's study, both modes, on
   ``CheckpointStore(dir, remote=DirectoryObjectStore(dir2),
   disk_capacity_bytes=`` two states ``)``: demotions and promotions > 0,
   ``steps_run``, the best trial and every reported metric bit-equal to
   phase 4's memory-tier runs, B1 = steps; wall seconds beside phase 4's.
18. ``mamba2_group_study`` (last) — mamba2-2.7b at full width over
   ``examples/torch_hpo_lm.py::group_space`` at ``MAMBA_GROUP_LAYERS``
   layers, stage-based, with and without ``batch_siblings``, each on a
   directory store: solo's ``steps_run`` and best trial, metrics within
   2e-2, B5 = L × (launch steps + evaluations), B6 = L × launch steps (one
   launch per group call), all on the tensor cores; each store's numbers.
19. ``fault_plane`` (run after ``resnet_tiered_study``) — phase 4's
   study on one worker, fault-free and under a seeded ``FaultInjector``
   (stage faults, worker crashes, store outages; ``FAULT_SEED``,
   ``FAULT_RATES``): faults fired and retried, every checkpoint the store
   holds at the end bit-equal to the fault-free run's (byte views), every
   reported metric bit-equal, the same best trial; B1 = the training
   steps the device computed (a failed attempt's too), no per-leaf launch,
   no fallback; the faults by kind, quarantines, verified re-puts, useful
   and wasted GPU seconds.
20. ``session`` — the same study on one worker on a directory store and
   on the memory tier: stepped until SHA's first rung is decided,
   ``svc.snapshot(path)`` (the directory copied right after), closed (the
   uninterrupted run), then ``StudyService.restore`` against a new trainer
   and store in a fresh process (``chip_smoke.py --session-child``): the
   count fields, every held checkpoint (the memory tier: blake2b of byte
   views; the directory: the same cids and chunk digests), every metric
   and the best trial equal to the uninterrupted run's; B1 before the
   snapshot + after the restore = the uninterrupted run's.  The
   memory-tier snapshot decodes in a process with ``CUDA_VISIBLE_DEVICES``
   empty; the directory run's ``enable_auto_snapshot(keep=2)`` rotates
   and ``restore_latest`` reads the newest slot.
21. ``lm_group_degraded`` (run after ``lm_group_study``) — qwen2-0.5b's
   group study with its first group attempt failed (a transient fault),
   so the group runs as solo members: on the vectorised tier against
   ``lm_group_study``'s grouped run (one degraded group, the same
   ``steps_run``, the largest |Δ| of held checkpoints and metrics printed,
   metrics within 2e-2 by ``group_vs_solo(best_margin=True)``), and on
   the looped tier against its own fault-free run, checkpoints and
   metrics bit-equal; B1–B4 launches exact, B2–B4 on the tensor cores.
22. ``gateway`` (run after ``session``) — the front door: two tenants'
   ResNet56 studies on one plan key through ``StudyGateway`` (one slot,
   quotas alice 2.0 / bob 1.0, a memory-tier store per key): alice's
   six-schedule SHA study and bob's SHA study over the first three of
   those schedules, merged in one forest.  Against the same two
   submissions through ``StudyService(n_workers=1)`` directly: the count
   fields, every held checkpoint (blake2b of byte views), every metric and
   each study's best trial equal; the tenant ledger equal to each
   tenant's ``by_study`` shares, the tenants' total the session's; B1 =
   the device's steps, no per-leaf launch, no fallback.  A gateway
   envelope snapshotted when alice's first rung is decided is restored in
   a fresh process (``chip_smoke.py --gateway-child``) with
   ``StudyGateway.restore`` on a new trainer and store: its record equal
   to the uninterrupted gateway run's, B1 before + after = uninterrupted;
   ``StudyService.restore`` refuses the envelope.  Each study alone too:
   the merged run's steps beside the sum of the two.
   Then ``serve_studies --workers 1`` (``main(argv, backend=...)``)
   serving one ResNet56 study over a thread slot and over a one-device
   mesh slot (``--devices-per-worker 1``): the count fields equal, B1 =
   the device's steps in both (``gateway_serve_studies``).
24. ``mesh_plane`` (run after ``gateway``) — phase 4's study on one
   worker at ResNet20's depth (``MESH_RESNET``, cut for the script's
   budget), a thread fleet against a one-device mesh fleet
   (``worker_meshes=[WorkerMesh.build([0])]``), on the memory tier and on
   a directory store, then over ``group_space`` with ``batch_siblings``
   (the vectorised tier) on the memory tier: each pair's count fields
   (``ckpt_loads`` included), held checkpoints, metrics, best trial and B1
   launches equal (B1 = the device's steps solo); resumes served device
   to device on the mesh fleet (``d2d_handoffs`` > 0), the store's reads
   fewer by exactly the handoffs; the d2d cache's peak device bytes.
   First, an engine over the same CUDA trainer with a mesh wider than
   the visible cards (``WorkerMesh.build([0, 1, 2, 3])`` on one card) is
   refused when it is built, before any work, with the visible-device
   ``ValueError`` (no fallback to the card it has); the row prints the
   visible device count and ``nvidia-smi``'s name and power limit.
25. ``launch_train`` (run after ``lm_study``) —
   ``repro_torch.launch.train.main`` for qwen2-0.5b at full width, batch
   4 × 1024: ``LAUNCH_STEPS`` (20) steps with the kernels, B1 = 20, B2 =
   B3 = B4 = 480, all on the tensor cores, no fallback; its first 3 steps
   again on the plain versions, each loss within ``LAUNCH_LOSS_RTOL``
   (2^-8, one bf16 rounding) of the plain one; s/step and tokens/s.
36. ``local_heads`` (run after ``launch_train``) — the kernel bindings on
   two head shards, as two model ranks hold them (``ops.attention_plan``
   / ``ops.ssd_plan``), reassembled (heads concatenated; case 2's dk /
   dv and B6's dB / dC summed) against the whole-tensor call on the same
   inputs: qwen2-0.5b's attention (B 4, S 1024, 14 / 2, hd 64, causal:
   each shard whole kv groups, plan case 1), recurrentgemma-2b's (B 1, S
   4096, 10 / 1, hd 256, window 2048: inside one kv group, case 2) and
   mamba2-2.7b's SSD (H 80, x / dt / decays split, B and C whole), bf16
   (the tensor cores, asserted by the ``launches_tc`` deltas) and f32;
   bf16 by ``rounding_rule`` against the whole call (env = Σ |partial
   sums| where a head sum is split, else 0), f32 within 1e-5 × scale;
   prints whether each output came out bit-equal.
37. ``launch_ranks`` — in a child process (``--launch-ranks-child``: a
   one-rank NCCL process group), ``launch.train._train_ranks`` (what each
   ``torchrun`` rank runs) with ``--use-kernel`` on a (1, 1)
   ``DeviceMesh``: qwen2-0.5b at full width, 4 × 1024, ``LAUNCH_STEPS``
   steps (B2 = B3 = B4 = 24 a step on the tensor cores) and mamba2-2.7b
   at full width and ``RANKS_MAMBA["layers"]`` (4) of 64 layers, 1 ×
   2048 (B5 = B6 = 4 a step), the plain update (B1 0, as the JAX
   launcher's step), no fallback, no head gathered; each loss within
   ``LAUNCH_LOSS_RTOL`` of the one-process launcher's kernels from the
   same seed (qwen2's: ``launch_train``'s run; mamba2's: the child's).
26. ``group_retry`` (run after ``lm_group_degraded``) — a retry that
   crosses the group tiers on qwen2-0.5b, vectorised: a member of a
   depth-2 group chain fails its second boundary's put after its first
   committed and is retried solo; the run finishes with the bitwise retry
   check unchanged (the committed boundary was taken back), the other
   members' metrics bit-equal to the fault-free run's, the retried one's
   within 2e-2; B1–B4 launches exact.
27. ``serve`` (last but two) — decode through
   ``repro_torch.train.step.build_serve_step``: qwen2-0.5b at full width
   and ``SERVE["layers"]`` (6) of its 24 layers, bf16, random weights
   from a seed: batch 8, a 256-token prompt
   fed token by token, then 64 greedy tokens, the position a 0-d device
   tensor and CUDA's sync debug mode set to raise (no step reads the card
   back); every step's logits held against the port's forward over the
   same 320 tokens on B2, per row within 4 × the row's largest |bf16
   forward − f32 forward| (the plain path on the same weights in f32),
   greedy tokens equal to the forward's arg-max wherever its top-1 /
   top-2 margin passes twice that bound; again with ``sliding_window=128``
   (the ring buffer wraps); B2 = one per layer per forward, nothing else
   launched.
   Then the ``decode_32k`` shape at its full size, all 24 layers (batch
   128, 32,768 slots as ``init_cache`` makes them, the position from
   32,767 on): 20 steps,
   ms / step and tokens/s beside the bytes bound (the KV cache and the
   parameters read once at 3.35 TB/s), launches per token and the idle
   share (profiler), peak memory and one step's transient memory (whether
   the attention einsum copies a layer's K and V).
28. ``mamba2_serve`` — the same for mamba2-2.7b at full width and
   ``MAMBA_SERVE["layers"]`` (8) of its 64 layers: batch 8, 128 prompt
   tokens and 32 new ones against the B5 forward (padded to whole
   chunks), B5 = 16; ``decode_32k``'s batch of 128 against its bound (the
   SSD state read and written, the parameters read).
29. ``moe`` (last) — qwen2-moe-a2.7b at full width (d_model 2048, 60
   experts top-4, 4 shared, 16 / 16 heads of 128): served at
   ``MOE_SERVE["layers"]`` (2) layers drop-free (``capacity_factor=16``)
   in f32 (bf16 routing flips between decode and forward) against the B2
   forward on its f32 route within 5e-3 (B2 = 4); then ``lm_study`` on it at
   ``MOE_STUDY["layers"]`` (1) layer, batch 4 × 1024 (``moe_study``: the
   same best trial, every metric bit-equal, B1 = steps, B2 = layers ×
   (steps + evaluations), B3 = B4 = layers × steps, on the tensor cores);
   an evaluation's loss equal to ``LM.loss`` on the same batch and to
   ``nll + router_aux_weight · moe_aux / layers`` (f32), ``moe_aux`` > 0.
30. ``rglru_study`` — the SHA study of ``examples/torch_hpo_lm.py`` with
   recurrentgemma-2b at full width and ``RGLRU_STUDY["layers"]`` (5) of
   its 26 layers — one (RG-LRU, RG-LRU, local) cycle and the two trailing
   RG-LRU layers, 1,043,422,720 parameters — batch 1 × 4096 (``lm_study``:
   fewer steps stage-based, the same best trial, every metric bit-equal,
   B1 = steps, B2 = 1 × (steps + evaluations), B3 = B4 = steps on the
   tensor cores at head dim 256); ``rglru_scan``: the log-depth RG-LRU
   scan alone at one layer's (1, 4096, 2560), forward and backward.
31. ``rglru_serve`` — decode with the study's model: batch 8, 256 prompt
   tokens fed one by one and 64 greedy ones (``serve_pass``: every step
   within 4 × the bf16 forward's distance from an f32 forward, on the B2
   forward), ms a step, CUDA launches a token, peak memory.
32. ``frontends`` — ``train/step.py``'s train step: hubert-xlarge at all
   48 layers (features (4, 1024, 512) bf16, labels in [0, 504); B2–B4 48
   a step at head dim 80) and qwen2-vl-7b at 2 of its 28 layers (1,024
   patches (2, 1024, 1280) and 1,024 text tokens, M-RoPE ids on a 32 × 32
   grid), ``FRONTEND_STEPS`` steps with the kernels and the first 3 again
   on the plain versions, each loss within 2^-8 of the plain one; s/step,
   tokens/s, peak memory.
34. ``dryrun`` (last) — ``repro_torch.launch.dryrun``: every
   architecture's reduced variant (f32, 4 × 64 tokens) × every shape for
   real on the card, 38 cases (hubert-xlarge's two decode shapes skipped
   by design): the kernels' step against the plain step on the same
   parameters (the train loss within 1e-5, every gradient within 1e-4,
   prefill / decode logits within 1e-4), each kernel launched exactly
   where the step runs it (B1 on every train case; B2 on the train and
   prefill cases of a model with attention, local too, B3–B4 on its train
   cases; B5 on mamba2's train and prefill cases, B6 on its train case; a
   decode step none), a train step's B1 update (new parameters and AdamW
   moments) within 1e-4 of the plain update on the same gradients, the
   card's memory and the plain step's flops per case; and, from a child
   process started with this phase (``chip_smoke.py --dryrun-child``: it
   needs no card, runs beside the reduced cases and after every timed
   phase, and keeps its fake 256-rank process group out of this
   process), qwen2-0.5b's production single-pod cases ``decode_32k``,
   ``prefill_32k`` and ``train_4k`` over fake tensors, per-device memory
   against the card's, collectives, roofline terms (H100 data-sheet
   peaks).
35. last lines  — the script's run time and each phase's seconds, the card
   and its power limit, the
   ``kernels`` line (B1's tree kernel, B2–B6, and B2–B4's rows at head
   dims 256 (recurrentgemma-2b's shape and study) and 80 (hubert-xlarge's
   shape and train steps); with the grouped runs',
   the fault plane's, the sessions', the gateway's, the mesh plane's,
   the launcher's (one process and, ``launches_launch_ranks``, a rank),
   the retry's, the degraded runs', the serve phases',
   the MoE study's, the RG-LRU study's, the frontends' and the dry run's
   launches and the fold's checks) and ``{"ok": true, "device": {...}}``.

The solo studies of phases 4, 7, 10, 17, 19, 20, 22 and 24 pass
``batch_siblings=False``: their launch counts are those of PRs 11–17.

Any failed check raises; nothing is caught and passed over.  The script
sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` unless the caller
set it (fragments left by the 64 GiB phases can otherwise keep the qwen2 M
4 chunk from its largest block).
"""

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
KERNEL_SOURCE = "src/repro_torch/kernels/optim.py"     # the per-leaf kernel
B1_SOURCE = "src/repro_torch/kernels/csrc/optim.cu"    # the tree kernel
KERNEL_REPLACES = "src/repro/kernels/optim.py:130"
CUDA_SOURCES = ("flash_attention", "ssd_scan", "optim")
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = {"B2": "src/repro/kernels/flash_attention.py:202",
               "B3": "src/repro/kernels/flash_attention.py:386",
               "B4": "src/repro/kernels/flash_attention.py:406"}
# the attention grid of tests/test_kernels.py: (B, S, Hq, Hkv, hd)
FA_SHAPES = [(1, 128, 4, 4, 64), (2, 128, 8, 2, 64), (1, 256, 8, 1, 32),
             (1, 96, 4, 2, 64), (2, 64, 2, 1, 128),
             # hubert-xlarge's head dim (MHA) and recurrentgemma-2b's (MQA),
             # on a ragged length
             (2, 160, 4, 4, 80), (1, 160, 4, 1, 256)]
FA_MASKS = [(True, 0), (False, 0), (True, 48)]
QWEN = dict(B=4, S=1024, Hq=14, Hkv=2, hd=64)     # qwen2-0.5b's attention
QWEN3 = dict(B=1, S=2048, Hq=32, Hkv=8, hd=128)   # qwen3-8b's, at hd 128
QWEN_MOE = dict(B=4, S=1024, Hq=16, Hkv=16, hd=128)  # qwen2-moe's: MHA, hd 128
# the attention of the slices that run at head dims 256 and 80, and
# qwen2-vl-7b's over 1,024 patches + 1,024 text tokens, at their training
# shapes (bf16)
WIDE_ATTENTION = {
    "recurrentgemma-2b": dict(B=1, S=4096, Hq=10, Hkv=1, hd=256, causal=True,
                              window=2048),
    "hubert-xlarge": dict(B=4, S=1024, Hq=16, Hkv=16, hd=80, causal=False,
                          window=0),
    "qwen2-vl-7b": dict(B=2, S=2048, Hq=28, Hkv=4, hd=128, causal=True,
                        window=0)}
# B2 at qwen2-0.5b's shape before the tensor-core kernel: the CUDA-core
# kernel's bf16 instantiation, median of four runs on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md, kernel table).  A figure from the record,
# printed as such in the attention_kernels line and never in the kernels
# line; it cannot be measured here, since that instantiation is gone.
B2_CUDA_CORE_MS = 0.615
# B3 and B4 at the same shape before the tensor-core kernels: the CUDA-core
# kernels' bf16 instantiations, medians of five runs on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md, kernel table); figures from the record, printed
# as such, as B2's above.
B3_CUDA_CORE_MS = 0.746
B4_CUDA_CORE_MS = 0.971
LM_FULL = dict(batch=4, seq_len=1024, n_train=256, n_eval=8)
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = {"B5": "src/repro/kernels/ssd_scan.py:87",
                "B6": "src/repro/kernels/ssd_scan.py:189"}
# the SSD grid of tests/test_kernels.py: (B, nc, Q, H, P, N)
SSD_SHAPES = [(1, 2, 16, 2, 16, 16), (2, 3, 32, 4, 16, 24),
              (1, 1, 64, 1, 32, 32), (1, 4, 8, 8, 8, 8)]
SSD_RAGGED = (1, 2, 96, 2, 40, 20)     # ragged tiles, the model's decays
MAMBA = dict(B=1, nc=16, Q=128, H=80, P=64, N=128)   # mamba2-2.7b's SSD
# the study's depth: all 64 layers fit (63.8 GiB) but their 16.2 GB
# checkpoints make the study writer-bound (391 s of a 939 s run), so it is
# cut for the run's time; at 16 layers it took 104.6 s of a 751.4 s run
# (the serve and MoE phases added 108.6 s), so 8; at 8, 67.8 s of a 976.6
# s run on a slow host (the RG-LRU and frontend phases added 79.2 s), so
# 4; tools/step_compare.py times the 64-layer step
MAMBA_STUDY = dict(batch=1, seq_len=2048, n_train=64, n_eval=2, layers=4)
# the SHA study of examples/torch_hpo_lm.py on the reduced model on the
# CPU: 3 + 7 commits (stage- and trial-based), and at most 4 blobs on the
# directory at once (the four trials' first rung), the one being written
# included
STUDY_COMMITS = 10
STUDY_BLOBS_HELD = 4
# mamba2_group_study's commits, solo and grouped (4 + 4, PR 19's runs)
GROUP_STUDY_COMMITS = 8
# the group study's depth: 32 layers fit (a 2-member step 43.1 GiB,
# tools/group_probe.py memory mamba2-2.7b 32; the grouped study 51.0 GiB)
# but took 145 s of a 1,004 s run (16 layers 83 s of 939 s), so it is
# cut for the run's time; 8 layers took 98.4 s of a 976.6 s run, so 4;
# at 4, 36.2 s of an 822.1 s run that launch_ranks had grown, so 2
MAMBA_GROUP_LAYERS = 2
RESNET_FULL = dict(n=9, width=16, n_train=8192, n_eval=512, batch=128)
# mesh_plane's six studies at ResNet20's depth: at ResNet56 they took
# 48.8 s of that 822.1 s run (the fleets' bit-equality does not hang on it)
MESH_RESNET = dict(RESNET_FULL, n=3)
RESNET_LEAVES = 114

SHAPES = [(3, 3, 64, 64), (64,), (64, 10), (3, 3, 5, 7)]   # last one ragged
HPS = {"lr": 0.05, "wd": 0.01, "mom": 0.9, "b1": 0.9, "b2": 0.999,
       "eps": 1e-8}
ADAM_HPS = dict(HPS, lr=1e-3)
FOLD_M = 2                          # members of the fold phase's groups
GROUP_MS = (2, 4)                   # group sizes of group_step
QWEN_GROUP_MS = (2, 4)
# group_step's depths: ResNet20 and qwen2-0.5b at 12 of 24 layers (the
# studies keep ResNet56 and 24), mamba2-2.7b at 2 of 64; at ResNet56, 24
# and 4 the phase took 96.4 s of an 822.1 s run that launch_ranks had
# grown by 79.3 s (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 4)
GROUP_STEP = {"resnet_n": 3, "qwen2_layers": 12, "mamba2_layers": 2}
# the serve phases: batch, prompt tokens fed token by token, new greedy
# tokens; qwen2-0.5b's second pass with a 128-slot ring buffer; its
# token-by-token passes at 6 of its 24 layers (cut for the script's
# budget: 24, then 12, then 6 when launch_ranks came), decode_32k at all 24
SERVE = dict(batch=8, prompt=256, new=64, window=128, layers=6)
# mamba2-2.7b served at the studies' depth: a 64-layer host draw (2.7 B
# parameters) would take about half the three new phases' budget
MAMBA_SERVE = dict(batch=8, prompt=128, new=32, layers=8)
# qwen2-moe served in f32 at 2 layers: its 4-layer host draw (2.9 B f32
# parameters) took 25-31 s, and the script's budget needs it (PR 24)
MOE_SERVE = dict(batch=4, prompt=64, new=32, layers=2)
# the MoE study's depth: one layer's held states fit the card beside its
# step (a state is 6 bytes a parameter: bf16 weights and AdamW slots)
MOE_STUDY = dict(batch=4, seq_len=1024, n_train=256, n_eval=8, layers=1)
DECODE_32K_STEPS = 20
F32_DECODE_TOL = 5e-3      # tests/test_models.py::test_decode_matches_forward
# recurrentgemma-2b's study at full width and 5 of its 26 layers: one
# (RG-LRU, RG-LRU, local) cycle and the two trailing RG-LRU layers, 1.04 B
# parameters (6.3 GB a state), cut for the host's draw time and the
# script's budget; batch 1 x 4096 tokens (train_4k's length: the 2,048
# window bites)
RGLRU_STUDY = dict(batch=1, seq_len=4096, n_train=64, n_eval=1, layers=5)
RGLRU_SERVE = dict(batch=8, prompt=256, new=64)
# the frontends' train steps: hubert-xlarge at all 48 layers, qwen2-vl-7b
# at 2 of its 28 (1.56 B parameters, 0.55 B of them its untied head)
FRONTEND_STEPS, FRONTEND_PLAIN_STEPS = 4, 3
HUBERT_TRAIN = dict(batch=4, frames=1024)
QWEN_VL_TRAIN = dict(batch=2, patches=1024, text=1024, layers=2)


def emit(obj):
    print(json.dumps(obj), flush=True)


def free():
    """Give back to the card what the phase that returned left behind, and
    to the host the pinned buffers of the store's host copies."""
    gc.collect()
    torch.cuda.empty_cache()
    (getattr(torch.accelerator, "empty_host_cache", None)
     or torch._C._host_emptyCache)()


def time_ms(fn, reps=30, warm=5, windows=3):
    """Milliseconds of ``fn`` on CUDA events: the mean over ``reps``
    back-to-back calls, the median of ``windows`` such windows (one stall
    of the host — a collection, a page fault — in one window then moves
    nothing)."""
    for _ in range(warm):
        fn()
    got = []
    for _ in range(windows):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        got.append(e0.elapsed_time(e1) / reps)
    return sorted(got)[len(got) // 2]


def device_ms(fn, reps=20, expect=None):
    """Device time of the CUDA kernels one call of ``fn`` launches, from
    the profiler's trace: unlike ``time_ms`` it leaves out the host's time
    between launches, which a kernel of tens of microseconds can wait on.
    ``expect``: a kernel name fragment that one call launches once; the
    trace is then divided by the calls it holds of that kernel (the
    profiler has been seen to drop whole calls' records of a long run), and
    none is "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in rows)
    if expect is not None:
        reps = sum(e.count for e in rows if expect in e.key)
    elif rows:
        # whole calls' records dropped (seen late in a long run, where one
        # call of twenty was kept): a kernel that each call launches once
        # counts the calls the trace holds
        reps = min(reps, min(e.count for e in rows))
    return us / 1e3 / reps if us > 0 and reps > 0 else "not measured"


def launch_us(fn, reps=200):
    """Host microseconds per call of ``fn`` while the device keeps up: the
    calls are not synchronised, so this is the wrapper's own time (checks,
    allocation, the launch) that a kernel can wait on between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def host_ms(fn, reps):
    """Mean milliseconds of ``fn`` on the host clock, synchronised at both
    ends, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def bf16_ulps(a, c, slack=1e-6):
    """|a - c| in bf16 ulps at the larger magnitude, beyond an f32 slack
    (a sum that cancels can land on either side of 0)."""
    af, cf = a.float(), c.float()
    diff = (af - cf).abs()
    _, exp = torch.frexp(torch.maximum(af.abs(), cf.abs()))
    ulp = torch.ldexp(torch.ones_like(cf), exp - 8)
    return (diff - slack).clamp(min=0) / ulp


def within(a, b, atol, rtol):
    """(max |a - b|, whether every element is within atol + rtol |b|)."""
    a, b = a.float(), b.float()
    assert bool(a.isfinite().all()) and bool(b.isfinite().all())
    return float((a - b).abs().max()), bool(
        ((a - b).abs() <= atol + rtol * b.abs()).all())


def at_scale(a, b, f32_rule):
    """One output of a kernel against its plain version on the same inputs
    at the main path's shape: a bf16 output within one bf16 ulp of the
    value beyond an f32 slack of 2^-16 of the tensor's largest value (both
    sides do f32 math and round once; the sums only run in another order);
    an f32 output by ``f32_rule`` = (its text, ok(diff, b, scale)).
    Returns (the row to print, whether it holds)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    assert bool(a.isfinite().all()) and bool(b.isfinite().all())
    diff = (a.float() - b.float()).abs()
    scale = float(b.float().abs().max())
    assert scale > 0
    row = {"max_abs_err": float(diff.max()), "scale": scale,
           "err_over_scale": float(diff.max()) / scale}
    if a.dtype == torch.float32:
        row["tolerance"], ok_fn = f32_rule
        return row, ok_fn(diff, b, scale)
    ulps = float(bf16_ulps(a, b, slack=scale * 2 ** -16).max())
    row.update(max_err_bf16_in_ulps=ulps,
               tolerance="1 bf16 ulp beyond 2^-16 x scale")
    return row, ulps <= 1.0


def rounding_rule(a, ref, env, reference, env_text):
    """A bf16 output of a tensor-core kernel against its plain version on
    the inputs cast to f32 (``ref``, f32).  The kernel rounds an
    intermediate to bf16 before a product: B2 every probability before
    p·v (``env = (p/l)·|v|``), B3 / B4 dS before dS·K and dSᵀ·Q (``env``
    = |dS|·|K|, |dS|ᵀ·|Q|) and p before pᵀ·dO (``env = pᵀ·|dO|``), as the
    library's kernels do.  Each rounded value moves by at most half a bf16
    ulp, 2^-8 of itself, so an output moves by at most 2^-8 · ``env``, the
    same product on absolute values, in f32.  Allowed per element: that,
    plus one bf16 ulp of the value (the output's own rounding) and 2^-16
    of the tensor's largest value (f32 sums in another order).  The
    reference is the unrounded one, not a plain version that rounds too,
    because the two would round on different grids: their f32
    intermediates differ in the last bits (sums in other orders; exp2 of
    log2-scaled scores), and, in a row that spans more than one key tile,
    B2 rounds p against the running max and then rescales its accumulator
    by a factor that is not a power of 2, so most of that row's
    probabilities round to another neighbour.
    Returns (the row to print, whether it holds)."""
    assert a.shape == ref.shape == env.shape
    assert a.dtype == torch.bfloat16 and ref.dtype == torch.float32
    assert bool(a.isfinite().all()) and bool(ref.isfinite().all())
    diff = (a.float() - ref).abs()
    scale = float(ref.abs().max())
    _, exp = torch.frexp(torch.maximum(a.float().abs(), ref.abs()))
    ulp = torch.ldexp(torch.ones_like(diff), exp - 8)
    ratio = float((diff / (scale * 2 ** -16 + ulp + 2 ** -8 * env)).max())
    return ({"max_abs_err": float(diff.max()), "scale": scale,
             "err_over_scale": float(diff.max()) / scale,
             "max_err_over_allowed": ratio, "reference": reference,
             "tolerance": f"1 bf16 ulp + 2^-16 x scale + 2^-8 x {env_text}"},
            ratio <= 1.0)


def p_rounding_rule(a, ref, env):
    """B2's bf16 ``out`` by :func:`rounding_rule` against ``fwd_plain``
    with f32 probabilities, ``env = (p/l)·|v|``."""
    return rounding_rule(a, ref, env,
                         "fwd_plain on the inputs cast to f32 (f32 p)",
                         "(p/l)|v|")


def ds_rounding_rule(fa, q, k, v, do, lse, delta, got, mk):
    """B3's dq and B4's dk_h, dv_h (``got``, bf16) by :func:`rounding_rule`
    against the plain backward on the inputs cast to f32 (f32 p and dS),
    with ``env`` = |dS|·|K|, |dS|ᵀ·|Q| and pᵀ·|dO|.  Returns {name: row}
    and whether all three hold."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p, ds = fa._probs_and_ds(qf, kf, vf, lse, delta, dof, mk["causal"],
                             mk["window"])
    group = q.shape[2] // k.shape[2]
    kh, qh, doh = fa._heads(kf, group), fa._heads(qf), fa._heads(dof)
    del qf, kf, vf, dof
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    parts = {"dq": (lambda: ds @ kh, lambda: ds.abs() @ kh.abs(),
                    "|dS||K|"),
             "dk_h": (lambda: dst @ qh, lambda: dst.abs() @ qh.abs(),
                      "|dS|^T|Q|"),
             "dv_h": (lambda: pt @ doh, lambda: pt @ doh.abs(),
                      "P^T|dO|")}
    rows, ok_all = {}, True
    for name, a in zip(("dq", "dk_h", "dv_h"), got):
        ref_fn, env_fn, env_text = parts[name]
        row, ok = rounding_rule(
            a, ref_fn().transpose(1, 2), env_fn().transpose(1, 2),
            "the plain backward on the inputs cast to f32 (f32 p, dS)",
            env_text)
        rows[name], ok_all = row, ok_all and ok
    return rows, ok_all


def device_profile(fn, n_steps, chunk_ms, match=None, top=8):
    """The device's busy and idle share while ``fn`` runs one
    ``n_steps``-step chunk: device time of the CUDA kernels in the
    profiler's trace (the profiler slows the host, not the kernels) against
    ``chunk_ms``, the chunk's wall time measured without it.  ``match``
    picks the package's own kernels out by name.  The device's activity
    only: nothing here reads host events, and recording them slows
    ``key_averages`` several-fold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(((dev_time(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_time(e) > 0),
                  reverse=True)
    seen = lambda x: x if rows else "not measured"
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"window": f"one {n_steps}-step chunk",
           "chunk_ms_without_profiler": chunk_ms,
           "device_busy_ms": seen(busy_ms),
           "device_idle_share": seen(1.0 - busy_ms / chunk_ms),
           "device_kernel_launches_per_step": sum(r[1] for r in rows)
           / n_steps}
    if match is not None:
        mine_ms = sum(r[0] for r in rows if match in r[2]) / 1e3
        out.update(port_kernels=match, port_kernels_device_ms=seen(mine_ms),
                   port_kernels_share_of_busy=seen(mine_ms / max(busy_ms,
                                                                 1e-9)))
    out["top_device_time"] = [{"ms": r[0] / 1e3, "count": r[1],
                               "name": r[2][:80]} for r in rows[:top]]
    return out


def held_checkpoints(store, n_leaves, verify=None):
    """How many checkpoints a finished study's store holds.  Memory tier:
    each one's parameters on the card, finite, ``n_leaves`` leaves.
    Serialized tiers: every blob's header lists as many leaves as the
    others; every blob (or, with ``verify``, the newest ``verify`` full
    ones: a delta is read through its parents, 16 GB each for mamba2) is
    read back, its ``n_leaves`` parameters uploaded to the card and finite,
    and the chunk digests of every leaf's read-back bytes equal to the
    header's."""
    from repro_torch.utils.tree import tree_leaves
    cids = sorted(store.committed_ids(),
                  key=lambda c: int(c.rsplit("@", 1)[1]))
    assert cids
    held = len(cids)
    if store.directory is None:
        for cid in cids:
            leaves = tree_leaves(store.get(cid)["params"])
            assert len(leaves) == n_leaves
            assert all(l.is_cuda and bool(l.isfinite().all())
                       for l in leaves)
        return held
    headers = {cid: blob_header(store, cid) for cid in cids}
    assert len({len(h["leaves"]) for h in headers.values()}) == 1
    if verify:
        fulls = [c for c in cids if headers[c]["kind"] == "full"]
        assert fulls
        cids = fulls[-verify:]
    for cid in cids:
        tree = store.get(cid)
        leaves = [l.to(DEV) for l in tree_leaves(tree["params"])]
        assert len(leaves) == n_leaves
        assert all(bool(l.isfinite().all()) for l in leaves)
        assert digests_equal_header(store, cid, tree)
        del tree, leaves
    return held


def blob_header(store, cid):
    """The header of ``cid``'s blob, wherever its tier keeps it."""
    if cid in store._disk_cids:
        return store._read_header(cid)
    data = store.remote.get(cid)
    return store._parse_header(data)[0]


def digests_equal_header(store, cid, tree):
    """Do the chunk digests of ``tree``'s leaf bytes (a read-back tree)
    equal the ones the header of ``cid``'s blob lists?"""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.train import checkpoint as ck
    from repro_torch.utils.tree import tree_leaves
    hdr = blob_header(store, cid)
    views = [ck._leaf_view(x) for x in tree_leaves(tree)]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        metas = ck._encode_leaves_pooled(
            pool, [v[2] for v in views], [v[0] for v in views],
            [v[1] for v in views], None, hdr["chunk"])[0]
    strip = lambda leaves: [(m["d"], m["s"], m["n"],
                             [c[:2] for c in m["c"]]) for m in leaves]
    return strip(metas) == strip(hdr["leaves"])


def store_root(written, held):
    """Where the serialized tiers of the studies live: the first of the
    temporary-directory candidates (``$TMPDIR``, ``$TEMP``, ``$TMP``,
    ``/tmp``, ``/var/tmp``, ``/usr/tmp``, ``/dev/shm``) outside the
    checkout that is a memory-backed file system with host memory
    available for ``held`` bytes (the blobs held at once and a host copy)
    and room for ``written`` bytes, else the first on a disk with room for
    ``written`` — every byte the studies write, since a thinly provisioned
    disk does not get a deleted blob's blocks back.  A disk comes second:
    the GPU machine's ``/tmp`` writes at ~0.8 GB/s against tmpfs's ~1.3 and
    counts every byte against a per-command limit that its free bytes do
    not show.  Prints the choice; raises where no candidate has room
    (never the memory tier)."""
    mounts = []
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mounts.append((parts[1], parts[2]))
    meminfo = host_memory()
    seen, rows = set(), []
    cands = [os.environ.get(v) for v in ("TMPDIR", "TEMP", "TMP")]
    for d in cands + ["/tmp", "/var/tmp", "/usr/tmp", "/dev/shm"]:
        if not d or not os.path.isdir(d):
            continue
        real = os.path.realpath(d)
        if real in seen or (real + os.sep).startswith(ROOT + os.sep):
            continue
        seen.add(real)
        fs = max((m for m in mounts if (real + "/").startswith(
            m[0].rstrip("/") + "/")), key=lambda m: len(m[0]))[1]
        rows.append({"path": real, "filesystem": fs,
                     "free_bytes": shutil.disk_usage(real).free})
    fits = [r for r in rows if r["free_bytes"] >= written and (
        r["filesystem"] != "tmpfs" or meminfo["MemAvailable"] >= held)]
    fits.sort(key=lambda r: r["filesystem"] != "tmpfs")   # stable
    if not fits:
        raise RuntimeError(f"no directory takes {written} bytes written "
                           f"and {held} held: {rows}, host memory {meminfo}")
    emit({"phase": "store_dir", "path": fits[0]["path"],
          "filesystem": fits[0]["filesystem"],
          "free_bytes": fits[0]["free_bytes"], "written_bytes": written,
          "held_bytes": held, "host_memory_bytes": meminfo["MemTotal"],
          "host_memory_available_bytes": meminfo["MemAvailable"],
          "candidates": rows})
    return fits[0]["path"]


def host_memory():
    """``/proc/meminfo`` in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            out[key] = int(val.split()[0]) * 1024
    return out


@contextlib.contextmanager
def host_memory_peak(rec):
    """The most host memory in use (``MemTotal - MemAvailable``, sampled
    every 0.2 s) while the block runs, into ``rec["host_memory_peak_bytes"]``:
    a directory in tmpfs, pinned host copies and read-back blobs share it."""
    stop = threading.Event()

    def sample():
        while True:
            m = host_memory()
            rec["host_memory_peak_bytes"] = max(
                rec.get("host_memory_peak_bytes", 0),
                m["MemTotal"] - m["MemAvailable"])
            if stop.wait(0.2):
                return
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


def store_record(store):
    """Time ``store.flush`` and track the most bytes its directory held
    after a commit; returns the record the wrappers fill."""
    rec = {"flush_seconds": 0.0, "max_disk_bytes": 0}
    flush, publish = store.flush, store._publish_disk

    def timed_flush():
        t0 = time.perf_counter()
        flush()
        rec["flush_seconds"] += time.perf_counter() - t0

    def tracked_publish(cid, staged):
        publish(cid, staged)
        rec["max_disk_bytes"] = max(rec["max_disk_bytes"], store._disk_bytes)
    store.flush, store._publish_disk = timed_flush, tracked_publish
    return rec


def store_fields(stats, store, rec):
    """The checkpoint plane's numbers of one study on a serialized tier."""
    return {"ckpt_saves": stats.ckpt_saves,
            "ckpt_loads": stats.ckpt_loads,
            "ckpt_bytes_written": stats.ckpt_bytes_written,
            "ckpt_full_commits": store.full_commits,
            "ckpt_delta_commits": stats.ckpt_delta_commits,
            "dedup_ratio": stats.dedup_ratio,
            "ckpt_save_seconds": stats.ckpt_save_seconds,
            "ckpt_load_seconds": stats.ckpt_load_seconds,
            "flush_seconds": rec["flush_seconds"],
            "ckpt_disk_hits": stats.ckpt_disk_hits,
            "ckpt_mem_hits": stats.ckpt_mem_hits,
            "bytes_read": store.bytes_read,
            "max_disk_bytes": rec["max_disk_bytes"],
            "host_memory_peak_bytes": rec.get("host_memory_peak_bytes")}


def start_builds():
    """Build every CUDA source in the background, one ``nvcc`` each, all
    at once; returns ``join(name)`` → the seconds the build of
    ``csrc/<name>.cu`` took, raising its failure."""
    from repro_torch.kernels import _cuda
    builds = {}

    def build(name):
        t0 = time.perf_counter()
        try:
            _cuda.load(name)
        except BaseException as exc:          # re-raised by join()
            builds[name] = exc
            return
        builds[name] = time.perf_counter() - t0

    threads = {name: threading.Thread(target=build, args=(name,))
               for name in CUDA_SOURCES}
    for thread in threads.values():
        thread.start()

    def join(name):
        threads[name].join()
        if isinstance(builds[name], BaseException):
            raise builds[name]
        return builds[name]
    return join


# ------------------------------------------------------------------ 1. device
def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, kind


# ---------------------------------------------- 2. B1 against its plain version
def b1_operands(name, M, shapes, dtypes, seed, strided=False):
    """A tree of ``(M, *shape)`` leaves for optimizer ``name`` on the card
    — p, g (and m, v) — and its per-member ``(M,)`` f32 scalars, divergent
    per member.  ``strided``: every 4-D leaf's gradient an HWIO view of an
    OIHW tensor, as the ResNet's convolution hands it over."""
    from repro_torch.kernels.optim import _SPEC
    rng = np.random.default_rng(seed)
    narr, snames, _ = _SPEC[name]
    trees = [[] for _ in range(narr)]
    for shape, dtype in zip(shapes, dtypes):
        full = (M,) + shape
        vals = [rng.normal(size=full), 0.1 * rng.normal(size=full)]
        vals += [0.01 + 0.01 * rng.uniform(size=full)
                 for _ in range(narr - 2)]
        for i, v in enumerate(vals):
            t = torch.tensor(v, dtype=torch.float32, device=DEV).to(dtype)
            if i == 1 and strided and len(shape) == 4:
                t = t.permute(0, 4, 3, 1, 2).contiguous().permute(
                    0, 3, 4, 2, 1)
                assert not t.is_contiguous()
            trees[i].append(t)
    base = ADAM_HPS if narr == 4 else HPS
    spread = 1.0 + 0.1 * np.arange(M)          # divergent per member
    vals = {k: np.asarray(base[k] * spread, np.float32)
            for k in ("lr", "wd", "mom")}
    # decay rates stay below 1 while still diverging per member
    vals["b1"] = np.asarray(base["b1"] - 0.01 * np.arange(M), np.float32)
    vals["b2"] = np.asarray(base["b2"] - 1e-4 * np.arange(M), np.float32)
    vals["eps"] = np.full(M, base["eps"], np.float32)
    t = np.arange(M, dtype=np.float32) + 1.0
    vals["bc1"] = (1.0 - vals["b1"] ** t).astype(np.float32)
    vals["bc2"] = (1.0 - vals["b2"] ** t).astype(np.float32)
    return trees, [torch.tensor(vals[k], device=DEV) for k in snames]


def b1_tree_vs_leaf(name, trees, scal):
    """The tree kernel twice and the per-leaf Triton kernel (the first
    port's design, strided gradients copied first) on the same operands:
    one launch a call, every output leaf ``torch.equal`` across the three.
    Returns the tree kernel's outputs."""
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    n0 = stacked_tree_update.launches
    got = stacked_tree_update(name, *trees, *scal)
    again = stacked_tree_update(name, *trees, *scal)
    assert stacked_tree_update.launches - n0 == 2, "one launch a tree"
    leaf = [stacked_leaf_update(name, *(t.contiguous() for t in lf), *scal)
            for lf in zip(*trees)]
    torch.cuda.synchronize()
    for o, outs in enumerate(got):
        for i, a in enumerate(outs):
            assert torch.equal(a, again[o][i]), (name, "two runs differ", o,
                                                 i)
            assert torch.equal(a, leaf[i][o]), (
                name, "tree kernel differs from the per-leaf kernel", o, i,
                float((a.float() - leaf[i][o].float()).abs().max()))
    return got


def b1_tree_row(name, params, grads, state, hp, step, n_bytes, library,
                plain=True, reps=30, warm=5, keep=False):
    """The whole tree's update by ``fused_apply_update`` (one launch of the
    tree kernel) twice and by ``leafwise_apply_update`` (the per-leaf
    Triton kernel) twice, all four bit-equal (compared two at a time: a
    64-layer mamba2 tree's outputs are 16 GB); timed by CUDA events and by
    the profiler beside the per-leaf kernel, the plain version (``plain``),
    ``library`` (a yardstick the package never calls) and the bound
    (``n_bytes`` / 3.35 TB/s).  Returns (the row, the tree kernel's
    outputs if ``keep``)."""
    from repro_torch.kernels.optim import (fused_apply_update,
                                           leafwise_apply_update,
                                           stacked_leaf_update,
                                           stacked_tree_update)
    from repro_torch.train.optimizer import apply_update
    from repro_torch.utils.tree import tree_leaves
    args = (name, params, grads, state, hp, step)
    n_leaves = len(tree_leaves(params))
    t0, l0 = stacked_tree_update.launches, stacked_leaf_update.launches
    out = fused_apply_update(*args)
    for fn in (fused_apply_update, leafwise_apply_update,
               leafwise_apply_update):
        other = fn(*args)
        torch.cuda.synchronize()
        for a, b in zip(tree_leaves(out), tree_leaves(other)):
            assert torch.equal(a, b), (name, "tree kernel differs from the "
                                       "per-leaf kernel or from itself")
        del other
    assert stacked_tree_update.launches - t0 == 2, "one launch a step"
    assert stacked_leaf_update.launches - l0 == 2 * n_leaves
    if not keep:
        out = None
    kern = lambda: fused_apply_update(*args)
    ms = time_ms(kern, reps=reps, warm=warm)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    row = {"ms": ms, "device_ms": device_ms(kern, reps=max(reps // 3, 3),
                                            expect="tree_update_kernel"),
           "wrapper_host_us": launch_us(kern, reps=max(reps, 20)),
           "per_leaf_triton_ms": time_ms(lambda: leafwise_apply_update(
               *args), reps=reps, warm=warm),
           "plain_ms": time_ms(lambda: apply_update(*args), reps=reps,
                               warm=warm) if plain else None,
           "library_ms": time_ms(library, reps=reps, warm=warm),
           "bound_ms": bound, "bound_by": "bytes", "bytes": n_bytes,
           "launches_per_call": 1, "leaves": n_leaves,
           "bit_equal_to_per_leaf_kernel_twice": True}
    dev = row["device_ms"]
    row["bound_share_of_device_ms"] = (bound / dev if isinstance(dev, float)
                                       else "not measured")
    row["bound_share_of_ms"] = bound / ms
    return row, out


def b1_phase(join_build):
    """B1: the per-leaf Triton kernel (the first port's) against the plain
    version over the optimizer × members × dtype × shape grid, then the
    tree kernel (CUDA, ``csrc/optim.cu``) bit-equal to it over the same
    grid as trees, strided, of mixed dtypes, and on the ResNet56 tree at
    its shapes and strides; returns B1's row for the ResNet56 tree."""
    import torch_hpo_resnet as example
    from repro_torch.kernels import optim as ko
    from repro_torch.kernels.optim import _SPEC, stacked_leaf_update
    from repro_torch.models.resnet import ResNet
    from repro_torch.train.optimizer import (OPTIMIZERS, apply_update,
                                             leaf_update)
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    def plain(name, arrs, scal, snames):
        bshape = (arrs[0].shape[0],) + (1,) * (arrs[0].dim() - 1)
        return leaf_update(name, *arrs, **{k: s.reshape(bshape)
                                           for k, s in zip(snames, scal)})

    t0 = time.perf_counter()
    for name in OPTIMIZERS:                         # build: JIT at 1st launch
        trees, scal = b1_operands(name, 1, [(64,)], [torch.float32], 0)
        stacked_leaf_update(name, *(t[0] for t in trees), *scal)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tree_build_s = join_build("optim")
    ko._lib()                                   # load, check its constants

    variants = []
    worst_f32 = 0.0
    for name in OPTIMIZERS:
        err_f32, ulp_bf16, cases, tree_cases = 0.0, 0.0, 0, 0
        snames = _SPEC[name][1]
        for M in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                for strided in (False, True):
                    # the grid's shapes as one tree: tree kernel twice and
                    # per-leaf kernel, bit for bit
                    trees, scal = b1_operands(name, M, SHAPES,
                                              [dtype] * len(SHAPES),
                                              100 * M + 2 * strided + (
                                                  dtype == torch.bfloat16),
                                              strided)
                    b1_tree_vs_leaf(name, trees, scal)
                    tree_cases += 1
                for si, shape in enumerate(SHAPES):
                    trees, scal = b1_operands(name, M, [shape], [dtype],
                                              100 * M + si)
                    arrs = [t[0] for t in trees]
                    b1_tree_vs_leaf(name, trees, scal)  # a one-leaf tree
                    got = stacked_leaf_update(name, *arrs, *scal)
                    again = stacked_leaf_update(name, *arrs, *scal)
                    want = plain(name, arrs, scal, snames)
                    torch.cuda.synchronize()
                    assert len(got) == len(want) == _SPEC[name][2]
                    for a, b, c in zip(got, again, want):
                        assert a.shape == c.shape and a.dtype == c.dtype
                        assert bool(a.isfinite().all())
                        assert torch.equal(a, b), (
                            f"{name}: two runs differ", M, dtype, shape)
                        if dtype == torch.float32:
                            diff = (a - c).abs()
                            err_f32 = max(err_f32, float(diff.max()))
                            bad = diff > 1e-6 + 1e-6 * c.abs()
                        else:
                            # one bf16 ulp at the value's magnitude
                            ulps = bf16_ulps(a, c)
                            ulp_bf16 = max(ulp_bf16, float(ulps.max()))
                            bad = ulps > 1.0
                        assert not bool(bad.any()), (
                            f"{name}: kernel disagrees with plain version",
                            M, dtype, shape, float((a.float()
                                                    - c.float()).abs().max()))
                    cases += 1
        # f32 and bf16 leaves in one tree, 4 members
        trees, scal = b1_operands(name, 4, SHAPES, [
            torch.float32, torch.bfloat16, torch.bfloat16, torch.float32], 7,
            strided=True)
        b1_tree_vs_leaf(name, trees, scal)
        tree_cases += 1
        # time one launch at the widest ResNet56 leaf, 1 and 4 members
        timing = {}
        for M in (1, 4):
            trees, scal = b1_operands(name, M, [SHAPES[0]], [torch.float32],
                                      7)
            arrs = [t[0] for t in trees]
            n_in, n_out = _SPEC[name][0], _SPEC[name][2]
            nbytes = (n_in + n_out) * arrs[0].numel() * 4
            timing[f"M{M}"] = {
                "ms": time_ms(lambda: stacked_leaf_update(name, *arrs, *scal)),
                "tree_kernel_ms": time_ms(lambda: ko.stacked_tree_update(
                    name, *trees, *scal)),
                "plain_ms": time_ms(lambda: plain(name, arrs, scal, snames)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        worst_f32 = max(worst_f32, err_f32)
        variants.append({"name": name, "cases": cases,
                         "tree_cases_bit_equal_to_per_leaf": tree_cases,
                         "max_abs_err_f32": err_f32,
                         "max_err_bf16_in_ulps": ulp_bf16,
                         "bit_equal_twice": True,
                         "leaf_3x3x64x64": timing})

    # the whole-tree update at the main path's shapes and strides:
    # ResNet56, momentum, gradients as the loss's backward hands them over
    # (convolution weights' come as non-contiguous HWIO views: the tree
    # kernel reads them through their strides, the per-leaf design copied)
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    params = ResNet(n=9, width=16).init(0, device=DEV)
    batch0 = {k: v[0] for k, v in backend._upload(
        backend.pipeline_factory().next_batches(1)).items()}
    _, grads = value_and_grad(backend.task.loss, params, batch0)
    n_strided = sum(not g.is_contiguous() for g in tree_leaves(grads))
    assert n_strided > 0, "expected strided weight gradients on this path"
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = tree_map(lambda p: 0.01 * torch.rand(p.shape, device=DEV,
                                                 generator=gen),
                     {"m": params})
    n_leaves = len(tree_leaves(params))
    n_params = sum(p.numel() for p in tree_leaves(params))
    assert n_leaves == RESNET_LEAVES, n_leaves
    hp = {"lr": torch.tensor(0.05, device=DEV)}
    step = torch.tensor(3, dtype=torch.int32, device=DEV)
    ps, gs, ms = (tree_leaves(params), tree_leaves(grads),
                  tree_leaves(state["m"]))

    def library():       # yardstick only — the package never calls this
        m2 = torch._foreach_mul(ms, 0.9)
        torch._foreach_add_(m2, gs)
        return torch._foreach_add(ps, m2, alpha=-0.05), m2

    tree_bytes = 5 * n_params * 4          # read p, g, m; write p, m (f32)
    timing, (new_k, st_k) = b1_tree_row("momentum", params, grads, state, hp,
                                        step, tree_bytes, library, keep=True)
    new_p, st_p = apply_update("momentum", params, grads, state, hp, step)
    lib_p, lib_m = library()
    torch.cuda.synchronize()
    tree_err = 0.0
    for a, b in zip(tree_leaves((new_k, st_k)), tree_leaves((new_p, st_p))):
        diff = (a - b).abs()
        tree_err = max(tree_err, float(diff.max()))
        assert not bool((diff > 1e-6 + 1e-6 * b.abs()).any())
    for a, b in zip(tree_leaves((new_p, st_p["m"])), list(lib_p) + list(lib_m)):
        assert float((a - b).abs().max()) <= 1e-5     # yardstick is the same fn
    row = {
        "name": "stacked_tree_update", "route": "cuda", "source": B1_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": None,
        "max_abs_err": max(worst_f32, tree_err), **timing,
        "library": "torch._foreach_mul / _foreach_add_ / _foreach_add",
        "shape": f"ResNet56 tree, momentum: {n_leaves} leaves, "
                 f"{n_params} f32 parameters, one launch; {n_strided} "
                 f"gradient leaves strided, read through their strides",
        # the tree kernel's performance targets (PERF.md §6), printed and
        # not asserted: a time is no check of correctness
        "targets_met": {
            "ms_le_0.85": timing["ms"] <= 0.85,
            "ms_le_library_ms": timing["ms"] <= timing["library_ms"]},
        "per_leaf_kernel": {"source": KERNEL_SOURCE, "route": "triton",
                            "build_seconds": build_s,
                            "launches_per_call": n_leaves},
        "build_seconds": tree_build_s, "variants": variants}
    emit({"phase": "kernels", "build_seconds": build_s,
          "tree_kernel_build_seconds": tree_build_s,
          "variants_ok": [v["name"] for v in variants],
          "tree_kernel_bit_equal_to_per_leaf": True,
          "max_abs_err_f32": row["max_abs_err"],
          "tree_update": {k: row[k] for k in (
              "ms", "device_ms", "wrapper_host_us", "per_leaf_triton_ms",
              "plain_ms", "library_ms", "bound_ms",
              "bound_share_of_device_ms", "targets_met")}})
    return row


# -------------------------------------------- 3. small input, agreement on card
def small_phase():
    import torch_hpo_resnet as example
    from repro_torch.core import Constant, HpConfig, MultiStep
    from repro_torch.core.searchplan import SearchPlan
    from repro_torch.core.trainer import StageContext
    from repro_torch.core.trial import Trial
    from repro_torch.utils.tree import tree_leaves

    small = dict(n=1, width=8, n_train=256, n_eval=128, batch=32)
    t_kernel = example.make_backend(use_kernel=True, **small)
    t_plain = example.make_backend(use_kernel=False, **small)
    assert t_kernel.device.type == "cuda" and t_kernel.use_kernel
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    trial = Trial(HpConfig({"lr": MultiStep(0.05, [4], values=[0.05, 0.01]),
                            "bs": Constant(32)}), 6)
    plan = SearchPlan("solo-" + trial.trial_id)
    node, _, _ = plan.submit(trial, 6)
    path = plan.path_to_root(node.node_id)
    ctxs = [StageContext(n.node_id, n.desc, n.start, n.start,
                         6 if i == len(path) - 1 else path[i + 1].start,
                         plan.path_key(n.node_id))
            for i, n in enumerate(path)]
    chain = t_kernel.run_chain(t_kernel.init_state(), ctxs)[-1]
    s_step, s_plain = t_kernel.init_state(), t_plain.init_state()
    for ctx in ctxs:
        s_step = t_kernel.run_stage_stepwise(s_step, ctx)
        s_plain = t_plain.run_stage(s_plain, ctx)
    torch.cuda.synchronize()
    small_err, bitwise = 0.0, True
    for a, b, c in zip(tree_leaves((chain["params"], chain["opt"])),
                       tree_leaves((s_step["params"], s_step["opt"])),
                       tree_leaves((s_plain["params"], s_plain["opt"]))):
        assert bool(a.isfinite().all())
        bitwise = bitwise and torch.equal(a, b)
        small_err = max(small_err, float((a - c).abs().max()))
    assert small_err <= 1e-4, small_err
    assert bitwise, "fused chain and per-step loop differ on the card"
    emit({"phase": "small", "model": "ResNet(n=1, width=8)", "steps": 6,
          "kernel_vs_plain_max_abs_err": small_err, "atol": 1e-4,
          "fused_chain_equals_stepwise_bitwise": bitwise})


# ------------------------------------------------- 4-5. ResNet56 main path
def resnet_study_phase():
    """Both modes of the ResNet56 study; returns the tree kernel's
    launches in them and each mode's ``(stats, tuner, wall seconds)``."""
    import torch_hpo_resnet as example
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)

    kops.reset_kernel_stats()
    stacked_tree_update.launches = 0            # counts to 0 just before
    stacked_leaf_update.launches = 0
    runs = {}
    for share in (True, False):
        backend = example.make_backend(use_kernel=True, **RESNET_FULL)
        stats, tuner, store, wall = example.run_study(
            backend, share, batch=RESNET_FULL["batch"], name="resnet56",
            batch_siblings=False)
        torch.cuda.synchronize()
        runs[share] = (stats, tuner, store, wall)
    launches = stacked_tree_update.launches     # ... and read just after
    leaf_launches = stacked_leaf_update.launches
    calls, fallbacks = kops.KERNEL_STATS.snapshot()

    total_steps = 0
    for share, (stats, tuner, store, wall) in runs.items():
        assert tuner.is_done() and tuner.best is not None
        assert stats.kernel_calls > 0 and stats.kernel_fallbacks == 0
        assert stats.kernel_calls == stats.steps_run, (
            stats.kernel_calls, stats.steps_run)
        assert stats.chain_fused_stages > 0
        assert stats.ckpt_async_writes == stats.ckpt_saves > 0
        assert store.pending_writes == 0
        n_ckpts = held_checkpoints(store, RESNET_LEAVES)
        total_steps += stats.steps_run
        emit({"phase": "study", "mode": "stage" if share else "trial",
              "model": "ResNet(n=9, width=16)", "batch": RESNET_FULL["batch"],
              "steps_run": stats.steps_run, "stages_run": stats.stages_run,
              "chain_fused_stages": stats.chain_fused_stages,
              "ckpt_saves": stats.ckpt_saves,
              "ckpt_async_writes": stats.ckpt_async_writes,
              "ckpt_loads": stats.ckpt_loads,
              "kernel_calls": stats.kernel_calls,
              "kernel_fallbacks": stats.kernel_fallbacks,
              "checkpoints_held": n_ckpts, "wall_seconds": wall,
              "steps_per_second": stats.steps_run / wall,
              "best_trial": tuner.best.trial_id,
              "best_val_acc": tuner.best_score})
    assert fallbacks == 0 and calls == total_steps, (calls, fallbacks)
    # one launch of the tree kernel per step, the per-leaf kernel never
    assert launches == total_steps and leaf_launches == 0, (
        launches, leaf_launches, total_steps)
    (s_stats, s_tuner), (t_stats, t_tuner) = runs[True][:2], runs[False][:2]
    assert s_stats.steps_run < t_stats.steps_run
    assert set(s_tuner.history) == set(t_tuner.history)
    worst = max(abs(m["loss"] - t_tuner.history[k]["loss"])
                for k, m in s_tuner.history.items())
    assert worst <= 1e-4, worst
    same_best = s_tuner.best.trial_id == t_tuner.best.trial_id
    assert same_best, (s_tuner.best.trial_id, t_tuner.best.trial_id)
    assert abs(s_tuner.best_score - t_tuner.best_score) <= 1e-4
    emit({"phase": "main_path", "ok": True, "launches": launches,
          "kernel_calls": calls, "kernel_fallbacks": fallbacks,
          "steps_run": {"stage": s_stats.steps_run,
                        "trial": t_stats.steps_run},
          "launches_per_step": 1, "per_leaf_kernel_launches": leaf_launches,
          "same_best_trial": same_best,
          "best_trial": s_tuner.best.trial_id,
          "best_scores_bit_equal":
              s_tuner.best_score == t_tuner.best_score,
          "all_reported_losses_bit_equal": worst == 0.0,
          "all_reported_metrics_bit_equal":
              s_tuner.history == t_tuner.history,
          "max_reported_loss_difference": worst})
    return launches, {share: (r[0], r[1], r[3]) for share, r in runs.items()}


def step_profile(prefix, model, backend, opt, lr, n_chunk, profile_steps,
                 tokens=None, port=None):
    """Where one training step's time goes — a chunk of ``n_chunk`` steps
    and the loss's forward + backward alone (host clock, synchronised at
    both ends, mean of two runs), the update alone on CUDA events against
    its bound, ``port`` = (label, ms per step, kernel-name match) for the
    package's own kernels, the peak device memory — then the device's busy
    and idle share over one ``profile_steps``-step chunk.  Prints phases
    ``<prefix>step`` and ``<prefix>profile``."""
    from repro_torch.kernels.optim import fused_apply_update
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params0 = backend.init_state()["params"]
    draw_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params0))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params0))
    # the carry advances chunk by chunk, so that no step keeps an older
    # training state alive beside the current one
    carry = [(params0, init_opt_state(opt, params0))]
    n_slots = len(carry[0][1])
    del params0
    slab = backend._upload(backend.pipeline_factory().next_batches(n_chunk))
    steps = torch.arange(n_chunk, dtype=torch.int32, device=DEV)
    lrs = torch.full((n_chunk,), lr, device=DEV)

    def chunk(n):
        carry[0] = backend._run_chunk(
            opt, carry[0], {}, {"lr": lrs[:n]},
            {k: v[:n] for k, v in slab.items()}, steps[:n])

    step_ms = host_ms(lambda: chunk(n_chunk), 2) / n_chunk
    batch0 = {k: v[0] for k, v in slab.items()}
    grad_ms = host_ms(lambda: value_and_grad(
        backend.task.loss, carry[0][0], batch0), 2)
    _, grads = value_and_grad(backend.task.loss, carry[0][0], batch0)
    upd_ms = time_ms(lambda: fused_apply_update(
        opt, carry[0][0], grads, carry[0][1], {"lr": lrs[0]}, steps[-1]),
        reps=5, warm=1)
    del grads
    # read p, g and each state slot; write p and each slot: leaf dtypes
    upd_bytes = (2 * n_slots + 3) * param_bytes
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": prefix + "step", "model": model, "parameters": n_params,
           "init_draw_seconds": draw_s, "step_ms": step_ms,
           "steps_per_second": 1e3 / step_ms}
    if tokens is not None:
        row["tokens_per_second"] = tokens * 1e3 / step_ms
    row["loss_fwd_bwd_ms"] = grad_ms
    if port is not None:
        label, port_ms, _ = port
        row.update({f"{label}_ms": port_ms,
                    f"{label}_share_of_step": port_ms / step_ms})
    row.update(optimizer_update_ms=upd_ms,
               optimizer_update_share_of_step=upd_ms / step_ms,
               optimizer_update_bound_ms=upd_bytes / HBM_BYTES_PER_S * 1e3,
               peak_device_memory_bytes=peak,
               peak_device_memory_gib=peak / 2 ** 30,
               clock="step and forward + backward: host, synchronised at "
                     "both ends; the update alone: CUDA events"
                     + ("" if port is None else
                        f"; {label}: the layers x the kernels' CUDA-event "
                        f"times at the main path's shape"))
    emit(row)
    emit({"phase": prefix + "profile",
          **device_profile(lambda: chunk(profile_steps), profile_steps,
                           step_ms * profile_steps,
                           match=None if port is None else port[2])})


def resnet_step_phase():
    import torch_hpo_resnet as example
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    step_profile("", "ResNet(n=9, width=16)", backend, "momentum", 0.05,
                 n_chunk=8, profile_steps=8)


# ------------------------------- 6. attention kernels vs plain version
CAUSAL = dict(causal=True, window=0)


def live_pairs(S, causal, window):
    """The (query, key) pairs a mask keeps over S positions: the work of
    the attention kernels, which skip dead tiles and mask the rest."""
    q = np.arange(S)
    hi = q if causal else np.full(S, S - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S, int)
    return int((hi - lo + 1).clip(min=0).sum())


def sdpa_inputs(q, k, v, mk):
    """(B, H, S, hd) views for the library's attention, K / V repeated
    onto the query heads, and the boolean mask of a windowed case (None
    otherwise: the library's causal flag serves)."""
    from repro_torch.kernels.ref import attention_mask
    group = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ke, ve = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
    mask = attention_mask(q.shape[1], k.shape[1], mk["causal"],
                          mk["window"], q.device) if mk["window"] else None
    return qt, ke, ve, mask


def b2_case(fa, q, k, v, lse_rule, label, mk=CAUSAL):
    """B2 in bf16 at a main path's shape under the mask ``mk``: two
    launches bit-equal, executed tiles equal to ``fa_tile_counts``,
    ``out`` by ``p_rounding_rule`` and ``lse`` by ``lse_rule`` against the
    plain version on the same inputs; timed by CUDA events and by the
    profiler beside SDPA (a yardstick the package never calls; with a
    window, over its boolean mask), with its bound: 4·B·Hq·hd·(the live
    (query, key) pairs) operations.  Returns (out, lse, row)."""
    import torch.nn.functional as F
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    tc0 = fa.flash_attention_fwd.launches_tc
    runs = [fa.flash_attention_fwd(q, k, v, return_lse=True,
                                   count_tiles=True, **mk) for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_tc - tc0 == 2, label
    assert all(torch.equal(a, b) for a, b in zip(runs[0][:2], runs[1][:2])), (
        "two launches differ", label)
    want = B * Hq * fa.fa_tile_counts(S, S, *fa.fwd_blocks(torch.bfloat16,
                                                           hd),
                                      mk["causal"], mk["window"])[0]
    assert int(runs[0][2]) == int(runs[1][2]) == want, (
        "executed tiles", label, int(runs[0][2]), want)
    out, lse = runs[0][:2]
    del runs
    qf, kf, vf = q.float(), k.float(), v.float()
    out_row, ok = p_rounding_rule(out, fa.fwd_plain(qf, kf, vf, **mk)[0],
                                  fa.fwd_plain(qf, kf, vf.abs(), **mk)[0])
    assert ok, ("B2 disagrees with its plain version", label, out_row)
    del qf, kf, vf
    lse_row, ok = at_scale(lse, fa.fwd_plain(q, k, v, **mk)[1], lse_rule)
    assert ok, ("B2 lse disagrees with its plain version", label, lse_row)
    qt, ke, ve, mask = sdpa_inputs(q, k, v, mk)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    kern = lambda: fa.flash_attention_fwd(q, k, v, return_lse=True, **mk)
    if mask is None:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=mk["causal"], enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                     attn_mask=mask)
    lib_err = float((lib().transpose(1, 2).float() - out.float()).abs().max()
                    ) / float(out.float().abs().max())
    assert lib_err <= 2e-2, ("yardstick differs", label, lib_err)
    ms, lib_ms = time_ms(kern, reps=20, warm=3), time_ms(lib, reps=20, warm=3)
    flops = 4.0 * B * Hq * hd * live_pairs(S, mk["causal"], mk["window"])
    # each input read once, each output written once
    nbytes = 2 * 2 * B * S * (Hq + Hkv) * hd + 4 * B * Hq * S
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return out, lse, {
        "shape": label, "ms": ms,
        "plain_ms": time_ms(lambda: fa.fwd_plain(q, k, v, **mk), reps=5,
                            warm=1),
        "library_ms": lib_ms, "ms_over_library_ms": ms / lib_ms,
        "device_ms": device_ms(kern), "library_device_ms": device_ms(lib),
        "wrapper_host_us": launch_us(kern), "library_host_us": launch_us(lib),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes, "tiles": want,
        "vs_plain": {"out": out_row, "lse": lse_row},
        "library_vs_kernel_err_over_scale": lib_err}


def bwd_case(fa, q, k, v, do, out, lse, label, mk=CAUSAL):
    """B3 and B4 in bf16 at a main path's shape under the mask ``mk``, fed
    B2's ``lse``: two launches of each bit-equal, every one on the
    tensor-core kernels; dq, dk_h, dv_h by ``ds_rounding_rule`` against the
    plain versions and within 2e-2 of the largest value of the library's
    backward (a yardstick the package never calls: the flash backward, or
    with a window SDPA's backward over its boolean mask); each kernel timed
    by CUDA events and by the profiler beside its plain version and its
    bound, the pair beside the library's backward and the backward's bound
    as a whole.  Returns ({"B3": row, "B4": row}, the pair's row)."""
    import torch.nn.functional as F
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    kern = {"B3": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    **mk),
            "B4": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                     delta, **mk)}
    plain = {"B3": lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta, **mk),
             "B4": lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta, **mk)}
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    tc0 = [w.launches_tc for w in wrappers]
    got = (kern["B3"](),) + kern["B4"]()
    again = (kern["B3"](),) + kern["B4"]()
    torch.cuda.synchronize()
    assert [w.launches_tc - t for w, t in zip(wrappers, tc0)] == [2, 2], label
    for a, b in zip(got, again):
        assert torch.equal(a, b), ("two launches differ", label)
    del again
    vs_plain, ok = ds_rounding_rule(fa, q, k, v, do, lse, delta, got, mk)
    assert ok, ("B3 / B4 disagree with their plain versions", label,
                vs_plain)

    # yardstick only — the package never calls it: the library's backward
    # alone, on its own forward's residuals, over K / V repeated onto the
    # query heads: one call that computes what B3 and B4 compute together
    # (dq and the per-query-head dk_h, dv_h)
    qt, ke, ve, mask = sdpa_inputs(q, k, v, mk)
    dot = do.transpose(1, 2)
    if mask is None:
        res = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, ke, ve, 0.0, mk["causal"], False)

        def sdpa_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, ke, ve, res[0], res[1], res[2], res[3], res[4],
                res[5], 0.0, mk["causal"], res[6], res[7])
        library = ("aten._scaled_dot_product_flash_attention_backward over "
                   "K / V repeated onto the query heads")
    else:
        leaves = [x.detach().requires_grad_(True) for x in (qt, ke, ve)]
        o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)

        def sdpa_bwd():
            return torch.autograd.grad(o_lib, leaves, dot, retain_graph=True)
        library = ("the backward of F.scaled_dot_product_attention over its "
                   "boolean window mask, K / V repeated onto the query heads")

    lib_err = {}
    for name, a, b in zip(("dq", "dk_h", "dv_h"), sdpa_bwd(), got):
        a = a.transpose(1, 2)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        lib_err[name] = float((a.float() - b.float()).abs().max()) / float(
            b.float().abs().max())
        assert lib_err[name] <= 2e-2, ("yardstick differs", name, lib_err)
    del got

    e_bf16, e_f32 = 2, 4
    n_q, n_kv, n_row = B * S * Hq * hd, B * S * Hkv * hd, B * Hq * S
    fwd_flops = 4.0 * B * Hq * hd * live_pairs(S, mk["causal"], mk["window"])
    # (flops, bytes) of each backward kernel's function: each input read
    # once, each output written once.  Alone, B3 must recompute s and dp
    # and form ds·K (three products of the forward's two: 1.5x); B4 must
    # recompute them and form dsᵀ·Q and pᵀ·dO (2x).
    work = {"B3": (1.5 * fwd_flops,
                   e_bf16 * (3 * n_q + 2 * n_kv) + e_f32 * 2 * n_row),
            "B4": (2.0 * fwd_flops,
                   e_bf16 * (4 * n_q + 2 * n_kv) + e_f32 * 2 * n_row)}
    rows = {}
    for key, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        rows[key] = {
            "ms": time_ms(kern[key], reps=20, warm=3),
            "device_ms": device_ms(kern[key]),
            "wrapper_host_us": launch_us(kern[key]),
            "plain_ms": time_ms(plain[key], reps=5, warm=1),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}
    # the backward as a whole (the repo's numerator,
    # benchmarks/bench_kernels.py:68-74): five products, s and dp formed
    # once, 2.5x the forward's flops and bytes
    bwd_flops = 2.5 * fwd_flops
    bwd_bytes = 2.5 * e_bf16 * (2 * n_q + 2 * n_kv)
    t_ops, t_bytes = bwd_flops / BF16_FLOP_PER_S, bwd_bytes / HBM_BYTES_PER_S
    pair_ms = rows["B3"]["ms"] + rows["B4"]["ms"]
    lib_ms = time_ms(sdpa_bwd, reps=20, warm=3)
    dev = [rows[key]["device_ms"] for key in ("B3", "B4")]
    pair = {"shape": label, "ms": pair_ms,
            "device_ms": sum(dev) if all(isinstance(x, float) for x in dev)
            else "not measured",
            "library_ms": lib_ms, "library_device_ms": device_ms(sdpa_bwd),
            "ms_over_library_ms": pair_ms / lib_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": bwd_flops, "bytes": bwd_bytes,
            "per_kernel_bound_ms": rows["B3"]["bound_ms"]
            + rows["B4"]["bound_ms"],
            "library": library,
            "vs_plain": vs_plain, "library_vs_kernel_err_over_scale": lib_err}
    return rows, pair


def wide_attention_case(fa, arch, lse_rule, gen):
    """B2–B4 in bf16 at ``WIDE_ATTENTION[arch]``'s training shape by
    :func:`b2_case` / :func:`bwd_case`; returns {"B2", "B3", "B4": row,
    "pair": the backward's row}."""
    spec = WIDE_ATTENTION[arch]
    mk = {x: spec[x] for x in ("causal", "window")}
    B, S, Hq, Hkv, hd = (spec[x] for x in ("B", "S", "Hq", "Hkv", "hd"))
    label = (f"B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, hd {hd}, "
             f"{'causal' if mk['causal'] else 'non-causal'}"
             + (f", window {mk['window']}" if mk["window"] else "")
             + f", bf16 ({arch})")
    q, k, v, do = [torch.randn(shape, generator=gen).to(DEV, torch.bfloat16)
                   for shape in ((B, S, Hq, hd), (B, S, Hkv, hd),
                                 (B, S, Hkv, hd), (B, S, Hq, hd))]
    out, lse, b2 = b2_case(fa, q, k, v, lse_rule, label, mk)
    bwd, pair = bwd_case(fa, q, k, v, do, out, lse, label, mk)
    del q, k, v, do, out, lse
    free()
    return {"B2": b2, "B3": dict(bwd["B3"], shape=label),
            "B4": dict(bwd["B4"], shape=label), "pair": pair}


def attention_phase(join_build):
    """B2–B4 on the grid and at qwen2-0.5b's, qwen3-8b's,
    qwen2-moe-a2.7b's, recurrentgemma-2b's (hd 256), hubert-xlarge's (hd
    80) and qwen2-vl-7b's shapes; returns their rows (the kernels line's
    B2–B4 and their ``_hd256`` / ``_hd80`` rows)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    build_s = join_build("flash_attention")
    fa._lib()                                   # load, check tile sizes
    gen = torch.Generator().manual_seed(12)
    lse_rule = ("atol 2e-5 + rtol 2e-5",
                lambda diff, b, scale: bool((diff <= 2e-5 + 2e-5
                                             * b.abs()).all()))

    def fa_inputs(B, S, Hq, Hkv, hd, dtype):
        return [torch.randn(shape, generator=gen).to(DEV, dtype)
                for shape in ((B, S, Hq, hd), (B, S, Hkv, hd),
                              (B, S, Hkv, hd), (B, S, Hq, hd))]

    fa_err = {k: {"float32": 0.0, "bfloat16": 0.0}
              for k in ("B2", "B3", "B4")}
    fa_cases = 0
    grid_b2_bf16 = {"max_err_over_allowed": 0.0, "lse_max_abs_err": 0.0}
    grid_bwd_bf16 = {"dq": 0.0, "dk_h": 0.0, "dv_h": 0.0}
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    n0 = [(w.launches, w.launches_tc) for w in wrappers]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32
        grad_tol = (2e-4, 2e-3) if f32 else (2e-2, 2e-2)
        for B, S, Hq, Hkv, hd in FA_SHAPES:
            for causal, window in FA_MASKS:
                q, k, v, do = fa_inputs(B, S, Hq, Hkv, hd, dtype)
                mk = dict(causal=causal, window=window)
                runs = [fa.flash_attention_fwd(q, k, v, return_lse=True,
                                               count_tiles=True, **mk)
                        for _ in range(2)]
                out, lse, tiles = runs[0]
                p_out, p_lse, p_tiles = fa.fwd_plain(q, k, v, **mk)
                delta = (do.float() * out.float()).sum(-1).transpose(
                    1, 2).contiguous()
                dqs = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                 **mk) for _ in range(2)]
                dkvs = [fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   **mk) for _ in range(2)]
                p_dq = fa.bwd_dq_plain(q, k, v, do, lse, delta, **mk)
                p_dk, p_dv = fa.bwd_dkv_plain(q, k, v, do, lse, delta, **mk)
                torch.cuda.synchronize()
                case = (dname, B, S, Hq, Hkv, hd, causal, window)
                for a, b in zip(runs[0][:2] + (dqs[0],) + dkvs[0],
                                runs[1][:2] + (dqs[1],) + dkvs[1]):
                    assert torch.equal(a, b), ("two launches differ", case)
                want = B * Hq * fa.fa_tile_counts(
                    S, S, *fa.fwd_blocks(dtype, hd), causal, window)[0]
                assert int(tiles) == int(runs[1][2]) == p_tiles == want, (
                    "executed tiles", case, int(tiles), want)
                assert float(dqs[0].float().abs().max()) > 0
                if f32:       # B2 in f32: the CUDA-core kernel, f32 p
                    b2_pairs = (("B2", ((out, p_out), (lse, p_lse)),
                                 (2e-5, 2e-5)),)
                else:         # B2 in bf16: the tensor-core kernel, bf16 p
                    qf, kf, vf = q.float(), k.float(), v.float()
                    row, ok = p_rounding_rule(
                        out, fa.fwd_plain(qf, kf, vf, **mk)[0],
                        fa.fwd_plain(qf, kf, vf.abs(), **mk)[0])
                    assert ok, ("B2 disagrees with its plain version", case,
                                row)
                    lse_err, ok = within(lse, p_lse, 2e-5, 2e-5)
                    assert ok, ("B2 lse disagrees", case, lse_err)
                    fa_err["B2"][dname] = max(fa_err["B2"][dname],
                                              row["max_abs_err"])
                    for x, y in (("max_err_over_allowed",
                                  row["max_err_over_allowed"]),
                                 ("lse_max_abs_err", lse_err)):
                        grid_b2_bf16[x] = max(grid_b2_bf16[x], y)
                    b2_pairs = ()
                    # B3 / B4 in bf16: the tensor-core kernels, bf16 p, dS
                    rows, ok = ds_rounding_rule(fa, q, k, v, do, lse, delta,
                                                (dqs[0],) + dkvs[0], mk)
                    assert ok, ("B3 / B4 disagree with their plain "
                                "versions", case, rows)
                    for name, row in rows.items():
                        grid_bwd_bf16[name] = max(
                            grid_bwd_bf16[name], row["max_err_over_allowed"])
                for key, pairs, (atol, rtol) in b2_pairs + (
                        ("B3", ((dqs[0], p_dq),), grad_tol),
                        ("B4", ((dkvs[0][0], p_dk), (dkvs[0][1], p_dv)),
                         grad_tol)):
                    for a, b in pairs:
                        assert a.shape == b.shape and a.dtype == b.dtype
                        err, ok = within(a, b, atol, rtol)
                        fa_err[key][dname] = max(fa_err[key][dname], err)
                        assert ok, (f"{key} disagrees with its plain "
                                    f"version", case, err)
                fa_cases += 1
    n_grid = len(FA_SHAPES) * len(FA_MASKS)
    # each case launches B2, B3 and B4 twice each: f32 on the CUDA-core
    # kernels, bf16 on the tensor-core ones
    for w, (all0, tc0) in zip(wrappers, n0):
        assert w.launches - all0 == 4 * n_grid, w.__name__
        assert w.launches_tc - tc0 == 2 * n_grid, w.__name__

    # the main path's own shapes, bf16, causal: qwen2-0.5b's training
    # attention (GQA 7), then qwen3-8b's at hd 128; B3 / B4 fed B2's lse
    B, S, Hq, Hkv, hd = (QWEN[x] for x in ("B", "S", "Hq", "Hkv", "hd"))
    shape_s = f"B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, hd {hd}, causal, bf16"
    q, k, v, do = fa_inputs(B, S, Hq, Hkv, hd, torch.bfloat16)
    out, lse, b2_main = b2_case(fa, q, k, v, lse_rule, shape_s)
    bwd_rows, pair = bwd_case(fa, q, k, v, do, out, lse, shape_s)
    main_err = {"B2": b2_main["vs_plain"],
                "B3": {"dq": pair["vs_plain"]["dq"]},
                "B4": {x: pair["vs_plain"][x] for x in ("dk_h", "dv_h")}}
    del q, k, v, do, out, lse
    free()
    shape3 = ("B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, hd {hd}, causal, bf16 "
              "(qwen3-8b)".format(**QWEN3))
    q3 = fa_inputs(*(QWEN3[x] for x in ("B", "S", "Hq", "Hkv", "hd")),
                   torch.bfloat16)
    out3, lse3, hd128 = b2_case(fa, *q3[:3], lse_rule, shape3)
    bwd3_rows, pair3 = bwd_case(fa, *q3, out3, lse3, shape3)
    del q3, out3, lse3
    free()
    # qwen2-moe-a2.7b's: MHA (a GQA group of 1) at hd 128, the shape the
    # moe phase's study trains on
    shape_m = ("B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, hd {hd}, causal, bf16 "
               "(qwen2-moe-a2.7b, MHA)".format(**QWEN_MOE))
    qm = fa_inputs(*(QWEN_MOE[x] for x in ("B", "S", "Hq", "Hkv", "hd")),
                   torch.bfloat16)
    out_m, lse_m, moe128 = b2_case(fa, *qm[:3], lse_rule, shape_m)
    bwdm_rows, pairm = bwd_case(fa, *qm, out_m, lse_m, shape_m)
    del qm, out_m, lse_m
    free()
    # the slices' head dims 256 and 80, and qwen2-vl-7b's attention
    wide = {arch: wide_attention_case(fa, arch, lse_rule, gen)
            for arch in WIDE_ATTENTION}

    def kernel_row(key, name):
        return {"name": name, "route": "cuda", "source": FA_SOURCE,
                "replaces": FA_REPLACES[key], "launches": None,
                "max_abs_err": max(list(fa_err[key].values())
                                   + [r["max_abs_err"]
                                      for r in main_err[key].values()]),
                "shape": shape_s, "max_abs_err_by_dtype": fa_err[key],
                "cases": fa_cases, "main_shape_vs_plain": main_err[key]}

    rows = {"B2": dict(
        kernel_row("B2", fa.flash_attention_fwd.__name__),
        **{x: b2_main[x] for x in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_over_library_ms", "device_ms", "library_device_ms",
            "wrapper_host_us", "library_host_us", "flops", "bytes")},
        library="F.scaled_dot_product_attention(enable_gqa=True)",
        route_bf16="wgmma (fa_fwd_tc)", route_f32="simt (fa_fwd)",
        grid_bf16=grid_b2_bf16, qwen3_8b_hd128=hd128,
        qwen2_moe_hd128_mha=moe128)}
    for key, wrapper, route in (
            ("B3", fa.flash_attention_bwd_dq, "fa_bwd_dq"),
            ("B4", fa.flash_attention_bwd_dkv, "fa_bwd_dkv")):
        rows[key] = dict(
            kernel_row(key, wrapper.__name__), **bwd_rows[key],
            # no one library call computes dq alone or dk_h / dv_h alone:
            # the library's backward is held against B3 + B4 together in
            # the attention_kernels line
            library_ms=None, library=None,
            route_bf16=f"wgmma ({route}_tc)", route_f32=f"simt ({route})",
            grid_bf16_max_err_over_allowed={
                x: grid_bwd_bf16[x] for x in (
                    ("dq",) if key == "B3" else ("dk_h", "dv_h"))},
            qwen3_8b_hd128=dict(bwd3_rows[key], shape=shape3),
            qwen2_moe_hd128_mha=dict(bwdm_rows[key], shape=shape_m))
    # each wide row of the kernels line: B2–B4 at recurrentgemma-2b's head
    # dim 256 and hubert-xlarge's 80 (their launches are the rglru_study's
    # and the frontends phase's, filled in by run_phases)
    for arch, hd in (("recurrentgemma-2b", 256), ("hubert-xlarge", 80)):
        for key, wrapper in (("B2", fa.flash_attention_fwd),
                             ("B3", fa.flash_attention_bwd_dq),
                             ("B4", fa.flash_attention_bwd_dkv)):
            r = wide[arch][key]
            errs = (r["vs_plain"] if key == "B2" else {
                x: wide[arch]["pair"]["vs_plain"][x]
                for x in (("dq",) if key == "B3" else ("dk_h", "dv_h"))})
            rows[f"{key}_hd{hd}"] = dict(
                {x: r[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "device_ms", "wrapper_host_us", "flops",
                                   "bytes", "shape")},
                name=wrapper.__name__, route="cuda", source=FA_SOURCE,
                replaces=FA_REPLACES[key], launches=None, head_dim=hd,
                model=arch, max_abs_err=max(e["max_abs_err"]
                                            for e in errs.values()),
                vs_plain=errs,
                library_ms=r["library_ms"] if key == "B2" else None,
                library=("F.scaled_dot_product_attention" if key == "B2"
                         else None),
                route_bf16=rows[key]["route_bf16"])
    # each kernel's registers and spills, from the build's ptxas -v report
    ptxas = _cuda.ptxas_report("flash_attention")
    emit({"phase": "attention_kernels",
          "build_seconds": build_s, "cases": fa_cases,
          "ptxas": ptxas,
          "bit_equal_twice": True, "tiles_equal_fa_tile_counts": True,
          "bf16_on_tensor_cores": ["B2", "B3", "B4"],
          "max_abs_err": fa_err, "shape": shape_s,
          "grid_bf16_max_err_over_allowed": dict(
              grid_bwd_bf16, out=grid_b2_bf16["max_err_over_allowed"]),
          "main_shape_vs_plain": main_err,
          "library_vs_kernel_err_over_scale": dict(
              pair["library_vs_kernel_err_over_scale"],
              out=b2_main["library_vs_kernel_err_over_scale"]),
          "timing": {key: {x: r[x] for x in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
                     for key, r in rows.items()},
          "b2": dict({x: rows["B2"][x] for x in (
              "ms", "library_ms", "ms_over_library_ms", "device_ms",
              "library_device_ms", "wrapper_host_us", "library_host_us",
              "grid_bf16", "qwen3_8b_hd128", "qwen2_moe_hd128_mha")},
              cuda_core_ms_not_from_this_run={
                  "ms": B2_CUDA_CORE_MS,
                  "what": "the CUDA-core kernel's bf16 instantiation "
                          "at this shape, median of four runs (PERF.md); "
                          "not measured here, it is gone"}),
          "backward_b3_plus_b4": dict(
              {x: y for x, y in pair.items() if x != "vs_plain"},
              device_ms_by_kernel={key: bwd_rows[key]["device_ms"]
                                   for key in ("B3", "B4")},
              cuda_core_ms_not_from_this_run={
                  "B3": B3_CUDA_CORE_MS, "B4": B4_CUDA_CORE_MS,
                  "B3_plus_B4": B3_CUDA_CORE_MS + B4_CUDA_CORE_MS,
                  "what": "the CUDA-core kernels' bf16 instantiations at "
                          "this shape, medians of five runs (PERF.md); "
                          "not measured here, they are gone"}),
          "backward_b3_plus_b4_qwen3_8b_hd128": dict(
              {x: y for x, y in pair3.items() if x != "vs_plain"},
              vs_plain=pair3["vs_plain"],
              cuda_core_ms_not_from_this_run="none in the record"),
          "backward_b3_plus_b4_qwen2_moe_hd128_mha": dict(
              {x: y for x, y in pairm.items() if x != "vs_plain"},
              vs_plain=pairm["vs_plain"]),
          "wide": {arch: {"b2": {x: y for x, y in w["B2"].items()},
                          "b3": w["B3"], "b4": w["B4"],
                          "backward_b3_plus_b4": w["pair"]}
                   for arch, w in wide.items()}})
    return rows


def lm_small_phase(phase, arch, tokens, seed, attention):
    """A reduced LM (f32) on the card through the kernels' autograd
    bindings against its plain path: loss and every gradient leaf, at the
    CPU tests' tolerances against the JAX package.  With ``attention``, B2,
    B3 and B4 must have run, else B5 and B6, in f32 on the CUDA-core
    kernels only."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.models.transformer import LM
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config(arch).reduced()
    params = LM(cfg).init(0, device=DEV)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, tokens,
        generator=torch.Generator().manual_seed(seed)).to(DEV)}
    got = {}
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    n0 = [(w.launches, w.launches_tc) for w in wrappers]
    ssd0 = [(w.launches, w.launches_tc)
            for w in (ssk.ssd_intra_fwd, ssk.ssd_intra_bwd)]
    for use_kernel in (True, False):
        (loss, _), grads = value_and_grad(
            LM(cfg, use_kernel=use_kernel).loss, params, batch)
        got[use_kernel] = (loss, tree_leaves(grads))
    loss_err = abs(float(got[True][0]) - float(got[False][0]))
    grad_err = max(float((a - b).abs().max())
                   for a, b in zip(got[True][1], got[False][1]))
    assert all(bool(g.isfinite().all()) for g in got[True][1])
    assert loss_err <= 1e-5 and grad_err <= 1e-4, (loss_err, grad_err)
    f32_launches = {w.__name__: w.launches - all0
                    for w, (all0, _) in zip(wrappers, n0)}
    for w, (_, tc0) in zip(wrappers, n0):       # never the bf16 kernels
        assert w.launches_tc == tc0, w.__name__
    assert all((n > 0) == attention for n in f32_launches.values()), \
        f32_launches
    # the f32 SSD forward and backward stay on the CUDA-core kernels
    ssd_fwd, ssd_bwd = (w.launches - all0 for w, (all0, _) in zip(
        (ssk.ssd_intra_fwd, ssk.ssd_intra_bwd), ssd0))
    assert (ssd_fwd > 0) != attention and (ssd_bwd > 0) != attention, (
        ssd_fwd, ssd_bwd)
    assert [w.launches_tc for w in (ssk.ssd_intra_fwd, ssk.ssd_intra_bwd)
            ] == [tc0 for _, tc0 in ssd0]
    emit({"phase": phase, "model": f"{arch} reduced",
          "attention_launches": f32_launches,
          "attention_tensor_core_launches": 0,
          "ssd_fwd_launches": ssd_fwd, "ssd_fwd_tensor_core_launches": 0,
          "ssd_bwd_launches": ssd_bwd, "ssd_bwd_tensor_core_launches": 0,
          "layers": cfg.num_layers, "dtype": cfg.dtype,
          "tokens": list(tokens), "loss": float(got[True][0]),
          "kernel_vs_plain_loss_err": loss_err, "loss_atol": 1e-5,
          "kernel_vs_plain_grad_max_abs_err": grad_err, "grad_atol": 1e-4})


# --------------------------------------------------- an LM study, both modes
def lm_study(phase, make_backend, batch, seq_len, fwd, bwd, model_fields,
             make_store=None, verify=None, kernel_layers=None):
    """Both modes of the SHA study of ``examples/torch_hpo_lm.py`` on one
    trainer, made by ``make_backend()`` after the kernel-plane accounting is
    reset (a trainer counts its calls and fallbacks from its construction);
    its initial parameters are drawn once, first, outside the timed runs
    (the draw launches no kernel).  Every launch count is zeroed just
    before and read just after: each of the ``fwd`` kernels = layers ×
    (steps + evaluations), each of the ``bwd`` kernels = layers × steps
    (``kernel_layers``: the layers that run them, default all)
    (the bf16 attention and SSD ones all on the tensor cores), B1's
    tree kernel = steps, the per-leaf kernel and every other kernel 0; no
    fallback; fewer steps
    stage-based; the same best trial and every reported metric bit-equal.
    The first run's checkpoints are dropped before the second starts.
    ``make_store(mode)`` gives each run its checkpoint store (default: the
    memory tier); a serialized one is closed and its directory removed
    after the run, and ``verify`` bounds the held checkpoints read back
    (:func:`held_checkpoints`).  Returns the launch counts and the
    trainer."""
    import torch_hpo_lm as lm_example
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    from repro_torch.utils.tree import tree_leaves

    kops.reset_kernel_stats()
    backend = make_backend()
    cfg = backend.task.cfg
    assert backend.task.use_kernel and cfg.dtype == "bfloat16"
    t0 = time.perf_counter()
    params0 = backend.init_state()["params"]
    draw_s = time.perf_counter() - t0
    n_leaves = len(tree_leaves(params0))
    n_params = sum(p.numel() for p in tree_leaves(params0))
    assert n_params == cfg.param_count(), n_params
    del params0
    counters = (stacked_tree_update, stacked_leaf_update,
                fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, ssk.ssd_intra_fwd,
                ssk.ssd_intra_bwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc_counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dkv, ssk.ssd_intra_fwd,
                   ssk.ssd_intra_bwd)
    for c in counters:                          # counts to 0 just before
        c.launches = 0
    for c in tc_counters:
        c.launches_tc = 0
    runs = {}
    for share in (True, False):
        evals0 = backend.evaluations
        calls0 = kops.KERNEL_STATS.calls
        store = None if make_store is None else make_store(
            "stage" if share else "trial")
        rec = {} if store is None else store_record(store)
        with host_memory_peak(rec):
            stats, tuner, store, wall = lm_example.run_study(
                backend, share, batch=batch, name=cfg.name,
                batch_siblings=False, store=store)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        free()      # the pinned host copies go before blobs are read back
        assert tuner.is_done() and tuner.best is not None
        assert stats.kernel_fallbacks == 0 and stats.kernel_calls > 0
        assert stats.chain_fused_stages > 0
        assert stats.ckpt_async_writes == stats.ckpt_saves > 0
        assert store.pending_writes == 0
        runs[share] = dict(stats=stats, history=tuner.history,
                           best=tuner.best.trial_id,
                           best_score=tuner.best_score, wall=wall,
                           ckpts=held_checkpoints(store, n_leaves, verify),
                           evals=backend.evaluations - evals0,
                           calls=kops.KERNEL_STATS.calls - calls0,
                           peak=peak, store=None if make_store is None
                           else store_fields(stats, store, rec))
        lm_example.drop_checkpoints(store)  # this run's go before the next
        assert len(store) == 0
        if make_store is not None:
            store.close()
            shutil.rmtree(store.directory)
        del store, tuner
        free()
        torch.cuda.reset_peak_memory_stats()
    launches = {c.__name__: c.launches for c in counters}   # just after
    launches_tc = {c.__name__: c.launches_tc for c in tc_counters}
    calls, fallbacks = kops.KERNEL_STATS.snapshot()
    peak = max(r["peak"] for r in runs.values())

    L = cfg.num_layers if kernel_layers is None else kernel_layers
    steps = sum(r["stats"].steps_run for r in runs.values())
    evals = sum(r["evals"] for r in runs.values())
    expected = {name: 0 for name in launches}
    expected.update({name: L * (steps + evals) for name in fwd})
    expected.update({name: L * steps for name in bwd})
    expected["stacked_tree_update"] = steps     # the whole tree, one launch
    assert fallbacks == 0, kops.KERNEL_STATS.reasons
    assert launches == expected, (launches, expected, steps, evals)
    # a bf16 model's attention and SSD kernels all went through the
    # tensor-core kernels
    assert launches_tc == {name: launches[name] for name in launches_tc}, (
        launches_tc, launches)
    assert calls == steps + L * (steps + evals), (calls, steps, evals)
    s_run, t_run = runs[True], runs[False]
    assert s_run["stats"].steps_run < t_run["stats"].steps_run
    assert s_run["history"] == t_run["history"], \
        "a reported metric differs across modes"
    assert all(m["loss"] == m["loss"]                          # no NaN
               for m in s_run["history"].values())
    assert s_run["best"] == t_run["best"]
    assert s_run["best_score"] == t_run["best_score"]
    text = {name: "0" for name in launches}
    text.update({name: f"{L} x (steps + evaluations)" for name in fwd})
    text.update({name: f"{L} x steps" for name in bwd})
    text["stacked_tree_update"] = "steps (one launch per step)"
    emit({"phase": phase, "model": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.num_layers, "kernel_layers": L, **model_fields,
          "parameters": n_params,
          "leaves": n_leaves, "init_draw_seconds": draw_s, "batch": batch,
          "seq_len": seq_len, "optimizer": "adamw",
          "modes": {("stage" if share else "trial"): {
              "steps_run": r["stats"].steps_run,
              "stages_run": r["stats"].stages_run,
              "evaluations": r["evals"],
              "chain_fused_stages": r["stats"].chain_fused_stages,
              "ckpt_saves": r["stats"].ckpt_saves,
              "checkpoints_held": r["ckpts"],
              "kernel_calls": r["calls"],
              "wall_seconds": r["wall"],
              "steps_per_second": r["stats"].steps_run / r["wall"],
              "peak_device_memory_gib": r["peak"] / 2 ** 30,
              **({} if r["store"] is None else {"store": r["store"]})}
              for share, r in runs.items()},
          "launches": launches, "tensor_core_launches": launches_tc,
          "kernel_calls": calls,
          "kernel_fallbacks": fallbacks, "expected": text,
          "best_trial": s_run["best"], "same_best_trial": True,
          "best_val_acc": s_run["best_score"],
          "all_reported_metrics_bit_equal": True,
          "reported_results": len(s_run["history"]),
          "peak_device_memory_bytes": peak,
          "peak_device_memory_gib": peak / 2 ** 30})
    return launches, backend


# ------------------------------------------- 7-8. qwen2-0.5b: the LM's path
def lm_update_phase(backend, b1_resnet):
    """B1 on the whole qwen2-0.5b AdamW bf16 tree: the tree kernel against
    its plain version, bit-equal to the per-leaf kernel, beside a
    ``torch._fused_adamw_`` yardstick; returns B1's row."""
    from repro_torch.kernels.optim import fused_apply_update
    from repro_torch.train.optimizer import apply_update
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    params0 = backend.init_state()["params"]
    n_leaves = len(tree_leaves(params0))
    n_params = sum(p.numel() for p in tree_leaves(params0))
    slab = backend._upload(backend.pipeline_factory().next_batches(1))
    batch0 = {k: v[0] for k, v in slab.items()}
    _, grads = value_and_grad(backend.task.loss, params0, batch0)
    n_strided = sum(not g.is_contiguous() for g in tree_leaves(grads))
    gen = torch.Generator(device="cuda").manual_seed(2)
    opt = {slot: tree_map(lambda p: (1e-3 * torch.rand(
        p.shape, device=DEV, generator=gen)).to(p.dtype), params0)
        for slot in ("m", "v")}
    hp = {"lr": torch.tensor(3e-4, device=DEV)}
    step = torch.tensor(3, dtype=torch.int32, device=DEV)
    new_k, st_k = fused_apply_update("adamw", params0, grads, opt, hp, step)
    new_p, st_p = apply_update("adamw", params0, grads, opt, hp, step)
    torch.cuda.synchronize()
    upd_ulps, upd_err = 0.0, 0.0
    for a, c in zip(tree_leaves((new_k, st_k)), tree_leaves((new_p, st_p))):
        assert a.dtype == c.dtype == torch.bfloat16
        upd_ulps = max(upd_ulps, float(bf16_ulps(a, c).max()))
        upd_err = max(upd_err, float((a.float() - c.float()).abs().max()))
    assert upd_ulps <= 1.0, upd_ulps
    del new_k, st_k, st_p
    lib_lists = [[t.clone() for t in tree_leaves(x)]
                 for x in (params0, grads, opt["m"], opt["v"])]
    lib_steps = [torch.tensor(4.0, device=DEV) for _ in lib_lists[0]]

    def fused_adamw():   # yardstick only — the package never calls this
        torch._fused_adamw_(*lib_lists, [], lib_steps, lr=3e-4, beta1=0.9,
                            beta2=0.999, weight_decay=0.0, eps=1e-8,
                            amsgrad=False, maximize=False)

    fused_adamw()
    torch.cuda.synchronize()
    lib_ulps = max(float(bf16_ulps(a, c).max())
                   for a, c in zip(lib_lists[0], tree_leaves(new_p)))
    assert lib_ulps <= 1.0, lib_ulps               # the same function
    del new_p
    tree_bytes = 7 * n_params * 2        # read p, g, m, v; write p, m, v
    timing, _ = b1_tree_row("adamw", params0, grads, opt, hp, step,
                            tree_bytes, fused_adamw, reps=10, warm=2)
    row = dict(b1_resnet)
    row.update(timing)
    row.update({
        "max_abs_err": max(upd_err, b1_resnet["max_abs_err"]),
        "library": "torch._fused_adamw_",
        "shape": f"qwen2-0.5b tree, adamw, bf16: {n_leaves} leaves "
                 f"(12 stacked (24, ...)), {n_params} parameters, one "
                 f"launch; {n_strided} gradient leaves strided",
        "max_err_bf16_in_ulps": upd_ulps,
        "targets_met": {"ms_le_per_leaf_ms_plus_5pct": timing["ms"]
                                <= 1.05 * timing["per_leaf_triton_ms"]},
        "resnet56_momentum_f32": {x: b1_resnet[x] for x in (
            "ms", "device_ms", "wrapper_host_us", "per_leaf_triton_ms",
            "plain_ms", "bound_ms", "bound_share_of_device_ms",
            "library_ms", "library", "max_abs_err", "shape",
            "targets_met")},
        "launches_resnet56_study": b1_resnet["launches"]})
    emit({"phase": "lm_update", "optimizer": "adamw", "dtype": "bfloat16",
          "leaves": n_leaves, "parameters": n_params,
          "strided_gradient_leaves": n_strided,
          "max_err_bf16_in_ulps": upd_ulps,
          "library_max_err_bf16_in_ulps": lib_ulps,
          **{x: row[x] for x in ("ms", "device_ms", "wrapper_host_us",
                                 "per_leaf_triton_ms", "plain_ms",
                                 "bound_ms", "library_ms",
                                 "targets_met")}})
    return row


def mamba2_update_phase(backend):
    """B1 on the study's mamba2-2.7b AdamW tree (bf16 leaves beside
    f32 ``A_log`` / ``dt_bias``, one launch): bit-equal to the per-leaf
    kernel, timed beside it, its bound and ``torch._fused_adamw_`` (one
    call per dtype: a yardstick the package never calls).  The gradients
    and moments are drawn on the card (the update's values do not move its
    time); the plain version is not run (its f32 temporaries of the
    1.7 G-element stacked leaf do not fit beside the tree).  Returns the
    row."""
    from repro_torch.kernels.optim import fused_apply_update
    from repro_torch.utils.tree import tree_leaves, tree_map
    params0 = backend.init_state()["params"]      # drawn once, cached
    ps = tree_leaves(params0)
    dtypes = sorted({str(p.dtype) for p in ps})
    n_params = sum(p.numel() for p in ps)
    param_bytes = sum(p.numel() * p.element_size() for p in ps)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rand = lambda scale: tree_map(lambda p: (scale * torch.rand(
        p.shape, device=DEV, generator=gen)).to(p.dtype), params0)
    grads = rand(1e-2)
    opt = {"m": rand(1e-3), "v": rand(1e-3)}
    hp = {"lr": torch.tensor(3e-4, device=DEV)}
    step = torch.tensor(3, dtype=torch.int32, device=DEV)
    groups = {}      # the yardstick's copies, made at its first (warm-up)
    # call, after the tree's outputs are compared and freed

    def fused_adamw():   # yardstick only — the package never calls this
        if not groups:
            for p, g, m, v in zip(ps, tree_leaves(grads),
                                  tree_leaves(opt["m"]),
                                  tree_leaves(opt["v"])):
                lists = groups.setdefault(p.dtype, [[], [], [], [], []])
                for lst, t in zip(lists, (p.clone(), g, m.clone(),
                                          v.clone(), torch.tensor(
                                              4.0, device=DEV))):
                    lst.append(t)
        for lists in groups.values():
            torch._fused_adamw_(*lists[:4], [], lists[4], lr=3e-4,
                                beta1=0.9, beta2=0.999, weight_decay=0.0,
                                eps=1e-8, amsgrad=False, maximize=False)

    row, _ = b1_tree_row("adamw", params0, grads, opt, hp, step,
                         7 * param_bytes, fused_adamw, plain=False, reps=5,
                         warm=1)
    row.update(shape=f"mamba2-2.7b, {backend.task.cfg.num_layers} layers, "
                     f"adamw: {len(ps)} leaves, "
                     f"{n_params} parameters, dtypes {dtypes}, one launch",
               library="torch._fused_adamw_, one call per dtype",
               targets_met={
                   "bound_share_ge_0.85": row["bound_share_of_ms"] >= 0.85})
    emit({"phase": "mamba2_update", **row})
    return row


def qwen2_phase(fa_rows, b1_resnet):
    """The qwen2-0.5b study, B1 on its tree, its step and profile; returns
    B1's row and the study's launch counts."""
    import torch_hpo_lm as lm_example
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.vocab_size) == (24, 896, 14, 2, 151936)
    launches, backend = lm_study(
        "lm_study", lambda: lm_example.make_backend(use_kernel=True,
                                                    **LM_FULL),
        LM_FULL["batch"], LM_FULL["seq_len"],
        fwd=("flash_attention_fwd",),
        bwd=("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
        model_fields={"d_model": cfg.d_model,
                      "heads": [cfg.num_heads, cfg.num_kv_heads],
                      "vocab": cfg.vocab_size})
    assert backend.task.cfg == cfg
    # 24 layers x (48 steps + 10 evaluations) forwards, 24 x 48 backwards,
    # all on the tensor cores (lm_study holds launches_tc to these)
    assert launches["flash_attention_fwd"] == 1392, launches
    assert launches["flash_attention_bwd_dq"] == 1152, launches
    assert launches["flash_attention_bwd_dkv"] == 1152, launches
    b1_row = lm_update_phase(backend, b1_resnet)
    b1_row["launches"] = launches["stacked_tree_update"]
    attn_ms = cfg.num_layers * sum(fa_rows[k]["ms"]
                                   for k in ("B2", "B3", "B4"))
    step_profile("lm_", cfg.name, backend, "adamw", 3e-4, n_chunk=4,
                 profile_steps=4,
                 tokens=LM_FULL["batch"] * LM_FULL["seq_len"],
                 port=("attention_kernels", attn_ms, "::fa_"))
    return b1_row, launches


# ------------------------------------------ 9. SSD kernels vs plain version
def ssd_work(B, nc, Q, H, P, N, e_x):
    """(flops, bytes) of B5 and B6 at one shape.  Flops: the products and
    the elementwise work each function needs, over the Q(Q+1)/2 pairs
    j <= i (above the diagonal everything is 0); cb = C·Bᵀ depends on no
    head, so it is formed once per cell.  B5 per cell: cb, 2TN; per head
    y = att·x, 2TP, and seg, exp, ·dt, ·cb, 4T.  B6 per cell: cb, 2TN, and
    dB = dcbᵀ·C, dC = dcb·B, 4TN; per head datt = g·xᵀ and dx = attᵀ·g,
    4TP, and seg, exp, att (2), dad, ddt (2), dseg, its row and column sums
    (2), the head sum of dcb (2), 12T.  Bytes at the tensors' dtypes, each
    input read once and each output written once."""
    T, cells = Q * (Q + 1) // 2, B * nc
    n_x, n_row, n_bc = cells * Q * H * P, cells * Q * H, cells * Q * N
    return {"B5": (cells * (2 * T * N + H * (2 * T * P + 4 * T)),
                   e_x * (2 * n_x + 2 * n_bc) + 4 * 2 * n_row),
            "B6": (cells * (6 * T * N + H * (4 * T * P + 12 * T)),
                   e_x * (3 * n_x + 4 * n_bc) + 4 * 4 * n_row)}


def ssd_inputs(B, nc, Q, H, P, N, dtype, model_decay, seed):
    """x, dt, ltT, B, C and a cotangent g on the card.  The JAX tests'
    small decays (|lt| <= 0.1 |N(0,1)|), or the model's at init: dt =
    softplus(N(0,1)), A = -exp(A_log) = -linspace(1, 16, H), so that
    cum falls to about -1,000 within a chunk of 128 and exp(cum_i -
    cum_j) above the diagonal overflows."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    x, g = rnd(B, nc, Q, H, P), rnd(B, nc, Q, H, P)
    Bm, Cm = rnd(B, nc, Q, N), rnd(B, nc, Q, N)
    dt = F.softplus(rnd(B, nc, Q, H))
    lt = (dt * -torch.linspace(1.0, 16.0, H)).movedim(-1, -2) \
        if model_decay else -rnd(B, nc, H, Q).abs() * 0.1
    return (x.to(DEV, dtype), dt.to(DEV), lt.contiguous().to(DEV),
            Bm.to(DEV, dtype), Cm.to(DEV, dtype), g.to(DEV, dtype))


def ssd_plain(x, dt, lt, Bm, Cm, g=None):
    """What the wrappers compute, through the plain versions: the same
    cumsum in torch (float64 on the CUDA-core route, float32 on the
    tensor cores), dltT as the route's kernel forms it."""
    from repro_torch.kernels import ssd_scan as ssk
    cum = ssk._cumsum(lt, ssk.fwd_route(x.dtype, x.shape[2], x.shape[4],
                                        Bm.shape[-1]))
    if g is None:
        return ssk.fwd_plain(x, dt, cum, Bm, Cm)
    return ssk.bwd_plain(x, dt, cum, Bm, Cm, g)


def ssd_phase(join_build):
    """B5 and B6 on the grid and at mamba2-2.7b's shape; returns their
    rows."""
    from repro_torch.kernels import ssd_scan as ssk
    build_s = join_build("ssd_scan")
    ssk._lib()                                  # load, check the tile size
    names = ("y", "dx", "ddt", "dlt", "dB", "dC")

    inputs, plain = ssd_inputs, ssd_plain

    def run(x, dt, lt, Bm, Cm, g):
        """B5 + B6 twice (required bit-equal; in bf16 both on the tensor
        cores, counted in ``launches_tc``, in f32 on the CUDA cores), and
        the plain versions on the same inputs; every output finite, shaped
        and typed alike.  In bf16, B5 and B6 are also run on the CUDA-core
        kernels they replace: returns their outputs too (None in f32)."""
        tc0 = (ssk.ssd_intra_fwd.launches_tc, ssk.ssd_intra_bwd.launches_tc)
        runs = [(ssk.ssd_intra_fwd(x, dt, lt, Bm, Cm),)
                + ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g) for _ in range(2)]
        bf16 = x.dtype == torch.bfloat16
        # every bf16 case here (grid, ragged, main shape) is in reach
        assert (ssk.fwd_route(x.dtype, x.shape[2], x.shape[4], Bm.shape[-1])
                == "wgmma") == bf16
        assert ssk.ssd_intra_fwd.launches_tc - tc0[0] == 2 * bf16, (
            "B5 took the wrong route", x.dtype)
        assert ssk.ssd_intra_bwd.launches_tc - tc0[1] == 2 * bf16, (
            "B6 took the wrong route", x.dtype)
        run.scratch_bytes = ssk.ssd_intra_bwd.scratch_bytes
        old = ((ssk.ssd_intra_fwd(x, dt, lt, Bm, Cm, route="simt"),)
               + ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g, route="simt")) \
            if bf16 else None
        want = (plain(x, dt, lt, Bm, Cm),) + plain(x, dt, lt, Bm, Cm, g)
        torch.cuda.synchronize()
        for name, a, b, c in zip(names, runs[0], runs[1], want):
            assert torch.equal(a, b), ("two launches differ", name)
            assert a.shape == c.shape and a.dtype == c.dtype, name
            assert bool(a.isfinite().all()) and bool(c.isfinite().all()), (
                "not finite", name)
        return runs[0], want, old

    def vs_replaced(outs, old, tol):
        """The tensor-core B5 and B6 against the CUDA-core kernels they
        replace: both are held to the plain version, so they agree within
        the same tolerance; returns the largest difference over the largest
        value, per kernel."""
        worst = {"B5": 0.0, "B6": 0.0}
        for name, a, b in zip(names, outs, old):
            key = "B5" if name == "y" else "B6"
            e, ok = within(a, b, tol, tol)
            assert ok, (f"tensor-core {key} disagrees with the CUDA-core "
                        f"{key}", name, e)
            worst[key] = max(worst[key], e / float(b.float().abs().max()))
        return worst

    err = {n: {"float32": 0.0, "bfloat16": 0.0} for n in names}
    cases, grid_vs_replaced = 0, {"B5": 0.0, "B6": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape in SSD_SHAPES + [SSD_RAGGED]:
            outs, want, old = run(*inputs(*shape, dtype, shape == SSD_RAGGED,
                                          seed=cases))
            if old is not None:
                for key, e in vs_replaced(outs, old, 2e-2).items():
                    grid_vs_replaced[key] = max(grid_vs_replaced[key], e)
            for name, a, b in zip(names, outs, want):
                # the JAX tests' tolerances: forward f32 2e-5, bf16 2e-2;
                # gradients 2e-3, and 2e-2 for a gradient rounded to bf16
                if name == "y":
                    tol = 2e-5 if dtype == torch.float32 else 2e-2
                else:
                    tol = 2e-3 if a.dtype == torch.float32 else 2e-2
                e, ok = within(a, b, tol, tol)
                err[name][dname] = max(err[name][dname], e)
                assert ok, ("SSD kernel disagrees with its plain version",
                            name, dname, shape, e)
            cases += 1

    # the main path's shape: one mamba2-2.7b layer's SSD at 1 x 2048 tokens
    # (16 chunks x 80 heads).  bf16 and f32 with the model's decays, which
    # the studies run and which would overflow above the diagonal (in f32
    # the CUDA-core kernels against the plain version's float64 cum); bf16
    # and f32 with the JAX tests' small decays, under which the chunk's
    # far corner (i = Q - 1, j = 0) carries weight (every element of B6's
    # sums across strips and passes counts).  bf16 outputs within one
    # bf16 ulp beyond 2^-16 of the tensor's largest value; f32 outputs
    # within 1e-5 of it
    Bs, nc, Q, H, P, N = (MAMBA[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    shape_s = f"B {Bs}, nc {nc}, Q {Q}, H {H}, P {P}, N {N}"
    f32_rule = ("1e-5 x scale",
                lambda diff, b, scale: float(diff.max()) <= 1e-5 * scale)
    main, cum_min, far_decay = {}, {}, {}
    main_vs_replaced, scratch = {}, {}
    for case, dtype, model_decay, seed in (
            ("bf16, model decays", torch.bfloat16, True, 99),
            ("bf16, small decays", torch.bfloat16, False, 98),
            ("f32, model decays", torch.float32, True, 96),
            ("f32, small decays", torch.float32, False, 97)):
        x, dt, lt, Bm, Cm, g = inputs(Bs, nc, Q, H, P, N, dtype,
                                      model_decay, seed)
        cum = torch.cumsum(lt, -1)
        cum_min[case] = float(cum.min())
        # the decay from a chunk's first position to its last, per (cell,
        # head): its smallest and its median
        far = torch.exp(cum[..., -1] - cum[..., 0]).flatten()
        far_decay[case] = {"min": float(far.min()),
                           "median": float(far.median())}
        outs, want, old = run(x, dt, lt, Bm, Cm, g)
        for name, a, b in zip(names, outs, want):
            row, ok = at_scale(a, b, f32_rule)
            main.setdefault(name, {})[case] = row
            assert ok, ("SSD kernel disagrees with its plain version at the "
                        "main path's shape", case, name, row)
        if old is not None:
            main_vs_replaced[case] = vs_replaced(outs, old, 2e-2)
            scratch[case] = run.scratch_bytes
        del outs, want, old
    assert min(cum_min["bf16, model decays"],              # overflow in reach
               cum_min["f32, model decays"]) < -500.0, cum_min
    assert far_decay["f32, small decays"]["median"] > 2 ** -16, far_decay

    # timed on the study's own inputs: bf16, the model's decays
    x, dt, lt, Bm, Cm, g = inputs(Bs, nc, Q, H, P, N, torch.bfloat16, True,
                                  99)
    repo_fwd_flops = Bs * nc * H * (2 * Q * Q * (N + P) + 6 * Q * Q)
    work = ssd_work(Bs, nc, Q, H, P, N, x.element_size())
    fns = {
        "B5": (ssk.ssd_intra_fwd,
               lambda: ssk.ssd_intra_fwd(x, dt, lt, Bm, Cm),
               lambda: plain(x, dt, lt, Bm, Cm), repo_fwd_flops),
        "B6": (ssk.ssd_intra_bwd,
               lambda: ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g),
               lambda: plain(x, dt, lt, Bm, Cm, g), 3 * repo_fwd_flops)}
    rows = {}
    for key, (wrapper, kern, plain_fn, repo_flops) in fns.items():
        flops, nbytes = work[key]
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        outs_of = names[:1] if key == "B5" else names[1:]
        rows[key] = {
            "name": wrapper.__name__, "route": "cuda", "source": SSD_SOURCE,
            "replaces": SSD_REPLACES[key], "launches": None,
            "max_abs_err": max([err[n][d] for n in outs_of for d in err[n]]
                               + [r["max_abs_err"] for n in outs_of
                                  for r in main[n].values()]),
            "ms": time_ms(kern, reps=20, warm=3),
            "plain_ms": time_ms(plain_fn, reps=10, warm=2),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "library": "none: no single PyTorch call computes this function",
            "shape": shape_s + ", bf16, the model's decays",
            "flops": flops, "bytes": nbytes,
            # benchmarks/bench_kernels.py:77-85: B·nc·H·(2Q²(N+P) + 6Q²)
            # forward, 3x backward — whole (Q, Q) tiles, cb per head
            "flops_repo_numerator": repo_flops,
            "max_abs_err_by_dtype": {n: err[n] for n in outs_of},
            "cases": cases,
            "main_shape_vs_plain": {n: main[n] for n in outs_of}}
    # B5 and B6 in bf16 run on the tensor cores (ssd_fwd_tc, ssd_bwd_tc);
    # the CUDA-core kernels they replace (ssd_fwd, ssd_bwd) are timed
    # beside them in this run
    le = lambda t, limit: isinstance(t, float) and t <= limit
    # (each device time is divided by the calls of a kernel that one call
    # launches once: the profiler can drop whole calls' records)
    for key, kernel, replaced, replaced_kernel in (
            ("B5", "ssd_fwd",
             lambda: ssk.ssd_intra_fwd(x, dt, lt, Bm, Cm, route="simt"),
             "ssd_fwd_simt_kernel"),
            ("B6", "ssd_bwd",
             lambda: ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g, route="simt"),
             "ssd_bwd_simt_kernel")):
        kern = fns[key][1]
        rows[key].update(
            route_bf16=f"wgmma ({kernel}_tc)", route_f32=f"simt ({kernel})",
            device_ms=device_ms(kern, expect=f"{kernel}_tc_kernel"),
            wrapper_host_us=launch_us(kern),
            replaced_cuda_core_ms=time_ms(replaced, reps=10, warm=2),
            replaced_cuda_core_device_ms=device_ms(replaced, reps=5,
                                                   expect=replaced_kernel),
            heads_per_block=ssk.head_groups(Bs * nc, H),
            grid_vs_replaced_err_over_scale=grid_vs_replaced[key],
            main_shape_vs_replaced_err_over_scale={
                case: e[key] for case, e in main_vs_replaced.items()})
    rows["B5"]["targets_met"] = {
        "device_ms_le_0.05": le(rows["B5"]["device_ms"], 0.05),
        "ms_le_0.08": rows["B5"]["ms"] <= 0.08}
    rows["B6"].update(
        scratch_bytes=scratch["bf16, model decays"],
        replaced_scratch_bytes=Bs * nc * H * Q * Q * 4,
        targets_met={"ms_le_0.15": rows["B6"]["ms"] <= 0.15,
                     "scratch_le_10.5MB":
                         scratch["bf16, model decays"] <= 10.5e6})
    tc_keys = ("device_ms", "wrapper_host_us", "replaced_cuda_core_ms",
               "replaced_cuda_core_device_ms", "heads_per_block",
               "grid_vs_replaced_err_over_scale",
               "main_shape_vs_replaced_err_over_scale", "targets_met")
    emit({"phase": "ssd_kernels", "build_seconds": build_s,
          "cases": cases, "bit_equal_twice": True, "all_finite": True,
          "max_abs_err": err, "shape": shape_s, "cum_min": cum_min,
          "far_corner_decay_min": far_decay, "main_shape_vs_plain": main,
          "b5_tensor_cores": {k: rows["B5"][k] for k in tc_keys},
          "b6_tensor_cores": {k: rows["B6"][k] for k in tc_keys + (
              "scratch_bytes", "replaced_scratch_bytes")},
          "timing": {key: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "flops", "bytes")}
                     for key, r in rows.items()}})
    return rows


def ssd_f32_phase():
    """The float32 SSD path at the shape of the benchmark's mamba2-2.7b-f32
    configuration (B 2, S 1,024, Q 128, H 80, P 64, N 128), on inputs
    under which a chunk's cumulative log-decay reaches about -1,000: the
    scan (``ssd_chunked``) by the kernel route (B5 / B6 on the CUDA cores)
    and by the plain route, y and every gradient within 2e-6 (relative L2)
    of the plain route in float64, where the plain route with TF32
    products, the precision below, reads above 2e-5 on each; then one
    training step of a float32 layer at the published widths with every
    B5 / B6 launch on the CUDA-core kernels and no fallback."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import LM
    from repro_torch.train.torch_trainer import value_and_grad
    B, S, Q, H, P, N = 2, 1024, 128, 80, 64, 128
    tol = 2e-6
    names = ("y", "dx", "ddt", "dA_log", "dB", "dC")
    gen = torch.Generator().manual_seed(20261018)
    leaves = [F.silu(torch.randn((B, S, H, P), generator=gen)),
              F.softplus(torch.randn((B, S, H), generator=gen)),
              torch.log(torch.linspace(1.0, 16.0, H)),
              F.silu(torch.randn((B, S, N), generator=gen)),
              F.silu(torch.randn((B, S, N), generator=gen))]
    g = torch.randn((B, S, H, P), generator=gen).to(DEV)
    leaves = [t.to(DEV) for t in leaves]

    def scan(use_kernel, dtype):
        ins = [t.to(dtype).requires_grad_(True) for t in leaves]
        x, dt, A_log, Bm, Cm = ins
        y = ssd_chunked(x, dt, -torch.exp(A_log), Bm, Cm, Q,
                        use_kernel=use_kernel)[0]
        return [y.detach()] + list(torch.autograd.grad(y, ins, g.to(dtype)))

    def rel(got, want):
        return {n: float((a.double() - b).norm() / b.norm())
                for n, a, b in zip(names, got, want)}

    launches = lambda: [(w.launches, w.launches_tc)
                        for w in (ssk.ssd_intra_fwd, ssk.ssd_intra_bwd)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want = scan(False, torch.float64)
        n0, fb0 = launches(), kops.KERNEL_STATS.fallbacks
        errs = {"kernel": rel(scan(True, torch.float32), want)}
        n1 = launches()
        errs["plain"] = rel(scan(False, torch.float32), want)
        torch.backends.cuda.matmul.allow_tf32 = True
        errs["plain_tf32"] = rel(scan(False, torch.float32), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for route in ("kernel", "plain"):
        assert all(e <= tol for e in errs[route].values()), (route, errs)
    assert all(e > 10 * tol for e in errs["plain_tf32"].values()), errs
    assert [(a1 - a0, t1 - t0) for (a0, t0), (a1, t1) in zip(n0, n1)] == \
        [(1, 0), (1, 0)], (n0, n1)
    del want, leaves, g
    free()

    # one step of a float32 layer at the published widths
    cfg = dataclasses.replace(mamba2_cut(1), dtype="float32")
    params = LM(cfg).init(0, device=DEV)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S),
        generator=torch.Generator().manual_seed(7)).to(DEV)}
    n0 = launches()
    (loss, _), grads = value_and_grad(LM(cfg, use_kernel=True).loss, params,
                                      batch)
    (fwd, fwd_tc), (bwd, bwd_tc) = [(a1 - a0, t1 - t0) for (a0, t0), (a1, t1)
                                    in zip(n0, launches())]
    assert bool(torch.isfinite(loss)), float(loss)
    assert fwd >= 1 and bwd >= 1 and fwd_tc == bwd_tc == 0, n0
    assert kops.KERNEL_STATS.fallbacks == fb0, kops.KERNEL_STATS.reasons
    emit({"phase": "ssd_f32", "shape": f"B {B}, S {S}, Q {Q}, H {H}, P {P}, "
          f"N {N}, float32", "rel_l2_vs_float64": errs, "tolerance": tol,
          "tf32_above": 10 * tol, "step_launches": {
              "ssd_intra_fwd": fwd, "ssd_intra_bwd": bwd,
              "tensor_core": fwd_tc + bwd_tc,
              "fallbacks": kops.KERNEL_STATS.fallbacks - fb0},
          "step_loss": float(loss)})
    del params, grads


# -------------------------------------------- 10-11. mamba2-2.7b: the SSD path
def mamba2_cut(layers):
    """mamba2-2.7b's published config cut to ``layers`` layers."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-2.7b"), num_layers=layers)


def mamba2_state_bytes(cfg):
    """Bytes of a mamba2 AdamW training state: params, m and v (bf16 but
    for the f32 ``A_log`` / ``dt_bias``)."""
    f32 = 2 * cfg.num_layers * cfg.ssm_heads
    return 3 * (2 * (cfg.param_count() - f32) + 4 * f32)


def mamba2_study_phase(root):
    """The mamba2-2.7b study at full width and ``MAMBA_STUDY["layers"]``
    layers, its checkpoints on a directory store under ``root`` (1.7 GB
    each at 4 layers: the card holds the running state only); returns its
    launch counts and the trainer (its parameters drawn)."""
    import torch_hpo_lm as lm_example
    from repro_torch.configs import get_config
    from repro_torch.train.checkpoint import CheckpointStore
    cfg = get_config("mamba2-2.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size,
            cfg.dtype, cfg.param_count()) == (
        64, 2560, 5120, 80, 64, 128, 128, 50280, "bfloat16", 2_702_235_136)
    launches, backend = lm_study(
        "mamba2_study", lambda: lm_example.make_backend(
            arch="mamba2-2.7b", use_kernel=True, **MAMBA_STUDY),
        MAMBA_STUDY["batch"], MAMBA_STUDY["seq_len"],
        fwd=("ssd_intra_fwd",), bwd=("ssd_intra_bwd",),
        model_fields={"published_layers": cfg.num_layers,
                      "published_parameters": cfg.param_count(),
                      "d_model": cfg.d_model, "ssd_heads": cfg.ssm_heads,
                      "state": cfg.ssm_state, "chunk": cfg.ssm_chunk,
                      "vocab": cfg.vocab_size,
                      "state_bytes": mamba2_state_bytes(
                          mamba2_cut(MAMBA_STUDY["layers"])),
                      "store": "CheckpointStore(directory, "
                               "read_cache_entries=0, serializer_procs="
                               f"{os.cpu_count()})"},
        make_store=lambda mode: CheckpointStore(
            os.path.join(root, "mamba2_" + mode), read_cache_entries=0,
            serializer_procs=os.cpu_count()),
        verify=1)
    assert backend.task.cfg.num_layers == MAMBA_STUDY["layers"]
    return launches, backend


def mamba2_step_phase(ssd_rows, backend):
    """mamba2-2.7b on the study's trainer (its parameters drawn already):
    step, update and profile, then B1 on its tree; returns B1's row
    there."""
    cfg = backend.task.cfg
    assert cfg.param_count() == mamba2_cut(cfg.num_layers).param_count()
    ssd_ms = cfg.num_layers * (ssd_rows["B5"]["ms"] + ssd_rows["B6"]["ms"])
    step_profile("mamba2_", cfg.name, backend, "adamw", 3e-4, n_chunk=4,
                 profile_steps=2, tokens=2048,
                 port=("ssd_kernels", ssd_ms, "::ssd_"))
    free()
    return mamba2_update_phase(backend)


# ------------------------------------------ 12. B7: sibling groups, folded
@contextlib.contextmanager
def no_vmap_fallback():
    """functorch's warning for an op without a batching rule (a hidden
    per-member loop: "There is a performance drop ...") switched on inside
    the block, and none allowed."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    loops = [str(w.message)[:200] for w in caught
             if "performance drop" in str(w.message)]
    assert not loops, ("an op ran as a per-member loop under vmap", loops)


def launched(fn):
    """``fn()`` and the launches of B2–B6 it made (only the non-zero)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssk
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, ssk.ssd_intra_fwd,
                ssk.ssd_intra_bwd)
    n0 = [c.launches for c in counters]
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches - n for c, n in zip(counters, n0)
                 if c.launches != n}


def fold_phase():
    """B7 on the card: B2–B6 in bf16 at the main paths' shapes with
    ``FOLD_M`` members, through the raw launchers' vmap rules — one folded
    launch per kernel, bit-equal to ``FOLD_M`` separate launches and held
    to the plain version by each kernel's rule at the main shape — and
    ``vmap(grad)`` through ``ops.flash_attention`` with an unbatched KV,
    bit-equal to each member's solo gradients, one note and one launch of
    each of B2, B3, B4.  Returns the rows per kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssk
    M, bf16 = FOLD_M, torch.bfloat16
    gen = torch.Generator().manual_seed(31)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(DEV, bf16)
    fold = lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])
    rows = {}

    # attention: qwen2-0.5b's shape, M members of B 4 -> one launch of B 8
    B, S, Hq, Hkv, hd = (QWEN[x] for x in ("B", "S", "Hq", "Hkv", "hd"))
    q, do = rnd(M, B, S, Hq, hd), rnd(M, B, S, Hq, hd)
    k, v = rnd(M, B, S, Hkv, hd), rnd(M, B, S, Hkv, hd)
    (out, lse), n = launched(lambda: torch.func.vmap(
        lambda *a: ops._FaFwd.apply(*a, True, 0))(q, k, v))
    assert n == {"flash_attention_fwd": 1}, n
    solo = [fa.flash_attention_fwd(q[m], k[m], v[m], return_lse=True)
            for m in range(M)]
    assert all(torch.equal(out[m], solo[m][0])
               and torch.equal(lse[m], solo[m][1]) for m in range(M)), \
        "B2: the folded launch differs from the members' own"
    del solo
    qf, kf, vf = (fold(x).float() for x in (q, k, v))
    out_row, ok = p_rounding_rule(fold(out), fa.fwd_plain(qf, kf, vf)[0],
                                  fa.fwd_plain(qf, kf, vf.abs())[0])
    assert ok, ("folded B2 disagrees with its plain version", out_row)
    del qf, kf, vf
    lse_row, ok = at_scale(fold(lse), fa.fwd_plain(fold(q), fold(k),
                                                   fold(v))[1],
                           ("atol 2e-5 + rtol 2e-5",
                            lambda diff, b, scale: bool(
                                (diff <= 2e-5 + 2e-5 * b.abs()).all())))
    assert ok, ("folded B2 lse disagrees with its plain version", lse_row)
    rows["B2"] = {"vs_plain": {"out": out_row, "lse": lse_row}}

    grads, n = launched(lambda: torch.func.vmap(
        lambda *a: ops._FaBwd.apply(*a, True, 0))(q, k, v, out, lse, do))
    assert n == {"flash_attention_bwd_dq": 1,
                 "flash_attention_bwd_dkv": 1}, n
    for m in range(M):
        for a, b in zip(grads, fa.flash_attention_bwd(q[m], k[m], v[m],
                                                      out[m], lse[m],
                                                      do[m])):
            assert torch.equal(a[m], b), \
                "B3 / B4: the folded launch differs from the members' own"
    del grads
    # B3 and B4 alone: the folded wrapper calls against the members' own
    delta = (do.float() * out.float()).sum(-1).transpose(-1, -2).contiguous()
    args = [fold(x) for x in (q, k, v, do, lse, delta)]
    got = (fa.flash_attention_bwd_dq(*args),) \
        + fa.flash_attention_bwd_dkv(*args)
    for m in range(M):
        own = (fa.flash_attention_bwd_dq(q[m], k[m], v[m], do[m], lse[m],
                                         delta[m]),) \
            + fa.flash_attention_bwd_dkv(q[m], k[m], v[m], do[m], lse[m],
                                         delta[m])
        for a, b in zip(got, own):
            assert torch.equal(a[m * B:(m + 1) * B], b), \
                "B3 / B4 alone: the folded launch differs"
    vs_plain, ok = ds_rounding_rule(fa, *args, got,
                                    dict(causal=True, window=0))
    assert ok, ("folded B3 / B4 disagree with their plain versions",
                vs_plain)
    rows["B3"] = {"vs_plain": {"dq": vs_plain["dq"]}}
    rows["B4"] = {"vs_plain": {x: vs_plain[x] for x in ("dk_h", "dv_h")}}
    del got, args, delta, out, lse, do

    # vmap(grad) through the binding with one KV for every member: one
    # note, one launch each, each member's gradients its solo ones
    k0, v0 = k[0].clone(), v[0].clone()
    w = torch.randn((B, S, Hq, hd), generator=gen).to(DEV)
    loss = lambda q_, k_, v_: (ops.flash_attention(q_, k_, v_).float()
                               * w).sum()
    calls0 = ops.KERNEL_STATS.calls
    with no_vmap_fallback():
        vg, n = launched(lambda: torch.func.vmap(
            torch.func.grad(loss, argnums=(0, 1, 2)),
            in_dims=(0, None, None))(q, k0, v0))
    assert ops.KERNEL_STATS.calls - calls0 == 1
    assert n == {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                 "flash_attention_bwd_dkv": 1}, n
    for m in range(M):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q[m], k0, v0)]
        for a, b in zip(vg, torch.autograd.grad(loss(*leaves), leaves)):
            assert torch.equal(a[m], b), \
                "vmap(grad) differs from the member's solo gradients"
    del vg, q, k, v, k0, v0, w

    # SSD: mamba2-2.7b's shape, M members of B 1 -> one launch of B 2, the
    # heads grouped as one member's launch groups them (G 10)
    Bs, nc, Q, H, P, N = (MAMBA[x] for x in ("B", "nc", "Q", "H", "P", "N"))
    per = [ssd_inputs(Bs, nc, Q, H, P, N, bf16, True, 90 + m)
           for m in range(M)]
    x, dt, lt, Bm, Cm, g = (torch.stack(t) for t in zip(*per))
    y, n = launched(lambda: torch.func.vmap(ops._SSDFwd.apply)(
        x, dt, lt, Bm, Cm))
    assert n == {"ssd_intra_fwd": 1}, n
    grads, n = launched(lambda: torch.func.vmap(ops._SSDBwd.apply)(
        x, dt, lt, Bm, Cm, g))
    assert n == {"ssd_intra_bwd": 1}, n
    names = ("y", "dx", "ddt", "dlt", "dB", "dC")
    for m in range(M):
        own = (ssk.ssd_intra_fwd(*per[m][:5]),) + ssk.ssd_intra_bwd(*per[m])
        for name, a, b in zip(names, (y,) + grads, own):
            assert torch.equal(a[m], b), (
                f"{name}: the folded launch differs from the members' own")
    want = (ssd_plain(*(fold(t) for t in (x, dt, lt, Bm, Cm))),) \
        + ssd_plain(*(fold(t) for t in (x, dt, lt, Bm, Cm, g)))
    f32_rule = ("1e-5 x scale",
                lambda diff, b, scale: float(diff.max()) <= 1e-5 * scale)
    ssd_rows = {}
    for name, a, b in zip(names, (y,) + grads, want):
        row, ok = at_scale(fold(a), b, f32_rule)
        assert ok, ("folded SSD disagrees with its plain version", name, row)
        ssd_rows[name] = row
    rows["B5"] = {"vs_plain": {"y": ssd_rows["y"]}}
    rows["B6"] = {"vs_plain": {k_: ssd_rows[k_] for k_ in names[1:]}}
    emit({"phase": "fold", "members": M,
          "attention_shape": f"{M} x (B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, "
                             f"hd {hd}), causal, bf16",
          "ssd_shape": f"{M} x (B {Bs}, nc {nc}, Q {Q}, H {H}, P {P}, "
                       f"N {N}), bf16, the model's decays",
          "ssd_heads_per_block": ssk.head_groups(Bs * nc, H),
          "launches_per_group_call": 1,
          "folded_bit_equal_to_separate_launches": True,
          "vmap_grad_broadcast_kv_bit_equal_to_solo": True,
          "notes_per_group_call": 1, "kernels": rows})
    return rows


def group_record(backend):
    """Record every batched call the dispatcher makes of ``backend``, as
    (members, the steps of each stage level)."""
    groups = []
    stages, chains = backend.run_stages_batched, backend.run_chains_batched

    def run_stages_batched(states, ctxs):
        groups.append((len(ctxs), [ctxs[0].stop - ctxs[0].start]))
        return stages(states, ctxs)

    def run_chains_batched(states, chains_):
        groups.append((len(chains_), [c.stop - c.start for c in chains_[0]]))
        return chains(states, chains_)

    backend.run_stages_batched = run_stages_batched
    backend.run_chains_batched = run_chains_batched
    return groups


def launch_steps(stats, groups):
    """Steps that launch kernels: a group level of M members and n steps
    trains M·n member-steps in n launches of each kernel.  The recorded
    groups are held to ``EngineStats`` (every batched call counted in
    ``batched_groups``, its stages in ``batched_stages``: no group fell
    back to its members one by one)."""
    assert len(groups) == stats.batched_groups, (groups, stats.batched_groups)
    assert sum(m * len(lv) for m, lv in groups) == stats.batched_stages
    return stats.steps_run - sum((m - 1) * sum(lv) for m, lv in groups)


def metric_diff(a, b):
    """The largest |difference| of any reported metric of two studies'
    histories (same (trial, step) keys, same names)."""
    assert set(a) == set(b), "the studies reported different results"
    worst = 0.0
    for key, m in a.items():
        assert set(m) == set(b[key])
        for name, x in m.items():
            assert x == x and b[key][name] == b[key][name], "NaN"
            worst = max(worst, abs(x - b[key][name]))
    return worst


def group_vs_solo(phase, runs, metric_tol, fields, best_margin=False):
    """The checks the group studies share: grouped ≥ 1 batched group,
    solo none; the same ``steps_run`` and best trial; every reported metric
    bit-equal or within ``metric_tol``; prints the phase's row.  With
    ``best_margin`` the best trials may differ only where the solo study's
    best score stands above its best score of the grouped study's best
    trial by no more than the largest metric difference of the two runs
    (which trial is best is then decided below the grouped tier's
    numerical difference from solo); the margin is printed."""
    g, s = runs[True], runs[False]
    assert g["stats"].batched_groups >= 1 and s["stats"].batched_groups == 0
    assert g["stats"].steps_run == s["stats"].steps_run, (
        g["stats"].steps_run, s["stats"].steps_run)
    worst = metric_diff(g["history"], s["history"])
    assert worst <= metric_tol, (worst, metric_tol)
    margin = s["best_score"] - max(      # the tuners score val_acc
        m["val_acc"] for (tid, _), m in s["history"].items()
        if tid == g["best"])
    if best_margin and g["best"] != s["best"]:
        assert margin <= worst, (g["best"], s["best"], margin, worst)
    else:
        assert g["best"] == s["best"], (g["best"], s["best"])
    emit({"phase": phase, **fields,
          "modes": {("grouped" if k else "solo"): {
              "batch_siblings": k, "steps_run": r["stats"].steps_run,
              "launch_steps": r["launch_steps"],
              "batched_groups": r["stats"].batched_groups,
              "batched_stages": r["stats"].batched_stages,
              "groups": r["groups"], "evaluations": r["evals"],
              "chain_fused_stages": r["stats"].chain_fused_stages,
              "launches": r["launches"], "kernel_calls": r["calls"],
              "kernel_fallbacks": r["fallbacks"],
              "wall_seconds": r["wall"],
              "peak_device_memory_gib": r["peak"] / 2 ** 30}
              for k, r in runs.items()},
          "wall_seconds_grouped_over_solo": g["wall"] / s["wall"],
          "same_steps_run": True, "same_best_trial": g["best"] == s["best"],
          "best_trial": g["best"], "best_trial_solo": s["best"],
          "solo_best_score_margin": margin,
          "all_reported_metrics_bit_equal": g["history"] == s["history"],
          "max_reported_metric_difference": worst,
          "metric_tolerance": metric_tol,
          "vmap_fallback_warnings": 0})
    return g["launches"]


def run_group_study(example, backend, siblings, counters, keep=False,
                    looped=False, **kw):
    """One study of ``example`` over its ``group_space`` (stage-based),
    every counter zeroed just before and read just after, with
    ``batch_siblings=siblings`` on the vectorised tier (``looped``: the
    looped one); returns its record (with ``keep``, the trees its store
    holds at the end under ``held``)."""
    from repro_torch.kernels import ops as kops
    groups = group_record(backend)
    free()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:                          # counts to 0 just before
        c.launches = 0
    kops.reset_kernel_stats()
    evals0 = backend.evaluations
    with no_vmap_fallback():
        stats, tuner, store, wall = example.run_study(
            backend, True, batch_siblings=siblings,
            space_fn=example.group_space, **kw)
        torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}   # just after
    calls, fallbacks = kops.KERNEL_STATS.snapshot()
    assert tuner.is_done() and tuner.best is not None
    assert fallbacks == 0 and stats.kernel_fallbacks == 0
    assert store.pending_writes == 0
    if siblings:
        assert backend.vectorize_groups != looped
    rec = dict(stats=stats, history=tuner.history, best=tuner.best.trial_id,
               best_score=tuner.best_score,
               wall=wall, peak=torch.cuda.max_memory_allocated(),
               launches=launches, calls=calls, fallbacks=fallbacks,
               groups=list(groups), evals=backend.evaluations - evals0,
               launch_steps=launch_steps(stats, groups))
    if keep:
        rec["held"] = held_trees(store)
    if hasattr(example, "drop_checkpoints"):
        example.drop_checkpoints(store)
    del store, tuner
    del backend.run_stages_batched, backend.run_chains_batched
    return rec


def resnet_group_study_phase():
    """ResNet56's SHA study over ``group_space`` (2 workers), stage-based,
    with and without sibling groups in one call: one B1 launch per group
    step, so B1 = steps − Σ (members − 1) × group steps; returns B1's
    launches in the grouped run."""
    import torch_hpo_resnet as example
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    runs = {}
    for siblings in (False, True):
        backend = example.make_backend(use_kernel=True, **RESNET_FULL)
        runs[siblings] = run_group_study(
            example, backend, siblings,
            (stacked_tree_update, stacked_leaf_update),
            batch=RESNET_FULL["batch"], name="resnet56")
        del backend
    for r in runs.values():
        assert r["launches"] == {"stacked_tree_update": r["launch_steps"],
                                 "stacked_leaf_update": 0}, r["launches"]
        assert r["calls"] == r["launch_steps"]
    # f32; a grouped convolution and batched products sum in another order
    # than the solo ones, and a reported accuracy moves in steps of 1/512
    return group_vs_solo("resnet_group_study", runs, 5e-3, {
        "model": "ResNet(n=9, width=16)", "batch": RESNET_FULL["batch"],
        "space": "examples/torch_hpo_resnet.py::group_space",
        "expected": "B1 = launch_steps = steps_run - sum over groups of "
                    "(members - 1) x group steps"})


def lm_group_study_phase():
    """qwen2-0.5b's SHA study over ``group_space``, stage-based, with and
    without sibling groups in one call, on one trainer: B2 = 24 ×
    (launch steps + evaluations), B3 = B4 = 24 × launch steps, all on the
    tensor cores, B1 = launch steps; returns the grouped run's launches,
    the trainer (its parameters drawn) and the grouped run's record, with
    the trees its store held at the end (for ``lm_group_degraded``)."""
    import torch_hpo_lm as example
    backend = example.make_backend(use_kernel=True, **LM_FULL)
    backend.init_state()                       # the draw, outside the runs
    L = backend.task.cfg.num_layers
    counters = lm_counters()
    runs = {}
    for siblings in (False, True):
        # the grouped run's held trees stay for lm_group_degraded
        runs[siblings] = lm_group_run(example, backend, siblings, counters,
                                      keep=siblings)
    # bf16 weights: a batched product rounds its f32 sums to bf16 where
    # the solo product does, from sums in another order
    return group_vs_solo("lm_group_study", runs, 2e-2, {
        "model": "qwen2-0.5b", "dtype": "bfloat16", "layers": L,
        "batch": LM_FULL["batch"], "seq_len": LM_FULL["seq_len"],
        "space": "examples/torch_hpo_lm.py::group_space",
        "expected": "B1 = n, B2 = 24 x (n + evaluations), B3 = B4 = 24 x n,"
                    " n = launch_steps = steps_run - sum over groups of "
                    "(members - 1) x group steps"}), backend, runs[True]


def lm_counters():
    """The launch counters of every port kernel an LM study can reach."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    return (stacked_tree_update, stacked_leaf_update,
            fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv, ssk.ssd_intra_fwd,
            ssk.ssd_intra_bwd)


def lm_group_run(example, backend, siblings, counters, **kw):
    """One qwen2-0.5b group study by :func:`run_group_study`, its launches
    held exact: B1 = n, B2 = L × (n + evaluations), B3 = B4 = L × n, all
    on the tensor cores, n the steps that launch (the vectorised tier
    launches once per group step, the looped tier once per member-step)."""
    L = backend.task.cfg.num_layers
    tc = counters[2:5]
    tc0 = [c.launches_tc for c in tc]
    r = run_group_study(example, backend, siblings, counters,
                        batch=LM_FULL["batch"], name="qwen2-0.5b", **kw)
    n = (r["launch_steps"] if backend.vectorize_groups
         else r["stats"].steps_run)
    e = r["evals"]
    assert r["launches"] == {
        "stacked_tree_update": n, "stacked_leaf_update": 0,
        "flash_attention_fwd": L * (n + e),
        "flash_attention_bwd_dq": L * n, "flash_attention_bwd_dkv": L * n,
        "ssd_intra_fwd": 0, "ssd_intra_bwd": 0}, (r["launches"], n, e)
    assert [c.launches_tc - t for c, t in zip(tc, tc0)] == [
        L * (n + e), L * n, L * n]
    assert r["calls"] == n + L * (n + e)
    return r


# ------------------------------- 19-21. the fault plane and session snapshots
# EngineStats fields that count (the wall-derived ones — gpu_seconds, the
# clock, the timers — differ run to run on a wall-clock trainer)
COUNT_FIELDS = ("steps_run", "stages_run", "evals_run", "ckpt_saves",
                "ckpt_loads", "ckpt_misses", "ckpt_evictions",
                "stage_failures", "stage_retries", "workers_quarantined",
                "groups_degraded", "faults_injected", "kernel_calls",
                "kernel_fallbacks", "chain_fused_stages", "batched_groups")
# the ResNet56 study's fault schedule: every kind at rates that fire
# several times in its few units of work; max_faults ≤ max_stage_retries
# with one-op outages, so no unit can exhaust its retries whatever order
# the wall-clock scheduler runs the units in
FAULT_SEED = 13
FAULT_RATES = dict(stage_fault_rate=0.25, crash_rate=0.25, outage_rate=0.1,
                   outage_ops=1, max_faults=8)
AUTO_SNAPSHOT_EVERY = 0.5          # virtual seconds (the clock is walls)


def counts(stats):
    return {k: getattr(stats, k) for k in COUNT_FIELDS}


def device_steps(backend):
    """Count the training steps ``backend`` computes (a failed attempt's
    too: an outage on a boundary's put comes after its chain ran); returns
    the live count ``{"steps": n}``."""
    seen = {"steps": 0}
    chain, stage = backend.run_chain, backend.run_stage

    def run_chain(state, ctxs):
        seen["steps"] += sum(c.stop - c.start for c in ctxs)
        return chain(state, ctxs)

    def run_stage(state, ctx):
        seen["steps"] += ctx.stop - ctx.start
        return stage(state, ctx)

    backend.run_chain, backend.run_stage = run_chain, run_stage
    return seen


def held_trees(store):
    """``{cid: tree}`` of every checkpoint ``store`` holds."""
    return {cid: store.get(cid) for cid in store.committed_ids()}


def trees_bit_equal(a, b):
    """The dispatcher's own bit-pattern comparison of two trees."""
    from repro_torch.core.engine.dispatch import _no_leaf, _same_bits
    from repro_torch.utils.tree import tree_leaves, tree_map
    return (tree_map(_no_leaf, a) == tree_map(_no_leaf, b)
            and all(_same_bits(x, y)
                    for x, y in zip(tree_leaves(a), tree_leaves(b))))


def held_equal(a, b):
    """Two studies' held checkpoints: the same cids, each bit-equal."""
    assert set(a) == set(b), (sorted(set(a) ^ set(b)))
    assert a, "no checkpoint held"
    return all(trees_bit_equal(a[c], b[c]) for c in a)


def held_max_diff(a, b):
    """The largest |difference| of any tensor leaf of two studies' held
    checkpoints (the same cids)."""
    from repro_torch.utils.tree import tree_leaves
    assert set(a) == set(b) and a
    worst = 0.0
    for cid in a:
        for x, y in zip(tree_leaves(a[cid]), tree_leaves(b[cid])):
            if isinstance(x, torch.Tensor):
                d = (x.to(DEV).float() - y.to(DEV).float()).abs().max()
                worst = max(worst, float(d))
    return worst


def fault_plane_phase():
    """ResNet56's SHA study (one worker, the memory tier, the chain-fused
    tier, no groups) fault-free and under the seeded schedule: faults
    fired and retried, every held checkpoint and every reported metric
    bit-equal, the same best trial, B1 = the steps the device computed;
    returns B1's launches in both runs."""
    import torch_hpo_resnet as example
    from repro_torch.core.faults import FaultInjector
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    runs = {}
    for faulty in (False, True):
        backend = example.make_backend(use_kernel=True, **RESNET_FULL)
        computed = device_steps(backend)
        inj = FaultInjector(FAULT_SEED, **FAULT_RATES) if faulty else None
        kops.reset_kernel_stats()
        stacked_tree_update.launches = 0        # counts to 0 just before
        stacked_leaf_update.launches = 0
        stats, tuner, store, wall = example.run_study(
            backend, True, batch=RESNET_FULL["batch"], n_workers=1,
            name="resnet56", batch_siblings=False, fault_injector=inj)
        torch.cuda.synchronize()
        launches = stacked_tree_update.launches  # ... and read just after
        leaf_launches = stacked_leaf_update.launches
        calls, fallbacks = kops.KERNEL_STATS.snapshot()
        assert tuner.is_done() and tuner.best is not None
        assert fallbacks == 0 and stats.kernel_fallbacks == 0
        assert leaf_launches == 0, leaf_launches
        assert launches == calls == stats.kernel_calls == computed["steps"], (
            launches, calls, stats.kernel_calls, computed["steps"])
        assert stats.chain_fused_stages > 0 and store.pending_writes == 0
        runs[faulty] = dict(stats=stats, tuner=tuner, wall=wall, inj=inj,
                            held=held_trees(store), launches=launches)
    ref, got = runs[False], runs[True]
    inj, st = got["inj"], got["stats"]
    assert inj.injected > 0 and st.faults_injected == inj.injected
    assert st.stage_retries > 0 and st.stage_failures >= st.stage_retries
    assert st.steps_run >= ref["stats"].steps_run
    assert held_equal(ref["held"], got["held"]), \
        "a checkpoint differs from the fault-free run's"
    assert got["tuner"].history == ref["tuner"].history, \
        "a reported metric differs from the fault-free run's"
    assert got["tuner"].best.trial_id == ref["tuner"].best.trial_id
    emit({"phase": "fault_plane", "model": "ResNet(n=9, width=16)",
          "batch": RESNET_FULL["batch"], "workers": 1,
          "seed": FAULT_SEED, "rates": FAULT_RATES,
          "faults_by_kind": dict(inj.by_kind),
          "every_kind_fired": {"stage", "crash", "outage"} <= set(
              inj.by_kind),
          "faults_injected": st.faults_injected,
          "stage_failures": st.stage_failures,
          "stage_retries": st.stage_retries,
          "workers_quarantined": st.workers_quarantined,
          "retries_verified": inj.retries_verified,
          "counts": {"fault_free": counts(ref["stats"]),
                     "faulty": counts(st)},
          "b1_launches": {"fault_free": ref["launches"],
                          "faulty": got["launches"]},
          "b1_launches_equal_device_steps": True,
          "useful_gpu_seconds": {"fault_free": ref["stats"].gpu_seconds,
                                 "faulty": st.gpu_seconds},
          "wasted_gpu_seconds": st.wasted_gpu_seconds,
          "wall_seconds": {"fault_free": ref["wall"], "faulty": got["wall"]},
          "checkpoints_held": len(got["held"]),
          "held_checkpoints_bit_equal": True,
          "all_reported_metrics_bit_equal": True,
          "best_trial": got["tuner"].best.trial_id, "same_best_trial": True})
    return {"fault_free": ref["launches"], "faulty": got["launches"]}


def b1_reset():
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    kops.reset_kernel_stats()
    stacked_tree_update.launches = stacked_leaf_update.launches = 0


def b1_read():
    """B1's tree-kernel launches since :func:`b1_reset`, after checking
    that no per-leaf launch and no fallback came with them."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    torch.cuda.synchronize()
    assert stacked_leaf_update.launches == 0, stacked_leaf_update.launches
    assert kops.KERNEL_STATS.fallbacks == 0, kops.KERNEL_STATS.snapshot()
    return stacked_tree_update.launches


def session_tuner():
    """The ResNet56 study's SHA tuner, of the package's own class: a
    snapshot's reader admits no class from outside ``repro_torch``."""
    import torch_hpo_resnet as example
    from repro_torch.core.tuners import SHATuner
    return SHATuner(example.space(RESNET_FULL["batch"]).trials(
        example.STEPS), min_steps=25, max_steps=example.STEPS, eta=2)


def plan_record(plan, store, stats, futures):
    """What finished studies left: the count fields, every held
    checkpoint's digest (the memory tier: blake2b of its leaves' bytes;
    the directory: the blob header's chunk digests), every metric the plan
    recorded by trial and step, each study's best trial — as JSON."""
    import hashlib
    from repro_torch.utils.tree import tree_leaves
    digests = {}
    for cid in sorted(store.committed_ids()):
        if store.directory:
            hdr = blob_header(store, cid)
            digests[cid] = [[c[:2] for c in m["c"]] for m in hdr["leaves"]]
            continue
        h = hashlib.blake2b(digest_size=16)
        for x in tree_leaves(store.get(cid)):
            if isinstance(x, torch.Tensor):
                h.update(str(x.dtype).encode())
                h.update(x.detach().cpu().contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
            else:
                h.update(repr(x).encode())
        digests[cid] = h.hexdigest()
    metrics = {f"{tid}@{step}": m
               for tid, path in plan.trial_paths.items() for nid in path
               for step, m in plan.nodes[nid].metrics.items()}
    assert all(v == v for m in metrics.values() for v in m.values())
    for fut in futures:
        assert fut.tuner.is_done() and fut.done(), fut.study_id
    return {"counts": counts(stats), "digests": digests, "metrics": metrics,
            "best": {f.study_id: f.tuner.best.trial_id for f in futures}}


def session_record(svc, store):
    """:func:`plan_record` of a finished one-study ResNet56 session, its
    best trial's id under ``"best"``."""
    rec = plan_record(svc.engine.plan, store, svc.stats, svc.futures)
    rec["best"] = rec["best"][svc.futures[0].study_id]
    return rec


def session_child(spec):
    """A fresh process: restore the snapshot ``spec["path"]`` against a new
    trainer and store (the copied directory, or a fresh memory tier),
    close it, and write its record and B1's launches to ``spec["out"]``.
    Prints no result line."""
    import torch_hpo_resnet as example
    from repro_torch.core import SearchPlanDB, StudyService
    from repro_torch.train.checkpoint import CheckpointStore
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    store = (CheckpointStore(spec["store"]) if spec["store"]
             else CheckpointStore())
    b1_reset()
    t0 = time.perf_counter()
    svc = StudyService.restore(SearchPlanDB(), spec["path"], backend,
                               store=store)
    restore_s = time.perf_counter() - t0
    svc.close()
    rec = session_record(svc, store)
    rec.update(launches=b1_read(), restore_seconds=restore_s,
               seconds=time.perf_counter() - t0)
    with open(spec["out"], "w") as f:
        json.dump(rec, f)
    return 0


def session_run(tier, root):
    """One ResNet56 session on ``tier``: stepped until SHA's first rung is
    decided (some trials done, some mid-path), snapshotted (the directory
    copied right after), closed — the uninterrupted run — and restored in
    a fresh process; returns the phase's row and B1's launches."""
    from repro_torch.core import SearchPlanDB, StudyService, StudySpec
    from repro_torch.core.engine import load_latest_session, session_rotation
    from repro_torch.train.checkpoint import CheckpointStore
    import torch_hpo_resnet as example
    d = os.path.join(root, "session_" + tier)
    os.makedirs(d)
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    store = (CheckpointStore(os.path.join(d, "ckpt"))
             if tier == "directory" else CheckpointStore())
    b1_reset()
    svc = StudyService(SearchPlanDB(), backend, n_workers=1, store=store,
                       batch_siblings=False)
    base = os.path.join(d, "auto.snap")
    if tier == "directory":
        svc.enable_auto_snapshot(base, every=AUTO_SNAPSHOT_EVERY, keep=2)
    tuner = session_tuner()
    svc.submit(StudySpec("resnet56", "synthetic-cifar", ("lr", "bs")), tuner)
    t0 = time.perf_counter()
    events = 0
    while tuner._rung == 0:          # losers done, survivors mid-path
        assert svc.step()
        events += 1
    path = os.path.join(d, "session.snap")
    t1 = time.perf_counter()
    svc.snapshot(path)
    snapshot_s = time.perf_counter() - t1
    before = {"launches": b1_read(), "counts": counts(svc.stats)}
    copy = None
    if tier == "directory":
        copy = os.path.join(d, "ckpt_copy")
        shutil.copytree(store.directory, copy)
    svc.close()
    total = b1_read()
    wall = time.perf_counter() - t0
    ref = session_record(svc, store)
    assert ref["counts"]["kernel_calls"] == total == ref["counts"][
        "steps_run"], (ref["counts"], total)

    out = os.path.join(d, "child.json")
    spec = {"path": path, "store": copy, "out": out}
    t2 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--session-child", json.dumps(spec)], check=True,
                   timeout=600)
    child_s = time.perf_counter() - t2
    with open(out) as f:
        got = json.load(f)
    assert got["counts"] == ref["counts"], (got["counts"], ref["counts"])
    assert got["digests"] == ref["digests"], \
        "a held checkpoint differs from the uninterrupted run's"
    assert got["metrics"] == ref["metrics"], \
        "a reported metric differs from the uninterrupted run's"
    assert got["best"] == ref["best"]
    assert before["launches"] + got["launches"] == total, (
        before["launches"], got["launches"], total)
    row = {"tier": tier, "events_before_snapshot": events,
           "counts_at_snapshot": before["counts"],
           "counts": ref["counts"],
           "snapshot_bytes": os.path.getsize(path),
           "snapshot_seconds": snapshot_s,
           "b1_launches": {"before_snapshot": before["launches"],
                           "after_restore": got["launches"],
                           "uninterrupted": total},
           "checkpoints_held": len(ref["digests"]),
           "uninterrupted_wall_seconds": wall,
           "child_seconds": child_s,
           "child_restore_seconds": got["restore_seconds"],
           "child_study_seconds": got["seconds"],
           "held_checkpoints_bit_equal": True,
           "all_reported_metrics_bit_equal": True,
           "best_trial": ref["best"], "same_best_trial": True}
    if tier == "directory":
        slots = session_rotation(base)
        assert len(slots) == 2 and slots[0][0] > 2, slots
        _, newest = load_latest_session(base)
        assert newest == slots[0][1]
        latest = StudyService.restore_latest(
            SearchPlanDB(), base, backend, store=CheckpointStore(copy))
        assert latest._auto_snapshot == (base, AUTO_SNAPSHOT_EVERY, 2)
        del latest
        row["auto_snapshot"] = {"every": AUTO_SNAPSHOT_EVERY, "keep": 2,
                                "slots": [s for s, _ in slots],
                                "restore_latest_read_newest": True}
    else:
        # a snapshot written on the card decodes where there is no card
        probe = subprocess.run(
            [sys.executable, "-c",
             "import sys, torch\n"
             "from repro_torch.core.engine import load_session\n"
             "s = load_session(sys.argv[1])\n"
             "print(torch.cuda.is_available(), len(s.store_mem))", path],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                 "PYTHONPATH": os.path.join(ROOT, "src")})
        assert probe.returncode == 0, probe.stderr[-2000:]
        avail, n = probe.stdout.split()
        assert avail == "False" and int(n) > 0, probe.stdout
        row["decoded_without_cuda"] = {"store_mem_trees": int(n)}
    shutil.rmtree(d)
    return row, total


def session_phase(root):
    """The same ResNet56 session on a directory store and on the memory
    tier, each snapshotted mid-study and restored in a fresh process:
    count fields, held checkpoints, metrics and the best trial equal to
    the uninterrupted run's, B1 before + after == uninterrupted; returns
    B1's launches by tier."""
    rows, launches = {}, {}
    for tier in ("directory", "memory"):
        rows[tier], launches[tier] = session_run(tier, root)
    emit({"phase": "session", "model": "ResNet(n=9, width=16)",
          "batch": RESNET_FULL["batch"], "workers": 1, "tiers": rows})
    return launches


TENANTS = {"alice": 2.0, "bob": 1.0}     # the gateway phase's quota weights
BOB_TRIALS = 3                # bob's SHA study: the first schedules of six


def gateway_studies():
    """The gateway phase's two submissions on one plan key, as ``(tenant,
    tuner)``: alice's six-schedule SHA study (:func:`session_tuner`) and
    bob's SHA study of the same tuner class over the first
    ``BOB_TRIALS`` of those schedules, so the two share prefixes.  Bob's
    trials carry ids of their own: a trial's default id is a hash of its
    schedule, and a study that stops a trial stops it under that id for
    every study (ROADMAP queue C)."""
    import torch_hpo_resnet as example
    from repro_torch.core.trial import Trial
    from repro_torch.core.tuners import SHATuner
    trials = [Trial(t.hp_config, t.total_steps, trial_id="bob-" + t.trial_id)
              for t in example.space(RESNET_FULL["batch"]).trials(
                  example.STEPS)[:BOB_TRIALS]]
    bob = SHATuner(trials, min_steps=25, max_steps=example.STEPS, eta=2)
    return [("alice", session_tuner()), ("bob", bob)]


GATEWAY_SPEC = ("resnet56", "synthetic-cifar", ("lr", "bs"))


def gateway_child(spec):
    """A fresh process: ``StudyGateway.restore`` of the envelope
    ``spec["path"]`` against a new trainer and a new memory-tier store,
    closed; writes the record of the restored plan key and B1's launches
    to ``spec["out"]``.  Prints no result line."""
    import torch_hpo_resnet as example
    from repro_torch.core import SearchPlanDB
    from repro_torch.frontdoor import StudyGateway
    from repro_torch.train.checkpoint import CheckpointStore
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    stores = {}

    def store_factory(key):
        return stores.setdefault(key, CheckpointStore())

    b1_reset()
    t0 = time.perf_counter()
    db = SearchPlanDB()
    gw = StudyGateway.restore(db, spec["path"], backend,
                              store_factory=store_factory,
                              batch_siblings=False)
    restore_s = time.perf_counter() - t0
    [(key, stats)] = gw.close()
    rec = plan_record(db.get(key), stores[key], stats,
                      [f.inner for f in gw.futures])
    rec.update(launches=b1_read(), ledger=gw.tenant_ledger(),
               restore_seconds=restore_s, seconds=time.perf_counter() - t0)
    with open(spec["out"], "w") as f:
        json.dump(rec, f)
    return 0


def gateway_phase(root):
    """Two tenants' ResNet56 studies on one plan key through
    ``StudyGateway`` (one slot, weighted quotas, a memory-tier store per
    key), against the same two submissions through ``StudyService``
    directly and each study alone: the gateway's count fields, held
    checkpoints, metrics and best trials bit-equal to the direct run's;
    the tenant ledger equal to the studies' ``by_study`` shares; B1 = the
    device's steps; a gateway envelope snapshotted when alice's first
    rung is decided and restored in a fresh process bit-equal, B1 before
    + after = uninterrupted; ``StudyService.restore`` refuses the
    envelope.  Returns B1's launches."""
    import torch_hpo_resnet as example
    from repro_torch.core import SearchPlanDB, StudyService, StudySpec
    from repro_torch.frontdoor import StudyGateway, TenantQuota
    from repro_torch.train.checkpoint import CheckpointStore
    d = os.path.join(root, "gateway")
    os.makedirs(d)
    spec = StudySpec(*GATEWAY_SPEC)
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    computed = device_steps(backend)
    runs = {}

    def direct(studies, label):
        """The submissions through one ``StudyService`` (one worker), with
        the gateway's study ids."""
        store = CheckpointStore()
        svc = StudyService(SearchPlanDB(), backend, n_workers=1, store=store,
                           batch_siblings=False)
        b1_reset()
        steps0 = computed["steps"]
        t0 = time.perf_counter()
        for i, (_, tuner) in enumerate(studies):
            svc.submit(spec, tuner, study_id=f"study-{i}")
        svc.close()
        wall = time.perf_counter() - t0
        launches = b1_read()
        assert launches == svc.stats.kernel_calls == \
            computed["steps"] - steps0 == svc.stats.steps_run, (
                launches, svc.stats.kernel_calls, svc.stats.steps_run)
        runs[label] = dict(record=plan_record(svc.engine.plan, store,
                                              svc.stats, svc.futures),
                           wall=wall, launches=launches)

    for tenant, tuner in gateway_studies():
        direct([(tenant, tuner)], tenant)             # each study alone
    direct(gateway_studies(), "direct")

    # the gateway, snapshotted once alice's first rung is decided
    stores = {}

    def store_factory(key):
        return stores.setdefault(key, CheckpointStore())

    db = SearchPlanDB()
    gw = StudyGateway(db, backend, n_slots=1,
                      quotas={t: TenantQuota(w) for t, w in TENANTS.items()},
                      store_factory=store_factory, batch_siblings=False)
    studies = gateway_studies()
    b1_reset()
    steps0 = computed["steps"]
    t0 = time.perf_counter()
    futs = [gw.submit(spec, tuner, tenant=tenant)
            for tenant, tuner in studies]
    assert [f.study_id for f in futs] == ["study-0", "study-1"]
    assert len(gw.sessions) == 1 and len(gw.leases.held(spec.key)) == 1
    events = 0
    while studies[0][1]._rung == 0:
        assert gw.step()
        events += 1
    path = os.path.join(d, "gateway.snap")
    t1 = time.perf_counter()
    gw.snapshot(path)
    snapshot_s = time.perf_counter() - t1
    before = b1_read()
    gw.join()
    ledger = gw.tenant_ledger()
    [(key, stats)] = gw.close()
    wall = time.perf_counter() - t0
    launches = b1_read()
    assert key == spec.key and not gw.sessions
    assert launches == stats.kernel_calls == computed["steps"] - steps0 \
        == stats.steps_run, (launches, stats.kernel_calls, stats.steps_run)
    ref = plan_record(db.get(key), stores[key], stats,
                      [f.inner for f in gw.futures])

    # 1. bit-equal to the same submissions through StudyService directly
    got = runs["direct"]["record"]
    assert ref["counts"] == got["counts"], (ref["counts"], got["counts"])
    assert ref["digests"] == got["digests"], \
        "a held checkpoint differs from the direct run's"
    assert ref["metrics"] == got["metrics"], \
        "a reported metric differs from the direct run's"
    assert ref["best"] == got["best"], (ref["best"], got["best"])
    # 2. each tenant is billed its studies' split-charged shares
    tenant_of = {f.study_id: f.tenant for f in gw.futures}
    for tenant in TENANTS:
        share = sum(ss.gpu_seconds for sid, ss in stats.by_study.items()
                    if tenant_of[sid] == tenant)
        assert ledger[tenant]["gpu_seconds"] == share, (tenant, ledger)
        assert ledger[tenant]["studies"] == 1
    billed = sum(e["gpu_seconds"] for e in ledger.values())
    assert abs(billed - stats.gpu_seconds) <= 1e-9 * stats.gpu_seconds, (
        billed, stats.gpu_seconds)
    assert set(ledger) == set(TENANTS)

    # 4. the envelope restored in a fresh process; refused by the service
    try:
        StudyService.restore(SearchPlanDB(), path, backend)
    except ValueError as exc:
        assert "gateway envelope" in str(exc), exc
    else:
        raise AssertionError("StudyService.restore took a gateway envelope")
    out = os.path.join(d, "child.json")
    t2 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--gateway-child", json.dumps({"path": path,
                                                   "out": out})],
                   check=True, timeout=600)
    child_s = time.perf_counter() - t2
    with open(out) as f:
        child = json.load(f)
    assert child["counts"] == ref["counts"], (child["counts"], ref["counts"])
    assert child["digests"] == ref["digests"], \
        "a held checkpoint differs from the uninterrupted gateway run's"
    assert child["metrics"] == ref["metrics"], \
        "a reported metric differs from the uninterrupted gateway run's"
    assert child["best"] == ref["best"]
    assert before + child["launches"] == launches, (
        before, child["launches"], launches)
    alone = {t: runs[t]["record"]["counts"]["steps_run"] for t in TENANTS}
    emit({"phase": "gateway", "model": "ResNet(n=9, width=16)",
          "batch": RESNET_FULL["batch"], "slots": 1,
          "quotas": TENANTS, "plan_key": key,
          "trials": {t: len(tuner.all_trials) for t, tuner in studies},
          "steps": {"merged": stats.steps_run, "alone": alone,
                    "alone_sum": sum(alone.values())},
          "by_study_steps": {sid: ss.steps_run
                             for sid, ss in stats.by_study.items()},
          "counts": ref["counts"],
          "tenant_ledger": ledger,
          "wall_seconds": {"gateway": wall,
                           "direct": runs["direct"]["wall"],
                           **{f"alone_{t}": runs[t]["wall"]
                              for t in TENANTS}},
          "events_before_snapshot": events,
          "snapshot_bytes": os.path.getsize(path),
          "snapshot_seconds": snapshot_s,
          "child_seconds": child_s,
          "child_restore_seconds": child["restore_seconds"],
          "child_study_seconds": child["seconds"],
          "b1_launches": {"gateway": launches,
                          "direct": runs["direct"]["launches"],
                          "before_snapshot": before,
                          "after_restore": child["launches"],
                          **{f"alone_{t}": runs[t]["launches"]
                             for t in TENANTS}},
          "b1_launches_equal_device_steps": True,
          "checkpoints_held": len(ref["digests"]),
          "bit_equal_to_direct_service": True,
          "restored_bit_equal": True,
          "ledger_equals_by_study": True,
          "service_restore_refused": True,
          "best_trials": ref["best"]})
    shutil.rmtree(d)
    return {"gateway": launches, "before_snapshot": before,
            "after_restore": child["launches"],
            "serve_studies": serve_studies_meshes()}


def group_fault():
    """A fault injector that fails the first batched-group attempt with a
    transient fault (the JAX package's ``GroupFault`` of
    ``tests/test_faults.py``) and nothing else."""
    from repro_torch.core.faults import FaultInjector, TransientStageError

    class GroupFault(FaultInjector):
        def __init__(self):
            super().__init__(0)
            self._armed = True

        def before_execute(self, site):
            if self._armed and site.startswith(("group:", "group-chain:")):
                self._armed = False
                self._record("stage", site)
                raise TransientStageError(f"injected group fault at {site}")

    return GroupFault()


def lm_group_degraded_phase(backend, grouped):
    """qwen2-0.5b's group study with its first group attempt failed, so
    the group runs as solo members: on the vectorised tier (CUDA's)
    against ``lm_group_study``'s grouped run ``grouped`` — one degraded
    group, the same ``steps_run``, the largest |Δ| of held checkpoints
    and metrics printed, metrics within ``group_vs_solo``'s tolerance —
    and on the looped tier against its own fault-free run, bit for bit.
    Returns the launches of the degraded runs."""
    import torch_hpo_lm as example
    counters = lm_counters()
    vec = lm_group_run(example, backend, True, counters, keep=True,
                       fault_injector=group_fault())
    st = vec["stats"]
    assert st.groups_degraded == 1 and st.stage_failures == 1
    assert st.batched_groups == 0
    leaf_diff = held_max_diff(grouped["held"], vec["held"])
    launches = group_vs_solo("lm_group_degraded_vectorised",
                             {True: grouped, False: vec}, 2e-2, {
        "model": "qwen2-0.5b", "dtype": "bfloat16",
        "layers": backend.task.cfg.num_layers,
        "against": "lm_group_study's grouped run (vectorised, fault-free)",
        "groups_degraded": st.groups_degraded,
        "stage_failures": st.stage_failures,
        "max_held_checkpoint_difference": leaf_diff}, best_margin=True)
    del grouped["held"], vec["held"]
    free()
    out = {"vectorised": vec["launches"]}

    backend.vectorize_groups = False           # the looped tier
    try:
        runs = {faulty: lm_group_run(
            example, backend, True, counters, keep=True, looped=True,
            fault_injector=group_fault() if faulty else None)
            for faulty in (False, True)}
    finally:
        backend.vectorize_groups = True
    ref, got = runs[False], runs[True]
    st = got["stats"]
    assert ref["stats"].batched_groups >= 1
    assert st.groups_degraded == 1 and st.stage_failures == 1
    assert st.steps_run == ref["stats"].steps_run
    assert held_equal(ref["held"], got["held"]), \
        "a degraded member's checkpoint differs from the looped group's"
    assert got["history"] == ref["history"]
    assert got["best"] == ref["best"]
    emit({"phase": "lm_group_degraded_looped", "model": "qwen2-0.5b",
          "dtype": "bfloat16", "tier": "looped (vectorize_groups=False)",
          "steps_run": st.steps_run, "groups_degraded": st.groups_degraded,
          "stage_failures": st.stage_failures,
          "batched_groups": {"fault_free": ref["stats"].batched_groups,
                             "faulty": st.batched_groups},
          "launches": {"fault_free": ref["launches"],
                       "faulty": got["launches"]},
          "checkpoints_held": len(got["held"]),
          "held_checkpoints_bit_equal": True,
          "all_reported_metrics_bit_equal": True,
          "best_trial": got["best"], "same_best_trial": True,
          "wall_seconds": {"fault_free": ref["wall"], "faulty": got["wall"]}})
    del ref["held"], got["held"]
    out["looped"] = got["launches"]
    return out


def per_member_step(fn, member_steps):
    """Per member-step of ``fn`` (one chunk of ``member_steps``
    member-steps): host-clock ms (synchronised at both ends, the mean of
    three chunks after two warm-up ones), the chunk's CUDA-event span,
    device busy ms (the profiler's kernel times over one more chunk), the
    idle share against the host clock, and CUDA launches."""
    fn()
    ms = host_ms(fn, 3)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    prof = device_profile(fn, member_steps, ms)
    busy, idle = prof["device_busy_ms"], prof["device_idle_share"]
    if isinstance(idle, float) and idle < 0:
        # the profiler's summed kernel times exceed the chunk's span (seen
        # with cuDNN's grouped convolutions): their sum is then no share
        idle = "not measured: summed kernel time exceeds the span"
    return {"host_ms": ms / member_steps,
            "events_ms": e0.elapsed_time(e1) / member_steps,
            "device_busy_ms": busy / member_steps
            if isinstance(busy, float) else busy,
            "device_idle_share": idle,
            "cuda_launches": prof["device_kernel_launches_per_step"],
            "top_device_time": prof["top_device_time"][:4]}


def group_step(label, backend, opt, lr, n, Ms, per_step):
    """One member-stacked chunk of ``n`` steps (the vectorised tier, the
    slab shared, divergent learning rates) against solo chunks, per
    member-step, for each group size in ``Ms``; the peak memory of each.
    A group chunk launches each kernel of ``per_step`` (name → launches a
    step) that many times a step whatever the group's size, and B1 once a
    step; returns the launches of one group chunk of the last size."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import stacked_tree_update
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.torch_trainer import _stack
    from repro_torch.utils.tree import tree_leaves
    p0 = backend.init_state()["params"]
    slab = backend._upload(backend.pipeline_factory().next_batches(n))
    steps = torch.arange(n, dtype=torch.int32, device=DEV)
    carry = [(p0, init_opt_state(opt, p0))]
    lrs = torch.full((n,), lr, device=DEV)

    def solo():
        carry[0] = backend._run_chunk(opt, carry[0], {}, {"lr": lrs}, slab,
                                      steps)

    torch.cuda.reset_peak_memory_stats()
    out = {"solo": per_member_step(solo, n)}
    out["solo"]["peak_device_memory_gib"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    del carry[0]
    free()
    for M in Ms:
        torch.cuda.reset_peak_memory_stats()
        ps = _stack([p0] * M)
        gcarry = [ps, init_opt_state(opt, ps)]       # updated in place
        del ps
        hp = {"lr": (lr * (1.0 + 0.1 * torch.arange(M, device=DEV))
                     ).expand(n, M).contiguous()}

        def group():
            backend._run_group_chunk(opt, gcarry, {}, hp, slab, steps, True)

        with no_vmap_fallback():
            b1 = stacked_tree_update.launches
            calls0 = kops.KERNEL_STATS.calls
            _, launches = launched(group)
            launches["stacked_tree_update"] = \
                stacked_tree_update.launches - b1
            # a step: one update, one binding call per forward kernel
            # launch, for all the members
            assert kops.KERNEL_STATS.calls - calls0 == n * (
                1 + per_step.get("flash_attention_fwd", 0)
                + per_step.get("ssd_intra_fwd", 0))
            assert launches == {"stacked_tree_update": n, **{
                k: v * n for k, v in per_step.items()}}, launches
            row = per_member_step(group, n * M)
        assert all(bool(t.isfinite().all()) for t in tree_leaves(gcarry[0]))
        row["launches_per_group_chunk"] = launches
        row["peak_device_memory_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        row["host_ms_over_solo"] = row["host_ms"] / out["solo"]["host_ms"]
        out[f"M={M}"] = row
        gcarry.clear()
        free()
    emit({"phase": "group_step", "model": label, "chunk_steps": n,
          "per_member_step": out, "kernel_launches_per_step": per_step,
            "clock": "host: synchronised at both ends, mean of three chunks; "
                   "events: one chunk's CUDA-event span; device busy and "
                   "launches: the profiler over one chunk"})
    return launches


def group_step_phase():
    """``group_step`` at ``GROUP_STEP``'s depths: ResNet20 and qwen2-0.5b
    (full width, 12 layers) at M = 2 and 4, and mamba2-2.7b at full width,
    2 layers, M = 2: B5 and B6 folded; returns mamba2's launches of one
    chunk."""
    import torch_hpo_lm as lm_example
    import torch_hpo_resnet as example
    n = GROUP_STEP["resnet_n"]
    backend = example.make_backend(use_kernel=True,
                                   **dict(RESNET_FULL, n=n))
    group_step(f"ResNet(n={n}, width=16), batch 128", backend, "momentum",
               0.05, 8, GROUP_MS, {})
    del backend
    free()
    L = GROUP_STEP["qwen2_layers"]
    backend = lm_example.make_backend(arch="qwen2-0.5b", use_kernel=True,
                                      layers=L, **LM_FULL)
    group_step(f"qwen2-0.5b, {L} layers, 4 x 1024 tokens", backend, "adamw",
               3e-4, 4, QWEN_GROUP_MS, {"flash_attention_fwd": L,
                                        "flash_attention_bwd_dq": L,
                                        "flash_attention_bwd_dkv": L})
    del backend
    free()
    L = GROUP_STEP["mamba2_layers"]
    backend = lm_example.make_backend(arch="mamba2-2.7b", use_kernel=True,
                                      batch=1, seq_len=2048, n_train=8,
                                      n_eval=1, layers=L)
    return group_step(f"mamba2-2.7b, {L} layers, 1 x 2048 tokens", backend,
                      "adamw", 3e-4, 4, (2,),
                      {"ssd_intra_fwd": L, "ssd_intra_bwd": L})


# ------------------------------------------- 16-18. the serialized tiers
def read_back_equal(store, cid, like):
    """Is every leaf of ``store.get(cid)`` — uploaded again, for a tensor —
    equal (``torch.equal``, same dtype; the same Python value and type) to
    ``like``'s, and are the digests of its bytes the header's?"""
    from repro_torch.utils.tree import tree_leaves
    tree = store.get(cid)
    for a, b in zip(tree_leaves(tree), tree_leaves(like), strict=True):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a.to(b.device), b)
        else:
            assert type(a) is type(b) and a == b, (a, b)
    return digests_equal_header(store, cid, tree)


def ckpt_plane_phase(root):
    """The serialized tiers from device tensors: a full commit of a
    ResNet56-shaped f32 tree with a bf16 copy and the state's scalars, a
    delta child with one leaf changed, a chain that reaches
    ``max_delta_depth`` and rebases — each read back equal, digests equal
    to the header's — then the transfer and commit rates on a 1 GiB tree:
    device-to-host (the pinned host copy ``put_async`` starts) and
    host-to-device (that copy, and a blob read back from the directory),
    and seconds per GB committed, inline and with the thread-pool
    encoder."""
    from repro_torch.models.resnet import ResNet
    from repro_torch.train.checkpoint import CheckpointStore
    from repro_torch.utils.tree import tree_leaves, tree_map
    gen = torch.Generator().manual_seed(11)
    params = tree_map(lambda x: x.to(DEV), ResNet(n=9, width=16).init(gen))
    assert len(tree_leaves(params)) == RESNET_LEAVES
    state = {"params": params,
             "opt": {"m": tree_map(torch.randn_like, params)},
             "bf16": tree_map(lambda p: p.to(torch.bfloat16), params),
             "opt_name": "momentum", "data": (3, 1, 384, 128), "step": 25}
    store = CheckpointStore(os.path.join(root, "plane"), max_delta_depth=2)
    c0 = store.put_async("plane", 25, state)
    store.flush()
    hdr0 = store._read_header(c0)
    assert hdr0["kind"] == "full" and store.full_commits == 1
    assert {m["d"] for m in hdr0["leaves"]} == {"<f4", "bfloat16", "<i8",
                                                "<U8"}
    store._read_cache.clear()
    full_ok = read_back_equal(store, c0, state)
    # a delta child: one leaf changed
    child = dict(state, params=dict(params), step=26)
    key = next(iter(params))
    child["params"][key] = params[key] + 1.0
    c1 = store.put_async("plane", 26, child, parent_cid=c0)
    store.flush()
    hdr1 = store._read_header(c1)
    refs = sum(1 for m in hdr1["leaves"] for c in m["c"] if not c[2])
    assert store.delta_commits == 1 and hdr1["kind"] == "delta"
    assert hdr1["parent"] == c0 and refs > 0
    store._read_cache.clear()
    delta_ok = read_back_equal(store, c1, child)
    # a chain past max_delta_depth = 2: depths 1, 2, then a rebase
    parent, depths = c1, [1]
    for step in (27, 28):
        child = dict(child, params=dict(child["params"]), step=step)
        child["params"][key] = child["params"][key] + 1.0
        parent = store.put("plane", step, child, parent_cid=parent)
        depths.append(store._read_header(parent)["depth"])
    assert depths == [1, 2, 0] and store.delta_rebases == 1, depths
    assert store.full_commits == 2
    store._read_cache.clear()
    chain_ok = read_back_equal(store, parent, child)
    assert full_ok and delta_ok and chain_ok
    full_bytes = os.path.getsize(store._path(c0))
    delta_bytes = os.path.getsize(store._path(c1))
    store.close()

    # rates on a 1 GiB f32 tree
    big = {f"w{i}": torch.randn(1 << 26, device=DEV) for i in range(4)}
    gb = sum(x.numel() * x.element_size() for x in big.values()) / 1e9
    rates = {}
    for label, procs in (("inline", 0), ("threads", os.cpu_count())):
        st = CheckpointStore(os.path.join(root, "rate_" + label),
                             read_cache_entries=0, serializer_procs=procs)
        for rep in range(2):        # the first one pins its host buffer
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cid = st.put_async("rate", rep, big)
            t_dep = time.perf_counter() - t0
            host = st._pending[cid].wait()  # the pinned copy, landed
            t_d2h = time.perf_counter() - t0
            st.flush()
            t_commit = time.perf_counter() - t0 - t_d2h
            t1 = time.perf_counter()
            up = {k: v.to(DEV, non_blocking=True) for k, v in host.items()}
            torch.cuda.synchronize()
            t_h2d_pinned = time.perf_counter() - t1
            assert all(h.is_pinned() for h in host.values())
            assert all(torch.equal(up[k], big[k]) for k in big)
            del host, up
        t3 = time.perf_counter()
        back = st.get(cid)
        t_read = time.perf_counter() - t3
        t4 = time.perf_counter()
        up = {k: v.to(DEV) for k, v in back.items()}
        torch.cuda.synchronize()
        t_h2d = time.perf_counter() - t4
        assert all(torch.equal(up[k], big[k]) for k in big)
        del back, up
        rates[label] = {
            "serializer_procs": procs, "put_async_seconds": t_dep,
            "device_to_host_gb_per_s": gb / t_d2h,
            "host_to_device_pinned_gb_per_s": gb / t_h2d_pinned,
            "commit_seconds_per_gb": t_commit / gb,
            "read_back_gb_per_s": gb / t_read,
            "host_to_device_read_back_gb_per_s": gb / t_h2d}
        st.close()
    shutil.rmtree(os.path.join(root, "plane"))
    for label in rates:
        shutil.rmtree(os.path.join(root, "rate_" + label))
    emit({"phase": "ckpt_plane", "leaves": len(hdr0["leaves"]),
          "full_commit_bytes": full_bytes, "delta_commit_bytes": delta_bytes,
          "delta_reference_chunks": refs, "delta_depths": depths,
          "delta_rebases": store.delta_rebases,
          "read_back_equal": True, "digests_equal_header": True,
          "rate_tree_gb": gb, "rates": rates,
          "clock": "host, synchronised where a copy ends; the second of "
                   "two deposits (the first pins its host buffer)"})


def resnet_tiered_study_phase(root, memory_runs):
    """ResNet56's study of phase 4, stage- and trial-based, on a directory
    store with a remote tier and room for about two states on the
    directory: blobs demote to the remote and promote back; ``steps_run``,
    the best trial and every reported metric bit-equal to phase 4's
    memory-tier runs (``memory_runs``), B1 = steps; wall seconds beside
    the memory tier's.  Demotions and promotions > 0, counted after every
    held checkpoint is read back (the study's own promotions printed
    apart: whether a resume finds its blob demoted depends on the two
    workers' timing)."""
    import torch_hpo_resnet as example
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    from repro_torch.train.checkpoint import (CheckpointStore,
                                              DirectoryObjectStore)
    state_bytes = 2 * 4 * 853_546          # params + momentum, f32
    kops.reset_kernel_stats()
    stacked_tree_update.launches = 0            # counts to 0 just before
    stacked_leaf_update.launches = 0
    runs = {}
    for share in (True, False):
        mode = "stage" if share else "trial"
        backend = example.make_backend(use_kernel=True, **RESNET_FULL)
        store = CheckpointStore(
            os.path.join(root, "resnet_" + mode), read_cache_entries=0,
            remote=DirectoryObjectStore(os.path.join(root, "remote_" + mode)),
            disk_capacity_bytes=2 * state_bytes)
        rec = store_record(store)
        stats, tuner, store, wall = example.run_study(
            backend, share, batch=RESNET_FULL["batch"], name="resnet56",
            batch_siblings=False, store=store)
        torch.cuda.synchronize()
        runs[share] = (stats, tuner, store, wall, rec)
    launches = stacked_tree_update.launches     # ... and read just after
    leaf_launches = stacked_leaf_update.launches
    steps = sum(r[0].steps_run for r in runs.values())
    assert launches == steps and leaf_launches == 0, (launches, steps)
    for share, (stats, tuner, store, wall, rec) in runs.items():
        m_stats, m_tuner, m_wall = memory_runs[share]
        assert stats.kernel_fallbacks == 0
        assert stats.steps_run == m_stats.steps_run, (
            stats.steps_run, m_stats.steps_run)
        assert tuner.best.trial_id == m_tuner.best.trial_id
        assert tuner.history == m_tuner.history, \
            "a reported metric differs from the memory tier's"
        promoted_in_study = store.tier_promotions
        # every held checkpoint read back: a demoted one promotes
        n_ckpts = held_checkpoints(store, RESNET_LEAVES)
        assert store.tier_demotions > 0 and store.tier_promotions > 0, (
            store.tier_demotions, store.tier_promotions)
        emit({"phase": "resnet_tiered_study",
              "mode": "stage" if share else "trial",
              "model": "ResNet(n=9, width=16)",
              "store": "CheckpointStore(directory, read_cache_entries=0, "
                       "remote=DirectoryObjectStore(...), "
                       f"disk_capacity_bytes={2 * state_bytes})",
              "steps_run": stats.steps_run, "checkpoints_held": n_ckpts,
              "tier_demotions": store.tier_demotions,
              "tier_promotions": store.tier_promotions,
              "tier_promotions_in_study": promoted_in_study,
              "remote_bytes_written": store.remote_bytes_written,
              "remote_bytes_read": store.remote_bytes_read,
              "ckpt_remote_hits": stats.ckpt_remote_hits,
              **store_fields(stats, store, rec),
              "wall_seconds": wall, "memory_tier_wall_seconds": m_wall,
              "wall_over_memory_tier": wall / m_wall,
              "b1_launches_equal_steps": True,
              "steps_run_equal_memory_tier": True,
              "best_trial": tuner.best.trial_id,
              "same_best_trial_as_memory_tier": True,
              "all_reported_metrics_bit_equal_memory_tier": True})
        store.close()
        for cid in list(store.committed_ids()):
            store.evict(cid)
        shutil.rmtree(store.directory)
        shutil.rmtree(store.remote.directory)


def mamba2_group_study_phase(root):
    """mamba2-2.7b at full width and ``MAMBA_GROUP_LAYERS`` layers over
    ``examples/torch_hpo_lm.py::group_space``, stage-based, with and
    without sibling groups in one call, each on a directory store: B5 = L
    × (launch steps + evaluations), B6 = L × launch steps (one launch per
    group call), all on the tensor cores, B1 = launch steps; solo's
    ``steps_run`` and best trial, every reported metric within 2e-2."""
    import torch_hpo_lm as example
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    from repro_torch.train.checkpoint import CheckpointStore
    L = MAMBA_GROUP_LAYERS
    backend = example.make_backend(arch="mamba2-2.7b", use_kernel=True,
                                   **dict(MAMBA_STUDY, layers=L))
    backend.init_state()                       # the draw, outside the runs
    assert backend.task.cfg.num_layers == L
    counters = (stacked_tree_update, stacked_leaf_update,
                fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, ssk.ssd_intra_fwd,
                ssk.ssd_intra_bwd)
    tc = counters[5:]
    runs = {}
    for siblings in (False, True):
        tc0 = [c.launches_tc for c in tc]
        mode = "grouped" if siblings else "solo"
        store = CheckpointStore(os.path.join(root, "mamba2_group_" + mode),
                                read_cache_entries=0,
                                serializer_procs=os.cpu_count())
        rec = store_record(store)
        with host_memory_peak(rec):
            runs[siblings] = r = run_group_study(
                example, backend, siblings, counters,
                batch=MAMBA_STUDY["batch"], name="mamba2-2.7b", store=store)
        r["store"] = store_fields(r["stats"], store, rec)
        store.close()
        shutil.rmtree(store.directory)
        n, e = r["launch_steps"], r["evals"]
        assert r["launches"] == {
            "stacked_tree_update": n, "stacked_leaf_update": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "ssd_intra_fwd": L * (n + e),
            "ssd_intra_bwd": L * n}, (r["launches"], n, e)
        assert [c.launches_tc - t for c, t in zip(tc, tc0)] == [
            L * (n + e), L * n]
        assert r["calls"] == n + L * (n + e)
    cfg = backend.task.cfg
    # bf16 weights: batched products sum in another order than solo ones
    launches = group_vs_solo("mamba2_group_study", runs, 2e-2, {
        "model": "mamba2-2.7b", "dtype": "bfloat16", "layers": L,
        "published_layers": 64, "batch": MAMBA_STUDY["batch"],
        "seq_len": MAMBA_STUDY["seq_len"],
        "state_bytes": mamba2_state_bytes(cfg),
        "space": "examples/torch_hpo_lm.py::group_space",
        "stores": {("grouped" if k else "solo"): r["store"]
                   for k, r in runs.items()},
        "expected": f"B1 = n, B5 = {L} x (n + evaluations), B6 = {L} x n,"
                    " n = launch_steps = steps_run - sum over groups of "
                    "(members - 1) x group steps"}, best_margin=True)
    return launches


# ------------------------ 24-27. the mesh plane, the launcher, cross-tier retry
MESH = [0]                     # the one-device worker mesh: the card's id
LAUNCH_STEPS, LAUNCH_PLAIN_STEPS = 20, 3
# the launcher's kernel and plain paths differ only in rounding (bf16 p
# and dS before their products, B1's fma contractions): each step's loss,
# an f32 mean over 4,096 tokens, stays within one bf16 rounding of itself
LAUNCH_LOSS_RTOL = 2.0 ** -8
# the retried member of group_retry runs solo where its siblings ran on
# the vectorised tier: qwen2's metrics differ by up to 3.53e-5 between the
# tiers (ROADMAP queue C item 9); lm_group_study's tolerance
GROUP_RETRY_METRIC_TOL = 2e-2


def d2d_bytes(disp):
    """Wrap ``disp._d2d_put`` to record the most device bytes and entries
    the d2d cache held after any put; returns the live record."""
    from repro_torch.utils.tree import tree_leaves
    rec = {"peak_device_bytes": 0, "peak_entries": 0}
    put = disp._d2d_put

    def d2d_put(cid, state, worker):
        put(cid, state, worker)
        held = sum(x.numel() * x.element_size()
                   for entry in disp._d2d.values()
                   for x in tree_leaves(entry[0])
                   if isinstance(x, torch.Tensor) and x.is_cuda)
        rec["peak_device_bytes"] = max(rec["peak_device_bytes"], held)
        rec["peak_entries"] = max(rec["peak_entries"], len(disp._d2d))

    disp._d2d_put = d2d_put
    return rec


def mesh_study(example, backend, computed, meshes, store, space_fn,
               siblings):
    """Phase 4's SHA study (stage-based, one worker) over ``space_fn``
    through ``Study.engine(worker_meshes=meshes)``; returns its record,
    the count fields and B1's launches (held to the device's steps on the
    solo path)."""
    from repro_torch.core import SearchPlanDB, Study
    db = SearchPlanDB()
    study = Study.create(db, "resnet56", "synthetic-cifar", ("lr", "bs"))
    tuner = example.RecordingSHATuner(
        space_fn(RESNET_FULL["batch"]).trials(example.STEPS), min_steps=25,
        max_steps=example.STEPS, eta=2)
    b1_reset()             # before the engine: its kernel counts start here
    eng = study.engine(backend, n_workers=1, store=store,
                       batch_siblings=siblings, worker_meshes=meshes)
    d2d = d2d_bytes(eng.dispatcher)
    steps0 = computed["steps"]
    t0 = time.perf_counter()
    stats = eng.run([tuner])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b1_read()
    assert tuner.is_done() and tuner.best is not None
    assert store.pending_writes == 0
    assert launches == stats.kernel_calls, (launches, stats.kernel_calls)
    if not siblings:
        assert launches == computed["steps"] - steps0 == stats.steps_run, (
            launches, computed["steps"] - steps0, stats.steps_run)
    rec = plan_record(db.get(study.key), store, stats, [])
    rec.update(best=tuner.best.trial_id, history=tuner.history, wall=wall,
               launches=launches, d2d=d2d, stats=stats,
               reads=stats.ckpt_disk_hits + stats.ckpt_mem_hits)
    return rec


def wide_mesh_refusal(backend, smi):
    """An engine over the CUDA ``backend`` with a mesh of more cards than
    are visible (``WorkerMesh.build([0, 1, 2, 3])`` on one card) raises
    the visible-device ``ValueError`` when it is built: no chunk ran, the
    trainer is bound to no mesh.  Returns the row."""
    from repro_torch.core import SearchPlanDB, Study
    from repro_torch.dist.meshes import WorkerMesh
    n_cards = torch.cuda.device_count()
    wide = WorkerMesh.build(range(max(4, n_cards + 1)))
    calls0 = backend.exec_calls
    study = Study.create(SearchPlanDB(), "resnet56", "synthetic-cifar",
                         ("lr", "bs"))
    try:
        study.engine(backend, n_workers=1, worker_meshes=[wide])
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise AssertionError(f"a {wide.n_devices}-card mesh was taken with "
                             f"{n_cards} visible")
    assert "visible CUDA devices" in refusal, refusal
    assert backend.exec_calls == calls0 and backend._wmesh is None
    return {"device_ids": list(wide.device_ids), "visible_devices": n_cards,
            "nvidia_smi": smi, "error": refusal,
            "refused_before_any_work": True}


def mesh_plane_phase(root, smi):
    """Phase 4's study at ``MESH_RESNET``'s depth on one worker, a thread
    fleet against a one-device mesh fleet (``worker_meshes=
    [WorkerMesh.build([0])]``), on the memory tier and on a directory
    store, then grouped (``group_space``,
    ``batch_siblings=True``, the vectorised tier) on the memory tier:
    each pair bit-equal — count fields (``ckpt_loads`` included), held
    checkpoints, metrics, best trial, B1 launches (= device steps solo) —
    with resumes served device to device on the mesh fleet
    (``d2d_handoffs`` > 0) and the store's reads fewer by exactly the
    handoffs; prints the d2d cache's peak device bytes.  First, a mesh
    wider than the visible cards is refused (:func:`wide_mesh_refusal`).
    Returns B1's launches."""
    import torch_hpo_resnet as example
    from repro_torch.dist.meshes import WorkerMesh
    from repro_torch.train.checkpoint import CheckpointStore
    d = os.path.join(root, "mesh_plane")
    backend = example.make_backend(use_kernel=True, **MESH_RESNET)
    refusal = wide_mesh_refusal(backend, smi)
    computed = device_steps(backend)
    fleets = {"thread": None, "mesh": [WorkerMesh.build(MESH)]}
    rows, launches = {}, {}
    for tier, space_fn, siblings in (("memory", example.space, False),
                                     ("directory", example.space, False),
                                     ("grouped", example.group_space, True)):
        runs = {}
        for fleet, meshes in fleets.items():
            store = (CheckpointStore(os.path.join(d, fleet))
                     if tier == "directory" else CheckpointStore())
            runs[fleet] = mesh_study(example, backend, computed, meshes,
                                     store, space_fn, siblings)
            del store
            free()
        t, m = runs["thread"], runs["mesh"]
        st_t, st_m = t["stats"], m["stats"]
        assert m["counts"] == t["counts"], (m["counts"], t["counts"])
        assert m["digests"] == t["digests"], \
            "a held checkpoint differs from the thread fleet's"
        assert m["metrics"] == t["metrics"] and m["history"] == t["history"]
        assert m["best"] == t["best"] and m["launches"] == t["launches"]
        assert st_m.mesh_placements > 0 and st_t.mesh_placements == 0
        assert st_m.d2d_handoffs > 0 and st_t.d2d_handoffs == 0
        assert t["reads"] - m["reads"] == st_m.d2d_handoffs, (
            t["reads"], m["reads"], st_m.d2d_handoffs)
        if siblings:
            assert st_m.batched_groups >= 1
        rows[tier] = {
            "space": space_fn.__name__, "batch_siblings": siblings,
            "counts": m["counts"], "best_trial": m["best"],
            "checkpoints_held": len(m["digests"]),
            "b1_launches": m["launches"],
            "mesh_placements": st_m.mesh_placements,
            "placement_rejections": st_m.placement_rejections,
            "d2d_handoffs": st_m.d2d_handoffs,
            "store_reads": {"thread": t["reads"], "mesh": m["reads"]},
            "ckpt_load_seconds": {"thread": st_t.ckpt_load_seconds,
                                  "mesh": st_m.ckpt_load_seconds},
            "d2d_peak_device_bytes": m["d2d"]["peak_device_bytes"],
            "d2d_peak_entries": m["d2d"]["peak_entries"],
            "wall_seconds": {"thread": t["wall"], "mesh": m["wall"]}}
        launches[tier] = m["launches"]
    shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "mesh_plane",
          "model": f"ResNet(n={MESH_RESNET['n']}, width=16)",
          "batch": MESH_RESNET["batch"], "workers": 1,
          "mesh": {"device_ids": MESH, "axes": [["data", 1]]},
          "wide_mesh_refusal": refusal,
          "tiers": rows, "bit_equal_to_thread_fleet": True,
          "b1_launches_equal_device_steps": True,
          "store_reads_fall_by_handoffs": True})
    return launches


def launch_train_phase():
    """``repro_torch.launch.train.main`` for qwen2-0.5b at full width,
    batch 4 × 1024: ``LAUNCH_STEPS`` steps with the kernels (B1 once a
    step, B2 / B3 / B4 once a layer a step, all on the tensor cores, no
    fallback), then its first ``LAUNCH_PLAIN_STEPS`` steps again on the
    plain versions (no launch): each step's loss within
    ``LAUNCH_LOSS_RTOL`` of the plain one.  Returns the kernels' run's
    launches, and its losses and s/step."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as launcher
    counters = lm_counters()
    tc = counters[2:5]
    argv = ["--arch", "qwen2-0.5b", "--batch", str(LM_FULL["batch"]),
            "--seq", str(LM_FULL["seq_len"])]
    runs = {}
    for label, extra in (("kernels", ["--steps", str(LAUNCH_STEPS)]),
                         ("plain", ["--steps", str(LAUNCH_PLAIN_STEPS),
                                    "--no-use-kernel"])):
        for c in counters:                       # counts to 0 just before
            c.launches = 0
        tc0 = [c.launches_tc for c in tc]
        kops.reset_kernel_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = launcher.main(argv + extra)
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
        out["all_launches"] = {c.__name__: c.launches for c in counters}
        out["launches_tc"] = [c.launches_tc - t for c, t in zip(tc, tc0)]
        runs[label] = out
        free()
    k, p = runs["kernels"], runs["plain"]
    L, n = 24, LAUNCH_STEPS
    assert k["launches"] == {"B1": n, "B2": L * n, "B3": L * n,
                             "B4": L * n, "B5": 0, "B6": 0}, k["launches"]
    assert k["all_launches"] == {
        "stacked_tree_update": n, "stacked_leaf_update": 0,
        "flash_attention_fwd": L * n, "flash_attention_bwd_dq": L * n,
        "flash_attention_bwd_dkv": L * n, "ssd_intra_fwd": 0,
        "ssd_intra_bwd": 0}, k["all_launches"]
    assert k["launches_tc"] == [L * n] * 3, k["launches_tc"]
    assert k["kernel_fallbacks"] == 0 and k["kernel_calls"] == n * (1 + L)
    assert set(p["launches"].values()) == {0}
    assert set(p["all_launches"].values()) == {0}
    assert p["kernel_calls"] == p["kernel_fallbacks"] == 0
    losses = np.array(k["losses"])
    assert np.isfinite(losses).all() and len(losses) == n
    ratios = [abs(a - b) / (LAUNCH_LOSS_RTOL * abs(b))
              for a, b in zip(k["losses"], p["losses"])]
    assert max(ratios) <= 1.0, (k["losses"][:3], p["losses"], ratios)
    emit({"phase": "launch_train", "entry": "repro_torch.launch.train.main",
          "model": "qwen2-0.5b", "dtype": "bfloat16", "layers": L,
          "batch": LM_FULL["batch"], "seq_len": LM_FULL["seq_len"],
          "device": k["device"], "steps": n,
          "seconds_per_step": k["seconds_per_step"],
          "tokens_per_s": k["tokens_per_s"],
          "first_step_seconds": k["step_seconds"][0],
          "wall_seconds": {"kernels": k["wall"], "plain": p["wall"]},
          "plain_seconds_per_step": p["seconds_per_step"],
          "launches": k["launches"], "launches_tc": k["launches_tc"],
          "kernel_calls": k["kernel_calls"],
          "kernel_fallbacks": k["kernel_fallbacks"],
          "losses": k["losses"], "plain_losses": p["losses"],
          "loss_rtol": LAUNCH_LOSS_RTOL,
          "loss_difference_over_tolerance": ratios})
    return k["launches"], {"losses": k["losses"],
                           "seconds_per_step": k["seconds_per_step"]}


# --------------------- 36-37. the kernels on local heads, the launcher on ranks
LOCAL_HEADS_M = 2               # head shards, as two model ranks hold them
# the shapes local_heads splits: the main paths' attention (qwen2-0.5b's
# GQA 14 / 2 splits on whole kv groups, plan case 1; recurrentgemma-2b's
# MQA 10 / 1 inside its one group, case 2) and mamba2-2.7b's SSD heads
LOCAL_HEADS_ATTENTION = {
    "qwen2-0.5b": dict(QWEN, causal=True, window=0),
    "recurrentgemma-2b": WIDE_ATTENTION["recurrentgemma-2b"]}
# launch_ranks' mamba2-2.7b run: mamba2_study's depth and tokens
RANKS_MAMBA = dict(layers=MAMBA_STUDY["layers"], batch=MAMBA_STUDY["batch"],
                   seq=MAMBA_STUDY["seq_len"], steps=5)


def shard_rule(a, whole, parts):
    """A reassembled output ``a`` of the binding's calls on head shards
    against the whole-tensor call's ``whole`` on the same inputs.  bf16 by
    :func:`rounding_rule` with the whole call as the reference: where the
    shards split a sum over heads (case 2's dk / dv, B6's dB / dC), each
    partial sum in ``parts`` was rounded to bf16 once before they were
    added, moving by at most 2^-8 of itself, so ``env = Σ |part|``;
    elsewhere ``env = 0`` (one bf16 ulp + 2^-16 x scale).  f32 within
    1e-5 x scale (the SSD phase's f32 rule).  Returns (row, ok), the row
    saying whether the output came out bit-equal."""
    bits = torch.equal(a, whole)
    if a.dtype == torch.bfloat16:
        env = torch.zeros_like(whole, dtype=torch.float32)
        for part in parts:
            env += part.float().abs()
        row, ok = rounding_rule(a, whole.float(), env,
                                "the whole-tensor call",
                                "sum |partial sums|" if parts else "0")
    else:
        diff = float((a - whole).abs().max())
        scale = float(whole.abs().max())
        row = {"max_abs_err": diff, "scale": scale,
               "err_over_scale": diff / scale, "tolerance": "1e-5 x scale"}
        ok = diff <= 1e-5 * scale
    row["bit_equal"] = bits
    return row, ok


def binding_call(fn, inputs, cotangent, **kw):
    """``fn`` (a kernel binding) on fresh leaves of ``inputs``: its output
    and each input's gradient under ``cotangent``."""
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*leaves, **kw)
    return [out.detach()] + list(torch.autograd.grad(out, leaves,
                                                     cotangent))


def local_heads_operands(arch, dtype, seed):
    """One ``local_heads`` case on the card, made from ``seed``: ``(plan,
    binding, inputs, cotangent, keywords, placements)``.  The placements
    are the operands' on a (data 1, model ``LOCAL_HEADS_M``) mesh: q split
    on heads, k / v split where the kv heads divide, else whole, as the
    launcher's rank step hands them over; SSD's x, dt and the decays split
    on heads, B and C whole.  (The rank step hands dt over whole; the
    backward of its ``Replicate → Shard`` is DTensor's all-gather, which
    crashes on gloo with CUDA tensors, so the ranks on the one card take
    it split.)  The plan is the one they make."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops as kops
    m = LOCAL_HEADS_M
    if arch == "mamba2-2.7b":
        x, dt, lt, Bm, Cm, g = ssd_inputs(*(MAMBA[k] for k in (
            "B", "nc", "Q", "H", "P", "N")), dtype, True, seed)
        placements = ((Shard(0), Shard(3)), (Shard(0), Shard(3)),
                      (Shard(0), Shard(2))) + ((Shard(0), Replicate()),) * 2
        plan = kops.ssd_plan(placements, MAMBA["H"], (1, m))
        return plan, kops.ssd_intra, (x, dt, lt, Bm, Cm), g, {}, placements
    shape = LOCAL_HEADS_ATTENTION[arch]
    B, S, Hq, Hkv, hd = (shape[k] for k in ("B", "S", "Hq", "Hkv", "hd"))
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(B, S, Hq, hd, generator=gen).to(DEV, dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, hd, generator=gen).to(DEV, dtype)
            for _ in range(2))
    kv = (Shard(0), Shard(2) if Hkv % m == 0 else Replicate())
    placements = ((Shard(0), Shard(2)), kv, kv)
    plan = kops.attention_plan(placements, Hq, Hkv, (1, m))
    return plan, kops.flash_attention, (q, k, v), do, dict(
        causal=shape["causal"], window=shape["window"]), placements


def local_heads_attention(arch, dtype, seed):
    """One attention shape on one route, by hand: ``LOCAL_HEADS_M`` head
    shards by the plan (q split on heads; k / v split where the kv heads
    divide, else each shard's kv head), the binding on each, reassembled
    (q heads concatenated; dk / dv concatenated in case 1, summed in bf16
    or f32 as an all-reduce sums them in case 2).  Returns (plan, the
    whole call's output and gradients, the reassembled ones, each one's
    partial sums, empty where none)."""
    plan, fn, (q, k, v), do, mk, _ = local_heads_operands(arch, dtype,
                                                          seed)
    m, Hq, Hkv = LOCAL_HEADS_M, q.shape[2], k.shape[2]
    whole = binding_call(fn, (q, k, v), do, **mk)
    hl = Hq // m
    got = [torch.empty_like(x) for x in whole]
    parts = [[], [], [], []]
    for c in range(m):
        qs = slice(c * hl, (c + 1) * hl)
        if plan.kv_heads is None:
            ks = slice(c * Hkv // m, (c + 1) * Hkv // m)
        else:
            h = plan.kv_heads[1][c]
            ks = slice(h, h + 1)
        out, dq, dk, dv = binding_call(
            fn, (q[:, :, qs], k[:, :, ks], v[:, :, ks]),
            do[:, :, qs].contiguous(), **mk)
        got[0][:, :, qs], got[1][:, :, qs] = out, dq
        if plan.kv_heads is None:
            got[2][:, :, ks], got[3][:, :, ks] = dk, dv
        else:
            parts[2].append(dk)
            parts[3].append(dv)
            if c == 0:
                got[2].zero_()
                got[3].zero_()
            got[2][:, :, ks] += dk
            got[3][:, :, ks] += dv
    return plan, whole, got, parts


def local_heads_ssd(arch, dtype, seed):
    """mamba2-2.7b's SSD shape on one route, by hand: ``LOCAL_HEADS_M``
    head shards by the plan (x, dt and the decays split on heads, B and C
    whole), the binding on each, reassembled (y, dx, ddt, dlt
    concatenated on heads, dB / dC summed).  Returns as
    :func:`local_heads_attention`."""
    plan, fn, (x, dt, lt, Bm, Cm), g, _, _ = local_heads_operands(
        arch, dtype, seed)
    m, H = LOCAL_HEADS_M, x.shape[3]
    whole = binding_call(fn, (x, dt, lt, Bm, Cm), g)
    got = [torch.empty_like(t) for t in whole]
    parts = [[], [], [], [], [], []]
    hl = H // m
    for c in range(m):
        hs = slice(c * hl, (c + 1) * hl)
        y, dx, ddt, dlt, dB, dC = binding_call(
            fn, (x[:, :, :, hs], dt[..., hs], lt[:, :, hs], Bm, Cm),
            g[:, :, :, hs].contiguous())
        got[0][:, :, :, hs], got[1][:, :, :, hs] = y, dx
        got[2][..., hs], got[3][:, :, hs] = ddt, dlt
        parts[4].append(dB)
        parts[5].append(dC)
    got[4] = parts[4][0] + parts[4][1]
    got[5] = parts[5][0] + parts[5][1]
    return plan, whole, got, parts


def misaligned_call(arch, seed):
    """``arch``'s attention in bf16 with q handed over contiguous but 2
    bytes past a 16-byte boundary, as a rank's batch slice of a replica
    can lie: the binding copies it to an aligned buffer for the TMA maps
    (``ops._aligned``).  Returns whether its output and gradients came out
    bit-equal to the call on aligned q."""
    _, fn, (q, k, v), do, mk, _ = local_heads_operands(
        arch, torch.bfloat16, seed)
    whole = binding_call(fn, (q, k, v), do, **mk)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    qm = buf[1:].view(q.shape)
    qm.copy_(q)
    assert qm.is_contiguous() and qm.data_ptr() % 16, qm.data_ptr()
    leaves = [qm.requires_grad_()] + [x.detach().clone().requires_grad_()
                                      for x in (k, v)]
    out = fn(*leaves, **mk)
    got = [out.detach()] + list(torch.autograd.grad(out, leaves, do))
    return all(torch.equal(a, b) for a, b in zip(got, whole))


def local_heads_ranks_child(spec):
    """One of ``LOCAL_HEADS_M`` gloo ranks on the one card (NCCL takes one
    rank a card): each ``local_heads`` case of ``spec["cases"]``, remade
    from its seed, as DTensors on a (data 1, model ``LOCAL_HEADS_M``) mesh
    placed by :func:`local_heads_operands`; the binding on them and its
    backward, the output and every input's gradient placed as the plan
    says (asserted).  Saved to ``spec["out"].<rank>``: each one's local
    tensor and its placement on ``model`` (the shard's tensor dimension,
    ``"partial"`` or ``"replicate"``), the launch deltas and the kernel
    plane's.  Nothing is gathered here: DTensor's collectives crash on
    gloo with CUDA tensors, so :func:`hold_ranks` assembles the pieces.
    Prints no result line."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import ops as kops
    rank, fns, stats = spec["rank"], lm_counters()[2:], kops.KERNEL_STATS
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=LOCAL_HEADS_M)
    got = {}
    try:
        mesh = init_device_mesh(DEV.type, (1, LOCAL_HEADS_M),
                                mesh_dim_names=("data", "model"))
        for arch, dtype, seed in spec["cases"]:
            plan, fn, inputs, cot, kw, placements = local_heads_operands(
                arch, getattr(torch, dtype), seed)
            dts = [distribute_tensor(x, mesh, p, src_data_rank=None)
                   .requires_grad_() for x, p in zip(inputs, placements)]
            before = [(f.launches, f.launches_tc) for f in fns]
            stats0 = (stats.calls, stats.fallbacks, stats.heads_gathered)
            out = fn(*dts, **kw)
            outs = (out,) + torch.autograd.grad(out, dts, distribute_tensor(
                cot, mesh, out.placements, src_data_rank=None))
            torch.cuda.synchronize()
            want = (plan.output,) + tuple(
                g if p == i else p for p, i, g in zip(
                    placements, plan.inputs, plan.grads))
            placed = tuple(tuple(t.placements) for t in outs)
            assert placed == want, (arch, dtype, placed, want)
            got[f"{arch}:{dtype}"] = {
                "local": [t.to_local().cpu() for t in outs],
                "model": ["partial" if p[1].is_partial() else "replicate"
                          if p[1].is_replicate() else p[1].dim
                          for p in placed],
                "placements": [[str(p) for p in ps] for ps in placed],
                "launches": [[f.launches - a, f.launches_tc - b]
                             for f, (a, b) in zip(fns, before)],
                "kernel_plane": [stats.calls - stats0[0],
                                 stats.fallbacks - stats0[1],
                                 stats.heads_gathered - stats0[2]]}
    finally:
        dist.destroy_process_group()
    torch.save(got, f"{spec['out']}.{rank}")
    return 0


def local_heads_ranks(root, cases):
    """Start the ``LOCAL_HEADS_M`` ranks of
    :func:`local_heads_ranks_child` on ``cases``; returns ``join()`` →
    each rank's results, raising if a rank failed."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = os.path.join(root, "local_heads_ranks")
    children = [subprocess.Popen([
        sys.executable, os.path.abspath(__file__),
        "--local-heads-ranks-child", json.dumps(
            {"rank": r, "port": port, "out": out, "cases": cases})])
        for r in range(LOCAL_HEADS_M)]

    def join():
        try:
            codes = [child.wait(timeout=300) for child in children]
            assert codes == [0] * LOCAL_HEADS_M, (
                "a local_heads rank failed", codes)
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        got = []
        for r in range(LOCAL_HEADS_M):
            got.append(torch.load(f"{out}.{r}"))
            os.remove(f"{out}.{r}")
        return got
    return join


LOCAL_HEADS_NAMES = {"attention": ("out", "dq", "dk", "dv"),
                     "ssd": ("y", "dx", "ddt", "dlt", "dB", "dC")}


def hold_ranks(ranks, key, names, whole, hand, tc):
    """One case's DTensor results (every rank's, by
    :func:`local_heads_ranks_child`) against the whole call.  Each output
    is assembled from the ranks' local tensors by its placement on
    ``model``: shards concatenated in rank order, a ``Partial`` sum added
    in rank order (its local tensors the partial sums of
    :func:`shard_rule`), a replica the same on every rank; then held by
    :func:`shard_rule`.  Each rank made one call, no fallback, no head
    gathered, and one launch of each of the binding's kernels (on the
    tensor cores where ``tc``).  Returns (rows, ok), each row saying
    whether the output came out bit-equal to the reassembled hand
    shards."""
    attention = names == LOCAL_HEADS_NAMES["attention"]
    want = [[1, int(tc)] if (i < 3) == attention else [0, 0]
            for i in range(5)]
    r0 = ranks[0][key]
    for r in ranks:
        assert r[key]["launches"] == want, (key, r[key]["launches"])
        assert r[key]["kernel_plane"] == [1, 0, 0], r[key]["kernel_plane"]
        assert r[key]["placements"] == r0["placements"], key
    rows, ok_all = {}, True
    for i, name in enumerate(names):
        pieces = [r[key]["local"][i].to(DEV) for r in ranks]
        placed, parts = r0["model"][i], []
        if placed == "partial":
            a, parts = pieces[0], pieces
            for piece in pieces[1:]:
                a = a + piece
        elif placed == "replicate":
            a = pieces[0]
            assert all(torch.equal(a, p) for p in pieces), (key, name)
        else:
            a = torch.cat(pieces, placed)
        rows[name], ok = shard_rule(a, whole[i].to(DEV), parts)
        rows[name]["bit_equal_to_hand_shards"] = torch.equal(a.cpu(),
                                                             hand[i])
        rows[name]["placements"] = r0["placements"][i]
        ok_all = ok_all and ok
    return rows, ok_all


def local_heads_phase(join_build, root):
    """The bindings on ``LOCAL_HEADS_M`` head shards at the main paths'
    shapes (qwen2-0.5b's attention, plan case 1; recurrentgemma-2b's, case
    2; mamba2-2.7b's SSD), bf16 on the tensor cores and f32, two ways.  In
    this process, by hand, as two model ranks hold them: each reassembled
    output by :func:`shard_rule` against the whole-tensor call on the same
    inputs, and whether it came out bit-equal; the tensor-core route
    asserted by the ``launches_tc`` deltas (each shard and the whole call
    one forward and one backward).  On DTensors, over ``LOCAL_HEADS_M``
    gloo ranks in child processes on the one card
    (:func:`local_heads_ranks_child`, started first): the same rule
    against the same whole call, assembled by :func:`hold_ranks`.
    Besides, q handed over misaligned (:func:`misaligned_call`)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssk
    join_build("flash_attention")
    join_build("ssd_scan")
    archs = (*LOCAL_HEADS_ATTENTION, "mamba2-2.7b")
    dtypes = ((torch.bfloat16, True), (torch.float32, False))
    join_ranks = local_heads_ranks(root, [
        [arch, str(dt).replace("torch.", ""), 300 + i]
        for i, arch in enumerate(archs) for dt, _ in dtypes])
    calls = LOCAL_HEADS_M + 1
    fa_fns = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv)
    ssd_fns = (ssk.ssd_intra_fwd, ssk.ssd_intra_bwd)
    shapes, kept = {}, {}
    for seed, arch in enumerate(archs, 300):
        ssd = arch == "mamba2-2.7b"
        fns, run = (ssd_fns, local_heads_ssd) if ssd else (
            fa_fns, local_heads_attention)
        names = LOCAL_HEADS_NAMES["ssd" if ssd else "attention"]
        routes = {}
        for dtype, tc in dtypes:
            before = [(f.launches, f.launches_tc) for f in fns]
            plan, whole, got, parts = run(arch, dtype, seed)
            rows, ok_all = {}, True
            for i, name in enumerate(names):
                rows[name], ok = shard_rule(got[i], whole[i], parts[i])
                ok_all = ok_all and ok
            torch.cuda.synchronize()
            assert ok_all, ("a shard result disagrees with the whole call",
                            arch, str(dtype), rows)
            deltas = [(f.launches - a, f.launches_tc - b)
                      for f, (a, b) in zip(fns, before)]
            assert deltas == [(calls, calls if tc else 0)] * len(fns), (
                arch, str(dtype), deltas)
            route = str(dtype).replace("torch.", "")
            routes[route] = {
                "outputs": rows, "launches": [d[0] for d in deltas],
                "launches_tc": [d[1] for d in deltas]}
            kept[f"{arch}:{route}"] = (names, [t.cpu() for t in whole],
                                       [t.cpu() for t in got], tc)
            del whole, got, parts
            free()
        shapes[arch] = {"plan_cases": list(plan.cases),
                        "kv_heads": plan.kv_heads, "routes": routes}
    aligned = misaligned_call("qwen2-0.5b", 300)
    assert aligned, "misaligned q did not come out bit-equal"
    ranks = join_ranks()
    on_ranks = {}
    for key, (names, whole, hand, tc) in kept.items():
        rows, ok = hold_ranks(ranks, key, names, whole, hand, tc)
        assert ok, ("a DTensor result disagrees with the whole call", key,
                    rows)
        on_ranks[key] = rows
    emit({"phase": "local_heads", "head_shards": LOCAL_HEADS_M,
          "shapes": shapes,
          "shape_args": {"qwen2-0.5b": QWEN,
                         "recurrentgemma-2b": LOCAL_HEADS_ATTENTION[
                             "recurrentgemma-2b"], "mamba2-2.7b": MAMBA},
          "rule": "bf16 rounding_rule against the whole call (env = sum "
                  "|partial sums| where a head sum is split, else 0); f32 "
                  "1e-5 x scale",
          "dtensor_ranks": {
              "process_group": f"gloo, world {LOCAL_HEADS_M}, one card",
              "mesh": {"data": 1, "model": LOCAL_HEADS_M},
              "entry": "kops.flash_attention / kops.ssd_intra on DTensors",
              "assembled": "from each rank's local tensors by their "
                           "placements (DTensor's collectives crash on "
                           "gloo with CUDA tensors)",
              "cases": on_ranks},
          "misaligned_q_bit_equal": aligned})


def launch_ranks_child(spec):
    """A fresh process with a one-rank NCCL process group (this process's
    stays without one): the function each rank of ``torchrun`` runs,
    ``launch.train._train_ranks``, with ``--use-kernel`` on a (1, 1)
    ``DeviceMesh`` for each run of ``spec["runs"]`` (its launches and
    kernel counters set to 0 just before), and the one-process launcher
    for each of ``spec["one_process"]``, each run ``(argv, layers)``: the
    launcher's config cut to ``layers`` layers where that is not None
    (the widths kept); the reports written to ``spec["out"]``.  Prints no
    result line."""
    import socket

    import torch.distributed as dist
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as launcher
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    counters = lm_counters()
    reports = {}

    get_config = launcher.get_config

    def run(label, fn, layers):
        launcher.get_config = get_config if layers is None else (
            lambda arch: dataclasses.replace(get_config(arch),
                                             num_layers=layers))
        for c in counters:                       # counts to 0 just before
            c.launches = 0
            if hasattr(c, "launches_tc"):
                c.launches_tc = 0
        kops.reset_kernel_stats()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                rep = fn()
        finally:
            launcher.get_config = get_config
        torch.cuda.synchronize()
        rep["wall"] = time.perf_counter() - t0
        rep["all_launches"] = {c.__name__: c.launches for c in counters}
        rep.pop("local_shapes", None)
        reports[label] = rep
        free()

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        for label, (argv, layers) in spec["runs"].items():
            run(label, lambda: launcher._train_ranks(
                *launcher.parse(argv), world=1), layers)
    finally:
        dist.destroy_process_group()
    for label, (argv, layers) in spec["one_process"].items():
        run(f"one_process:{label}", lambda: launcher.main(argv), layers)
    with open(spec["out"], "w") as f:
        json.dump(reports, f)
    return 0


def launch_ranks_phase(root, one_qwen):
    """In a child process (``--launch-ranks-child``: a one-rank NCCL
    process group), the launcher's rank function with ``--use-kernel`` on
    a (1, 1) mesh: qwen2-0.5b at full width, batch 4 × 1024,
    ``LAUNCH_STEPS`` steps (B2–B4 24 a step on the tensor cores), and
    mamba2-2.7b at full width and ``RANKS_MAMBA["layers"]`` of its 64
    layers, batch 1 × 2048 (B5 / B6 4 a step on the tensor cores), then
    mamba2's one-process launcher with the kernels; no fallback, no head
    gathered, the update the plain one (B1 0, as the JAX launcher's step);
    each step's loss within ``LAUNCH_LOSS_RTOL`` of the one-process
    launcher's kernels run from the same seed (qwen2's: ``launch_train``'s
    ``one_qwen``).  Returns the rank runs' launches, qwen2's B2–B4 and
    mamba2's B5 / B6."""
    out = os.path.join(root, "launch_ranks.json")
    qwen = ["--arch", "qwen2-0.5b", "--batch", str(LM_FULL["batch"]),
            "--seq", str(LM_FULL["seq_len"]), "--steps", str(LAUNCH_STEPS),
            "--use-kernel"]
    mamba = ["--arch", "mamba2-2.7b", "--batch", str(RANKS_MAMBA["batch"]),
             "--seq", str(RANKS_MAMBA["seq"]), "--steps",
             str(RANKS_MAMBA["steps"]), "--use-kernel"]
    cut = (mamba, RANKS_MAMBA["layers"])
    spec = {"out": out, "runs": {"qwen2-0.5b": (qwen, None),
                                 "mamba2-2.7b": cut},
            "one_process": {"mamba2-2.7b": cut}}
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--launch-ranks-child", json.dumps(spec)])
    try:
        assert child.wait(timeout=900) == 0, "the launch_ranks child failed"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with open(out) as f:
        reports = json.load(f)
    os.remove(out)
    one = reports["one_process:mamba2-2.7b"]
    n, layers = RANKS_MAMBA["steps"], RANKS_MAMBA["layers"]
    assert one["launches"] == {"B1": n, "B2": 0, "B3": 0, "B4": 0,
                               "B5": layers * n, "B6": layers * n}, \
        one["launches"]
    assert one["kernel_fallbacks"] == 0
    rows = {}
    for arch, one, layers, n, keys in (
            ("qwen2-0.5b", {"losses": one_qwen["losses"],
                            "seconds_per_step": one_qwen[
                                "seconds_per_step"]},
             24, LAUNCH_STEPS, ("B2", "B3", "B4")),
            ("mamba2-2.7b", one, layers, n, ("B5", "B6"))):
        r = reports[arch]
        want = {k: (layers * n if k in keys else 0)
                for k in ("B1", "B2", "B3", "B4", "B5", "B6")}
        assert r["launches"] == want, (arch, r["launches"])
        assert r["launches_tc"] == {k: v for k, v in want.items()
                                    if k != "B1"}, (arch, r["launches_tc"])
        assert r["kernel_fallbacks"] == 0 and r["heads_gathered"] == 0, r
        assert r["kernel_calls"] == layers * n, (arch, r["kernel_calls"])
        assert r["mesh"] == {"data": 1, "model": 1} and r["world"] == 1
        losses = np.array(r["losses"])
        assert np.isfinite(losses).all() and len(losses) == n
        ratios = [abs(a - b) / (LAUNCH_LOSS_RTOL * abs(b))
                  for a, b in zip(r["losses"], one["losses"])]
        assert max(ratios) <= 1.0, (arch, r["losses"], one["losses"])
        rows[arch] = {
            "argv": spec["runs"][arch][0], "layers": layers, "steps": n,
            "device": r["device"], "seconds_per_step": r["seconds_per_step"],
            "tokens_per_s": r["tokens_per_s"],
            "first_step_seconds": r["step_seconds"][0],
            "wall_seconds": r["wall"],
            "one_process_seconds_per_step": one["seconds_per_step"],
            "launches": r["launches"], "launches_tc": r["launches_tc"],
            "all_launches": r["all_launches"],
            "kernel_calls": r["kernel_calls"],
            "kernel_fallbacks": r["kernel_fallbacks"],
            "heads_gathered": r["heads_gathered"], "losses": r["losses"],
            "one_process_losses": one["losses"],
            "loss_rtol": LAUNCH_LOSS_RTOL,
            "loss_difference_over_tolerance": ratios}
    emit({"phase": "launch_ranks", "entry":
          "repro_torch.launch.train._train_ranks (one rank of torchrun)",
          "process_group": "nccl, world 1", "mesh": {"data": 1, "model": 1},
          "dtype": "bfloat16", "runs": rows,
          "note": "one card: no collective crosses cards, no multi-card "
                  "figure"})
    return {**{k: rows["qwen2-0.5b"]["launches"][k]
               for k in ("B1", "B2", "B3", "B4")},
            **{k: rows["mamba2-2.7b"]["launches"][k] for k in ("B5", "B6")}}


def boundary_outage(step):
    """A fault injector that, from the first batched-group attempt on,
    fails the first put of a boundary at ``step`` (a chain's second
    boundary, after its first committed) and nothing else."""
    from repro_torch.core.faults import FaultInjector, StoreOutageError

    class BoundaryOutage(FaultInjector):
        def __init__(self):
            super().__init__(0)
            self._armed, self._left = False, 1

        def before_execute(self, site):
            if site.startswith(("group:", "group-chain:")):
                self._armed = True

        def on_store_op(self, op, key):
            if (self._armed and self._left and op == "put"
                    and key.endswith(f"@{step}")):
                self._left = 0
                self._record("outage", f"{op}:{key}")
                raise StoreOutageError(f"injected store outage at {key}")

    return BoundaryOutage()


def group_retry_phase(backend):
    """A retry that crosses the group tiers, on qwen2-0.5b at full width
    on the vectorised tier (``backend``: lm_group_study's trainer): three
    siblings forked at step 2 whose chains run 2 → 4 → 6, one worker, so
    the first chain takes the prefix and one sibling and the other two run
    as one depth-2 group chain; a store outage fails one member's put of
    step 6 after its step-4 put committed.  The member is retried solo;
    its committed boundary was taken back, so the run finishes with the
    bitwise retry check unchanged (no re-put verified, none failed).
    Against the fault-free run: the same ``steps_run`` and evaluations,
    the other members' metrics bit-equal, the retried member's within the
    tiers' tolerance; B1–B4 launches exact.  Returns the launches."""
    from repro_torch.core import (Constant, HpConfig, MultiStep,
                                  SearchPlanDB, StudyService, StudySpec,
                                  Trial)
    from repro_torch.core.tuners import GridTuner
    from repro_torch.kernels import ops as kops
    assert backend.vectorize_groups and not backend.batched_bitwise_solo
    L = backend.task.cfg.num_layers
    counters = lm_counters()
    tc = counters[2:5]
    spec = StudySpec("qwen2-0.5b", "synthetic-lm", ("lr", "bs"))
    values = (6e-4, 1e-4, 3e-5)
    runs = {}
    for faulty in (False, True):
        inj = boundary_outage(6) if faulty else None
        trials = [Trial(HpConfig({"lr": MultiStep(3e-4, [2, 4],
                                                  values=[3e-4, v, 1e-4]),
                                  "bs": Constant(LM_FULL["batch"])}), 6)
                  for v in values]
        svc = StudyService(SearchPlanDB(), backend, n_workers=1,
                           batch_siblings=True, fault_injector=inj)
        for c in counters:
            c.launches = 0
        tc0 = [c.launches_tc for c in tc]
        kops.reset_kernel_stats()
        evals0 = backend.evaluations
        t0 = time.perf_counter()
        svc.submit(spec, GridTuner(trials))
        stats = svc.close()
        torch.cuda.synchronize()
        plan = svc.engine.plan
        runs[faulty] = dict(
            stats=stats, wall=time.perf_counter() - t0, inj=inj,
            launches={c.__name__: c.launches for c in counters},
            launches_tc=[c.launches_tc - t for c, t in zip(tc, tc0)],
            evals=backend.evaluations - evals0,
            metrics={t.trial_id: plan.nodes[plan.trial_paths[t.trial_id][-1]]
                     .metrics[6] for t in trials})
        del svc, plan
        free()
    ref, got = runs[False], runs[True]
    st, inj = got["stats"], got["inj"]
    assert ref["stats"].batched_groups == st.batched_groups == 1
    assert ref["stats"].stage_failures == 0
    assert st.stage_failures == st.stage_retries == 1
    assert st.groups_degraded == 0 and st.faults_injected == 1
    assert [e["kind"] for e in inj.log] == ["outage"]
    assert inj.log[0]["site"].endswith("@6")
    assert inj.retries_verified == 0
    assert st.steps_run == ref["stats"].steps_run == 6 + 2 * 4
    assert got["evals"] == ref["evals"] == len(values)
    for r, n in ((ref, 6 + 4), (got, 6 + 4 + 4)):   # + the solo retry
        e = r["evals"]
        assert r["launches"] == {
            "stacked_tree_update": n, "stacked_leaf_update": 0,
            "flash_attention_fwd": L * (n + e),
            "flash_attention_bwd_dq": L * n,
            "flash_attention_bwd_dkv": L * n,
            "ssd_intra_fwd": 0, "ssd_intra_bwd": 0}, (r["launches"], n, e)
        assert r["launches_tc"] == [L * (n + e), L * n, L * n]
    diffs = {tid: max(abs(m[k] - ref["metrics"][tid][k]) for k in m)
             for tid, m in got["metrics"].items()}
    retried = [tid for tid, x in diffs.items() if x != 0.0]
    assert len(retried) <= 1, diffs
    assert max(diffs.values()) <= GROUP_RETRY_METRIC_TOL, diffs
    emit({"phase": "group_retry", "model": "qwen2-0.5b",
          "dtype": "bfloat16", "layers": L, "tier": "vectorised",
          "chains": "prefix 0-2, siblings 2-4-6 (a depth-2 group chain of 2)",
          "fault": inj.log[0], "stage_failures": st.stage_failures,
          "stage_retries": st.stage_retries,
          "retries_verified": inj.retries_verified,
          "steps_run": st.steps_run, "evaluations": got["evals"],
          "launches": {"fault_free": ref["launches"],
                       "faulty": got["launches"]},
          "launches_tc": {"fault_free": ref["launches_tc"],
                          "faulty": got["launches_tc"]},
          "metric_difference_by_trial": diffs,
          "metric_tolerance": GROUP_RETRY_METRIC_TOL,
          "retry_check": "bitwise, unchanged",
          "wall_seconds": {"fault_free": ref["wall"], "faulty": got["wall"]}})
    return {"fault_free": ref["launches"], "faulty": got["launches"]}


def serve_studies_meshes():
    """``serve_studies --workers 1`` serving one ResNet56 study (its own
    grid at ``--steps 40``, the critical-path policy) over a thread slot
    and over a one-device mesh slot (``--devices-per-worker 1``): the
    count fields equal, B1 = the device's steps in both, mesh placements
    and d2d handoffs only on the mesh slot.  Returns B1's launches."""
    import torch_hpo_resnet as example
    from repro_torch.launch import serve_studies
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    computed = device_steps(backend)
    runs = {}
    for dpw in (0, 1):
        b1_reset()
        steps0 = computed["steps"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            [(key, stats)] = serve_studies.main(
                ["--studies", "1", "--workers", "1", "--steps", "40",
                 "--policy", "critical_path", "--model", "resnet56",
                 "--dataset", "synthetic-cifar", "--devices-per-worker",
                 str(dpw)], backend=lambda: backend)
        torch.cuda.synchronize()
        launches = b1_read()
        assert launches == stats.kernel_calls == \
            computed["steps"] - steps0 == stats.steps_run, (
                launches, stats.kernel_calls, stats.steps_run)
        runs[dpw] = dict(stats=stats, launches=launches,
                         wall=time.perf_counter() - t0)
    t, m = runs[0]["stats"], runs[1]["stats"]
    assert counts(m) == counts(t), (counts(m), counts(t))
    assert m.mesh_placements > 0 and t.mesh_placements == 0
    assert t.d2d_handoffs == 0
    emit({"phase": "gateway_serve_studies",
          "entry": "repro_torch.launch.serve_studies.main",
          "argv": "--studies 1 --workers 1 --steps 40 --policy "
                  "critical_path --devices-per-worker 0 | 1",
          "model": "ResNet(n=9, width=16)", "counts": counts(m),
          "mesh_placements": m.mesh_placements,
          "d2d_handoffs": m.d2d_handoffs,
          "counts_equal_to_thread_slot": True,
          "b1_launches": {"thread": runs[0]["launches"],
                          "mesh": runs[1]["launches"]},
          "wall_seconds": {"thread": runs[0]["wall"],
                           "mesh": runs[1]["wall"]}})
    return {"thread": runs[0]["launches"], "mesh": runs[1]["launches"]}


# ------------------------------------------ 27-29. decode and Mixture-of-Experts
def decode_counters():
    """The launch counters of every kernel the serve and MoE phases may
    run, zeroed; ``read()`` gives each one's launches since."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    counters = (stacked_tree_update, stacked_leaf_update,
                fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, ssk.ssd_intra_fwd,
                ssk.ssd_intra_bwd)
    for c in counters:
        c.launches = 0
    kops.reset_kernel_stats()

    def read():
        calls, fallbacks = kops.KERNEL_STATS.snapshot()
        assert fallbacks == 0, kops.KERNEL_STATS.reasons
        return {c.__name__: c.launches for c in counters}
    return read


def serve_pass(model, params, params_f32, prompts, new):
    """``prompts`` (B, P) fed token by token through ``build_serve_step``,
    then ``new`` greedy tokens, the position a 0-d device tensor and CUDA's
    sync debug mode set to raise (a step that reads the device back to the
    host fails).  Every step's logits are recorded on the way (a wrapper of
    ``model.decode_step``, which the serve step calls) and held against the
    port's forward over the same P + new tokens (the kernels' path: B2 /
    B5 in bf16; an SSD model's padded to whole chunks): per row, within ``tol = 4 · e``, ``e`` the row's largest
    |bf16 forward − f32 forward| (the plain path on the same weights in
    f32, ``params_f32``).  Decode and the bf16 forward are two bf16
    computations of one function, each about ``e`` from the f32 one; the
    second 2 is margin.  Greedy tokens must equal the forward's arg-max
    wherever its top-1 / top-2 margin exceeds ``2 · tol``.  An f32 model
    (``params_f32`` None) is held within ``F32_DECODE_TOL``, the
    reference's own decode test's tolerance.  Returns the pass's record."""
    from repro_torch.models.transformer import LM
    from repro_torch.train.step import build_serve_step
    cfg = model.cfg
    B, P = prompts.shape
    logits = []
    inner = model.decode_step

    def recording(*args):
        lg, cache = inner(*args)
        logits.append(lg[:, 0])
        return lg, cache

    model.decode_step = recording
    try:
        serve = build_serve_step(model)
        cache = model.init_cache(B, P + new, device=DEV)
        index = torch.zeros((), dtype=torch.int64, device=DEV)
        nexts = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(P):
                tok, cache = serve(params, cache, prompts[:, i:i + 1], index)
                nexts.append(tok)
                index += 1
            t1 = time.perf_counter()
            for _ in range(new):
                tok, cache = serve(params, cache, tok[:, None], index)
                nexts.append(tok)
                index += 1
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        del model.decode_step            # the class's method again
    del cache
    nexts = torch.stack(nexts, 1)                    # (B, P + new)
    seq = torch.cat([prompts, nexts[:, P - 1:-1].long()], 1)
    dec = torch.stack(logits, 1)                     # (B, P + new, V)
    del logits
    # the SSD forward takes whole chunks: pad the sequence to one with
    # zeros, which a causal model's earlier positions do not see
    T = seq.shape[1]
    chunk = cfg.ssm_chunk if "ssm" in model.pattern else 1
    padded = torch.nn.functional.pad(seq, (0, -T % chunk))
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": padded})[0][:, :T]
        if params_f32 is None:       # an f32 model: the reference's 5e-3
            e = torch.zeros(fwd.shape[:2], device=DEV)
            tol = torch.full_like(e, F32_DECODE_TOL)
        else:
            f32 = LM(dataclasses.replace(cfg, dtype="float32")).forward(
                params_f32, {"tokens": padded})[0][:, :T]
            e = (fwd - f32).abs().amax(-1)           # (B, T)
            del f32
            tol = 4.0 * e
    diff = (dec - fwd).abs().amax(-1)
    ratio = float((diff / tol.clamp_min(1e-30)).max())
    assert bool(dec.isfinite().all()) and dec.shape == fwd.shape
    assert ratio <= 1.0, ("decode disagrees with the forward", ratio)
    top2 = fwd.topk(2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    sure = margin > 2.0 * tol
    agree = nexts.long() == top2.indices[..., 0]
    assert bool(agree[sure].all()), "a greedy token differs where the " \
        "forward's margin exceeds twice the bound"
    return {"batch": B, "prompt_tokens": P, "new_tokens": new,
            "steps": P + new,
            "prefill_ms_per_step": (t1 - t0) / P * 1e3,
            "decode_ms_per_step": (t2 - t1) / new * 1e3,
            "decode_tokens_per_second": B * new / (t2 - t1),
            "no_host_sync": True,
            "max_abs_logit_diff": float(diff.max()),
            "max_diff_over_bound": ratio,
            "bound_median": float(tol.median()),
            "bound_max": float(tol.max()),
            "bf16_forward_err_vs_f32_max": float(e.max()),
            "max_abs_logit": float(fwd.abs().max()),
            "greedy_positions_checked": int(sure.sum()),
            "greedy_positions": int(sure.numel()),
            "greedy_agree_share_all": float(agree.float().mean())}


def decode_32k(model, params, steps):
    """The ``decode_32k`` shape at its full size: batch 128 and 32,768
    cache slots as ``init_cache`` makes them, the position from 32,767 on
    (every KV slot live; the work does not depend on the values).
    ``steps`` serve steps timed on the host clock (ending in a sync) and
    by CUDA events; the bound: the bytes a step must move — the cache read
    (a KV slot once; an SSD state read and written) and the parameters
    read once — over 3.35 TB/s; peak memory; one step's transient memory
    beyond the cache (whether the attention einsum copies a layer's K / V:
    1.07 GB for qwen2-0.5b); launches per token and the device's idle
    share from the profiler."""
    from repro_torch.configs import SHAPES
    from repro_torch.train.step import build_serve_step
    from repro_torch.utils.tree import tree_leaves
    shape = SHAPES["decode_32k"]
    B, L = shape.global_batch, shape.seq_len
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(B, L, device=DEV)
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(cache))
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))
    kv = any(k == "attn" for k in model.pattern)
    layer_k_bytes = (B * L * cfg.num_kv_heads * cfg.resolved_head_dim * 2
                     if kv else 0)
    serve = build_serve_step(model)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=DEV)
    index = torch.full((), L - 1, dtype=torch.int64, device=DEV)

    def step():
        nonlocal tok, cache
        nxt, cache = serve(params, cache, tok, index)
        tok = nxt[:, None]
        index.add_(1)

    step()
    step()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(steps):
            step()
        e1.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    event_ms = e0.elapsed_time(e1) / steps
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: [step() for _ in range(2)], 2, host_ms * 2)
    nbytes = (cache_bytes if kv else 2 * cache_bytes) + param_bytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    assert bool(tok.ge(0).all()) and int(index) == L - 1 + steps + 5
    del cache
    return {"shape": f"decode_32k: batch {B}, {L} slots, index >= {L - 1}",
            "steps": steps, "ms_per_step": host_ms,
            "ms_per_step_events": event_ms,
            "tokens_per_second": B / (host_ms / 1e3),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_bytes": nbytes, "cache_bytes": cache_bytes,
            "parameter_bytes": param_bytes,
            "ms_over_bound": host_ms / bound_ms,
            "launches_per_token": prof["device_kernel_launches_per_step"],
            "device_busy_ms_per_step":
                prof["device_busy_ms"] / 2
                if isinstance(prof["device_busy_ms"], float)
                else "not measured",
            "device_idle_share": prof["device_idle_share"],
            "top_device_time": prof["top_device_time"][:5],
            "step_transient_bytes": transient,
            "layer_k_bytes": layer_k_bytes,
            "attention_einsum_copies_cache":
                bool(kv and transient >= layer_k_bytes),
            "peak_device_memory_gib": peak / 2 ** 30,
            "no_host_sync": True}


def lm_params(cfg, seed=0):
    """``LM(cfg).init(seed)`` on the card (drawn on the host), its f32
    copy, and the draw's seconds."""
    from repro_torch.models.transformer import LM
    from repro_torch.utils.tree import tree_map
    t0 = time.perf_counter()
    params = LM(cfg).init(seed, device=DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    return params, tree_map(lambda x: x.float(), params), draw_s


def serve_phase():
    """qwen2-0.5b at full width and ``SERVE["layers"]`` of its 24 layers,
    bf16: batch 8, a 256-token prompt fed token by token, 64 greedy
    tokens, held against the B2 forward; again with ``sliding_window=128``
    so the ring buffer wraps; then the ``decode_32k`` shape at its full
    size and all 24 layers (weights drawn anew).  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    full = get_config("qwen2-0.5b")
    assert (full.num_layers, full.d_model, full.dtype) == \
        (24, 896, "bfloat16")
    cfg = dataclasses.replace(full, num_layers=SERVE["layers"])
    read = decode_counters()
    params, params_f32, draw_s = lm_params(cfg)
    gen = torch.Generator().manual_seed(21)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE["batch"],
                                                SERVE["prompt"]),
                            generator=gen).to(DEV)
    passes = {}
    for name, window in (("full_cache", 0), ("window", SERVE["window"])):
        model = LM(dataclasses.replace(cfg, sliding_window=window),
                   use_kernel=True)
        passes[name] = serve_pass(model, params, params_f32, prompts,
                                  SERVE["new"])
        free()
    ring = passes["window"]
    assert ring["steps"] > SERVE["window"]            # the ring wrapped
    launches = read()
    # decode launches no kernel of the port's; each forward 24 B2 launches
    expected = {name: 0 for name in launches}
    expected["flash_attention_fwd"] = 2 * cfg.num_layers
    assert launches == expected, launches
    del params, params_f32
    free()
    d32 = decode_32k(LM(full), LM(full).init(0, device=DEV),
                     DECODE_32K_STEPS)
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
          "decode_32k_layers": full.num_layers,
          "dtype": cfg.dtype, "entry": "repro_torch.train.step."
          "build_serve_step", "init_draw_seconds": draw_s,
          "bound_rule": "per row, 4 x max |bf16 forward - f32 forward|",
          "passes": passes, "decode_32k": d32, "launches": launches})
    return launches


def mamba2_serve_phase():
    """mamba2-2.7b at full width and ``MAMBA_SERVE["layers"]`` layers:
    batch 8, 128 prompt tokens and 32 new ones, held against the B5
    forward; then ``decode_32k``'s batch of 128.  Returns the launches."""
    from repro_torch.models.transformer import LM
    cfg = mamba2_cut(MAMBA_SERVE["layers"])
    read = decode_counters()
    params, params_f32, draw_s = lm_params(cfg)
    gen = torch.Generator().manual_seed(22)
    prompts = torch.randint(0, cfg.vocab_size, (MAMBA_SERVE["batch"],
                                                MAMBA_SERVE["prompt"]),
                            generator=gen).to(DEV)
    model = LM(cfg, use_kernel=True)
    run = serve_pass(model, params, params_f32, prompts, MAMBA_SERVE["new"])
    launches = read()
    expected = {name: 0 for name in launches}
    expected["ssd_intra_fwd"] = cfg.num_layers
    assert launches == expected, launches
    del params_f32
    free()
    d32 = decode_32k(LM(cfg), params, DECODE_32K_STEPS)
    emit({"phase": "mamba2_serve", "model": cfg.name,
          "layers": cfg.num_layers, "layers_published": 64,
          "dtype": cfg.dtype, "init_draw_seconds": draw_s,
          "bound_rule": "per row, 4 x max |bf16 forward - f32 forward|",
          "pass": run, "decode_32k": d32, "launches": launches})
    return launches


def moe_phase():
    """qwen2-moe-a2.7b at full width (d_model 2048, 60 experts top-4, 4
    shared, 16 / 16 heads of 128): served at ``MOE_SERVE["layers"]``
    layers drop-free (``capacity_factor=16``) in f32, held against the B2
    forward; then the SHA study of ``examples/torch_hpo_lm.py`` at
    ``MOE_STUDY["layers"]`` layer(s), stage-based against trial-based
    (``lm_study``: the same best trial, every metric bit-equal, exact B1 –
    B4 launches), and the evaluation's loss with its router term equal to
    ``LM.loss`` on the same batch and to ``nll + w · moe_aux / layers``.
    Returns the serve run's and the study's launches."""
    import torch_hpo_lm as lm_example
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    full = get_config("qwen2-moe-a2.7b")
    assert (full.d_model, full.n_experts, full.top_k, full.n_shared_experts,
            full.num_heads, full.num_kv_heads, full.resolved_head_dim) == \
        (2048, 60, 4, 4, 16, 16, 128)
    # served in f32: a token's top-4 of 60 experts flips where two router
    # probabilities sit within a bf16 rounding of each other, and a
    # flipped expert (outputs ~10^3 at this init) moves the logits by
    # units, so bf16 decode and forward are not comparable token by token
    # (on an H100, 14x outside the bf16 rule); B2 takes its f32 route
    cfg = dataclasses.replace(full, num_layers=MOE_SERVE["layers"],
                              capacity_factor=16.0, dtype="float32")
    read = decode_counters()
    t0 = time.perf_counter()
    params = LM(cfg).init(0, device=DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(23)
    prompts = torch.randint(0, cfg.vocab_size, (MOE_SERVE["batch"],
                                                MOE_SERVE["prompt"]),
                            generator=gen).to(DEV)
    run = serve_pass(LM(cfg, use_kernel=True), params, None, prompts,
                     MOE_SERVE["new"])
    launches = read()
    expected = {name: 0 for name in launches}
    expected["flash_attention_fwd"] = cfg.num_layers
    assert launches == expected, launches
    del params
    free()

    layers = MOE_STUDY["layers"]
    data = {k: MOE_STUDY[k] for k in ("batch", "seq_len", "n_train",
                                      "n_eval")}
    study_launches, backend = lm_study(
        "moe_study", lambda: lm_example.make_backend(
            "qwen2-moe-a2.7b", use_kernel=True, layers=layers, **data),
        data["batch"], data["seq_len"], fwd=("flash_attention_fwd",),
        bwd=("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
        model_fields={"d_model": full.d_model, "experts": full.n_experts,
                      "top_k": full.top_k,
                      "shared_d_ff": full.shared_d_ff,
                      "heads": [full.num_heads, full.num_kv_heads],
                      "head_dim": full.resolved_head_dim,
                      "capacity_factor": full.capacity_factor,
                      "vocab": full.vocab_size})
    # the router term: an evaluation through the trainer against LM.loss
    # on the same batch, and against nll + w * moe_aux / layers in f32
    mcfg = backend.task.cfg
    state = backend.init_state()
    metrics = backend.evaluate(state, None)
    with torch.no_grad():
        loss, aux = backend.task.loss(
            backend.on_device(state)[0]["params"], backend.eval_batch)
    nll = torch.tensor(metrics["nll"], dtype=torch.float32)
    moe_aux = torch.tensor(metrics["moe_aux"], dtype=torch.float32)
    recomposed = nll + mcfg.router_aux_weight * moe_aux / max(
        1, mcfg.num_layers)
    assert metrics["loss"] == float(loss), (metrics["loss"], float(loss))
    assert metrics["moe_aux"] == float(aux["moe_aux"]) > 0
    assert metrics["loss"] == float(recomposed), (metrics, float(recomposed))
    del backend, state
    free()
    emit({"phase": "moe", "model": full.name, "serve_layers": cfg.num_layers,
          "study_layers": layers, "serve_dtype": cfg.dtype,
          "study_dtype": full.dtype,
          "serve_capacity_factor": cfg.capacity_factor,
          "init_draw_seconds": draw_s,
          "bound_rule": f"f32, {F32_DECODE_TOL} (the reference's decode "
                        f"test)", "serve": run, "serve_launches": launches,
          "router_term": {"loss": metrics["loss"], "nll": metrics["nll"],
                          "moe_aux": metrics["moe_aux"],
                          "router_aux_weight": mcfg.router_aux_weight,
                          "equals_lm_loss": True,
                          "equals_nll_plus_router_term": True},
          "study_launches": study_launches})
    return launches, study_launches


# ------------------------------------ 30-32. RG-LRU and the frontends
def rglru_study_phase():
    """The SHA study of ``examples/torch_hpo_lm.py`` with recurrentgemma-2b
    at full width and ``RGLRU_STUDY["layers"]`` layers (``lm_study``:
    stage- and trial-based, the same best trial, every metric bit-equal,
    B1 = steps, B2 = 1 × (steps + evaluations), B3 = B4 = steps — the one
    local-attention layer, at head dim 256 on the tensor cores); then the
    log-depth RG-LRU scan alone at the study's shape.  Returns the launch
    counts and the trainer."""
    import torch_hpo_lm as lm_example
    from repro_torch.configs import get_config
    from repro_torch.models.rglru import linear_scan
    full = get_config("recurrentgemma-2b")
    cut = dataclasses.replace(full, num_layers=RGLRU_STUDY["layers"])
    assert (full.d_model, full.rglru_width, full.num_heads,
            full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab_size, full.local_window, full.tie_embeddings,
            full.dtype) == (2560, 2560, 10, 1, 256, 7680, 256000, 2048,
                            True, "bfloat16")
    data = {k: RGLRU_STUDY[k] for k in ("batch", "seq_len", "n_train",
                                        "n_eval")}
    launches, backend = lm_study(
        "rglru_study", lambda: lm_example.make_backend(
            "recurrentgemma-2b", use_kernel=True,
            layers=RGLRU_STUDY["layers"], **data),
        data["batch"], data["seq_len"], fwd=("flash_attention_fwd",),
        bwd=("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
        model_fields={"d_model": full.d_model,
                      "rglru_width": full.rglru_width,
                      "heads": [full.num_heads, full.num_kv_heads],
                      "head_dim": full.resolved_head_dim,
                      "local_window": full.local_window,
                      "layer_kinds": list(cut.layer_kinds()),
                      "layers_published": full.num_layers,
                      "d_ff": full.d_ff, "vocab": full.vocab_size},
        kernel_layers=1)
    assert backend.task.cfg == cut
    assert cut.layer_kinds() == ("rglru", "rglru", "local", "rglru",
                                 "rglru")
    assert cut.param_count() == 1_043_422_720
    # the scan alone, forward and backward, at one layer's (B, S, W)
    B, S, W = data["batch"], data["seq_len"], full.rglru_width
    gen = torch.Generator().manual_seed(30)
    a = (0.9 + 0.0999 * torch.rand((B, S, W), generator=gen)).to(DEV)
    b = torch.randn((B, S, W), generator=gen).to(DEV).requires_grad_(True)
    dh = torch.randn((B, S, W), generator=gen).to(DEV)
    fwd_ms = time_ms(lambda: linear_scan(a, b), reps=10, warm=2)

    def fwd_bwd():
        torch.autograd.grad(linear_scan(a, b), b, dh)
    both_ms = time_ms(fwd_bwd, reps=10, warm=2)
    assert torch.equal(linear_scan(a, b), linear_scan(a, b))
    emit({"phase": "rglru_scan", "shape": [B, S, W], "dtype": "float32",
          "levels": (S - 1).bit_length(), "forward_ms": fwd_ms,
          "forward_backward_ms": both_ms, "bit_equal_twice": True,
          "timing": "CUDA events, mean of 10 calls, median of 3 windows"})
    return launches, backend


def rglru_serve_phase(backend):
    """Decode with the study's model (its trainer's parameters): batch 8,
    256 prompt tokens fed one by one, 64 greedy tokens (``serve_pass``:
    every step within 4 × the bf16 forward's distance from an f32
    forward, on the B2 forward over the same tokens); ms a step, CUDA
    launches a token (profiler) and the peak memory.  Returns the
    launches."""
    from repro_torch.models.transformer import LM
    from repro_torch.train.step import build_serve_step
    from repro_torch.utils.tree import tree_map
    cfg = backend.task.cfg
    read = decode_counters()
    params = backend.on_device(backend.init_state())[0]["params"]
    params_f32 = tree_map(lambda x: x.float(), params)
    gen = torch.Generator().manual_seed(24)
    B, P, new = (RGLRU_SERVE[k] for k in ("batch", "prompt", "new"))
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen).to(DEV)
    model = LM(cfg, use_kernel=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = serve_pass(model, params, params_f32, prompts, new)
    peak = torch.cuda.max_memory_allocated()
    launches = read()
    # decode launches no kernel of the port's; the forward one B2 (the
    # local layer)
    expected = {name: 0 for name in launches}
    expected["flash_attention_fwd"] = 1
    assert launches == expected, launches
    del params_f32
    free()
    # CUDA launches a token: a few decode steps under the profiler
    serve = build_serve_step(model)
    cache = model.init_cache(B, P + new, device=DEV)
    state = {"tok": prompts[:, :1], "cache": cache}
    index = torch.zeros((), dtype=torch.int64, device=DEV)

    def step():
        nxt, state["cache"] = serve(params, state["cache"], state["tok"],
                                    index)
        state["tok"] = nxt[:, None]
        index.add_(1)

    ms = host_ms(step, 8)
    prof = device_profile(lambda: [step() for _ in range(4)], 4, 4 * ms)
    emit({"phase": "rglru_serve", "model": cfg.name,
          "layers": cfg.num_layers, "layer_kinds": list(cfg.layer_kinds()),
          "dtype": cfg.dtype,
          "bound_rule": "per row, 4 x max |bf16 forward - f32 forward|",
          "pass": run, "ms_per_step": ms,
          "launches_per_token": prof["device_kernel_launches_per_step"],
          "device_idle_share": prof["device_idle_share"],
          "peak_device_memory_gib": peak / 2 ** 30, "launches": launches})
    return launches


def mrope_grid(batch, patches, text):
    """M-RoPE ids of a square patch grid then text, (3, B, P + T) on the
    card: patches (t, h, w) = (0, row, column), the text continuing at
    max + 1 in all three sections."""
    side = int(round(patches ** 0.5))
    assert side * side == patches
    idx = torch.arange(patches)
    rows, cols = idx // side, idx % side
    txt = side + torch.arange(text)
    pos = torch.stack([torch.cat([torch.zeros(patches, dtype=torch.long),
                                  txt]),
                       torch.cat([rows, txt]), torch.cat([cols, txt])])
    assert not torch.equal(pos[1], pos[2]) and not torch.equal(pos[0],
                                                               pos[1])
    return pos[:, None].expand(3, batch, patches + text).contiguous().to(DEV)


def frontend_train(cfg, batch, tokens, kernel_layers):
    """``FRONTEND_STEPS`` steps of ``train/step.py``'s train step on one
    batch with the kernels (B1 once a step, B2–B4 once per kernel layer a
    step, all on the tensor cores, no fallback), then the first
    ``FRONTEND_PLAIN_STEPS`` again on the plain versions from the same
    parameters: each loss within ``LAUNCH_LOSS_RTOL`` of the plain one.
    Returns the row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.models.transformer import LM
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.tree import tree_leaves
    t0 = time.perf_counter()
    params0 = LM(cfg).init(0, device=DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params0))
    assert n_params == cfg.param_count(), n_params
    counters = lm_counters()
    tc = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
          fa.flash_attention_bwd_dkv)
    runs = {}
    for label, use_kernel, n in (("kernels", True, FRONTEND_STEPS),
                                 ("plain", False, FRONTEND_PLAIN_STEPS)):
        step_fn = build_train_step(LM(cfg, use_kernel=use_kernel), "adamw")
        params, opt = params0, init_opt_state("adamw", params0)
        for c in counters:                       # counts to 0 just before
            c.launches = 0
        tc0 = [c.launches_tc for c in tc]
        kops.reset_kernel_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, seconds = [], []
        for i in range(n):
            t1 = time.perf_counter()
            params, opt, loss = step_fn(params, opt, batch, 3e-4, i)
            losses.append(float(loss))           # waits for the step
            seconds.append(time.perf_counter() - t1)
        runs[label] = dict(
            losses=losses, seconds=seconds,
            peak=torch.cuda.max_memory_allocated(),
            launches={c.__name__: c.launches for c in counters},
            launches_tc=[c.launches_tc - t for c, t in zip(tc, tc0)],
            stats=kops.KERNEL_STATS.snapshot())
        del params, opt, step_fn
        free()
    k, p = runs["kernels"], runs["plain"]
    n, L = FRONTEND_STEPS, kernel_layers
    assert k["launches"] == {
        "stacked_tree_update": n, "stacked_leaf_update": 0,
        "flash_attention_fwd": L * n, "flash_attention_bwd_dq": L * n,
        "flash_attention_bwd_dkv": L * n, "ssd_intra_fwd": 0,
        "ssd_intra_bwd": 0}, k["launches"]
    assert k["launches_tc"] == [L * n] * 3, k["launches_tc"]
    assert k["stats"] == (n * (1 + L), 0), k["stats"]
    assert set(p["launches"].values()) == {0} and p["stats"] == (0, 0)
    assert np.isfinite(k["losses"]).all()
    ratios = [abs(a - b) / (LAUNCH_LOSS_RTOL * abs(b))
              for a, b in zip(k["losses"], p["losses"])]
    assert max(ratios) <= 1.0, (k["losses"], p["losses"], ratios)
    steady = k["seconds"][1:]
    s_step = sum(steady) / len(steady)
    return {"model": cfg.name, "layers": cfg.num_layers,
            "dtype": cfg.dtype, "parameters": n_params,
            "init_draw_seconds": draw_s, "steps": n,
            "seconds_per_step": s_step, "first_step_seconds":
                k["seconds"][0],
            "tokens_per_s": tokens / s_step,
            "plain_seconds_per_step": sum(p["seconds"][1:])
            / max(1, len(p["seconds"]) - 1),
            "peak_device_memory_gib": k["peak"] / 2 ** 30,
            "launches": k["launches"], "launches_tc": k["launches_tc"],
            "kernel_calls": k["stats"][0], "kernel_fallbacks": 0,
            "losses": k["losses"], "plain_losses": p["losses"],
            "loss_rtol": LAUNCH_LOSS_RTOL,
            "loss_difference_over_tolerance": ratios}


def frontends_phase():
    """Train steps through the frontends on seeded synthetic inputs:
    hubert-xlarge at all 48 layers (audio features (4, 1024, 512) bf16,
    framewise labels in [0, 504); B2–B4 at head dim 80, non-causal) and
    qwen2-vl-7b at ``QWEN_VL_TRAIN["layers"]`` layers (1,024 patches
    (2, 1024, 1280) bf16 and 1,024 text tokens, M-RoPE ids on a 32 × 32
    grid); each by :func:`frontend_train`.  Returns {model: launches}."""
    from repro_torch.configs import get_config
    gen = torch.Generator().manual_seed(31)
    hub = get_config("hubert-xlarge")
    assert (hub.num_layers, hub.d_model, hub.num_heads, hub.num_kv_heads,
            hub.resolved_head_dim, hub.frontend_dim, hub.vocab_size,
            hub.causal) == (48, 1280, 16, 16, 80, 512, 504, False)
    Bh, F_ = HUBERT_TRAIN["batch"], HUBERT_TRAIN["frames"]
    hbatch = {"features": torch.randn((Bh, F_, hub.frontend_dim),
                                      generator=gen).to(DEV, torch.bfloat16),
              "labels": torch.randint(0, hub.vocab_size, (Bh, F_),
                                      generator=gen).to(DEV)}
    rows = {hub.name: frontend_train(hub, hbatch, Bh * F_, hub.num_layers)}
    del hbatch
    free()
    vl_full = get_config("qwen2-vl-7b")
    vl = dataclasses.replace(vl_full, num_layers=QWEN_VL_TRAIN["layers"])
    assert (vl.d_model, vl.num_heads, vl.num_kv_heads, vl.resolved_head_dim,
            vl.frontend_dim, vl.mrope_sections, vl.vocab_size) == \
        (3584, 28, 4, 128, 1280, (16, 24, 24), 152064)
    assert vl.param_count() == 1_560_701_440
    Bv, P, T = (QWEN_VL_TRAIN[k] for k in ("batch", "patches", "text"))
    vbatch = {"patches": torch.randn((Bv, P, vl.frontend_dim),
                                     generator=gen).to(DEV, torch.bfloat16),
              "tokens": torch.randint(0, vl.vocab_size, (Bv, T),
                                      generator=gen).to(DEV),
              "positions": mrope_grid(Bv, P, T)}
    rows[vl.name] = frontend_train(vl, vbatch, Bv * (P + T), vl.num_layers)
    rows[vl.name]["layers_published"] = vl_full.num_layers
    del vbatch
    emit({"phase": "frontends", "entry": "repro_torch.train.step."
          "build_train_step", "optimizer": "adamw",
          "shapes": {"hubert-xlarge": f"features ({Bh}, {F_}, 512) bf16",
                     "qwen2-vl-7b": f"patches ({Bv}, {P}, 1280) bf16 + "
                                    f"{T} text tokens, M-RoPE on a "
                                    f"{int(P ** 0.5)} x {int(P ** 0.5)} grid"},
          "runs": rows})
    return {name: r["launches"] for name, r in rows.items()}


# ------------------------------------------------------------ 34. dry run
#: the production cases the dry run's child process runs: qwen2-0.5b on
#: the single-pod (16 x 16) mesh, one of each step kind
DRYRUN_PRODUCTION = ("qwen2-0.5b", ("decode_32k", "prefill_32k", "train_4k"))
DRYRUN_SHAPES = ("decode_32k", "long_500k", "prefill_32k", "train_4k")
DRYRUN_LOSS_ATOL = 1e-5             # lm_small's: the loss
DRYRUN_ATOL = 1e-4                  # lm_small's: gradients and logits;
                                    # B1's new parameters and moments


def dryrun_expected(cfg, kind):
    """Which kernels a reduced case's step launches: B1 on a train step,
    B2 on a train or prefill step of a model with attention (local
    attention too), B3–B4 on its train step; B5 / B6 likewise for SSD
    blocks; a decode step none (neither package has a decode kernel)."""
    attn = cfg.uses_attention
    ssd = "ssm" in cfg.layer_kinds()
    fwd = kind in ("train", "prefill")
    train = kind == "train"
    return {"B1": train, "B2": attn and fwd, "B3": attn and train,
            "B4": attn and train, "B5": ssd and fwd, "B6": ssd and train}


def dryrun_child(spec):
    """A fresh process (its fake process group of 256 ranks stays out of
    the main process): the production cases of ``DRYRUN_PRODUCTION``,
    each with its roofline terms, written to ``spec["out"]``.  Prints no
    result line."""
    from repro_torch.analysis.roofline import roofline_terms
    from repro_torch.launch.dryrun import run_case
    arch, shapes = DRYRUN_PRODUCTION
    recs = []
    for shape in shapes:
        t0 = time.perf_counter()
        rec = run_case(arch, shape, verbose=False)
        rec["roofline"] = roofline_terms(rec, 256)
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
    with open(spec["out"], "w") as f:
        json.dump(recs, f)
    return 0


def dryrun_phase(root):
    """``repro_torch.launch.dryrun``: every architecture's reduced variant
    × every shape for real on the card (``run_case(reduced=True)``, f32,
    4 x 64 tokens; hubert-xlarge's two decode shapes skipped by design),
    each the kernels' step against the plain step on the same parameters
    (the train loss within 1e-5, every gradient and the B1 update's new
    parameters and moments within 1e-4, the prefill / decode logits within
    1e-4), each kernel launched where the step runs it and nowhere else
    (``dryrun_expected``), the card's memory and the plain step's flops;
    meanwhile, in a child process (``--dryrun-child``, its output under
    ``root``): qwen2-0.5b's production single-pod cases
    (``DRYRUN_PRODUCTION``) over fake tensors, per-device memory against
    the card's, collectives, roofline terms.  The child starts with this
    phase, after every timed phase, and is stopped if the phase fails.
    Returns each kernel's launches summed over the reduced cases."""
    out = os.path.join(root, "dryrun_child.json")
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--dryrun-child", json.dumps({"out": out})])
    try:
        return dryrun_cases(child, out)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def dryrun_cases(child, out):
    """The body of :func:`dryrun_phase`: the reduced cases, then
    ``child``'s production records from ``out``."""
    from repro_torch.configs import SHAPES, get_config, list_archs
    from repro_torch.launch import dryrun
    total = {k: 0 for k in dryrun.LAUNCH_COUNTERS}
    ok = skipped = 0
    for shape in DRYRUN_SHAPES:
        for arch in list_archs():
            rec = dryrun.run_case(arch, shape, reduced=True,
                                  device=DEV, verbose=False)
            if rec["status"] == "skipped":
                assert arch == "hubert-xlarge" and shape.startswith(
                    ("decode", "long")), rec
                skipped += 1
                emit({"phase": "dryrun", "case": f"{arch} x {shape}",
                      "status": "skipped", "reason": rec["reason"]})
                continue
            assert rec["status"] == "ok", rec
            kind = SHAPES[shape].kind
            err = rec["kernel_vs_plain"]
            if kind == "train":
                assert err["loss"] <= DRYRUN_LOSS_ATOL and \
                    err["grads"] <= DRYRUN_ATOL and \
                    err["update"] <= DRYRUN_ATOL, (arch, shape, err)
            else:
                assert err["logits"] <= DRYRUN_ATOL, (arch, shape, err)
            want = dryrun_expected(get_config(arch).reduced(), kind)
            got = rec["launches"]
            assert {k: n > 0 for k, n in got.items()} == want, (
                arch, shape, got)
            for k, n in got.items():
                total[k] += n
            ok += 1
            mem = rec["memory"]
            emit({"phase": "dryrun", "case": f"{arch} x {shape}",
                  "status": "ok", "kind": kind,
                  "memory_bytes": mem, "device_peak_bytes":
                  mem["argument_size_in_bytes"]
                  + mem["temp_size_in_bytes"],
                  "flops": rec["cost"]["flops"],
                  "bytes_accessed": rec["cost"]["bytes accessed"],
                  "launches": got, "kernel_vs_plain": err,
                  "tolerance": {"loss": DRYRUN_LOSS_ATOL,
                                "grads_update_and_logits": DRYRUN_ATOL}})
    assert child.wait(timeout=600) == 0, "the dry run's child failed"
    with open(out) as f:
        prod = json.load(f)
    card = torch.cuda.get_device_properties(0).total_memory
    for rec in prod:
        assert rec["status"] == "ok", rec
        mem, coll = rec["memory"], rec["collectives"]
        per_device = sum(mem.values())
        assert coll["total"] == sum(coll[k] for k in dryrun.COLLECTIVES)
        emit({"phase": "dryrun_production",
              "case": f"{rec['arch']} x {rec['shape']} x 16x16",
              "memory_bytes": mem, "per_device_bytes": per_device,
              "card_memory_bytes": card,
              "per_device_over_card": per_device / card,
              "fits_the_card": per_device <= card,
              "cost": rec["cost"], "collectives": coll,
              "roofline": rec["roofline"], "replicated":
              rec.get("replicated", {}), "lower_s": rec["lower_s"],
              "compile_s": rec["compile_s"], "seconds": rec["seconds"],
              "note": "fake tensors on a fake 256-rank process group: "
                      "rank 0's counts; the roofline terms use H100 "
                      "data-sheet peaks"})
    emit({"phase": "dryrun", "ok": ok, "skipped": skipped,
          "errors": 0, "cases": ok + skipped,
          "production_cases": len(prod), "launches": total})
    assert ok == 38 and skipped == 2, (ok, skipped)
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the session, gateway, dry run, local_heads and launch_ranks phases'
    # child processes
    children = {"--session-child": session_child,
                "--gateway-child": gateway_child,
                "--dryrun-child": dryrun_child,
                "--local-heads-ranks-child": local_heads_ranks_child,
                "--launch-ranks-child": launch_ranks_child}
    if sys.argv[1:2] and sys.argv[1] in children:
        sys.path[:0] = [os.path.join(ROOT, "src"),
                        os.path.join(ROOT, "examples")]
        return children[sys.argv[1]](json.loads(sys.argv[2]))
    # before the first allocation: without expandable segments, the qwen2
    # M 4 chunk of group_step (62.3 GiB at 24 layers, its depth before)
    # failed to find a 9.27 GiB block beside 16 GiB of free fragments that
    # earlier phases left
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples")]
    import repro_torch      # noqa: F401 — outside a checkout, fail here
    import torch_hpo_lm     # noqa: F401
    import torch_hpo_resnet  # noqa: F401

    t_start = time.perf_counter()
    smi, kind = device_phase()                                   # 1
    # the CUDA kernels build while the Triton phases run; a failed build
    # is raised where its phase joins it
    join_build = start_builds()
    # the serialized tiers' directory, outside the checkout, removed at
    # the end whatever happens
    state = mamba2_state_bytes(mamba2_cut(MAMBA_STUDY["layers"]))
    written = STUDY_COMMITS * state + GROUP_STUDY_COMMITS * \
        mamba2_state_bytes(mamba2_cut(MAMBA_GROUP_LAYERS))
    store_dir = tempfile.mkdtemp(prefix="hippo-ckpt-", dir=store_root(
        written, (STUDY_BLOBS_HELD + 1) * state))
    try:
        return run_phases(t_start, smi, kind, join_build, store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def run_phases(t_start, smi, kind, join_build, store_dir):
    seconds = {}                  # each phase's wall seconds, by name

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        free()
        seconds[name] = time.perf_counter() - t0
        return out

    b1_resnet = timed("kernels", b1_phase, join_build)           # 2
    timed("small", small_phase)                                  # 3
    b1_resnet["launches"], memory_runs = timed(
        "study", resnet_study_phase)                             # 4
    timed("step", resnet_step_phase)                             # 5
    timed("ckpt_plane", ckpt_plane_phase, store_dir)             # 16
    timed("resnet_tiered_study", resnet_tiered_study_phase,
          store_dir, memory_runs)                                # 17
    del memory_runs
    fault_launches = timed("fault_plane", fault_plane_phase)     # 19
    session_launches = timed("session", session_phase, store_dir)  # 20
    gateway_launches = timed("gateway", gateway_phase, store_dir)  # 22
    mesh_launches = timed("mesh_plane", mesh_plane_phase, store_dir,
                          smi)                                   # 24
    fa_rows = timed("attention_kernels", attention_phase, join_build)  # 6
    timed("lm_small", lm_small_phase, "lm_small", "qwen2-0.5b", (2, 200),
          4, True)
    b1_row, lm_launches = timed("lm_study", qwen2_phase, fa_rows,
                                b1_resnet)                       # 7, 8
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches"] = lm_launches[fa_rows[key]["name"]]
    train_launches, one_qwen = timed("launch_train",
                                     launch_train_phase)         # 25
    b1_row["launches_launch_train"] = train_launches["B1"]
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches_launch_train"] = train_launches[key]
    timed("local_heads", local_heads_phase, join_build, store_dir)  # 36
    rank_launches = timed("launch_ranks", launch_ranks_phase, store_dir,
                          one_qwen)                              # 37
    emit({"phase": "free", "device_memory_allocated_bytes":
          torch.cuda.memory_allocated()})
    ssd_rows = timed("ssd_kernels", ssd_phase, join_build)       # 9
    timed("ssd_f32", ssd_f32_phase)
    fold_rows = timed("fold", fold_phase)                        # 12
    for key, row in fold_rows.items():
        rows = fa_rows if key in fa_rows else ssd_rows
        rows[key]["fold"] = {"members": FOLD_M,
                             "bit_equal_to_separate_launches": True,
                             "launches_per_group_call": 1, **row}
    timed("mamba2_small", lm_small_phase, "mamba2_small", "mamba2-2.7b",
          (2, 192), 5, False)
    m_launches, backend = timed("mamba2_study", mamba2_study_phase,
                                store_dir)                       # 10
    for key in ("B5", "B6"):
        ssd_rows[key]["launches"] = m_launches[ssd_rows[key]["name"]]
    b1_row["launches_mamba2_study"] = m_launches["stacked_tree_update"]
    b1_row["mamba2_adamw"] = timed(
        "mamba2_step", mamba2_step_phase, ssd_rows, backend)     # 11
    del backend
    free()
    # 13-15: sibling groups, vectorised: the studies with and without
    # groups, then one member-stacked chunk against solo chunks
    b1_row["launches_grouped_studies"] = {
        "resnet56": timed("resnet_group_study", resnet_group_study_phase)[
            "stacked_tree_update"]}
    g_launches, lm_backend, lm_grouped = timed("lm_group_study",
                                               lm_group_study_phase)
    b1_row["launches_grouped_studies"]["qwen2-0.5b"] = \
        g_launches["stacked_tree_update"]
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches_grouped_study"] = \
            g_launches[fa_rows[key]["name"]]
    d_launches = timed("lm_group_degraded", lm_group_degraded_phase,
                       lm_backend, lm_grouped)                   # 21
    del lm_grouped
    r_launches = timed("group_retry", group_retry_phase, lm_backend)  # 26
    b1_row["launches_group_retry"] = {
        run: r["stacked_tree_update"] for run, r in r_launches.items()}
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches_group_retry"] = {
            run: r[fa_rows[key]["name"]] for run, r in r_launches.items()}
    b1_row["launches_fault_plane"] = fault_launches
    b1_row["launches_session"] = session_launches
    b1_row["launches_gateway"] = gateway_launches
    b1_row["launches_mesh_plane"] = mesh_launches
    b1_row["launches_lm_group_degraded"] = {
        tier: r["stacked_tree_update"] for tier, r in d_launches.items()}
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches_lm_group_degraded"] = {
            tier: r[fa_rows[key]["name"]] for tier, r in d_launches.items()}
    del lm_backend
    free()
    m_group = timed("group_step", group_step_phase)
    for key in ("B5", "B6"):
        ssd_rows[key]["launches_group_step"] = m_group[ssd_rows[key]["name"]]
    m_study = timed("mamba2_group_study", mamba2_group_study_phase,
                    store_dir)                                   # 18
    b1_row["launches_grouped_studies"]["mamba2-2.7b"] = \
        m_study["stacked_tree_update"]
    for key in ("B5", "B6"):
        ssd_rows[key]["launches_grouped_study"] = \
            m_study[ssd_rows[key]["name"]]
    # 27-29: decode (qwen2-0.5b, mamba2-2.7b) and Mixture-of-Experts
    s_launches = timed("serve", serve_phase)
    ms_launches = timed("mamba2_serve", mamba2_serve_phase)
    moe_serve, moe_launches = timed("moe", moe_phase)
    fa_rows["B2"]["launches_serve"] = {
        "qwen2-0.5b": s_launches["flash_attention_fwd"],
        "qwen2-moe-a2.7b": moe_serve["flash_attention_fwd"]}
    ssd_rows["B5"]["launches_mamba2_serve"] = ms_launches["ssd_intra_fwd"]
    b1_row["launches_moe_study"] = moe_launches["stacked_tree_update"]
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches_moe_study"] = \
            moe_launches[fa_rows[key]["name"]]
    # 30-32: RG-LRU (recurrentgemma-2b's study and decode) and the
    # frontends (hubert-xlarge, qwen2-vl-7b); B2–B4's head-dim-256 rows
    # count the study's launches, their head-dim-80 rows hubert's
    rg_launches, rg_backend = timed("rglru_study", rglru_study_phase)
    rg_serve = timed("rglru_serve", rglru_serve_phase, rg_backend)
    del rg_backend
    free()
    fe_launches = timed("frontends", frontends_phase)
    b1_row["launches_rglru_study"] = rg_launches["stacked_tree_update"]
    b1_row["launches_frontends"] = {
        name: r["stacked_tree_update"] for name, r in fe_launches.items()}
    fa_rows["B2"]["launches_serve"]["recurrentgemma-2b"] = \
        rg_serve["flash_attention_fwd"]
    for key in ("B2", "B3", "B4"):
        name = fa_rows[key]["name"]
        fa_rows[f"{key}_hd256"]["launches"] = rg_launches[name]
        fa_rows[f"{key}_hd80"]["launches"] = \
            fe_launches["hubert-xlarge"][name]
        fa_rows[key]["launches_frontends"] = {
            model: r[name] for model, r in fe_launches.items()}
        assert fa_rows[f"{key}_hd256"]["launches"] > 0
        assert fa_rows[f"{key}_hd80"]["launches"] > 0
    # 34: the dry run, every architecture x shape reduced on the card
    dry = timed("dryrun", dryrun_phase, store_dir)
    b1_row["launches_dryrun"] = dry["B1"]
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches_dryrun"] = dry[key]
    for key in ("B5", "B6"):
        ssd_rows[key]["launches_dryrun"] = dry[key]
    # the launcher's rank step updates through the plain apply_update, as
    # the JAX launcher's does; no rank run has head dim 256 or 80, and the
    # counters do not tell head dims apart, so those rows hold null
    b1_row["launches_launch_ranks"] = rank_launches["B1"]
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches_launch_ranks"] = rank_launches[key]
        for hd in (256, 80):
            fa_rows[f"{key}_hd{hd}"]["launches_launch_ranks"] = None
            fa_rows[f"{key}_hd{hd}"]["launches_launch_ranks_note"] = (
                f"not measured: launch_ranks runs no model at head dim "
                f"{hd}")
    for key in ("B5", "B6"):
        ssd_rows[key]["launches_launch_ranks"] = rank_launches[key]

    # ------------------------------------------------------------ last lines
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    print(smi, flush=True)
    emit({"kernels": [b1_row, fa_rows["B2"], fa_rows["B3"], fa_rows["B4"],
                      ssd_rows["B5"], ssd_rows["B6"]]
          + [fa_rows[f"{key}_hd{hd}"] for hd in (256, 80)
             for key in ("B2", "B3", "B4")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
