#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only mesh    # the build and the mesh phase
    python3 chip_smoke.py --only cells   # the cells phase alone
    python3 chip_smoke.py --only lm      # the LM phase alone
    python3 chip_smoke.py --only decode  # the decode phase alone
    python3 chip_smoke.py --only mesh_decode  # the sharded decode cell
    python3 chip_smoke.py --only moe     # the mixture-of-experts phase
    python3 chip_smoke.py --only hybrid  # the hybrid (zamba2) phase
    python3 chip_smoke.py --only hybrid_mesh  # its sharded runs alone
    python3 chip_smoke.py --only xlstm   # the xLSTM phase
    python3 chip_smoke.py --only xlstm_mesh  # its sharded runs alone
    python3 chip_smoke.py --only loop    # the training runtime's phase
    python3 chip_smoke.py --only loop_mesh  # the loop over a mesh alone
    python3 chip_smoke.py --only examples  # the build and the examples

from the root of a checkout, on a machine with one CUDA card (built for
sm_90a: an H100; with ``--only mesh``, every card of the host joins the
mesh phase's NCCL world). It

1. prints the card's name and power limit (``nvidia-smi``), then the
   ``analysis`` record: the port's lint over ``src/repro_torch`` (zero
   unwaived findings, the 20 C entry points of ``_build.SIGNATURES``
   held against their prototypes) and two probes that must raise
   (``.item()`` inside ``sanitize.no_implicit_transfers()``, a CUDA graph
   captured inside ``sanitize.steady_state()``); every sync-free region
   below runs under both (:func:`sync_free`), summed in the
   ``guarded_regions`` record before the last line;
2. builds all six kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all at once, and counts ``similarity``'s
   launches per call at 2, 9, 17 and 33 classes from the profiler's
   events (one each; first, before any other profile of the process),
   then takes ``similarity``'s and ``hdc_encode_perm``'s device ms from
   the next profiles (later ones have recorded neither);
3. makes a HyperSense model at the paper's operating point (128x128
   frames, 96x96 fragments, stride 8, D=5000, RFF) from a seeded
   ``torch.Generator`` on the card: ``B0 ~ N(0, 1)``, ``b ~ U(0, 2 pi)``,
   class hypervectors bundled from encoded crops of synthetic object
   frames (Gaussian blobs on noise) and background frames;
4. holds each kernel against its plain PyTorch version on the same inputs
   at the main path's shape (a 32-frame chunk) — scores within 5e-5, the
   int kernel's int32 window sums bitwise, two runs bitwise equal, frames
   scored inside a 7-frame call bitwise as in the 32-frame one — and
   times kernel, plain version, a library matmul of the same projection
   and the card's bounds; the float kernel (3xTF32 tensor cores, the
   reuse form) also at ragged shapes for each nonlinearity (odd strides,
   ragged depths and widths, two D-tiles, per-stream classes, and a
   1024-wide frame); the int kernel (int8 tensor cores) also at 10-bit
   uint16 codes and at ragged shapes (odd stride, W not a multiple of 4,
   K steps that straddle base rows, M and td off the tiles, two D-tiles,
   per-stream classes);
5. drives the main path, ``StreamRunner.process``, over 256 frames six
   times (float32, int8, int4, binary, the closed capture loop, online
   adaptation): each chunk must launch its kernel exactly once, the frame
   scores must equal the plain version's within 5e-5, and the run must be
   bitwise the same when fed in 32-frame slices;
6. profiles one float32 and one int8 run (device busy share, top
   kernels);
7. drives the fleet, ``FleetRunner.process``, over 8 streams of 256
   frames (each stream its own frames and object schedule) six times
   (float32, int8, the closed capture loop, int8 with per-stream and with
   shared adaptation, float32 with ADC noise): each ``(8, 32)``
   super-chunk must make exactly one scorer call; each stream must be
   bitwise what an independent ``StreamRunner`` gives it (but under the
   shared classifier); the run fed as two ``process`` calls bitwise the
   whole run; super-chunk scores within 5e-5 of the plain version; each
   run billed by ``fleet_report`` (finite, a saving between 0 and 1, the
   open-loop capture bill exactly the duty bill); it prints each run's
   fps beside that of 8 looped ``StreamRunner``s, profiles the float32
   and int8 runs, and records how many streams' bits a class norm or a
   re-encode taken over the whole stack would change;
8. serves the fleet's frames through ``FleetService`` (dispatch/collect
   pipelined on the card, a slot pool under churn, checkpoints): the
   float32, int8 and closed-loop services bitwise ``FleetRunner`` on the
   same trace (scores, decisions, capture logs, HP drains), their tick-0
   scores within 5e-5 of the plain version, one scorer call per tick;
   ``max_inflight`` 1, 2, 4 and 8 bitwise the same; an int8 and a noisy
   float32 run under a seeded churn schedule (attach, detach, ragged
   arrival, a silent tick, a sensor reattached through another tenant of
   its slot) with per-stream pseudo adaptation, each sensor bitwise its
   own ``StreamRunner``, and no rebuild after the warm-up tick; a
   checkpoint at tick 4 resumed bitwise by a fresh service; warm frozen
   dispatches free of host syncs (``torch.cuda.set_sync_debug_mode``);
   the int8 service fed its ADC codes already on the card (uint8), its
   warm tick's host syncs counted (exactly the one read of the fused
   code-range check) and its run bitwise ``FleetRunner`` on those codes;
   it prints the fps of the service and of ``FleetRunner``, their
   device busy shares and the dispatch->collect latency;
9. shards the fleet (``mesh`` phase): each scorer's split entries (the
   partials entry over a slice of the D-tiles, the fold entry over the
   partials of all of them) at the paper's point with D cut into 8 tiles
   of 625, at 1, 2, 4 and 8 virtual shards concatenated in tile order,
   bitwise the wrapper's unsplit call for float32, int8, int4 and binary
   with shared and per-stream class tiles (the unsplit call within 5e-5
   of the plain version, the int shards' window sums bitwise the plain
   version's; each shard count's ms beside the unsplit call's); then an NCCL world of every card of the host (one spawned
   process a card; one card: a (1, 1) mesh) runs ``FleetRunner(mesh=)``
   (float32, int8, the closed loop, int8 with shared and with per-stream
   adaptation) and ``FleetService(mesh=)`` (the frozen float32 service,
   its warm dispatches free of host syncs; the int8 churn service, its
   checkpoint at tick 4 resumed sharded and unsharded, and the unsharded
   one resumed sharded), each bitwise the unsharded run this process
   makes on the same inputs and hands over through a file, with fps
   sharded and unsharded; and ``CascadeService(mesh=)`` over the
   full-width ``hubert-xlarge`` detector (below), its weights drawn on
   each rank's card from the cascade phase's seed and sharded
   tensor-parallel over "model" and FSDP over "data", its step captured
   with its NCCL collectives in one CUDA graph: 11 of the closed-loop
   runner's HP frames (a full batch and a padded tail), every rank's
   logits bitwise the same, batched bitwise ``eager``, two passes
   bitwise, one graph build, within 5% of the largest |logit| of this
   process's unsharded cascade (at 2 layers where bf16 drift over 48
   exceeds it, the 48-layer differences in bf16 and float32 printed beside
   how far a 1e-7 perturbation of one weight moves the unsharded float32
   logits), ``backbone_cost`` every
   rank's products, the collectives of a batch counted under
   ``roofline()`` (printed), and ms a batch in turns against an
   unsharded cascade on the rank's card; then the sharded train and
   prefill cells at full ``hubert-xlarge`` and ``internlm2-1.8b`` width
   and 6 and 3 of their 48 and 24 layers (``train_4k``'s 4096 tokens x
   4, ``prefill_32k``'s 32,768 x 1, the cells phase's cuts) on every
   mesh, each rank fed its blocks of one
   whole state this process makes and hands over in
   ``build/mesh/cells-<arch>.pt``: a warm step (its collectives counted,
   the allocator's peak beside ``analyze()`` on the mesh), then the
   unsharded and sharded steps in turns, each sharded step bitwise the
   warm one; the loss and exact digests of the gathered parameters,
   moments and prefill logits the same on every rank; on a (1, 1) mesh
   the step and the prefill bitwise the unsharded ones; at 2 layers
   (weights at std 0.02) in float32 and bf16 the step, its gradients and
   the prefill against the unsharded ones on the rank's card (the cells
   phase's card-vs-CPU bounds; the parameters after AdamW within 1e-5);
   and ``internlm2-1.8b``'s decode cell at those 6 layers
   (``decode_32k``'s cache cut to batch 8, filled from a generator on
   each rank's card) on every mesh,
   and on the (1, world) mesh also with the cache along the sequence
   (``{"act_kv_heads": None}``, the production meshes' split): the
   digests of the next tokens and of the gathered logits the same on
   every rank, (1, 1) bitwise the unsharded step (its written cache rows
   too), ms a step unsharded and sharded in turns, the collectives of a
   step, the peak beside ``analyze()``, and at 2 layers in float32 the
   logits within 1e-5 of the unsharded step's (``--only mesh_decode``
   runs this decode cell alone); ``nvidia-smi topo -m`` is printed
   once;
10. serves the gated cascade (paper §V-E): the closed-loop float32
   ``FleetService`` (8 slots, 8 ticks, HP at 12 bits) feeds its HP drains
   to a ``CascadeService`` over the full-width ``hubert-xlarge`` detector
   (48 layers, bf16, random weights from a seeded generator; 128x128
   frames at patch 8, batches of 8, 2 in flight, one CUDA graph), pumped
   after every collect, then flushed: every HP frame returns once with
   its (sensor, index), the logits are finite, batched logits equal
   ``eager`` bitwise at every batch position and in a padded tail, the
   graph is built once, warm submits are free of host syncs, and the card
   agrees with the CPU at full width on 2 layers (bf16) and at the smoke
   config (float32); ``backbone_cost`` must equal the hand count of the
   products, and ``roofline()``'s compute and memory terms the batch's
   hand bounds. It prints the backbone's frames/s and ms per batch against
   the batch's bounds, its device busy share, the site's frames/s against
   the gate's alone, ``roofline().to_dict()``, and the energy bill against
   an always-on backbone;
11. runs the encoder's training path (``cells`` phase) at full
   ``hubert-xlarge`` width (48 layers, bf16, remat "full", weights from
   ``Model.init`` on a seeded generator): counts the train cell at
   ``train_4k`` and the prefill cell at ``prefill_32k`` on meta tensors
   (``FlopCounterMode`` equal to the hand count; ``analyze()`` on one
   card, 16x16 and 2x16x16); at 12 of the 48 layers runs the train step
   at 4096 tokens x 4 (the batch cut from 256), a warm step and three timed ones from the same
   state, each bitwise the warm one, the loss and gradients twice
   bitwise, one step profiled, with ms a step, tokens/s, TFLOP/s and the
   allocator's peak beside ``analyze()``; runs the prefill cell at 32,768
   tokens x 1 (cut from 32), its logits finite, of the right shape and
   bitwise ``Model.forward``'s; holds the card against the CPU at 2
   layers (1,024 tokens, weights at std 0.02): float32 loss within 1e-5
   relative and every gradient within 1e-4 of its leaf's largest
   |entry|, bf16 within 1e-2 and 5%; records the float32 difference at
   ``Model.init``'s weights beside the card's response to a 1e-7
   perturbation; takes 10 AdamW steps at a constant 1e-4 on a fixed
   batch, the loss falling; and reads the dry run (``python -m
   repro_torch.launch.dryrun --all``, a subprocess on the host's CPU, no
   card, started before the kernels' build; one process a cell, the
   architectures' cells in parallel chains): the sharded train and
   prefill cells of the ten architectures counted on the 16x16 and
   2x16x16 meshes, the decoders' ``decode_32k`` cells and the hybrid's
   and the xLSTM's ``long_500k``, 62 ``ok`` records, their FLOPs the hand
   count plus what the ranks repeat (hubert-xlarge's unembedding; the k
   and v projections of the kv heads 16 ranks do not divide; every data
   rank's routing and experts over the whole gathered batch; the hybrid's
   ``C·B`` and ``h0 @ emb_proj`` on every "model" rank, every xLSTM block
   on every "model" rank, and long_500k's one sequence on every data
   rank), their memory ``analyze()``'s, no ``not_ported`` row;
12. runs the dense and vlm families (``lm`` phase) at full width (bf16,
   remat "full", weights from ``Model.init`` on seeded generators):
   ``internlm2-1.8b`` (24 layers, 16 heads over 8 kv heads, vocab
   92,544) through the cells phase's runs and checks (counted on meta
   tensors against the causal hand count, which follows the query
   blocks; the train step bitwise run to run, the step and its gradients
   again under ``torch.use_deterministic_algorithms(True)`` with no op
   flagged; the prefill bitwise ``Model.forward``; card vs CPU at 2
   layers; the loss falling), its train step and prefill at 6 of the 24
   layers; ``olmo-1b``'s train step and prefill at 4 of its 16 layers
   (its norms hold no parameters); ``internvl2-76b`` at 2 of its 80
   layers, a
   prefill of 32,768 tokens behind 256 image embeddings, its text logits
   bitwise run to run and moved by another image prefix;
13. runs the decode cell (``decode`` phase) of ``internlm2-1.8b`` at full
   width and 12 of its 24 layers against ``decode_32k``'s cache of
   32,768 positions, its batch cut from 128 to 8 (the bf16 cache 412 GB
   -> 12.9 GB): 64
   tokens primed one at a time, their logits within 5% of the largest
   |logit| of ``Model.forward``'s on the same tokens (weights at std
   0.02; the difference at ``Model.init``'s weights recorded); the card
   against the CPU at 2 layers in float32 (within 1e-4 of the largest
   |logit|); two greedy runs bitwise the same tokens and cache digests;
   ms a step at the cache's last index, timed under
   ``torch.cuda.set_sync_debug_mode("error")``, tokens/s, one step
   profiled, the allocator's peak beside ``analyze()`` and the bytes
   bound; ``olmo-1b``'s step at 8 of its 16 layers at the same batch and
   cache; and ``python -m repro_torch.launch.decode`` (the full config)
   in a subprocess started first, its tokens ``greedy_decode``'s on the
   same seeds;
14. runs the mixture of experts (``moe`` phase): ``qwen3-moe-235b-a22b``
   sharded in an NCCL world of every card (one card: the (1, 1) prefill
   and decode cell bitwise the unsharded ones; four: the train step at
   4096 tokens x 4 and the prefill on (1, 4), (2, 2) and (4, 1), every
   rank's digests equal, the meshes' losses within 1e-2 and logits
   within 5% of one another), then at full width and 2 of its 94 layers
   (128 experts top-8, bf16, ``Model.init``'s weights): the
   32,768-token prefill (capacity 2560) bitwise run to run, its drop
   share, ms and TFLOP/s beside the hand count, the peak beside
   ``analyze()``; 10 decode steps at ``decode_32k``'s cache cut to batch
   8, sync-free, beside the bytes bound; two greedy runs bitwise; decode
   against the prefill at the no-drop capacity (float32, held within 5%;
   bf16 recorded, with the tokens whose experts differ); the card
   against the CPU at 2 layers in float32 (expert ids equal outside the
   routing margin, logits within 1e-4); ``grok-1-314b`` at 1 of 64
   layers, its prefill (capacity 10,240) and timed decode steps;
15. runs the hybrid (``hybrid`` phase): ``zamba2-1.2b`` at full width
   and 12 of its 38 layers (two groups, two shared-block calls) sharded
   in an NCCL world of every card (one card: the (1, 1) train step,
   prefill and decode step bitwise the unsharded ones; four: (1, 4),
   (2, 2) and (4, 1), every rank's digests equal, the losses within
   1e-2 and the prefill logits within 5% of the (1, 4) mesh's); its
   train and prefill cells counted on meta tensors at full batch, the
   FLOPs the hand count (the Mamba layers' projections and SSD products
   by chunk, the six shared-block calls with ``emb_proj``, the
   unembedding, the recompute), ``analyze()`` on one card and the
   production meshes; at full width and 6 of the 38 layers (one
   shared-block call; ``HYBRID_TIMED_LAYERS``, cut to make room for the
   examples phase; bf16, remat "full", ``Model.init``'s weights) the
   train step at 4096
   tokens x 4 bitwise run to run, also under deterministic algorithms,
   the 32,768-token prefill bitwise ``Model.forward``, each with ms,
   tokens/s, TFLOP/s and the peak beside ``analyze()``; the card
   against the CPU at 6 layers (one shared-block call) in float32 and
   bf16 (loss, every gradient, the logits); sync-free timed decode steps
   at ``decode_32k``'s state cut to batch 8 and at ``long_500k`` uncut
   (524,288 positions, a 4.3 GB bf16 cache at 6 layers) beside their
   bytes bounds;
   two greedy runs bitwise; decode against ``Model.forward`` in float32
   with float32 states within 1e-4 of the largest |logit| (the bf16
   states' difference recorded); the decode card against the CPU at 6
   layers; the phase's seconds;
16. runs the xLSTM (``xlstm`` phase): ``xlstm-350m`` at full width and 8
   of its 24 blocks (one sLSTM) sharded in an NCCL world of every card
   (one card: the (1, 1) train step, prefill and decode step bitwise the
   unsharded ones; four: (1, 4), (2, 2) and (4, 1), every rank's digests
   equal, the losses within 1e-4 and the prefill logits within 2% of the
   (1, 4) mesh's); its train and prefill cells counted on meta tensors at
   full batch, the FLOPs the hand count (the mLSTM blocks' projections
   and chunkwise products, the sLSTM scan's registered counts forward
   and backward, the unembedding, the recompute), ``analyze()`` on one
   card and the production meshes; at full width and 8 of the 24 blocks
   (7 mLSTM and 1 sLSTM, bf16, remat "full", ``Model.init``'s weights;
   ``XLSTM_TIMED_LAYERS``, cut to make room for the loop phase) the
   train step at 4096 tokens x 4 bitwise run to run, also under
   deterministic algorithms, the 32,768-token prefill bitwise
   ``Model.forward``, each with ms, tokens/s, TFLOP/s, the bounds, the
   sLSTM loop's share of the run (``ScanClock``) and the peak beside
   ``analyze()``; one train step and one decode step profiled;
   sync-free timed decode steps at ``decode_32k``'s full batch of 128
   (11.3 GB of state) and at ``long_500k`` from reached states, bitwise
   run to run, beside their bytes bounds; two greedy runs bitwise;
   decode against ``Model.forward`` in float32 with float32 convolution
   buffers within 1e-4 of the largest |logit| (the bf16 buffers'
   difference recorded); the card against the CPU at 8 blocks in float32
   (loss 1e-6, logits 1e-5, gradients 1e-4) and bf16 (5%); the decode
   card against the CPU at 8 blocks; the launcher; the phase's seconds;
17. runs the training runtime (``loop`` phase): first the loop over a
   mesh (``train(mesh=)``, at the configuration below, every rank handed
   the whole stream) in an NCCL world of every card, while this process
   holds nothing on the card: on each mesh of the host's cards (one card:
   (1, 1)) 16 steps whose last rank sends itself SIGTERM on step 12,
   every rank leaving with 143 there and one checkpoint, gathered whole
   and written by rank 0 (the gather's and the write's s, GB and peak);
   that checkpoint relaunched on the mesh (the restore's s; every rank's
   digests equal; on several cards bitwise an uninterrupted run on the
   mesh, and the previous mesh's checkpoint restored bitwise its leaves
   and relaunched, losses within 1e-2); from its state a warm step free
   of host syncs, the peak beside ``analyze()`` on the mesh, ms a step
   sharded and unsharded in turns, one of each profiled; the world exits
   with the preempted run's 143. On one card the (1, 1) relaunch and the
   unsharded loop resuming the (1, 1) checkpoint are bitwise the
   uninterrupted run below. Then ``train/loop.py``'s
   ``train`` at full ``olmo-1b`` width and 2 of its 16 layers (bf16,
   remat "full"; the cut for the checkpoint's 4.08 GB a save) on
   train_4k's 4096 tokens x 4 in 2 microbatches, AdamW at 3e-4 after
   10 warmup steps: 16 steps checkpointed every 6 and preempted on step
   12 by the SIGTERM handler (exit 143, the checkpoint at 12), relaunched
   in the same directory (it resumes from step 12 and reads the stream
   from there), bitwise (parameters, moments, step) 16 uninterrupted
   steps; the first step's ms, a warm step free of host syncs
   (``set_sync_debug_mode``), ms a step and tokens/s over timed steps,
   the peak beside ``analyze()``; one step at lr 0 in 1 and 2
   microbatches, the losses within 1e-3; one step's loss and gradients
   under remat "none", "dots" and "full" from one state, bitwise the
   same, with ms and peak GB each; ``compress_grads`` on those
   gradients (3.40e8 float32), codes and scales bitwise the CPU's, the
   error within 1 ulp, ms a call beside its bytes bound; ``python -m
   repro_torch.launch.train --smoke`` in a subprocess on the card sent
   SIGTERM on its ``step 10/`` line (exit 143, a checkpoint at the step
   it reached), relaunched (it resumes there and finishes), its last
   checkpoint leaf by leaf bitwise an uninterrupted ``main([...])``'s;
   the launcher as one program over a process a card (``--coordinator``,
   ``--num-processes``), every process sent SIGTERM on rank 0's ``step
   10/`` line (each exits 143, one checkpoint), relaunched with as many
   (its last checkpoint bitwise an uninterrupted run's with that count)
   and, on several cards, with half as many (resumed, finished);
   the checkpoints' host copies, writes (GB) and restore in seconds;
   ``build/loop/`` and ``build/loop_mesh/`` deleted at the end;
18. runs the paper's loop as a user starts it (``examples`` phase): the
   port's twins of the reference's last three examples, each its own
   process on the card, all six started at once against the kernels
   built above (``EXAMPLE_RUNS``): ``examples/quickstart_torch.py``,
   ``examples/gated_cascade_torch.py`` and
   ``examples/intelligent_sensing_e2e_torch.py`` by default, with
   ``--sensors 4``, ``--drift`` and ``--control``; each runs its
   ``main()`` with every kernel's count zeroed right before it and read
   right after it (``COUNTED_RUN``), must exit 0, print the lines of its
   twin's ``LINES`` and launch the gate's kernels, the cascade with one
   backbone build across its ragged drains; it records each run's wall
   seconds, counts and headline numbers (the fragment AUC, ``T_score``,
   duty cycles, the total and edge saving beside the paper's 89.8% /
   60.6%, the fleet's saving, the three drift AUCs, the capture-log
   saving, the cascade's J/frame). Meanwhile this process holds the
   twins' stage functions on the card (counted) against the same calls
   on the CPU on the same inputs at the runs' shapes
   (``examples_parity``): gates trained on the card, the training's
   encode and similarity within HV_ATOL and SCORE_ATOL of their plain
   versions, ``fragment_auc``, ``frame_decisions``,
   ``operating_point``, ``single_stream``, ``sensor_fleet``, ``drift``,
   ``closed_loop`` and the cascade's loop: scores within SCORE_ATOL,
   AUCs within the share of pairs scored within 2 * SCORE_ATOL, every
   decision whose score sits beyond DECISION_MARGIN alike and the whole
   run alike unless one sits nearer, energy within 1e-6 relative, the
   detector's logits within CASCADE_F32_RTOL of the largest |logit|;
19. drives the training path (paper Fig. 5a) at the same width: samples
   balanced fragments from 256 synthetic training frames and 128 held-out
   frames (``sensing.fragments``), trains the Fragment model on the
   permutation base (``train_fragment_model``, 20 epochs), scores the
   held-out fragments (fragment AUC and partial AUC) and the held-out
   frames through ``from_fragment_model`` (frame AUC); the whole path runs
   twice and must be bitwise the same. It then holds the three training
   kernels (``hdc_encode_perm``, ``hdc_encode``, ``similarity``) against
   their plain versions at the path's shapes — hypervectors within 1e-4,
   scores within 5e-5, two runs bitwise equal, ``hdc_encode_perm``
   bitwise equal to ``hdc_encode`` on the expanded base — and times them;
   holds ``similarity`` also at 9, 17 and 33 classes, across batch
   positions, class subsets and a misaligned view (bitwise), and times
   it at N = 512 and at a 16,384-row split past the L2; holds
   both encoders the same way at ragged shapes (N, K and D off the tiles,
   K steps that straddle generator rows) for each nonlinearity, and
   reports their tiles, blocks and waves;
20. drives the int-datapath path (``benchmarks/int_datapath.py``'s
   claims): the float32 kernel, the live int8 kernel and the expanded-slab
   kernel (the int scorer's retired layout, ``csrc/int_expanded.cu``, on
   the int8 tensor cores) race on one ADC capture at the reference's shape
   (32x32 frames, 8x8 fragments, stride 4, D 256, chunk 16) and at the
   paper's operating point (``configs/hypersense.py``, chunk 32): one
   launch a call, the expanded window sums bitwise the live kernel's, its
   scores within 1e-6 of the live kernel's and within 5e-5 of its plain
   version, both int paths bitwise run to run and across a fresh
   precompute, a 7-frame expanded call bitwise inside the whole, ms per
   chunk, fps and speedups; the expanded kernel's tile, blocks, waves,
   shared memory, the operand bytes it reads and its tensor-core bound,
   and the same gates at the ragged int shapes with uint8 and 10-bit
   uint16 codes; the live int kernel at 4x the reference's frame
   width against its plain version, and the expanded operand's bytes at
   the deployment geometry beside the live block's; frame-score AUC of a
   gate trained on ``sensing/synthetic`` frames, float vs int8 and float at
   4 bits vs packed int4, on a synthetic and a drifted stream (gaps within
   0.01), also at the paper's operating point (reported); the binary
   gate's D-vs-AUC curve (each map within 5e-5 of the plain version; the
   reference's 0.85 claim on its best point reported); and the stream gate
   (``core/gate.py``) over 256 frames at the paper's point, its decisions
   equal to the same gate's on the CPU wherever the deciding score sits
   more than 2.5e-4 from ``t_score``, its frames/s, duty cycle and the
   detector FLOPs it saves;
21. runs Table I and Fig. 16's model comparison (``baselines`` phase):
   ``benchmarks/common.py``'s noisy 4-bit data made with
   ``sensing.synthetic`` (training noise 0.20; held-out noise 0.30 with
   3% impulse spikes), balanced fragments, at the paper's operating point
   (256 and 128 frames) and at the reference's scale (64x64 frames,
   16x16 fragments, D 8192, 60 and 100 frames); trains the HDC Fragment
   model (its kernels counted) and the MLP2, MLP4 and TinyConv baselines
   (``sensing/baselines.py``, AdamW from ``train/optim.py``) and prints
   each row's AUC, partial AUC above TPR 0.8, train seconds and the
   paper's value, on the held-out fragments and on the same windows of a
   ``low_precision_view`` (4 bits, sigma 0.01); checks that training
   lowered each baseline's cross-entropy, that the card's logits, the
   gradients of one step and its AdamW update equal the CPU's within
   1e-5, and that the MLPs train bitwise run to run (TinyConv reported);
   then times, per frame of a 32-frame chunk, the float32 HDC scorer
   against MLP2 on all 25 windows (beside the paper's 2.4x) and
   ``encode_frames`` with and without reuse;
22. prints one JSON line per phase, a ``kernels`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero as well without a CUDA device, or outside a checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shlex
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import pin_fp32_matmul  # noqa: E402
from repro_torch.analysis import linter as port_lint  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.convert import model_from_arrays  # noqa: E402
from repro_torch.core import (encoding, energy,  # noqa: E402
                              fragment_model, hypersense, metrics)
from repro_torch.core.hypersense import frame_detection_score  # noqa: E402
from repro_torch.core.online import AdaptConfig  # noqa: E402
from repro_torch.core.sensor_control import (  # noqa: E402
    CaptureConfig, ControllerConfig)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import hdc_encode as enc  # noqa: E402
from repro_torch.kernels import hdc_encode_perm as enc_perm  # noqa: E402
from repro_torch.kernels import similarity as sim  # noqa: E402
from repro_torch.kernels import sliding_scores as ss  # noqa: E402
from repro_torch.kernels import sliding_scores_int as ssi  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import hypersense as paper_config  # noqa: E402
from repro_torch.core import gate as hs_gate  # noqa: E402
from repro_torch.distributed import memory_model, sharding  # noqa: E402
from repro_torch.kernels import int_expanded as ie  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.cascade import CascadeService  # noqa: E402
from repro_torch.launch.serve import FleetService  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.sensing import (adc, baselines, fleet,  # noqa: E402
                                 fragments, stream, synthetic)
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import compress, optim  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402

# the paper's operating point (configs/hypersense.py)
FRAME, FRAG, STRIDE, DIM, BLOCK_D = 128, 96, 8, 5000, 512
CHUNK, N_STREAM = 32, 256
# the fleet: streams, and where a run is cut into two process calls (on
# the chunk grid, 96, when it adapts: each chunk is scored with the
# classifier of its start)
FLEET_S, FLEET_CUT = 8, 100
SCORE_ATOL = 5e-5
# the training path: frames sampled for training and held out, fragments
# per frame of each, retraining epochs; hypervector tolerance
N_TRAIN, N_HELD_OUT, EPOCHS = 256, 128, 20
HV_ATOL = 1e-4
SEED = 0
DEVICE = "cuda"

# D at which the Python and CUDA similarity chunk plans are compared:
# ranks with empty chunks, D % 4 != 0, the paper's D, several D tiles
SIM_PLAN_DS = (1, 16, 129, 130, 300, 1000, 4999, 5000, 8192, 8193, 20001)

# ragged encoder shapes (N, h, w, D): N, K = h*w and D off the 128 x 160
# (128 x 128) tiles and the 32-deep K steps, which w = 7 and w = 40 straddle
RAGGED = ((7, 5, 7, 131), (200, 6, 40, 1000))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, float32 (CUDA cores),
# TF32, bf16 and int8 (tensor cores) operations/s
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
TF32_OPS_S = 495e12
BF16_OPS_S = 989e12
INT8_OPS_S = 1979e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


#: every guarded region of this process, in order: its name and the
#: rebuild events it saw
GUARDED: list = []


@contextlib.contextmanager
def sync_free(region: str):
    """A warm region of the card's sync-free path:
    ``sanitize.no_implicit_transfers()`` (``set_sync_debug_mode("error")``:
    the first synchronizing op raises, named) inside
    ``sanitize.steady_state()`` (a rebuild event raises, named)."""
    led = sanitize.ledger()
    before = led.events
    with sanitize.steady_state(region), \
            sanitize.no_implicit_transfers(always=True):
        yield
    GUARDED.append((region, led.events - before))


def guarded_summary() -> dict:
    """``{region: {"entries", "rebuild_events"}}`` of GUARDED."""
    out = {}
    for region, events in GUARDED:
        rec = out.setdefault(region, {"entries": 0, "rebuild_events": 0})
        rec["entries"] += 1
        rec["rebuild_events"] += events
    return out


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def synthetic_frames(g, labels):
    """Noise frames in [0, 1.5]; frames labeled 1 carry a Gaussian blob.
    Returns the frames and each blob's (row, col) centre."""
    n = labels.shape[0]
    dev = g.device
    frames = 0.3 + 0.1 * torch.randn((n, FRAME, FRAME), generator=g,
                                     device=dev)
    centres = 24 + torch.rand((n, 2), generator=g, device=dev) * (FRAME - 48)
    frames = frames + 0.9 * labels[:, None, None].to(torch.float32) * blobs(
        centres)
    return frames.clamp(0.0, 1.5), centres


def blobs(centres):
    """``(n, FRAME, FRAME)`` Gaussian blobs (sigma 12 pixels, peak 1) at
    each ``(row, col)`` centre."""
    yy = torch.arange(FRAME, device=centres.device, dtype=torch.float32)
    dy = (yy[None, :] - centres[:, :1]) ** 2
    dx = (yy[None, :] - centres[:, 1:]) ** 2
    return torch.exp(-(dy[:, :, None] + dx[:, None, :]) / (2 * 12.0 ** 2))


def make_model(g):
    """Paper-shape model: class hypervectors bundled
    (``fragment_model.bundle_init``) from 64 object and 64 background
    crops, without retraining; the stream phases drive this model and the
    train phase trains its own. Also returns 64 held-out calibration
    frames and their labels."""
    B0, b = encoding.make_perm_base_rows(g, FRAG, DIM)
    labels = torch.arange(128, device=g.device) % 2
    frames, centres = synthetic_frames(g, labels)
    top = (centres - FRAG / 2).round().long().clamp(0, FRAME - FRAG)
    rand = torch.randint(0, FRAME - FRAG + 1, (128, 2), generator=g,
                         device=g.device)
    top = torch.where(labels[:, None] == 1, top, rand)
    crops = torch.stack([f[y:y + FRAG, x:x + FRAG] for f, (y, x)
                         in zip(frames, top.tolist())])
    hvs = encoding.encode_fragments(crops, encoding.flat_perm_base(B0, FRAG),
                                    b)
    class_hvs = fragment_model.bundle_init(hvs, labels)      # (2, D)
    model = model_from_arrays(class_hvs.cpu().numpy(), B0.cpu().numpy(),
                              b.cpu().numpy(), h=FRAG, w=FRAG, stride=STRIDE,
                              t_score=0.0, t_detection=0, device=DEVICE)
    cal_labels = torch.arange(64, device=g.device) % 2
    cal, _ = synthetic_frames(g, cal_labels)
    return model, cal, cal_labels


def calibrated(model, cal, cal_labels, precision: str, bits: int):
    """The model with ``t_score`` halfway between the median frame scores
    of the object and the background calibration frames, as this
    precision's ADC view scores them."""
    view = stream.adc_view(cal, bits) if precision == "float32" else cal
    s = hypersense.frame_scores_batch(model, view, precision=precision,
                                      adc_bits=bits)
    t_score = float((s[cal_labels == 1].median()
                     + s[cal_labels == 0].median()) / 2)
    return dataclasses.replace(model, t_score=t_score)


def kernel_phase(model, raw):
    """Kernel against plain version, run-to-run bitwise, and timings, at
    the main path's chunk shape. Returns the two kernels' records."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    N = raw.shape[0]
    my = mx = (FRAME - FRAG) // STRIDE + 1
    chunk_f = stream.adc_view(raw, 4)
    tiles = stream.model_tiles(model, FRAME, BLOCK_D, "float32")
    td, n_dt = tiles.block_d, tiles.slabs.shape[0]
    lib = _build.load("sliding_scores")
    check(ss.smem_bytes() == lib.sliding_scores_f32_smem_bytes()
          and ss.COL_TILE == lib.sliding_scores_f32_col_tile()
          and ss.WINDOWS_PER_BLOCK == lib.sliding_scores_f32_windows(),
          "python and CUDA float block sizes differ")

    # the projection as one library call: windows (N*my*mx, h*w) against
    # the expanded base (h*w, D); the port never calls it
    base = encoding.flat_perm_base(model.B0, FRAG)

    def windows(x):
        return x.unfold(1, FRAG, STRIDE).unfold(2, FRAG, STRIDE).reshape(
            N * my * mx, FRAG * FRAG).to(torch.float32)

    last = (mx - 1) * STRIDE + FRAG    # frame columns the windows cover
    macs = N * my * n_dt * td * FRAG * last   # h*last per (n, ky, column)
    records = []

    # --- float32 kernel
    got = ss.fragment_scores_batch(chunk_f, tiles, **kw)
    again = ss.fragment_scores_batch(chunk_f, tiles, **kw)
    seven = ss.fragment_scores_batch(chunk_f[20:27], tiles, **kw)
    plain = ss.fragment_scores_batch_plain(chunk_f, tiles, **kw)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(err <= SCORE_ATOL, f"float kernel vs plain: {err}")
    check(torch.equal(got, again), "float kernel differs run to run")
    check(torch.equal(seven, got[20:27]),
          "float: a 7-frame call differs from the 32-frame one")
    check(bool(torch.isfinite(got).all()) and got.shape == (N, my, mx),
          "float kernel scores not finite or of the wrong shape")
    oracle = torch.stack([ref.fragment_scores(
        f, model.class_hvs, model.B0, model.b, **kw) for f in chunk_f[:2]])
    oerr = float((got[:2] - oracle).abs().max())
    check(oerr <= SCORE_ATOL, f"float kernel vs naive oracle: {oerr}")
    win = windows(chunk_f)
    f_bytes = 4 * (chunk_f.numel() + tiles.slabs.numel()
                   + 3 * tiles.bias_t.numel() + 2 * N * my * mx)
    tc = bound(f_bytes, 3 * 2 * macs, TF32_OPS_S)
    device_ms, device_by_kernel = kernel_device_ms(
        lambda: ss.fragment_scores_batch(chunk_f, tiles, **kw),
        ("window_norms", "score_f32", "fold_epilogue"))
    records.append(dict(
        name="sliding_scores_f32", route="cuda",
        source="src/repro_torch/kernels/csrc/sliding_scores.cu",
        replaces="src/repro/kernels/sliding_scores.py:244",
        max_abs_err=err, oracle_max_abs_err=oerr, run_to_run_bitwise=True,
        batch_position_bitwise=True,
        ms=time_ms(lambda: ss.fragment_scores_batch(chunk_f, tiles,
                                                           **kw)),
        kernel_device_ms=device_ms,
        kernel_device_by_kernel_ms=device_by_kernel,
        plain_ms=time_ms(lambda: ss.fragment_scores_batch_plain(
            chunk_f, tiles, **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        shape=[N * my, FRAG * last, n_dt * td],
        **scorer_occupancy(lib.sliding_scores_f32_occupancy, N * my, mx,
                           n_dt * -(-td // ss.COL_TILE),
                           (ss.COL_TILE, ss.WINDOWS_PER_BLOCK)),
        **bound(f_bytes, 2 * macs, F32_OPS_S),
        bound_tc_ms=tc["bound_ms"], bound_tc_by=tc["bound_by"],
        ragged_max_abs_err=ragged_f32_checks()))
    records[-1]["beats_library"] = records[-1]["ms"] < records[-1][
        "library_ms"]

    records.append(int_kernel_record(model, raw, windows(
        stream.adc_view_codes(raw, 8)), base))
    return records


# the int kernel's precisions: (geometry mode, ADC bits, packed int4)
INT_CASES = {"int8": ("int8", 8, False), "int4": ("int8", 4, True),
             "binary": ("binary", 8, False), "u10": ("int8", 10, False)}

# ragged int shapes (N, S, H, W, h, w, stride, D, block_d): an odd stride,
# W not a multiple of 4, w % 32 != 0 (K steps straddle base rows; w = 7
# puts 8 rows in one 64-deep step), M and td off the 64 x 128 tile, n_dt = 2,
# S streams of N / S frames with their own class tiles
RAGGED_INT = ((6, 2, 45, 46, 21, 21, 3, 600, 300),
              (5, 1, 22, 30, 5, 7, 5, 131, 512))


def int_kernel_record(model, raw, win, base):
    """The int kernel at the main path's chunk, per precision (int8, packed
    int4, binary and 10-bit uint16 codes): int32 window sums bitwise equal
    to the plain version's, scores within SCORE_ATOL, bitwise run to run
    and for frames scored inside a 7-frame call; then its timings, occupancy and bounds, and the RAGGED_INT
    shapes."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    lib = _build.load("sliding_scores_int")
    check(ssi.COL_TILE == lib.sliding_scores_int_col_tile()
          and ssi.smem_bytes() == lib.sliding_scores_int_smem_bytes(),
          "python and CUDA int block sizes differ")
    N = raw.shape[0]
    my = mx = (FRAME - FRAG) // STRIDE + 1
    ms_by_precision, errs = {}, {}
    for precision, (mode, bits, packed) in INT_CASES.items():
        codes = stream.adc_view_codes(raw, bits)
        kcodes = adc.pack_nibbles(codes) if packed else codes
        itiles = stream.model_tiles(model, FRAME, BLOCK_D,
                                    "binary" if mode == "binary" else "int8")
        pkw = dict(packed=packed, **kw)
        got = ssi.fragment_scores_batch_int(kcodes, itiles, **pkw)
        again = ssi.fragment_scores_batch_int(kcodes, itiles, **pkw)
        seven = ssi.fragment_scores_batch_int(kcodes[20:27], itiles, **pkw)
        plain = ssi.fragment_scores_batch_int_plain(kcodes, itiles, **pkw)
        acc = ssi.int_window_acc(kcodes, itiles.geom, **pkw)
        acc_plain = ssi.int_window_acc(
            kcodes.cpu(), _geometry_to(itiles.geom, "cpu"), **pkw)
        torch.cuda.synchronize()
        errs[precision] = float((got - plain).abs().max())
        check(errs[precision] <= SCORE_ATOL,
              f"{precision} kernel vs plain: {errs[precision]}")
        check(torch.equal(got, again), f"{precision} kernel run to run")
        check(torch.equal(seven, got[20:27]),
              f"{precision}: a 7-frame call differs from the 32-frame one")
        check(torch.equal(acc.cpu(), acc_plain),
              f"{precision} int32 window sums differ from the plain ones")
        check(bool(torch.isfinite(got).all()) and got.shape == (N, my, mx),
              f"{precision} scores not finite or of the wrong shape")
        ms_by_precision[precision] = time_ms(
            lambda: ssi.fragment_scores_batch_int(kcodes, itiles, **pkw))
        if precision == "int8":
            int8 = dict(codes=codes, tiles=itiles)
    codes, itiles = int8["codes"], int8["tiles"]
    n_dt, td = itiles.geom.slabs_q.shape[0], itiles.geom.block_d
    M, n_ct = N * my * mx, n_dt * -(-td // ssi.COL_TILE)
    i_bytes = (codes.numel() + itiles.geom.slabs_q.numel()
               + 4 * itiles.geom.bias_t.numel() + 2 * itiles.cpos_t.numel()
               + 4 * 2 * M)
    # the reuse form's h*W multiply-adds per (n, ky, column); this GEMM's
    # h*w per window
    macs = N * my * n_dt * td * FRAG * FRAME
    tc = bound(i_bytes, 2 * M * FRAG * FRAG * n_dt * td, INT8_OPS_S)
    device_ms, device_by_kernel = kernel_device_ms(
        lambda: ssi.fragment_scores_batch_int(codes, itiles, **kw),
        ("window_norms", "im2col", "score_int", "fold_epilogue"))
    return dict(
        name="sliding_scores_int", route="cuda",
        source="src/repro_torch/kernels/csrc/sliding_scores_int.cu",
        replaces="src/repro/kernels/sliding_scores_int.py:463",
        max_abs_err=max(errs.values()), max_abs_err_by_precision=errs,
        acc_bitwise=True, run_to_run_bitwise=True, batch_position_bitwise=True,
        ms=ms_by_precision["int8"], ms_by_precision=ms_by_precision,
        kernel_device_ms=device_ms,
        kernel_device_by_kernel_ms=device_by_kernel,
        plain_ms=time_ms(lambda: ssi.fragment_scores_batch_int_plain(
            codes, itiles, **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        shape=[M, FRAG * FRAG, n_dt * td],
        **scorer_occupancy(lib.sliding_scores_int_occupancy, N * my, mx, n_ct,
                           (ssi.COL_TILE,)),
        **bound(i_bytes, 2 * macs, INT8_OPS_S),
        bound_tc_ms=tc["bound_ms"], bound_tc_by=tc["bound_by"],
        ragged_max_abs_err=ragged_int_checks())


def scorer_occupancy(entry, R: int, mx: int, n_ct: int, tile) -> dict:
    """A scorer's launch for R = N*my rows, mx window columns and n_ct
    column tiles, from its C ``entry``: its tile (the row tile, then
    ``tile``), blocks, resident blocks per SM, shared memory per block,
    waves on this card and the share of the waves' block slots the blocks
    fill."""
    vals = [ctypes.c_int() for _ in range(4)]
    _build.check(entry(R, mx, n_ct, *map(ctypes.byref, vals)), entry.__name__)
    tile_m, blocks, per_sm, smem = (v.value for v in vals)
    slots = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    waves = math.ceil(blocks / slots)
    return dict(tile=[tile_m, *tile], blocks=blocks, blocks_per_sm=per_sm,
                smem_bytes=smem, waves=waves,
                wave_efficiency=blocks / (waves * slots))


# ragged float shapes (N, S, H, W, h, w, stride, D, block_d): g = gcd(stride,
# w) = 3 with a depth of 63 (two K steps, the second padded) and W = 46, g = 1
# with a depth of 5 and td = 131 (a column tile of 3), two D-tiles, S
# streams of N / S frames with their own class tiles; and a 1024-wide frame
# (w = 8, stride 8, mx = 128: 26 window groups) that the CUDA-core kernel's
# block refused
RAGGED_F32 = ((6, 2, 45, 46, 21, 21, 3, 600, 300),
              (5, 1, 22, 30, 5, 7, 5, 131, 512),
              (2, 1, 8, 1024, 8, 8, 8, 5000, 512))


def window_projections_plain(frames, tiles, h, w, stride):
    """``(N, my, mx, D)`` normalized window projections ``acc / max(norm,
    1e-8)`` as the plain version computes them (each D-tile's
    ``tile_window_acc``), to find where ``sign`` sits within rounding of
    0."""
    acc = torch.cat(ss.tile_window_acc(frames, tiles, h, w, stride), -1)
    norms = ss.window_norms_batch(frames, h, w, stride)
    return acc / torch.clamp(norms, min=1e-8)[..., None]


def ragged_f32_checks() -> float:
    """The float kernel at the RAGGED_F32 shapes, for each nonlinearity:
    scores within SCORE_ATOL of the plain version with per-stream class
    tiles, bitwise run to run. ``sign`` is held on the windows whose
    projections all sit clear of 0 by more than 1e-5 (elsewhere float32
    rounding may flip one). Returns the largest score error."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 4)
    worst = 0.0
    for N, S, H, W, h, w, stride, D, block_d in RAGGED_F32:
        kw = dict(h=h, w=w, stride=stride, frames_per_stream=N // S)
        frames = 1.5 * torch.rand((N, H, W), generator=g, device=DEVICE)
        B0 = torch.randn((h, D), generator=g, device=DEVICE)
        b = 2 * math.pi * torch.rand(D, generator=g, device=DEVICE)
        chvs = torch.randn((S, 2, D), generator=g, device=DEVICE)
        geom = ss.precompute_geometry(B0, b, W=W, w=w, stride=stride,
                                      block_d=block_d)
        tiles = ss.retile_classes_fleet(geom, chvs)
        s_n = window_projections_plain(frames, tiles, h, w, stride)
        clear = (s_n.abs() > 1e-5).all(-1)                  # (N, my, mx)
        for nl in ("rff", "linear", "sign"):
            what = f"{nl} at {(N, S, H, W, h, w, stride, D)}"
            got = ss.fragment_scores_batch(frames, tiles, nonlinearity=nl,
                                           **kw)
            again = ss.fragment_scores_batch(frames, tiles, nonlinearity=nl,
                                             **kw)
            plain = ss.fragment_scores_batch_plain(frames, tiles,
                                                   nonlinearity=nl, **kw)
            torch.cuda.synchronize()
            keep = clear if nl == "sign" else torch.ones_like(clear)
            check(keep.float().mean() > 0.9, f"{what}: projections near 0")
            err = float((got - plain)[keep].abs().max())
            check(err <= SCORE_ATOL, f"{what}: kernel vs plain {err}")
            check(torch.equal(got, again), f"{what}: kernel run to run")
            check(bool(torch.isfinite(got).all()), f"{what}: not finite")
            worst = max(worst, err)
    return worst


def ragged_int_checks() -> float:
    """The int kernel at the RAGGED_INT shapes, per precision: int32 window
    sums bitwise equal to the plain version's, scores within SCORE_ATOL
    with per-stream class tiles, bitwise run to run. Returns the largest
    score error."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 3)
    worst = 0.0
    for N, S, H, W, h, w, stride, D, block_d in RAGGED_INT:
        kw = dict(h=h, w=w, stride=stride)
        frames = 1.5 * torch.rand((N, H, W), generator=g, device=DEVICE)
        B0 = torch.randn((h, D), generator=g, device=DEVICE)
        b = 2 * math.pi * torch.rand(D, generator=g, device=DEVICE)
        chvs = torch.randn((S, 2, D), generator=g, device=DEVICE)
        for precision, (mode, bits, packed) in INT_CASES.items():
            what = f"{precision} at {(N, S, H, W, h, w, stride, D)}"
            geom = ssi.precompute_geometry_int(B0, b, W=W, w=w, stride=stride,
                                               block_d=block_d, mode=mode)
            tiles = ssi.retile_classes_int_fleet(geom, chvs)
            codes = stream.adc_view_codes(frames, bits)
            kcodes = adc.pack_nibbles(codes) if packed else codes
            pkw = dict(packed=packed, frames_per_stream=N // S, **kw)
            got = ssi.fragment_scores_batch_int(kcodes, tiles, **pkw)
            again = ssi.fragment_scores_batch_int(kcodes, tiles, **pkw)
            plain = ssi.fragment_scores_batch_int_plain(kcodes, tiles, **pkw)
            acc = ssi.int_window_acc(kcodes, geom, packed=packed, **kw)
            acc_plain = ssi.int_window_acc(kcodes.cpu(),
                                           _geometry_to(geom, "cpu"),
                                           packed=packed, **kw)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            check(err <= SCORE_ATOL, f"{what}: kernel vs plain {err}")
            check(torch.equal(acc.cpu(), acc_plain),
                  f"{what}: int32 window sums differ from the plain ones")
            check(torch.equal(got, again), f"{what}: kernel run to run")
            worst = max(worst, err)
    return worst


def bound(n_bytes: int, n_ops: int, ops_s: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / ops_s * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=n_bytes, ops=n_ops)


def _geometry_to(geom, device):
    return dataclasses.replace(geom, **{
        f.name: getattr(geom, f.name).to(device)
        for f in dataclasses.fields(geom)
        if isinstance(getattr(geom, f.name), torch.Tensor)})


RUNS = {
    # name: (precision, adc_bits, closed loop, adapt)
    "float32": ("float32", 4, False, False),
    "int8": ("int8", 8, False, False),
    "int4": ("int4", 4, False, False),
    "binary": ("binary", 8, False, False),
    "closed_loop_float32": ("float32", 4, True, False),
    "adapt_int8": ("int8", 8, False, True),
}


def stream_phase(base_model, cal, raw, labels):
    """The main path: six StreamRunner runs over the same 256 frames.
    Returns each run's record and the launches it made per kernel."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    n_chunks = math.ceil(N_STREAM / CHUNK)
    labels_np = labels.cpu().numpy()
    records, launches = [], {"sliding_scores_f32": 0,
                             "sliding_scores_int": 0}
    for name, (precision, bits, closed, adapt) in RUNS.items():
        ctrl = ControllerConfig(hold_frames=3, base_rate_hz=10.0,
                                active_rate_hz=30.0)
        model = calibrated(base_model, *cal, precision, bits)

        def runner():
            return stream.StreamRunner(
                model, ctrl, chunk_size=CHUNK, block_d=BLOCK_D,
                adc_bits=bits, precision=precision,
                control=CaptureConfig(hp_bits=12) if closed else None,
                adapt=AdaptConfig(mode="label", lr=0.5) if adapt else None,
                device=DEVICE)

        feed = labels_np if adapt else None
        geom = stream.model_geometry(model, FRAME, BLOCK_D, precision)
        # (a) 32-frame slices, each held against the plain version with the
        #     classifier the runner holds at the slice's start
        ra, out_a, err = runner(), [], 0.0
        for lo in range(0, N_STREAM, CHUNK):
            chvs = ra.class_hvs
            sl = raw[lo:lo + CHUNK]
            out_a.append(ra.process(sl, labels=None if feed is None
                                    else feed[lo:lo + CHUNK]))
            if precision in adc.INT_PRECISIONS:
                packed = precision == "int4"
                codes = stream.adc_view_codes(sl, bits)
                maps = ssi.fragment_scores_batch_int_plain(
                    adc.pack_nibbles(codes) if packed else codes,
                    ops.retile_classes_int(geom, chvs), packed=packed, **kw)
            else:
                maps = ss.fragment_scores_batch_plain(
                    stream.adc_view(sl, bits), ops.retile_classes(geom, chvs),
                    **kw)
            want = frame_detection_score(maps, 0).cpu().numpy()
            err = max(err, float(abs(out_a[-1][0] - want).max()))
        check(err <= SCORE_ATOL, f"{name}: runner vs plain {err}")
        # (b) the main-path run: counts zeroed right before, read right after
        rb = runner()
        torch.cuda.synchronize()
        ss.LAUNCHES = ssi.LAUNCHES = 0
        t0 = time.perf_counter()
        scores, fired, gated = rb.process(raw, labels=feed)
        wall = time.perf_counter() - t0
        counts = {"sliding_scores_f32": ss.LAUNCHES,
                  "sliding_scores_int": ssi.LAUNCHES}
        kernel = ("sliding_scores_int" if precision in adc.INT_PRECISIONS
                  else "sliding_scores_f32")
        check(counts[kernel] == n_chunks,
              f"{name}: {counts[kernel]} launches for {n_chunks} chunks")
        check(sum(counts.values()) == n_chunks,
              f"{name}: the other kernel launched: {counts}")
        for k, v in counts.items():
            launches[k] += v
        for got, want in zip((scores, fired, gated),
                             (np.concatenate(x) for x in zip(*out_a))):
            check(np.array_equal(got, want),
                  f"{name}: slicing or a rerun changed the output")
        check(np.isfinite(scores).all() and scores.shape == (N_STREAM,),
              f"{name}: scores not finite or of the wrong shape")
        log = rb.capture_log
        hp_idx, hp = rb.drain_hp()
        if closed:
            check(len(hp_idx) == int(gated.sum()) and
                  hp.shape == (len(hp_idx), FRAME, FRAME),
                  f"{name}: HP drain does not match the gated frames")
        rec = dict(run=name, precision=precision, adc_bits=bits,
                   frames=N_STREAM, chunk=CHUNK, chunks=n_chunks,
                   launches=counts, fps=N_STREAM / wall, wall_s=wall,
                   fired=int(fired.sum()), gated=int(gated.sum()),
                   sampled=int(log.sampled.sum()), hp_frames=len(hp_idx),
                   max_abs_err_vs_plain=err, sliced_run_bitwise=True,
                   duty_cycle=float(gated.mean()),
                   missed_positive=float((labels_np.astype(bool)
                                          & ~gated).sum()
                                         / max(labels_np.sum(), 1)),
                   t_score=model.t_score)
        if adapt:
            rec["class_hvs_moved"] = float(
                (rb.class_hvs - model.class_hvs).abs().max())
        emit(rec)
        records.append(rec)
    return records, launches


def profile_phase(base_model, cal, raw):
    """Where a run's time goes: one float32 and one int8 run of the 256
    frames under ``torch.profiler`` — device busy share of the wall time
    and the device time of the top kernels. Outside the main-path counts;
    the profiler's own overhead lengthens the wall time it is shared of."""
    out = {}
    for precision, bits in (("float32", 4), ("int8", 8)):
        r = stream.StreamRunner(calibrated(base_model, *cal, precision, bits),
                                chunk_size=CHUNK, block_d=BLOCK_D,
                                adc_bits=bits, precision=precision,
                                device=DEVICE)
        r.process(raw[:CHUNK])
        out[precision] = device_profile(lambda: r.process(raw))
    return out


FLEET_RUNS = {
    # name: (precision, adc_bits, closed loop, adapt scope, adc_sigma)
    "fleet_float32": ("float32", 4, False, None, 0.0),
    "fleet_int8": ("int8", 8, False, None, 0.0),
    "fleet_closed_loop_float32": ("float32", 4, True, None, 0.0),
    "fleet_adapt_int8_per_stream": ("int8", 8, False, "per-stream", 0.0),
    "fleet_adapt_int8_shared": ("int8", 8, False, "shared", 0.0),
    "fleet_noisy_float32": ("float32", 4, False, None, 0.02),
}


def fleet_data(g):
    """``(FLEET_S, N_STREAM, FRAME, FRAME)`` frames and their labels: each
    stream its own draw of synthetic frames, with the stream phase's
    object schedule (one run of 16 in every 48 frames) shifted by 6 frames
    per stream."""
    idx = torch.arange(N_STREAM, device=g.device)
    labels = torch.stack([((idx + 6 * s) // 16) % 3 == 2
                          for s in range(FLEET_S)]).long()
    raw = torch.stack([synthetic_frames(g, lab)[0] for lab in labels])
    return raw, labels


def fleet_views(raw, precision, bits, sigma, start):
    """What each stream's scorer sees of ``raw (S, c, H, W)`` from its
    absolute frame ``start``: stream s's ADC noise keyed by
    ``fleet.stream_seed(SEED, s)``, as ``FleetRunner`` keys it."""
    view = (stream.adc_view_codes if precision in adc.INT_PRECISIONS
            else stream.adc_view)
    return torch.stack([view(raw[s], bits, sigma=sigma,
                             seed=fleet.stream_seed(SEED, s),
                             start_index=start)
                        for s in range(raw.shape[0])])


def fleet_plain_err(raw, scores, model, precision, bits, sigma, chvs, lo):
    """Largest difference between the fleet's scores of the super-chunk
    at frame ``lo`` and the plain version's, scored with the classifiers
    ``chvs`` (``(2, D)`` shared or ``(S, 2, D)`` per stream) the runner
    held at that super-chunk's start."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    views = fleet_views(raw[:, lo:lo + CHUNK], precision, bits, sigma, lo)
    S, C = views.shape[:2]
    flat = views.reshape(S * C, FRAME, FRAME)
    geom = stream.model_geometry(model, FRAME, BLOCK_D, precision)
    per_stream = dict(frames_per_stream=C) if chvs.ndim == 3 else {}
    if precision in adc.INT_PRECISIONS:
        retile = (ops.retile_classes_int_fleet if chvs.ndim == 3
                  else ops.retile_classes_int)
        maps = ssi.fragment_scores_batch_int_plain(
            flat, retile(geom, chvs), **kw, **per_stream)
    else:
        retile = (ops.retile_classes_fleet if chvs.ndim == 3
                  else ops.retile_classes)
        maps = ss.fragment_scores_batch_plain(flat, retile(geom, chvs),
                                              **kw, **per_stream)
    want = frame_detection_score(maps, 0).reshape(S, C).cpu().numpy()
    return float(abs(scores[:, lo:lo + C] - want).max())


def stacked_forms(g) -> dict:
    """Why the fleet takes some things stream by stream, measured at its
    shapes (no check): the streams of FLEET_S whose bits change when the
    positive class norms of an ``(S, 2, D)`` stack are taken in one call
    over its ``[:, 1]`` view instead of each alone (``ss.class_norms``),
    and when the online fold's top fragments are encoded as one
    ``S*CHUNK``-row matmul instead of ``CHUNK`` rows per stream
    (``stream._top_fragment_hvs``)."""
    x = torch.randn((FLEET_S, 2, DIM), generator=g, device=DEVICE)[:, 1]
    one_call = torch.linalg.vector_norm(x, dim=-1)
    frags = torch.rand((FLEET_S, CHUNK, FRAG, FRAG), generator=g,
                       device=DEVICE)
    base = encoding.flat_perm_base(torch.randn((FRAG, DIM), generator=g,
                                               device=DEVICE), FRAG)
    b = 2 * math.pi * torch.rand(DIM, generator=g, device=DEVICE)
    stacked = encoding.encode_fragments(
        frags.reshape(FLEET_S * CHUNK, FRAG, FRAG), base, b).reshape(
            FLEET_S, CHUNK, DIM)
    per_stream = torch.stack([encoding.encode_fragments(f, base, b)
                              for f in frags])
    return dict(norm_streams_differ=int((ss.class_norms(x) != one_call)
                                        .sum()),
                encode_streams_differ=int((stacked != per_stream)
                                          .flatten(1).any(1).sum()),
                encode_max_abs_diff=float((stacked - per_stream).abs()
                                          .max()))


def fleet_phase(base_model, cal, raw, labels):
    """The fleet: ``FleetRunner`` over FLEET_S streams of N_STREAM frames,
    once per FLEET_RUNS entry. Each run makes one scorer wrapper call per
    super-chunk; each stream is bitwise what an independent StreamRunner
    gives it (but under a shared classifier, which no single stream has);
    the run fed as two process calls is bitwise the whole run; the scores
    of super-chunk 0 (and, adapting, of the super-chunk at the cut) are
    within SCORE_ATOL of the plain version; each run is billed by
    ``fleet_report``. One float32 and one int8 run are profiled. Returns
    the runs' records and the launches they made per kernel."""
    S, n = raw.shape[:2]
    n_chunks = math.ceil(n / CHUNK)
    labels_np = labels.cpu().numpy()
    ctrl = ControllerConfig(hold_frames=3, base_rate_hz=10.0,
                            active_rate_hz=30.0)
    records, launches = [], {"sliding_scores_f32": 0,
                             "sliding_scores_int": 0}
    for name, (precision, bits, closed, scope, sigma) in FLEET_RUNS.items():
        model = calibrated(base_model, *cal, precision, bits)
        common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=bits,
                      adc_sigma=sigma, precision=precision,
                      control=CaptureConfig(hp_bits=12) if closed else None,
                      device=DEVICE)
        adapt = None if scope is None else AdaptConfig(
            mode="label", lr=0.5, scope=scope)
        feed = None if adapt is None else labels_np
        kernel = ("sliding_scores_int" if precision in adc.INT_PRECISIONS
                  else "sliding_scores_f32")

        def runner():
            return fleet.FleetRunner(model, ctrl, adc_seed=SEED, adapt=adapt,
                                     **common)

        def part(lo, hi):
            return None if feed is None else feed[:, lo:hi]

        runner().process(raw[:, :CHUNK], labels=part(0, CHUNK))  # warm-up
        # (a) the main-path run: counts zeroed right before, read right after
        rf = runner()
        torch.cuda.synchronize()
        ss.LAUNCHES = ssi.LAUNCHES = 0
        t0 = time.perf_counter()
        scores, fired, gated = rf.process(raw, labels=feed)
        wall = time.perf_counter() - t0
        counts = {"sliding_scores_f32": ss.LAUNCHES,
                  "sliding_scores_int": ssi.LAUNCHES}
        check(counts[kernel] == n_chunks,
              f"{name}: {counts[kernel]} scorer calls for {n_chunks} "
              f"super-chunks of {S} streams")
        check(sum(counts.values()) == n_chunks,
              f"{name}: the other kernel launched: {counts}")
        for k, v in counts.items():
            launches[k] += v
        check(np.isfinite(scores).all() and scores.shape == (S, n),
              f"{name}: scores not finite or of the wrong shape")
        log, drains = rf.capture_log, rf.drain_hp()

        # (b) the same frames through S looped StreamRunners, each held
        #     bitwise against its stream of the fleet
        rkw = dict(common, adapt=None if adapt is None else AdaptConfig(
            mode="label", lr=0.5))
        loop = [stream.StreamRunner(model, ctrl,
                                    adc_seed=fleet.stream_seed(SEED, s),
                                    **rkw) for s in range(S)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [r.process(raw[s], labels=None if feed is None else feed[s])
                for s, r in enumerate(loop)]
        looped_wall = time.perf_counter() - t0
        independent = scope != "shared"
        if independent:
            for s, (r, out) in enumerate(zip(loop, outs)):
                what = f"{name}: stream {s} differs from its StreamRunner"
                for got, want in zip((scores, fired, gated), out):
                    check(np.array_equal(got[s], want), f"{what} (gate)")
                rlog = r.capture_log
                check(np.array_equal(log.sampled[s], rlog.sampled)
                      and np.array_equal(log.gated[s], rlog.gated),
                      f"{what} (capture log)")
                idx, hp = r.drain_hp()
                check(np.array_equal(drains[s][0], idx)
                      and np.array_equal(drains[s][1], hp),
                      f"{what} (HP drain)")
                if adapt is not None:
                    check(torch.equal(rf.class_hvs[s], r.class_hvs),
                          f"{what} (classifier)")

        # (c) the run fed as two process calls
        cut = FLEET_CUT if adapt is None else FLEET_CUT // CHUNK * CHUNK
        rs = runner()
        first = rs.process(raw[:, :cut], labels=part(0, cut))
        chvs_cut = rs.class_hvs.clone()
        second = rs.process(raw[:, cut:], labels=part(cut, n))
        slog, sdrains = rs.capture_log, rs.drain_hp()
        for got, a, b in zip((scores, fired, gated), first, second):
            check(np.array_equal(got, np.concatenate([a, b], axis=1)),
                  f"{name}: slicing or a rerun changed the output")
        check(np.array_equal(log.sampled, slog.sampled)
              and np.array_equal(log.gated, slog.gated)
              and all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                      for x, y in zip(drains, sdrains))
              and torch.equal(rf.class_hvs, rs.class_hvs),
              f"{name}: slicing changed the log, drains or classifier")

        # (d) against the plain version
        err = fleet_plain_err(raw, scores, model, precision, bits, sigma,
                              model.class_hvs if scope != "per-stream" else
                              model.class_hvs.expand(S, 2, DIM), 0)
        if adapt is not None:
            err = max(err, fleet_plain_err(raw, scores, model, precision,
                                           bits, sigma, chvs_cut, cut))
        check(err <= SCORE_ATOL, f"{name}: fleet vs plain {err}")

        # (e) the energy account, at the run's LP depth
        params = energy.EnergyParams(adc_lp_bits=bits)
        rep = fleet.fleet_report(fired, gated, labels_np, params, precision,
                                 capture=log)
        by_duty = fleet.fleet_report(fired, gated, labels_np, params,
                                     precision)
        check(math.isfinite(rep.energy_total_j)
              and math.isfinite(rep.baseline_total_j)
              and 0.0 < rep.total_saving < 1.0,
              f"{name}: energy report out of range: {rep}")
        if closed:
            check(not log.sampled.all()
                  and rep.energy_total_j < by_duty.energy_total_j,
                  f"{name}: the closed loop saved no LP conversion")
        else:
            check(energy.from_capture_log(log, params, precision)
                  == energy.hypersense_measured(float(log.gated.mean()),
                                                params, precision),
                  f"{name}: the open-loop capture bill is not the duty "
                  f"bill")
        rec = dict(
            run=name, precision=precision, adc_bits=bits, closed_loop=closed,
            adapt=scope, adc_sigma=sigma, streams=S, frames_per_stream=n,
            chunk=CHUNK, super_chunks=n_chunks, launches=counts,
            fps=S * n / wall, wall_s=wall, looped_fps=S * n / looped_wall,
            looped_wall_s=looped_wall,
            streams_bitwise_vs_runners=(True if independent
                                        else "shared classifier"),
            sliced_run_bitwise=True, cut=cut, max_abs_err_vs_plain=err,
            fired=int(fired.sum()), gated=int(gated.sum()),
            sampled=int(log.sampled.sum()),
            hp_frames=sum(len(i) for i, _ in drains),
            duty_cycle=rep.duty_cycle,
            energy_per_frame_j=rep.energy_per_frame.total,
            energy_total_j=rep.energy_total_j,
            baseline_total_j=rep.baseline_total_j,
            total_saving=rep.total_saving,
            duty_bill_total_j=by_duty.energy_total_j, t_score=model.t_score)
        if name in ("fleet_float32", "fleet_int8"):
            rp = runner()
            rp.process(raw[:, :CHUNK])
            rec["profile"] = device_profile(lambda: rp.process(raw))
        emit(rec)
        records.append(rec)
    return records, launches


SERVICE_RUNS = {
    # name: (precision, adc_bits, closed loop)
    "service_float32": ("float32", 4, False),
    "service_int8": ("int8", 8, False),
    "service_closed_loop_float32": ("float32", 4, True),
}
SERVICE_INFLIGHT = 2
# the churn runs: 10 sensors on the fleet's 8 slots, sensor i reading
# stream i % 8 of the fleet's frames from frame N_STREAM // 4 * (i // 8); a
# checkpoint at tick CKPT_TICK
CKPT_TICK = 4


def service_ctrl():
    return ControllerConfig(hold_frames=3, base_rate_hz=10.0,
                            active_rate_hz=30.0)


def serve(svc, frames, sync_free_after_first: bool = False):
    """Every sensor 0..S-1 delivers its frames of ``frames`` (S, n, H, W),
    one ``CHUNK`` a tick; returns the collected ticks. With
    ``sync_free_after_first`` the dispatches after the first run under
    :func:`sync_free`: a host sync or a rebuild raises."""
    for k, lo in enumerate(range(0, frames.shape[1], CHUNK)):
        arrivals = {s: frames[s, lo:lo + CHUNK] for s in range(len(frames))}
        with (sync_free("service warm dispatch")
              if sync_free_after_first and k > 0 else contextlib.nullcontext()):
            svc.dispatch(arrivals)
    return svc.flush()


def served_arrays(chunks, S: int):
    """``(S, n)`` scores, fired and gated from ticks where every sensor
    0..S-1 delivered."""
    return tuple(np.stack([np.concatenate([ch.outputs[s][j]
                                           for ch in chunks])
                           for s in range(S)]) for j in range(3))


def churn_schedule(n_ticks: int):
    """(detach, attach, arrivals) per tick on 8 slots: sensors 0-7 attach;
    3 leaves for 8; tick 2 is silent; 8 and 5 leave, 3 comes back to its
    slot through tenant 8, 9 joins; 0 leaves for 8, reattached; the other
    ticks ragged (each attached sensor delivers with probability 0.75,
    from a seeded generator), the last full."""
    g = torch.Generator().manual_seed(SEED + 8)
    churn = {0: ((), tuple(range(FLEET_S))), 1: ((3,), (8,)),
             3: ((8, 5), (3, 9)), 5: ((0,), (8,))}
    attached, out = set(), []
    for k in range(n_ticks):
        det, att = churn.get(k, ((), ()))
        attached = (attached - set(det)) | set(att)
        if k == 2:
            arrive = ()
        elif k in (0, n_ticks - 1):
            arrive = tuple(sorted(attached))
        else:
            arrive = tuple(sid for sid in sorted(attached)
                           if float(torch.rand((), generator=g)) < 0.75)
        out.append((det, att, arrive))
    return out


def play_churn(svc, frames_of, schedule, fed=None):
    """Run ``schedule`` on ``svc`` (sensor ``sid`` reads ``frames_of(sid)``
    from where it stopped); returns ``{sid: [(s, f, g), ...]}`` and the
    frames fed per sensor."""
    fed = {} if fed is None else fed
    for det, att, arrive in schedule:
        for sid in det:
            svc.detach(sid)
        for sid in att:
            svc.attach(sid)
        arrivals = {}
        for sid in arrive:
            n0 = fed.get(sid, 0)
            arrivals[sid] = frames_of(sid)[n0:n0 + CHUNK]
            fed[sid] = n0 + CHUNK
        svc.dispatch(arrivals)
    got = {}
    for ch in svc.flush():
        for sid, out in ch.outputs.items():
            got.setdefault(sid, []).append(out)
    return got, fed


def service_phase(base_model, cal, raw):
    """``FleetService`` over the fleet's FLEET_S streams of N_STREAM frames:
    (1) the float32, int8 and closed-loop services bitwise the
    ``FleetRunner`` of the same trace, one scorer call per tick, tick 0
    within SCORE_ATOL of the plain version, and (frozen, open loop) every
    dispatch after the first free of host syncs; (2) an int8 and a noisy
    float32 run under ``churn_schedule`` with per-stream pseudo adaptation,
    each sensor bitwise its own ``StreamRunner``, (4) no rebuild after the
    warm-up tick; (3) ``max_inflight`` 1, 4 and 8 (closed loop; 8 ticks
    in flight with no back-pressure, so every dispatch after the first is
    checked free of syncs) bitwise as 2; (5) a checkpoint at CKPT_TICK
    resumed bitwise by a fresh service. It times the services (host and
    card arrivals) and ``FleetRunner`` in turns, profiles float32 and
    int8, and takes the median dispatch->collect latency. Returns the
    records and the launches of (1)."""
    S, n = raw.shape[:2]
    n_ticks = n // CHUNK
    raw_np = raw.cpu().numpy()
    ctrl = service_ctrl()
    records, launches = [], {"sliding_scores_f32": 0,
                             "sliding_scores_int": 0}
    for name, (precision, bits, closed) in SERVICE_RUNS.items():
        model = calibrated(base_model, *cal, precision, bits)
        common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=bits,
                      precision=precision, adc_seed=SEED, device=DEVICE,
                      control=CaptureConfig(hp_bits=12) if closed else None)
        kernel = ("sliding_scores_int" if precision in adc.INT_PRECISIONS
                  else "sliding_scores_f32")

        def service(inflight=SERVICE_INFLIGHT):
            svc = FleetService(model, ctrl, n_slots=S, max_inflight=inflight,
                               **common)
            for s in range(S):
                svc.attach(s)
            return svc

        rf = fleet.FleetRunner(model, ctrl, **common)
        want = rf.process(raw)
        want_log, want_hp = rf.capture_log, rf.drain_hp()

        def same_as_runner(svc, chunks, what):
            check([ch.seq for ch in chunks] == list(range(n_ticks)),
                  f"{what}: ticks not collected in order")
            for got, ref_out in zip(served_arrays(chunks, S), want):
                check(np.array_equal(got, ref_out),
                      f"{what}: differs from FleetRunner (gate)")
            for s in range(S):
                log = svc.capture_log(s)
                check(np.array_equal(log.sampled, want_log.sampled[s])
                      and np.array_equal(log.gated, want_log.gated[s]),
                      f"{what}: sensor {s} capture log")
                idx, hp = svc.drain_hp(s)
                check(np.array_equal(idx, want_hp[s][0])
                      and np.array_equal(hp, want_hp[s][1]),
                      f"{what}: sensor {s} HP drain")
            check(svc.hp_dropped == rf.hp_dropped, f"{what}: hp_dropped")

        # (1) the main-path run: host arrivals, counts zeroed right before
        svc = service()
        torch.cuda.synchronize()
        ss.LAUNCHES = ssi.LAUNCHES = 0
        chunks = serve(svc, raw_np, sync_free_after_first=not closed)
        counts = {"sliding_scores_f32": ss.LAUNCHES,
                  "sliding_scores_int": ssi.LAUNCHES}
        check(counts[kernel] == n_ticks and sum(counts.values()) == n_ticks,
              f"{name}: {counts} scorer calls for {n_ticks} ticks")
        for k, v in counts.items():
            launches[k] += v
        same_as_runner(svc, chunks, name)
        scores = served_arrays(chunks, S)[0]
        check(np.isfinite(scores).all() and scores.shape == (S, n),
              f"{name}: scores not finite or of the wrong shape")
        err = fleet_plain_err(raw, scores, model, precision, bits, 0.0,
                              model.class_hvs, 0)
        check(err <= SCORE_ATOL, f"{name}: tick 0 vs plain {err}")
        rec = dict(run=name, precision=precision, adc_bits=bits,
                   closed_loop=closed, slots=S, ticks=n_ticks, chunk=CHUNK,
                   max_inflight=SERVICE_INFLIGHT, launches=counts,
                   bitwise_vs_fleet_runner=True,
                   warm_dispatch_sync_free=not closed,
                   max_abs_err_vs_plain=err, fired=int(want[1].sum()),
                   hp_frames=sum(len(i) for i, _ in want_hp),
                   hp_dropped=rf.hp_dropped)

        # (3) pipelining depth (the closed loop: HP capture in collect)
        if closed:
            rec["max_inflight_bitwise"] = []
            for depth in (1, 4, n_ticks):
                ss.LAUNCHES = ssi.LAUNCHES = 0
                sv = service(depth)
                got = serve(sv, raw_np, sync_free_after_first=depth >= n_ticks)
                check(ss.LAUNCHES + ssi.LAUNCHES == n_ticks,
                      f"{name}: max_inflight={depth}: not one scorer call "
                      f"a tick")
                same_as_runner(sv, got, f"{name}, max_inflight={depth}")
                rec["max_inflight_bitwise"].append(depth)
            rec["warm_dispatch_sync_free_at_max_inflight"] = n_ticks

        # timing: FleetRunner and the service, each fed host (numpy) and
        # card frames, each warm, in turns; the latency of the host-arrival
        # ticks
        warm = service()
        serve(warm, raw_np)
        rf.process(raw)
        walls = {}
        for what, fn in (("runner_card", lambda: rf.process(raw)),
                         ("service_host", lambda: serve(warm, raw_np)),
                         ("service_card", lambda: serve(warm, raw)),
                         ("runner_host", lambda: rf.process(raw_np)),
                         ("runner_card_again", lambda: rf.process(raw))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            walls[what] = time.perf_counter() - t0
            if what == "service_host":
                rec["latency_median_s"] = statistics.median(
                    ch.latency_s for ch in out)
        rec.update({f"{k}_fps": S * n / v for k, v in walls.items()})
        if not closed:
            rec["profile_service_card"] = device_profile(
                lambda: serve(warm, raw))
            rec["profile_service_host"] = device_profile(
                lambda: serve(warm, raw_np))
            rec["profile_runner_card"] = device_profile(
                lambda: rf.process(raw))
        emit(rec)
        records.append(rec)

    records.append(service_card_codes(base_model, cal, raw))
    emit(records[-1])
    records += service_churn_checks(base_model, cal, raw)
    return records, launches


def service_card_codes(base_model, cal, raw) -> dict:
    """The int8 service fed ADC codes already on the card (uint8, the
    codes' wire dtype): its warm tick's host syncs counted under
    ``torch.cuda.set_sync_debug_mode("warn")`` inside
    ``sanitize.steady_state()`` must be exactly the one read of the fused
    code-range check (``adc.check_codes_range`` over every sensor's codes
    at once), and the run bitwise ``FleetRunner`` on the same codes."""
    S, n = raw.shape[:2]
    bits = 8
    model = calibrated(base_model, *cal, "int8", bits)
    codes = adc.pack_codes(adc.quantize_codes(raw, bits), bits)
    common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=bits,
                  precision="int8", adc_seed=SEED, device=DEVICE)
    svc = FleetService(model, service_ctrl(), n_slots=S,
                       max_inflight=SERVICE_INFLIGHT, **common)
    for s in range(S):
        svc.attach(s)
    region = "service card codes warm tick"
    led = sanitize.ledger()
    syncs = []
    for k, lo in enumerate(range(0, n, CHUNK)):
        arrivals = {s: codes[s, lo:lo + CHUNK] for s in range(S)}
        if k != 1:
            svc.dispatch(arrivals)
            continue
        before = led.events
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught, \
                sanitize.steady_state(region):
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                svc.dispatch(arrivals)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        GUARDED.append((region, led.events - before))
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "synchroniz" in str(w.message)]
    chunks = svc.flush()
    check(len(syncs) == 1, f"{region}: {len(syncs)} host syncs, the one "
          f"code-range read expected: {syncs}")
    want = fleet.FleetRunner(model, service_ctrl(), **common).process(codes)
    for got, ref_out in zip(served_arrays(chunks, S), want):
        check(np.array_equal(got, ref_out),
              "service fed card codes: differs from FleetRunner")
    return dict(run="service_int8_card_codes", codes_dtype=str(codes.dtype),
                slots=S, ticks=n // CHUNK, warm_tick_host_syncs=len(syncs),
                sync_ops=syncs, bitwise_vs_fleet_runner=True)


def service_churn_checks(base_model, cal, raw):
    """(2) and (4): the churn runs against independent StreamRunners and
    the rebuild count; (5): checkpoint at CKPT_TICK and resume."""
    n_ticks = raw.shape[1] // CHUNK
    schedule = churn_schedule(n_ticks)
    check(schedule[2][2] == () and any(a for _, a, _ in schedule[1:])
          and any(d for d, _, _ in schedule[1:]),
          "the churn schedule lost its silent tick, attach or detach")

    def frames_of(sid):
        return raw[sid % FLEET_S, N_STREAM // 4 * (sid // FLEET_S):]

    ctrl = service_ctrl()
    adapt = AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3,
                        confidence=0.0)
    records = []
    for name, precision, bits, sigma in (("churn_int8", "int8", 8, 0.0),
                                         ("churn_noisy_float32", "float32",
                                          4, 0.02)):
        model = calibrated(base_model, *cal, precision, bits)
        common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=bits,
                      adc_sigma=sigma, precision=precision, device=DEVICE)
        svc = FleetService(model, ctrl, n_slots=FLEET_S, adapt=adapt,
                           adc_seed=SEED, **common)
        first, rest = schedule[:1], schedule[1:]
        got, fed = play_churn(svc, frames_of, first)
        rebuilds = svc.rebuild_count()
        more, fed = play_churn(svc, frames_of, rest, fed)
        check(svc.rebuild_count() == rebuilds,
              f"{name}: {svc.rebuild_count() - rebuilds} rebuilds under "
              f"churn")
        for sid, outs in more.items():
            got.setdefault(sid, []).extend(outs)
        moved = 0.0
        for sid, n_fed in fed.items():
            r = stream.StreamRunner(
                model, ctrl, adapt=dataclasses.replace(adapt, scope="shared"),
                adc_seed=fleet.stream_seed(SEED, svc.uid(sid)), **common)
            want = r.process(frames_of(sid)[:n_fed])
            what = f"{name}: sensor {sid} differs from its StreamRunner"
            for j, w in enumerate(want):
                check(np.array_equal(np.concatenate(
                    [o[j] for o in got[sid]]), w), f"{what} (gate)")
            log, rlog = svc.capture_log(sid), r.capture_log
            check(np.array_equal(log.sampled, rlog.sampled)
                  and np.array_equal(log.gated, rlog.gated),
                  f"{what} (capture log)")
            chvs = svc.class_hvs_of(sid)
            check(torch.equal(chvs, r.class_hvs), f"{what} (classifier)")
            moved = max(moved, float((chvs - model.class_hvs).abs().max()))
        check(moved > 0, f"{name}: adaptation never moved a classifier")
        rec = dict(run=name, precision=precision, adc_sigma=sigma,
                   slots=FLEET_S, sensors=len(fed), ticks=n_ticks,
                   schedule=[[list(d), list(a), list(r)]
                             for d, a, r in schedule],
                   sensors_bitwise_vs_runners=True,
                   rebuild_count=svc.rebuild_count(),
                   rebuilds_after_warmup=0, class_hvs_moved=moved)
        emit(rec)
        records.append(rec)
    records.append(service_resume_check(base_model, cal, raw, schedule,
                                        frames_of))
    return records


def service_resume_check(base_model, cal, raw, schedule, frames_of):
    """(5) The closed loop with per-stream pseudo adaptation under the
    churn schedule, checkpointed at CKPT_TICK (two sensors parked, HP
    frames undrained); a fresh service restores it, and both continue:
    outputs, capture logs, classifiers (parked ones too) and HP drains
    bitwise."""
    ckpt_dir = ROOT / "build" / "service_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    model = calibrated(base_model, *cal, "float32", 4)

    def build():
        return FleetService(
            model, service_ctrl(), n_slots=FLEET_S, chunk_size=CHUNK,
            block_d=BLOCK_D, adc_bits=4, adc_seed=SEED,
            control=CaptureConfig(hp_bits=12),
            adapt=AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3,
                              confidence=0.0),
            ckpt_dir=str(ckpt_dir), device=DEVICE)

    try:
        svc = build()
        _, fed = play_churn(svc, frames_of, schedule[:CKPT_TICK])
        svc.checkpoint()
        svc.wait_ckpt()
        parked = len(svc._parked)
        undrained = sum(len(v) for v in svc._hp.values())
        check(parked > 0 and undrained > 0,
              f"resume: {parked} parked sensors, {undrained} HP frames")
        ref, _ = play_churn(svc, frames_of, schedule[CKPT_TICK:], dict(fed))
        svc2 = build()
        check(svc2.restore() == CKPT_TICK, "resume: restored tick count")
        got, _ = play_churn(svc2, frames_of, schedule[CKPT_TICK:], dict(fed))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(set(got) == set(ref), "resume: sensors served differ")
    for sid in ref:
        for j in range(3):
            check(np.array_equal(np.concatenate([o[j] for o in got[sid]]),
                                 np.concatenate([o[j] for o in ref[sid]])),
                  f"resume: sensor {sid} outputs")
    for sid in fed:
        a, b = svc.capture_log(sid), svc2.capture_log(sid)
        check(np.array_equal(a.sampled, b.sampled)
              and np.array_equal(a.gated, b.gated),
              f"resume: sensor {sid} capture log")
        check(torch.equal(svc.class_hvs_of(sid), svc2.class_hvs_of(sid)),
              f"resume: sensor {sid} classifier")
        (ia, fa), (ib, fb) = svc.drain_hp(sid), svc2.drain_hp(sid)
        check(np.array_equal(ia, ib) and np.array_equal(fa, fb),
              f"resume: sensor {sid} HP drain")
    rec = dict(run="checkpoint_resume", checkpoint_tick=CKPT_TICK,
               parked_at_checkpoint=parked,
               undrained_hp_frames_at_checkpoint=undrained,
               resumed_bitwise=True)
    emit(rec)
    return rec


# the mesh phase: the scorers' split entries at the paper's point, then the
# sharded fleet and service in an NCCL world of every card of the host. At
# D = 5000 the default block (512) leaves one D-wide tile; MESH_BLOCK_D =
# 625 gives n_dt = 8 tiles, which 2-, 4- and 8-way splits divide. Sharded
# and unsharded runs use the same block (the fold's grouping sets the bits)
MESH_BLOCK_D = 625
MESH_SHARDS = (1, 2, 4, 8)
# (precision, ADC bits): the split checks' datapaths
MESH_SPLIT = (("float32", 4), ("int8", 8), ("int4", 4), ("binary", 8))
MESH_RUNS = {
    # name: (precision, adc_bits, closed loop, adapt scope)
    "mesh_float32": ("float32", 4, False, None),
    "mesh_int8": ("int8", 8, False, None),
    "mesh_closed_loop_float32": ("float32", 4, True, None),
    "mesh_adapt_int8_shared": ("int8", 8, False, "shared"),
    "mesh_adapt_int8_per_stream": ("int8", 8, False, "per-stream"),
}
# seconds the world's ranks may take, their builds excluded (the parent
# builds every kernel before it spawns them)
MESH_TIMEOUT_S = 600
# the sharded cascade: the full-width detector on every mesh, fed a full
# batch and a padded tail of 3 of the closed-loop runner's HP frames;
# full batches timed warm in turns with an unsharded one on the rank's card
MESH_CASCADE_TAIL, MESH_CASCADE_TIMED = 3, 4
# the detector's own sensitivity at full depth: its float32 logits moved by
# a relative perturbation of this size in one weight (the MLPs' w_down)
MESH_PERTURB = 1e-7


def split_views(raw, precision, bits):
    """The (S*C, H, W) super-chunk a scorer sees at ``precision`` (int4:
    nibble-packed codes) and its scorer module."""
    flat = raw.reshape(-1, FRAME, FRAME)
    if precision == "float32":
        return stream.adc_view(flat, bits), ss
    codes = stream.adc_view_codes(flat, bits)
    return (adc.pack_nibbles(codes) if precision == "int4" else codes), ssi


def split_checks(model, raw, g) -> dict:
    """(a) Each scorer's split entries, in this process: the paper's point,
    an (FLEET_S, CHUNK) super-chunk, MESH_BLOCK_D tiles cut into 1, 2, 4
    and 8 contiguous virtual shards; each shard through the partials entry
    (its own D-tiles, cut by ``fleet.local_geometry``), the partials
    concatenated in tile order, then the fold entry: bitwise the wrapper's
    unsplit call, for each precision with shared and per-stream class
    tiles. The unsplit call's scores are held within SCORE_ATOL of the
    plain version on the same frames and tiles; for the int precisions the
    shards' int32 window sums, concatenated in tile order, bitwise the
    plain version's. Times each shard count's partials and fold beside the
    unsplit call."""
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    my = mx = (FRAME - FRAG) // STRIDE + 1
    per_stream = model.class_hvs + 0.05 * torch.randn(
        (FLEET_S, 2, DIM), generator=g, device=DEVICE)
    out = {}
    for precision, bits in MESH_SPLIT:
        frames, mod = split_views(raw[:, :CHUNK], precision, bits)
        packed = dict(packed=True) if precision == "int4" else {}
        N = frames.shape[0]
        geom = stream.model_geometry(model, FRAME, MESH_BLOCK_D, precision)
        n_dt = geom.idx.shape[0]
        check(n_dt == max(MESH_SHARDS), f"mesh: {n_dt} D-tiles")
        if mod is ssi:
            codes = adc.unpack_nibbles(frames) if packed else frames
            plain_acc = ssi._int_window_acc_plain(
                codes, geom, h=FRAG, stride=STRIDE).reshape(
                    N, my, mx, n_dt, MESH_BLOCK_D).permute(0, 1, 3, 2, 4)
        for layout, chvs in (("shared", model.class_hvs),
                             ("per_stream", per_stream)):
            if precision == "float32":
                retile = (ops.retile_classes_fleet if chvs.ndim == 3
                          else ops.retile_classes)
            else:
                retile = (ops.retile_classes_int_fleet if chvs.ndim == 3
                          else ops.retile_classes_int)
            fps = dict(frames_per_stream=CHUNK) if chvs.ndim == 3 else {}
            tiles = retile(geom, chvs)
            what = f"mesh: {precision} {layout}"
            if mod is ss:
                def unsplit():
                    return ss.fragment_scores_batch(frames, tiles, **kw,
                                                    **fps)
                plain = ss.fragment_scores_batch_plain(frames, tiles, **kw,
                                                       **fps)
            else:
                def unsplit():
                    return ssi.fragment_scores_batch_int(
                        frames, tiles, **kw, **fps, **packed)
                plain = ssi.fragment_scores_batch_int_plain(
                    frames, tiles, **kw, **fps, **packed)
            want = unsplit()
            err = float((want - plain).abs().max())
            check(err <= SCORE_ATOL, f"{what}: unsplit call vs plain {err}")
            check(bool(torch.isfinite(want).all())
                  and want.shape == (N, my, mx), f"{what}: not finite")
            rec = dict(unsplit_ms=time_ms(unsplit), max_abs_err=err,
                       split_ms={})
            for k in MESH_SHARDS:
                step = n_dt // k
                shards = [retile(fleet.local_geometry(geom, lo, lo + step),
                                 chvs) for lo in range(0, n_dt, step)]
                accs = [torch.empty((N, my, step, mx, MESH_BLOCK_D),
                                    dtype=torch.int32, device=DEVICE)
                        for _ in shards] if mod is ssi else None

                def split(accs=None):
                    parts = []
                    for j, t in enumerate(shards):
                        sums = {} if accs is None else dict(acc_out=accs[j])
                        parts.append(mod.split_partials(
                            frames, t, **kw, **fps, **packed, **sums))
                    return mod.split_fold(torch.cat(parts), tiles, N=N,
                                          my=my, mx=mx, **fps)
                got = split(accs)
                check(torch.equal(got, want),
                      f"{what} at {k} shards differs from the unsplit "
                      f"call by {float((got - want).abs().max())}")
                if accs is not None:
                    check(torch.equal(torch.cat(accs, 2), plain_acc),
                          f"{what} at {k} shards: window sums differ "
                          f"from the plain version's")
                rec["split_ms"][k] = time_ms(split)
            out[f"{precision}_{layout}"] = rec
    return out


def mesh_reference(base_model, cal, raw, labels, root) -> dict:
    """The unsharded runs the world is held against, on the card: the
    MESH_RUNS ``FleetRunner`` runs (the float32 one timed warm), the frozen
    float32 service, and the int8 churn service with per-stream pseudo
    adaptation, checkpointed at CKPT_TICK into ``root/unsharded_ckpt``."""
    ctrl = service_ctrl()
    labels_np = labels.cpu().numpy()
    ref = {"runs": {}, "models": {}}
    for name, (precision, bits, closed, scope) in MESH_RUNS.items():
        model = calibrated(base_model, *cal, precision, bits)
        ref["models"][precision] = model
        r = fleet.FleetRunner(model, ctrl, **mesh_runner_kwargs(
            precision, bits, closed, scope))
        feed = None if scope is None else labels_np
        out = r.process(raw, labels=feed)
        ref["runs"][name] = dict(
            out=out, class_hvs=r.class_hvs.cpu(), log=r.capture_log,
            hp=r.drain_hp(), hp_dropped=r.hp_dropped)
        if name == "mesh_float32":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.process(raw)
            torch.cuda.synchronize()
            ref["runner_fps"] = raw.shape[0] * raw.shape[1] / (
                time.perf_counter() - t0)
    ref["models"]["churn"] = calibrated(base_model, *cal, "int8", 8)
    svc = mesh_service("float32", ref["models"]["float32"])
    ref["service"] = served_arrays(serve(svc, raw.cpu().numpy()),
                                   raw.shape[0])
    ckpt = str(root / "unsharded_ckpt")
    svc = mesh_churn_service(ref["models"]["churn"], ckpt)
    ref["churn"] = mesh_churn(svc, raw, ckpt=True)
    return ref


def mesh_runner_kwargs(precision, bits, closed, scope) -> dict:
    return dict(chunk_size=CHUNK, block_d=MESH_BLOCK_D, adc_bits=bits,
                precision=precision, adc_seed=SEED, device=DEVICE,
                control=CaptureConfig(hp_bits=12) if closed else None,
                adapt=None if scope is None else AdaptConfig(
                    mode="label", lr=0.5, scope=scope))


def mesh_service(precision, model, mesh=None):
    svc = FleetService(model, service_ctrl(), n_slots=FLEET_S,
                       chunk_size=CHUNK, block_d=MESH_BLOCK_D, adc_bits=4,
                       precision=precision, adc_seed=SEED, device=DEVICE,
                       mesh=mesh)
    for s in range(FLEET_S):
        svc.attach(s)
    return svc


def mesh_churn_service(model, ckpt_dir, mesh=None):
    return FleetService(
        model, service_ctrl(), n_slots=FLEET_S, chunk_size=CHUNK,
        block_d=MESH_BLOCK_D, adc_bits=8, precision="int8", adc_seed=SEED,
        adapt=AdaptConfig(mode="pseudo", scope="per-stream", lr=0.3,
                          confidence=0.0),
        ckpt_dir=ckpt_dir, device=DEVICE, mesh=mesh)


def mesh_churn(svc, raw, *, ckpt: bool = False, start: int = 0) -> dict:
    """The service phase's churn schedule from tick ``start`` on ``svc``
    (a checkpoint at CKPT_TICK with ``ckpt``): per-sensor outputs,
    classifiers and capture logs."""
    schedule = churn_schedule(raw.shape[1] // CHUNK)

    def frames_of(sid):
        return raw[sid % FLEET_S, N_STREAM // 4 * (sid // FLEET_S):]

    fed: dict = {}
    for _, _, arrive in schedule[:start]:
        for sid in arrive:
            fed[sid] = fed.get(sid, 0) + CHUNK
    got = {}
    cut = CKPT_TICK if ckpt else start
    for lo, hi in ((start, cut), (cut, len(schedule))):
        more, fed = play_churn(svc, frames_of, schedule[lo:hi], fed)
        for sid, outs in more.items():
            got.setdefault(sid, []).extend(outs)
        if ckpt and hi == CKPT_TICK:
            svc.checkpoint()
            svc.wait_ckpt()
    return dict(outputs={sid: [np.concatenate([o[j] for o in outs])
                               for j in range(3)]
                         for sid, outs in got.items()},
                class_hvs={sid: svc.class_hvs_of(sid).cpu()
                           for sid in fed},
                logs={sid: (svc.capture_log(sid).sampled,
                            svc.capture_log(sid).gated) for sid in fed})


def same_churn(got, want, what, tail: bool = False) -> None:
    """``got`` bitwise ``want``; with ``tail``, ``got`` holds only the
    ticks from CKPT_TICK on (each sensor's outputs the end of ``want``'s);
    classifiers and capture logs cover the whole trace either way."""
    for sid, outs in got["outputs"].items():
        for a, b in zip(outs, want["outputs"][sid]):
            check(np.array_equal(a, b[len(b) - len(a):] if tail else b),
                  f"{what}: sensor {sid} outputs")
    if not tail:
        check(set(got["outputs"]) == set(want["outputs"]),
              f"{what}: sensors served")
    for sid, chvs in want["class_hvs"].items():
        check(torch.equal(got["class_hvs"][sid].cpu(), chvs.cpu()),
              f"{what}: sensor {sid} classifier")
        for a, b in zip(got["logs"][sid], want["logs"][sid]):
            check(np.array_equal(a, b), f"{what}: sensor {sid} capture log")


def mesh_shapes(world: int) -> list[tuple[int, int]]:
    """``make_host_mesh``'s (1, world), then every other (data, model)
    factorization of the world."""
    return [(1, world)] + [(d, world // d) for d in range(2, world + 1)
                           if world % d == 0]


def mesh_rank(rank: int, world: int, root: str, what: str = "all") -> None:
    """One rank of the NCCL world: its own card, the payload the parent
    wrote, every mesh shape of ``mesh_shapes``; each run checked bitwise
    against the parent's unsharded run, and the sharded cascade
    (:func:`mesh_cascade`) against the parent's unsharded one; then the
    sharded cells and LM_ARCH's decode cell (:func:`mesh_decodes`). With
    ``what`` "decode", the decode cell alone; with "moe", the sharded
    mixture of experts alone (:func:`mesh_moe`); with "hybrid", the
    sharded hybrid alone (:func:`mesh_hybrid`); with "xlstm", the sharded
    xLSTM alone (:func:`mesh_xlstm`); with "loop_mesh", the train loop
    over each mesh of :func:`loop_mesh_shapes` (:func:`loop_mesh_rank`).
    Writes its records to
    ``root/rank<r>.json``; any failed check raises (a non-zero exit); a
    preempted loop's ``SystemExit`` (143) is raised after the records are
    written."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_host_mesh
    root = pathlib.Path(root)
    try:
        # NCCL on the cards (DEVICE "cpu", for a rehearsal: gloo)
        cuda = DEVICE == "cuda"
        dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
        if cuda:
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            store=dist.FileStore(str(root / "store"), world), rank=rank,
            world_size=world, device_id=dev if cuda else None,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        meshes = [make_host_mesh(DEVICE) if shape == (1, world) else
                  init_device_mesh(DEVICE, shape,
                                   mesh_dim_names=("data", "model"))
                  for shape in mesh_shapes(world)]
        records = [dict(mesh=list(shape)) for shape in mesh_shapes(world)]
        preempted = None
        if what == "loop_mesh":
            on = loop_mesh_shapes(world)
            for shape, mesh, rec in zip(mesh_shapes(world), meshes,
                                        records):
                if shape in on:
                    rec["loop_mesh"], preempted = loop_mesh_rank(
                        mesh, on.index(shape), world, root)
        if what == "moe":
            for shape, mesh, rec in zip(mesh_shapes(world), meshes,
                                        records):
                rec["moe"] = mesh_moe(mesh, shape, world, root)
        if what == "hybrid":
            for shape, mesh, rec in zip(mesh_shapes(world), meshes,
                                        records):
                rec["hybrid"] = mesh_hybrid(mesh, shape, world, root)
        if what == "xlstm":
            for shape, mesh, rec in zip(mesh_shapes(world), meshes,
                                        records):
                rec["xlstm"] = mesh_xlstm(mesh, shape, world, root)
        archs = {"decode": [LM_ARCH], "moe": [], "hybrid": [],
                 "xlstm": [], "loop_mesh": []}.get(
            what, list(MESH_CELLS))
        if what == "all":
            ref = torch.load(root / "payload.pt", map_location=dev,
                             weights_only=False)
            raw, labels_np = ref["raw"], ref["labels"]
            plain = detector()
            for shape, mesh, rec in zip(mesh_shapes(world), meshes,
                                        records):
                rec.update(mesh_runs(mesh, shape, ref, raw, labels_np,
                                     root))
                rec["cascade"] = mesh_cascade(mesh, shape, ref["cascade"],
                                              plain)
            del plain
        for arch in archs:
            torch.cuda.empty_cache()
            st = torch.load(root / f"cells-{arch}.pt", map_location=dev,
                            weights_only=False)
            if what == "all":
                key = MESH_CELLS[arch][0]
                cells_ref = mesh_cells_reference(st, arch)
                for shape, mesh, rec in zip(mesh_shapes(world), meshes,
                                            records):
                    rec[key] = mesh_cells(mesh, shape, st, cells_ref, arch)
                del cells_ref
            if arch == LM_ARCH:
                for shape, mesh, rec in zip(mesh_shapes(world), meshes,
                                            records):
                    rec["decode_lm"] = mesh_decodes(mesh, shape, st, world)
            del st
        (root / f"rank{rank}.json").write_text(json.dumps(records))
        dist.destroy_process_group()
    except BaseException:
        import traceback
        (root / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    if preempted is not None:
        raise preempted


def mesh_runs(mesh, shape, ref, raw, labels_np, root) -> dict:
    """The runs of one mesh shape in one rank (every rank runs them all):
    the MESH_RUNS runners, the frozen float32 service with its warm
    dispatches free of host syncs, the churn service bitwise, its
    checkpoint at CKPT_TICK resumed by a fresh sharded service, and the
    parent's unsharded checkpoint resumed sharded."""
    S, n = raw.shape[:2]
    n_chunks = math.ceil(n / CHUNK)
    ctrl = service_ctrl()
    launches = {"sliding_scores_f32": 0, "sliding_scores_int": 0}
    rec = dict(mesh=list(shape), runs={})
    for name, (precision, bits, closed, scope) in MESH_RUNS.items():
        want = ref["runs"][name]
        kw = mesh_runner_kwargs(precision, bits, closed, scope)
        r = fleet.FleetRunner(ref["models"][precision], ctrl, mesh=mesh,
                              **kw)
        feed = None if scope is None else labels_np
        torch.cuda.synchronize()
        ss.LAUNCHES = ssi.LAUNCHES = 0
        t0 = time.perf_counter()
        out = r.process(raw, labels=feed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"sliding_scores_f32": ss.LAUNCHES,
                  "sliding_scores_int": ssi.LAUNCHES}
        check(sum(counts.values()) == n_chunks,
              f"{name} {shape}: {counts} scorer calls for {n_chunks} "
              f"super-chunks")
        for k, v in counts.items():
            launches[k] += v
        what = f"{name} on a {shape} mesh"
        for a, b in zip(out, want["out"]):
            check(np.array_equal(a, b), f"{what}: scores or gate differ")
        check(torch.equal(r.class_hvs.cpu(), want["class_hvs"].cpu()),
              f"{what}: classifier")
        log = r.capture_log
        check(np.array_equal(log.sampled, want["log"].sampled)
              and np.array_equal(log.gated, want["log"].gated),
              f"{what}: capture log")
        for (ia, fa), (ib, fb) in zip(r.drain_hp(), want["hp"]):
            check(np.array_equal(ia, ib) and np.array_equal(fa, fb),
                  f"{what}: HP drain")
        check(r.hp_dropped == want["hp_dropped"], f"{what}: hp_dropped")
        rec["runs"][name] = dict(bitwise=True, launches=counts,
                                 fps=S * n / wall)
        if name == "mesh_float32":
            # warm fps on this rank's card in turns: an unsharded runner,
            # the sharded one twice, the unsharded again; each profiled
            plain = fleet.FleetRunner(ref["models"][precision], ctrl, **kw)
            plain.process(raw)
            walls = {}
            for what, runner in (("unsharded", plain), ("sharded", r),
                                 ("sharded_again", r),
                                 ("unsharded_again", plain)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runner.process(raw)
                torch.cuda.synchronize()
                walls[what] = time.perf_counter() - t0
            rec["runner_fps_warm"] = {k: S * n / v for k, v in walls.items()}
            rec["profile_sharded"] = device_profile(lambda: r.process(raw))
            rec["profile_unsharded"] = device_profile(
                lambda: plain.process(raw))
    # the frozen service: bitwise the unsharded one; warm dispatches free
    # of host syncs (the scores gathered by NCCL on the card's stream)
    svc = mesh_service("float32", ref["models"]["float32"], mesh)
    ss.LAUNCHES = ssi.LAUNCHES = 0
    got = served_arrays(serve(svc, raw.cpu().numpy(), sync_free_after_first=True), S)
    check(ss.LAUNCHES == n // CHUNK and ssi.LAUNCHES == 0,
          f"service {shape}: not one scorer call a tick")
    launches["sliding_scores_f32"] += ss.LAUNCHES
    for a, b in zip(got, ref["service"]):
        check(np.array_equal(a, b), f"service on a {shape} mesh differs")
    rec["service"] = dict(bitwise=True, warm_dispatch_sync_free=True,
                          n_slots=svc.n_slots)
    # the churn service, its checkpoint resumed sharded, and the
    # unsharded checkpoint resumed sharded
    tag = "x".join(map(str, shape))
    ckpt = str(root / f"ckpt_{tag}")
    model = ref["models"]["churn"]
    churn = mesh_churn(mesh_churn_service(model, ckpt, mesh), raw, ckpt=True)
    same_churn(churn, ref["churn"], f"churn on a {shape} mesh")
    for src in (ckpt, str(root / "unsharded_ckpt")):
        svc = mesh_churn_service(model, src, mesh)
        check(svc.restore() == CKPT_TICK, f"{src}: restored tick")
        same_churn(mesh_churn(svc, raw, start=CKPT_TICK), ref["churn"],
                   f"{src} resumed on a {shape} mesh", tail=True)
    rec["churn"] = dict(bitwise=True, resumed_own_checkpoint=True,
                        resumed_unsharded_checkpoint=True, checkpoint=ckpt)
    rec["launches"] = launches
    return rec


def detector(mesh=None, n_layers: int | None = None, seed: int = SEED + 9,
             compute_dtype: str | None = None, perturb: float = 0.0):
    """A ``CascadeService`` over the full-width detector (``n_layers`` deep,
    or all 48; in ``compute_dtype``, or bf16), its parameters drawn on this
    process's card from ``seed`` (the cascade phase's; with ``perturb``,
    the MLPs' ``w_down`` times ``1 + perturb · N(0, 1)``), sharded over
    ``mesh`` if given."""
    cfg = configs.get_config(CASCADE_ARCH)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    hw = (FRAME, FRAME)
    params = steps.init_detector_params(
        torch.Generator(device=DEVICE).manual_seed(seed), cfg, frame_hw=hw,
        patch=CASCADE_PATCH)
    if perturb:
        mlp = params["backbone"]["layers"]["mlp"]
        mlp["w_down"] = mlp["w_down"] * (1.0 + perturb * torch.randn(
            mlp["w_down"].shape, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(seed + 1)))
    return CascadeService(params, cfg, batch_size=CASCADE_BATCH,
                          frame_hw=hw, patch=CASCADE_PATCH,
                          max_inflight=CASCADE_INFLIGHT, device=DEVICE,
                          mesh=mesh)


def mesh_cascade_reference(hp) -> dict:
    """The unsharded card cascade the ranks' sharded ones are held
    against: the first CASCADE_BATCH + MESH_CASCADE_TAIL HP frames of the
    closed-loop runner's drains ``hp`` (streams in order), batched; and
    at full depth in float32 on the first CASCADE_REF_FRAMES of them, the
    logits and how far a MESH_PERTURB perturbation of one weight moves
    them (how much the detector amplifies a change in the last bits)."""
    n = CASCADE_BATCH + MESH_CASCADE_TAIL
    frames = np.concatenate([f for _, f in hp])[:n]
    check(len(frames) == n, f"mesh cascade: {len(frames)} HP frames")
    casc = detector()
    casc.submit("ref", np.arange(n), frames)
    logits = np.concatenate([b.logits for b in casc.flush()])
    del casc
    f32, moved = (detector(compute_dtype="float32", perturb=p).eager(
        frames[:CASCADE_REF_FRAMES]) for p in (0.0, MESH_PERTURB))
    return dict(frames=frames, logits=logits, f32_logits=f32,
                sensitivity=dict(perturb=MESH_PERTURB,
                                 max_abs_diff=float(np.abs(moved - f32).max()),
                                 max_abs_logit=float(np.abs(f32).max())))


def mesh_cascade(mesh, shape, want, plain) -> dict:
    """The full-width sharded cascade on one mesh, in every rank: the
    parent's HP frames fed as 5 + 0 + the rest (a full batch, a padded
    tail), finite; batched bitwise ``eager`` at every position and in the
    tail; a second pass bitwise the first; one graph build; within
    CASCADE_BF16_RTOL of the parent's unsharded logits relative to their
    largest |logit| (where bf16 drift over all the layers exceeds it, the
    bound is held at CASCADE_REF_LAYERS, sharded against unsharded on
    this card, and the full-depth difference recorded, in bf16 and in
    float32 against the parent's float32 logits, beside the parent's
    measure of the detector's sensitivity);
    ``backbone_cost`` every rank's products; the collectives of one
    batch, counted under ``roofline()``. Then full batches timed warm in
    turns against ``plain``, an unsharded cascade on this rank's card.
    Returns the record, with the logits for the parent to hold every
    rank's against each other."""
    frames, B = want["frames"], CASCADE_BATCH
    casc = detector(mesh)
    what = f"sharded cascade on a {shape} mesh"

    def serve_frames():
        n = len(frames)
        for lo, hi in ((0, 5), (5, 5), (5, n)):
            casc.submit("mesh", np.arange(lo, hi), frames[lo:hi])
        return casc.flush()

    batches = serve_frames()
    check([b.n_padded for b in batches] == [0, B - MESH_CASCADE_TAIL],
          f"{what}: batches padded {[b.n_padded for b in batches]}")
    logits = np.concatenate([b.logits for b in batches])
    check(logits.shape == (len(frames), casc.n_out)
          and np.isfinite(logits).all(), f"{what}: logits")
    check(np.array_equal(casc.eager(frames), logits),
          f"{what}: batched logits differ from eager")
    check(np.array_equal(np.concatenate([b.logits for b in serve_frames()]),
                         logits), f"{what}: two runs differ")
    check(casc.rebuild_count() == 1, f"{what}: rebuilt")
    cfg = casc.cfg
    scale = float(np.abs(want["logits"]).max())
    diff = float(np.abs(logits - want["logits"]).max())
    rec = dict(mesh=list(shape), layers=cfg.n_layers, d_model=cfg.d_model,
               compute_dtype=cfg.compute_dtype, frames=len(frames),
               logits=logits.tolist(), bitwise_vs_eager=True,
               runs_bitwise=True, rebuild_count=casc.rebuild_count(),
               max_abs_diff_vs_unsharded=diff, max_abs_logit=scale,
               rtol=CASCADE_BF16_RTOL, held_at_layers=cfg.n_layers)
    if diff > CASCADE_BF16_RTOL * scale:
        cut = [detector(m, CASCADE_REF_LAYERS, SEED + 10).eager(
            frames[:CASCADE_REF_FRAMES]) for m in (mesh, None)]
        cut_diff = float(np.abs(cut[0] - cut[1]).max())
        cut_scale = float(np.abs(cut[1]).max())
        check(cut_diff <= CASCADE_BF16_RTOL * cut_scale,
              f"{what}: {CASCADE_REF_LAYERS} layers differ by {cut_diff} "
              f"(largest |logit| {cut_scale}; {cfg.n_layers} layers: "
              f"{diff} of {scale})")
        f32 = detector(mesh, compute_dtype="float32").eager(
            frames[:CASCADE_REF_FRAMES])
        rec.update(held_at_layers=CASCADE_REF_LAYERS,
                   cut_max_abs_diff=cut_diff, cut_max_abs_logit=cut_scale,
                   f32_max_abs_diff=float(np.abs(
                       f32 - want["f32_logits"]).max()),
                   f32_max_abs_logit=float(np.abs(want["f32_logits"]).max()))
        print(f"{what}: {cfg.n_layers} layers differ by {diff} in bf16 and "
              f"{rec['f32_max_abs_diff']} in float32 (largest |logit| "
              f"{scale}, {rec['f32_max_abs_logit']}); the detector's own "
              f"sensitivity {want['sensitivity']}; held at "
              f"{CASCADE_REF_LAYERS} layers: {cut_diff} of {cut_scale}",
              flush=True)
    # every rank's products: the unsharded hand count split over "model",
    # the embedder on every rank, the whole program on every data rank
    D, M = shape
    seq = steps.detector_seq_len((FRAME, FRAME), CASCADE_PATCH)
    hand = detector_matmul_flops(cfg, seq, CASCADE_PATCH)
    emb = 2 * seq * CASCADE_PATCH * CASCADE_PATCH * cfg.d_model
    cost = casc.backbone_cost()
    check(cost.flops == D * (hand - emb) + D * M * emb,
          f"{what}: backbone_cost {cost.flops} FLOPs/frame, hand count "
          f"{D * (hand - emb) + D * M * emb}")
    with sharding.count_collectives() as coll:
        rl = casc.roofline()
    # a frame: 6 FSDP gathers and 2 folds a layer, the unembedding's
    # gather and the head's row of logits
    calls = B * (cfg.n_layers * 8 + 2)
    check(coll.calls == {"all-gather": calls}
          and rl.hlo_gflops == cost.flops * B / 1e9,
          f"{what}: {coll.calls} collectives a batch, want {calls}")
    timed = np.concatenate([frames[:B]] * MESH_CASCADE_TIMED)

    def backbone(c):
        c.submit("timed", np.arange(len(timed)), timed)
        return c.flush()

    backbone(plain)
    walls = {}
    for turn, c in (("unsharded", plain), ("sharded", casc),
                    ("sharded_again", casc), ("unsharded_again", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backbone(c)
        torch.cuda.synchronize()
        walls[turn] = time.perf_counter() - t0
    rec.update(
        backbone_cost=dataclasses.asdict(cost), flops_hand_count=hand,
        collectives_per_batch=dict(calls=coll.calls, bytes=coll.bytes),
        roofline=rl.to_dict(),
        ms_per_batch={k: v / MESH_CASCADE_TIMED * 1e3
                      for k, v in walls.items()})
    return rec


# the sharded cells: full-width hubert-xlarge and LM_ARCH at train_4k's
# 4096 tokens x CELLS_TRAIN_BATCH and prefill_32k's 32,768 x
# CELLS_PREFILL_BATCH (the cells phase's cuts), from one whole state this
# process makes; held against the unsharded step at CELLS_CHECK_LAYERS,
# weights at CELLS_WEIGHT_STD, on the same batches; the moments within the
# gradients' bound (mu) and twice it (nu = 0.05 g^2), the parameters
# after AdamW within MESH_CELLS_PARAM_RTOL of each leaf's largest |entry|
MESH_CELLS_PARAM_RTOL = 1e-5


def mesh_cells_payload(root, arch: str) -> None:
    """The whole states every rank's sharded cells of ``arch`` start from,
    written to ``root/cells-<arch>.pt``: the full-width parameters at
    MESH_CELLS_LAYERS (``Model.init`` on this card from the cells or LM
    phase's seed), the
    2-layer parameters at CELLS_WEIGHT_STD (one float32 tree for both
    compute dtypes), and the train and prefill batches (the cells phase's
    seeds)."""
    cfg = mesh_cells_cfg(arch)
    params = lm.Model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(MESH_CELLS[arch][1]))
    check_cfg = cfg.replace(n_layers=CELLS_CHECK_LAYERS)
    train, prefill = cut_shape("train_4k"), cut_shape("prefill_32k")
    torch.save(dict(
        params=cpu_tree(params),
        check_params=scaled_params(check_cfg, SEED + 24, "cpu"),
        train=cell_batch(cfg, train.global_batch, train.seq_len, SEED + 22,
                         "cpu"),
        prefill=cell_batch(cfg, prefill.global_batch, prefill.seq_len,
                           SEED + 23, "cpu")),
        root / f"cells-{arch}.pt")
    del params
    torch.cuda.empty_cache()


def cut_shape(name: str):
    """``name``'s cell with its batch cut as the cells phase cuts it."""
    batch = CELLS_TRAIN_BATCH if name == "train_4k" else CELLS_PREFILL_BATCH
    return dataclasses.replace(configs.SHAPES[name], global_batch=batch)


# words a digest takes at a time (its int64 temporaries 1 GiB each)
DIGEST_CHUNK = 1 << 27


def digest(t: torch.Tensor) -> int:
    """An exact fingerprint of ``t``'s bits: its words as integers, each
    times a weight of its position, summed in int64 (wrapping, so the
    order of the sum does not matter: DIGEST_CHUNK words at a time)."""
    words = t.contiguous().view(
        {4: torch.int32, 2: torch.int16}[t.element_size()]).flatten()
    acc = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, words.numel(), DIGEST_CHUNK):
        part = words[lo:lo + DIGEST_CHUNK]
        w = torch.arange(lo, lo + part.numel(), device=t.device) % 65521 + 1
        acc += (part.to(torch.int64) * w).sum()
    return int(acc)


def whole_digests(blocks, specs, mesh) -> list[int]:
    """:func:`digest` of every leaf of ``blocks`` gathered whole, one leaf
    at a time."""
    out = []
    for t, spec in zip(model_common.leaves(blocks), spec_leaves(specs)):
        whole = sharding.whole_block(t, spec, mesh)
        out.append(digest(whole))
        del whole
    return out


def spec_leaves(specs) -> list:
    out = []
    model_common.tree_map(out.append, specs, lambda x: isinstance(x, tuple))
    return out


def mesh_cells_reference(st, arch: str) -> dict:
    """In each rank, before its meshes: the whole optimizer state, and the
    unsharded full-width prefill's logits (their shape and
    :func:`digest`) and ms."""
    cfg = mesh_cells_cfg(arch)
    ref = dict(state=steps.make_optimizer(cfg).init(st["params"]))
    cell = steps.build_cell(cfg, cut_shape("prefill_32k"))
    with torch.no_grad():
        logits, ref["prefill_ms"] = wall_ms(cell.step_fn, st["params"],
                                            st["prefill"])
    ref["logits_shape"] = tuple(logits.shape)
    ref["logits_digest"] = digest(logits)
    return ref


def wall_ms(fn, *args):
    """``fn(*args)`` on the host clock between synchronisations (its
    collectives run on NCCL's streams): (its output, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_cells(mesh, shape, st, ref, arch: str) -> dict:
    """``arch``'s sharded train and prefill cells on one mesh, in every
    rank, fed this rank's blocks of the whole state ``st`` (on a (1, 1)
    mesh the blocks are the whole tensors, passed as they are, not
    copied): at full width a warm step (its collectives counted, the
    allocator's peak beside ``analyze()`` on the mesh), then the
    unsharded and sharded steps in turns (unsharded, sharded, sharded,
    unsharded: ms), each sharded step bitwise the warm one (their
    :func:`fingerprint`s, so no two steps' outputs live at once); the
    loss, the digests of the gathered parameters and moments, and of the
    gathered prefill logits, for the parent to hold across ranks (on a
    (1, 1) mesh the step and the prefill are held bitwise the unsharded
    ones here); at CELLS_CHECK_LAYERS in each compute dtype, the step,
    its gradients and the prefill against the unsharded ones
    (:func:`mesh_cells_check`)."""
    cfg = mesh_cells_cfg(arch)
    what = f"sharded {arch} cells on a {shape} mesh"
    one = tuple(shape) == (1, 1)
    torch.cuda.empty_cache()
    train = cut_shape("train_4k")
    cell = steps.build_cell(cfg, train, mesh)
    plain = steps.build_cell(cfg, train)
    whole = (st["params"], ref["state"], st["train"])
    args = whole if one else steps.local_args(whole, cell.in_shardings, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    with sharding.count_collectives() as coll:
        warm, first_ms = wall_ms(cell.step_fn, *args)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(warm[2])
    check(math.isfinite(loss), f"{what}: loss {loss}")
    p_sh, opt_sh, _ = cell.out_shardings
    want = fingerprint(list(warm))
    digests = dict(params=whole_digests(warm[0], p_sh, mesh),
                   mu=whole_digests(warm[1].mu, opt_sh.mu, mesh),
                   nu=whole_digests(warm[1].nu, opt_sh.nu, mesh))
    del warm
    torch.cuda.empty_cache()
    turns = {}
    for turn in ("unsharded", "sharded", "sharded_again", "unsharded_again"):
        if turn.startswith("unsharded"):
            out, turns[turn] = wall_ms(plain.step_fn, *whole)
            if one and turn == "unsharded":
                check(fingerprint(list(out)) == want,
                      f"{what}: the (1, 1) step differs from the unsharded "
                      f"step")
        else:
            out, turns[turn] = wall_ms(cell.step_fn, *args)
            check(fingerprint(list(out)) == want,
                  f"{what}: two steps from one state differ")
        del out
        torch.cuda.empty_cache()
    del args
    pcell = steps.build_cell(cfg, cut_shape("prefill_32k"), mesh)
    pargs = steps.local_args((st["params"], st["prefill"]),
                             pcell.in_shardings, mesh)
    with torch.no_grad():
        logits, prefill_ms = wall_ms(pcell.step_fn, *pargs)
    logits = sharding.whole_block(logits, pcell.out_shardings, mesh)
    check(tuple(logits.shape) == ref["logits_shape"]
          and bool(torch.isfinite(logits).all()), f"{what}: prefill logits")
    digests["logits"] = digest(logits)
    if one:
        check(digests["logits"] == ref["logits_digest"],
              f"{what}: the (1, 1) prefill differs from the unsharded one")
    del logits, pargs
    rec = dict(
        arch=arch, mesh=list(shape), layers=cfg.n_layers, train_tokens=[
            train.global_batch, train.seq_len],
        prefill_tokens=list(ref["logits_shape"][:2]),
        loss=loss, digests=digests, run_to_run_bitwise=True,
        bitwise_vs_unsharded=one or "not held (a mesh of several ranks)",
        first_step_ms=first_ms, ms_per_step=turns, prefill_ms=prefill_ms,
        unsharded_prefill_ms=ref["prefill_ms"],
        collectives_per_step=dict(calls=coll.calls, bytes=coll.bytes),
        allocated_before_gb=before_gb, peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, train, mesh),
        check=mesh_cells_check(mesh, shape, st, arch))
    torch.cuda.empty_cache()
    return rec


def mesh_cells_check(mesh, shape, st, arch: str) -> dict:
    """The sharded step, its gradients and its prefill at
    CELLS_CHECK_LAYERS against the unsharded ones on this rank's card, in
    each compute dtype (each reference made and dropped in turn): loss,
    gradients and moments within CELLS_TOL (nu twice the gradients'
    bound), the parameters after AdamW within MESH_CELLS_PARAM_RTOL, the
    prefill logits within CASCADE_BF16_RTOL of the largest |logit| (the
    detector's bound)."""
    out = {}
    for dt, (loss_tol, grad_tol) in CELLS_TOL.items():
        c = configs.get_config(arch).replace(n_layers=CELLS_CHECK_LAYERS,
                                             compute_dtype=dt)
        state = steps.make_optimizer(c).init(st["check_params"])
        w_p, w_s, w_loss = steps.build_cell(c, cut_shape("train_4k")).step_fn(
            st["check_params"], state, st["train"])
        _, w_grads = steps.loss_and_grads(lm.Model(c), st["check_params"],
                                          st["train"])
        cell = steps.build_cell(c, cut_shape("train_4k"), mesh)
        whole = (st["check_params"], state, st["train"])
        args = steps.local_args(whole, cell.in_shardings, mesh)
        new_p, new_s, loss = cell.step_fn(*args)
        p_sh, opt_sh, _ = cell.out_shardings
        _, grads = steps.loss_and_grads(
            lm.Model(c), args[0], args[2], model_common.Parallel(
                mesh, None, cut_shape("train_4k").global_batch))
        r = dict(
            loss_rel_diff=abs(float(loss) - float(w_loss))
            / abs(float(w_loss)),
            grad_rel_diff=leaf_errs(steps.whole_args(grads, p_sh, mesh),
                                    cpu_tree(w_grads)),
            params_rel_diff=leaf_errs(steps.whole_args(new_p, p_sh, mesh),
                                      cpu_tree(w_p)),
            mu_rel_diff=leaf_errs(steps.whole_args(new_s.mu, opt_sh.mu, mesh),
                                  cpu_tree(w_s.mu)),
            nu_rel_diff=leaf_errs(steps.whole_args(new_s.nu, opt_sh.nu, mesh),
                                  cpu_tree(w_s.nu)))
        del w_p, w_s, w_grads, new_p, new_s, grads, args, state
        torch.cuda.empty_cache()
        pcell = steps.build_cell(c, cut_shape("prefill_32k"), mesh)
        with torch.no_grad():
            logits = pcell.step_fn(*steps.local_args(
                (st["check_params"], st["prefill"]), pcell.in_shardings,
                mesh))
            logits = sharding.whole_block(logits, pcell.out_shardings, mesh)
            want = steps.build_cell(c, cut_shape("prefill_32k")).step_fn(
                st["check_params"], st["prefill"])
            r.update(logits_max_abs_diff=max_abs_diff(logits, want),
                     max_abs_logit=max_abs(want))
        del logits, want
        torch.cuda.empty_cache()
        r.update(loss_rtol=loss_tol, grad_rtol=grad_tol,
                 param_rtol=MESH_CELLS_PARAM_RTOL,
                 logits_rtol=CASCADE_BF16_RTOL)
        check(r["loss_rel_diff"] <= loss_tol
              and r["grad_rel_diff"] <= grad_tol
              and r["mu_rel_diff"] <= grad_tol
              and r["nu_rel_diff"] <= 2 * grad_tol
              and r["params_rel_diff"] <= MESH_CELLS_PARAM_RTOL
              and r["logits_max_abs_diff"]
              <= CASCADE_BF16_RTOL * r["max_abs_logit"],
              f"sharded {arch} cells on a {shape} mesh against the "
              f"unsharded step at {CELLS_CHECK_LAYERS} layers, {dt}: {r}")
        out[dt] = r
    return out


# the mesh phase's decode cell (LM_ARCH at full width, decode_32k's cache
# cut to DECODE_BATCH, filled from a generator on each rank's card): the
# default rules on every mesh and, on the (1, world) mesh, the cache along
# the sequence (MESH_DECODE_RULES, the split of the production meshes);
# at CELLS_CHECK_LAYERS in float32 against the unsharded step on a cache
# of MESH_DECODE_CHECK[0] positions, index MESH_DECODE_CHECK[1] (every
# rank past it holds a masked block), within MESH_DECODE_RTOL of the
# largest |logit|
MESH_DECODE_RULES = {"act_kv_heads": None}
MESH_DECODE_CHECK, MESH_DECODE_RTOL = (1024, 700), 1e-5


def mesh_decodes(mesh, shape, st, world: int) -> list[dict]:
    """:func:`mesh_decode` on ``mesh`` under the default rules, and on the
    (1, world) mesh under MESH_DECODE_RULES too."""
    out = [mesh_decode(mesh, shape, st, "default", None)]
    if tuple(shape) == (1, world):
        out.append(mesh_decode(mesh, shape, st, "cache_seq",
                               MESH_DECODE_RULES))
    return out


def decode_logits(model, params, state, db, cell, mesh, rules):
    """``Model.decode_step``'s logits, whole: with ``mesh``, this rank's
    blocks in (``cell``'s specs) and the vocab and batch blocks gathered."""
    if mesh is None:
        return model.decode_step(params, state, db)[0]
    par = model_common.Parallel(mesh, rules, DECODE_BATCH)
    cfg = model.cfg
    logits, _ = model.decode_step(params, state, db, par,
                                  cell.in_shardings[1])
    vocab = par.group(model_common.unembed_spec(cfg.vocab, cfg.d_model)[
        "kernel"], "vocab")
    if vocab is not None:
        logits = sharding.all_gather_cat(logits, vocab, dim=-1)
    return sharding.whole_block(
        logits, (cell.in_shardings[2].tokens[0], None, None), mesh)


def mesh_decode(mesh, shape, st, rules_name: str, rules) -> dict:
    """LM_ARCH's sharded decode cell on one mesh under ``rules`` (over the
    default rules), in every rank: the unsharded step on the rank's card
    from the whole state, then the sharded one from this rank's blocks of
    it (on a (1, 1) mesh the whole tensors, passed as they are): the
    digests of the next tokens and of the whole logits for the parent to
    hold across ranks (on (1, 1) held bitwise the unsharded step's, the
    written cache rows too); the collectives of a step; ms a step,
    unsharded and sharded in turns (each step writes the same row again);
    the allocator's peak beside ``analyze()`` on the mesh; at
    CELLS_CHECK_LAYERS in float32 the logits against the unsharded
    step's."""
    cfg = mesh_cells_cfg(LM_ARCH)
    what = (f"sharded {LM_ARCH} decode on a {shape} mesh ({rules_name} "
            f"rules)")
    one = tuple(shape) == (1, 1)
    rules = dict(sharding.DEFAULT_RULES, **(rules or {}))
    dshape = decode_shape()
    idx = dshape.seq_len - 1
    model = lm.Model(cfg)
    cell = steps.build_cell(cfg, dshape, mesh, rules)
    plain = steps.build_cell(cfg, dshape)
    torch.cuda.empty_cache()
    state = filled_state(model, DECODE_BATCH, dshape.seq_len, SEED + 34,
                         DEVICE)
    db = lm.DecodeBatch(
        decode_tokens(cfg, (DECODE_BATCH, 1), SEED + 35, DEVICE),
        torch.tensor(idx, dtype=torch.int32, device=DEVICE))
    tokens, _ = plain.step_fn(st["params"], state, db)
    want = dict(tokens=digest(tokens), logits=digest(decode_logits(
        model, st["params"], state, db, None, None, None)))
    rows = [digest(t[:, :, idx]) for t in state]
    whole = (st["params"], state, db)
    args = whole if one else steps.local_args(whole, cell.in_shardings, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with sharding.count_collectives() as coll:
        (tokens, local), first_ms = wall_ms(cell.step_fn, *args)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = sharding.whole_block(tokens, cell.out_shardings[0], mesh)
    digests = dict(tokens=digest(tokens), logits=digest(decode_logits(
        model, *args, cell, mesh, rules)))
    if one:
        check(digests == want and [digest(t[:, :, idx]) for t in local]
              == rows, f"{what}: the (1, 1) step differs from the "
              f"unsharded step")
    turns = {}
    for turn in ("unsharded", "sharded", "sharded_again", "unsharded_again"):
        step, a = (plain.step_fn, whole) if turn.startswith("unsharded") \
            else (cell.step_fn, args)
        (tokens, _), turns[turn] = wall_ms(step, *a)
    del args, whole, state, local, tokens
    torch.cuda.empty_cache()
    return dict(
        arch=LM_ARCH, mesh=list(shape), rules=rules_name,
        cache_spec=list(cell.in_shardings[1].k), batch=DECODE_BATCH,
        cache=dshape.seq_len, index=idx, digests=digests,
        bitwise_vs_unsharded=one or "not held (a mesh of several ranks)",
        first_step_ms=first_ms, ms_per_step=turns,
        collectives_per_step=dict(calls=coll.calls, bytes=coll.bytes),
        peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, dshape, sharding.mesh_shape(mesh),
                                   rules),
        check=mesh_decode_check(mesh, shape, st, rules))


def mesh_decode_check(mesh, shape, st, rules) -> dict:
    """The sharded decode step at CELLS_CHECK_LAYERS in float32 (weights
    at CELLS_WEIGHT_STD) against the unsharded one on this rank's card,
    on a cache of MESH_DECODE_CHECK[0] positions at index
    MESH_DECODE_CHECK[1]: the logits within MESH_DECODE_RTOL of the
    largest |logit|."""
    cfg = configs.get_config(LM_ARCH).replace(
        n_layers=CELLS_CHECK_LAYERS, compute_dtype="float32")
    model = lm.Model(cfg)
    n, idx = MESH_DECODE_CHECK
    dshape = decode_shape(seq=n)
    cell = steps.build_cell(cfg, dshape, mesh, rules)
    db = lm.DecodeBatch(
        decode_tokens(cfg, (DECODE_BATCH, 1), SEED + 37, DEVICE),
        torch.tensor(idx, dtype=torch.int32, device=DEVICE))
    state = filled_state(model, DECODE_BATCH, n, SEED + 38, DEVICE)
    want = decode_logits(model, st["check_params"], state, db, None, None,
                         None)
    got = decode_logits(model, *steps.local_args(
        (st["check_params"], state, db), cell.in_shardings, mesh), cell,
        mesh, rules)
    r = dict(layers=cfg.n_layers, cache=n, index=idx,
             logits_max_abs_diff=max_abs_diff(got, want),
             max_abs_logit=max_abs(want), rtol=MESH_DECODE_RTOL)
    check(r["logits_max_abs_diff"] <= MESH_DECODE_RTOL * r["max_abs_logit"],
          f"sharded {LM_ARCH} decode on a {shape} mesh against the "
          f"unsharded step at {CELLS_CHECK_LAYERS} layers, float32: {r}")
    del state, want, got
    torch.cuda.empty_cache()
    return r


def cpu_tree(tree):
    return model_common.tree_map(lambda a: a.cpu(), tree)


def run_world(root, world: int, what: str, exit_code: int = 0):
    """An NCCL world of ``world`` ranks (one a card, ``torch.
    multiprocessing`` with ``spawn``) running :func:`mesh_rank` on
    ``what``: every rank's records and the world's seconds. A rank that
    exits with another code than ``exit_code`` (a preempted world's is
    143), or outlives MESH_TIMEOUT_S, fails the phase."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, world, str(root), what))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(MESH_TIMEOUT_S - (time.perf_counter() - t0), 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
    world_s = time.perf_counter() - t0
    for r, p in enumerate(procs):
        err = root / f"rank{r}.err"
        check(not alive and p.exitcode == exit_code and not err.exists(),
              f"mesh rank {r}: exit {p.exitcode}"
              f"{' (timed out)' if alive else ''}\n"
              f"{err.read_text() if err.exists() else ''}")
    return [json.loads((root / f"rank{r}.json").read_text())
            for r in range(world)], world_s


def same_decodes(ranks, i: int) -> None:
    """Every rank's decode records of mesh ``i``: the same token and
    logit digests."""
    for j, rec in enumerate(ranks[0][i]["decode_lm"]):
        check(all(r[i]["decode_lm"][j]["digests"] == rec["digests"]
                  for r in ranks[1:]),
              f"sharded {LM_ARCH} decode on a {rec['mesh']} mesh "
              f"({rec['rules']} rules): the tokens or logits differ "
              f"between ranks")


def mesh_decode_phase() -> dict:
    """``--only mesh_decode``: the mesh phase's NCCL world over every card
    of the host running LM_ARCH's sharded decode cell alone
    (:func:`mesh_decodes`), from the payload of its full-width
    parameters."""
    t0 = time.perf_counter()
    root = ROOT / "build" / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    mesh_cells_payload(root, LM_ARCH)
    world = torch.cuda.device_count()
    ranks, world_s = run_world(root, world, "decode")
    for i in range(len(ranks[0])):
        same_decodes(ranks, i)
    shutil.rmtree(root, ignore_errors=True)
    out = dict(world=world, ranks=ranks, world_s=world_s,
               phase_s=time.perf_counter() - t0)
    emit({"mesh_decode": out})
    return out


def mesh_phase(base_model, cal, raw, labels):
    """(a) :func:`split_checks`; (b) an NCCL world of every card of the
    host (one rank a card, ``torch.multiprocessing`` with ``spawn``, after
    this process built the kernels), each rank on every mesh shape of
    :func:`mesh_shapes` (on one card: a (1, 1) mesh, the sharded code path
    with its collectives on one-rank groups), held bitwise against this
    process's unsharded runs (:func:`mesh_reference`), handed over through
    a file; then an unsharded service resumes the first mesh's checkpoint
    bitwise. A rank that fails or outlives MESH_TIMEOUT_S fails the phase.
    Returns the phase's record and the launches of the first rank's
    runs."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 17)
    splits = split_checks(calibrated(base_model, *cal, "float32", 4), raw, g)
    root = ROOT / "build" / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ref = mesh_reference(base_model, cal, raw, labels, root)
    ref["cascade"] = mesh_cascade_reference(
        ref["runs"]["mesh_closed_loop_float32"]["hp"])
    torch.save(dict(ref, raw=raw.cpu(), labels=labels.cpu().numpy()),
               root / "payload.pt")
    for arch in MESH_CELLS:
        mesh_cells_payload(root, arch)
    topo = "not measured"
    if DEVICE == "cuda":
        # the link matrix (NVLink or PCIe) where the host's driver reports
        # it; what it says otherwise, with its exit code
        smi = subprocess.run(["nvidia-smi", "topo", "-m"],
                             capture_output=True, text=True)
        topo = (smi.stdout if smi.returncode == 0 else
                f"nvidia-smi topo -m: exit {smi.returncode}: "
                f"{(smi.stdout + smi.stderr).strip()}")
    print(topo, flush=True)
    world = torch.cuda.device_count()
    ranks, world_s = run_world(root, world, "all")
    for i, rec in enumerate(ranks[0]):
        check(all(r[i]["cascade"]["logits"] == rec["cascade"]["logits"]
                  for r in ranks[1:]),
              f"sharded cascade on a {rec['mesh']} mesh: ranks differ")
        same_decodes(ranks, i)
        for arch, (key, _) in MESH_CELLS.items():
            check(all(r[i][key]["loss"] == rec[key]["loss"]
                      and r[i][key]["digests"] == rec[key]["digests"]
                      for r in ranks[1:]),
                  f"sharded {arch} cells on a {rec['mesh']} mesh: the loss, "
                  f"the gathered parameters, moments or prefill logits "
                  f"differ between ranks")
    first = ranks[0][0]
    # the first mesh's checkpoint (written by its rank 0), resumed unsharded
    svc = mesh_churn_service(ref["models"]["churn"], first["churn"][
        "checkpoint"])
    check(svc.restore() == CKPT_TICK, "sharded checkpoint: restored tick")
    same_churn(mesh_churn(svc, raw, start=CKPT_TICK), ref["churn"],
               "the sharded checkpoint resumed unsharded", tail=True)
    shutil.rmtree(root, ignore_errors=True)
    launches = {k: sum(rec["launches"][k] for rec in ranks[0])
                for k in ("sliding_scores_f32", "sliding_scores_int")}
    out = dict(world=world, meshes=[rec["mesh"] for rec in ranks[0]],
               topology=topo, block_d=MESH_BLOCK_D, n_dt=DIM // MESH_BLOCK_D,
               cascade_sensitivity=ref["cascade"]["sensitivity"],
               split=splits, unsharded_runner_fps=ref["runner_fps"],
               ranks=ranks, world_s=world_s,
               sharded_checkpoint_resumed_unsharded=True)
    return out, launches


# the gated cascade: the closed-loop service's HP frames through the
# full-width detector, `batch` frames a step, `inflight` steps in flight;
# the CPU references at full width but CASCADE_REF_LAYERS layers (bf16)
# and at the smoke config (float32), on CASCADE_REF_FRAMES frames, each
# within its tolerance of the largest |logit| of the CPU run
CASCADE_ARCH, CASCADE_PATCH = "hubert-xlarge", 8
CASCADE_BATCH, CASCADE_INFLIGHT = 8, 2
CASCADE_REF_LAYERS, CASCADE_REF_FRAMES = 2, 4
CASCADE_BF16_RTOL, CASCADE_F32_RTOL = 5e-2, 1e-4
# batches timed warm, and batches under the profiler
CASCADE_TIMED, CASCADE_PROFILED = 16, 2


def detector_matmul_flops(cfg, seq: int, patch: int) -> int:
    """Hand count of one frame's products: per layer q, k, v, o, the
    scores and ``P·V``, and the MLP; the patch embedder and the unembedding
    of every position."""
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff
    kv = cfg.kv_heads
    layer = (2 * seq * d * (h + 2 * kv) * hd + 2 * seq * h * hd * d
             + 2 * 2 * seq * seq * h * hd + 2 * 2 * seq * d * f)
    return (cfg.n_layers * layer + 2 * seq * patch * patch * d
            + 2 * seq * d * cfg.vocab)


def cascade_reference(cfg, frames) -> dict:
    """``frames`` through a card cascade and through the same step on the
    CPU (weights copied from the card); returns the largest difference
    and the largest |logit| of the CPU run."""
    hw = frames.shape[1:]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    params = steps.init_detector_params(g, cfg, frame_hw=hw,
                                        patch=CASCADE_PATCH)
    card = CascadeService(params, cfg, batch_size=CASCADE_BATCH,
                          frame_hw=hw, patch=CASCADE_PATCH, device=DEVICE)
    got = card.eager(frames)
    cell = steps.build_detector_cell(cfg, batch=CASCADE_BATCH, frame_hw=hw,
                                     patch=CASCADE_PATCH)
    cpu = cell.prepare(model_common.tree_map(lambda a: a.cpu(), params))
    want = cell.step_fn(cpu, torch.from_numpy(frames)).numpy()
    return dict(layers=cfg.n_layers, d_model=cfg.d_model,
                compute_dtype=cfg.compute_dtype, frames=len(frames),
                max_abs_diff=float(np.abs(got - want).max()),
                max_abs_logit=float(np.abs(want).max()))


def cascade_phase(base_model, cal, raw):
    """The closed-loop float32 ``FleetService`` (FLEET_S slots, N_STREAM //
    CHUNK ticks, HP at 12 bits) feeding a ``CascadeService`` over the
    full-width detector, pumped after every collect, then flushed: every
    drained HP frame (the same trace's ``FleetRunner`` drains are the
    truth) returns once with its (sid, index), the logits are finite, one
    scorer call a tick. Then 2 ragged drains of ``inflight × batch`` frames
    and a 3-frame one, each submit free of host syncs, flushed; batched
    logits equal ``eager`` bitwise at every batch position and in the
    padded tail; ``rebuild_count()`` stays 1; the CPU references agree.
    It times the backbone warm, the site (gate plus cascade) against the
    gate alone, profiles two batches, and bills the energy. Returns the
    record and the scorers' launches of the main run."""
    S, n = raw.shape[:2]
    n_ticks = n // CHUNK
    B, hw = CASCADE_BATCH, (FRAME, FRAME)
    cfg = configs.get_config(CASCADE_ARCH)
    seq = steps.detector_seq_len(hw, CASCADE_PATCH)
    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    params = steps.init_detector_params(g, cfg, frame_hw=hw,
                                        patch=CASCADE_PATCH)
    n_params = model_common.count_params(params["backbone"])
    casc = CascadeService(params, cfg, batch_size=B, frame_hw=hw,
                          patch=CASCADE_PATCH, max_inflight=CASCADE_INFLIGHT,
                          device=DEVICE)
    del params
    setup_s = time.perf_counter() - t0

    model = calibrated(base_model, *cal, "float32", 4)
    common = dict(chunk_size=CHUNK, block_d=BLOCK_D, adc_bits=4,
                  precision="float32", adc_seed=SEED,
                  control=CaptureConfig(hp_bits=12), device=DEVICE)
    raw_np = raw.cpu().numpy()
    rf = fleet.FleetRunner(model, service_ctrl(), **common)
    rf.process(raw)
    want = {(s, int(i)): f for s, (idx, frs) in enumerate(rf.drain_hp())
            for i, f in zip(idx, frs)}
    check(len(want) > 2 * B, f"cascade: {len(want)} HP frames")

    def service():
        svc = FleetService(model, service_ctrl(), n_slots=S,
                           max_inflight=SERVICE_INFLIGHT, **common)
        for s in range(S):
            svc.attach(s)
        return svc

    def site(svc, with_cascade: bool = True):
        """One pass of the trace through ``svc``, the cascade pumped after
        every collect; the cascade's batches."""
        for k, lo in enumerate(range(0, n, CHUNK)):
            svc.dispatch({s: raw_np[s, lo:lo + CHUNK] for s in range(S)})
            if k and svc.collect() is not None and with_cascade:
                casc.pump(svc)
        svc.flush()
        if not with_cascade:
            return []
        casc.pump(svc)
        return casc.flush()

    # the main path, counts zeroed right before
    svc = service()
    torch.cuda.synchronize()
    ss.LAUNCHES = ssi.LAUNCHES = 0
    t0 = time.perf_counter()
    batches = site(svc)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"sliding_scores_f32": ss.LAUNCHES,
                "sliding_scores_int": ssi.LAUNCHES}
    check(launches["sliding_scores_f32"] == n_ticks
          and launches["sliding_scores_int"] == 0,
          f"cascade: {launches} scorer calls for {n_ticks} ticks")
    rows = [(sid, int(i)) for b in batches
            for sid, i in zip(b.sids, b.frame_idx)]
    check(len(rows) == len(set(rows)) and set(rows) == set(want),
          f"cascade: {len(rows)} rows back ({len(set(rows))} distinct) "
          f"for {len(want)} HP frames")
    logits = np.concatenate([b.logits for b in batches])
    check(logits.shape == (len(want), casc.n_out)
          and np.isfinite(logits).all(),
          "cascade: logits not finite or of the wrong shape")
    check(casc.rebuild_count() == 1, "cascade: rebuilt during the run")
    duty = float(np.mean([svc.capture_log(s).gated.mean()
                          for s in range(S)]))
    bill = casc.system_energy(svc.capture_log(0))

    # ragged drains after the warm-up: two full batches and a tail, every
    # submit free of host syncs (no more than max_inflight in flight)
    order = sorted(want)
    extra = order[:CASCADE_INFLIGHT * B + 3]
    cuts = (0, 5, 5, CASCADE_INFLIGHT * B, len(extra))
    for lo, hi in zip(cuts, cuts[1:]):
        part = extra[lo:hi]
        frs = (np.stack([want[r] for r in part]) if part
               else np.zeros((0, *hw), np.float32))
        with sync_free("cascade warm submit"):
            casc.submit("ragged", [i for _, i in part], frs)
    ragged = casc.flush()
    check([b.n_padded for b in ragged] == [0] * CASCADE_INFLIGHT + [B - 3]
          and np.array_equal(np.concatenate([b.frame_idx for b in ragged]),
                             [i for _, i in extra]),
          f"cascade: ragged batches {[b.n_padded for b in ragged]} padded")
    # batched == eager at every batch position: the main run's first batch,
    # the ragged full batches and the padded tail
    first = batches[0]
    frames = np.stack([want[(sid, int(i))] for sid, i
                       in zip(first.sids, first.frame_idx)]
                      + [want[r] for r in extra])
    batched = np.concatenate([first.logits] + [b.logits for b in ragged])
    check(np.array_equal(casc.eager(frames), batched),
          "cascade: batched logits differ from eager")
    check(casc.rebuild_count() == 1, "cascade: rebuilt by ragged drains")

    # timing, warm: the backbone alone (CASCADE_TIMED full batches), the
    # site with and without the cascade, in turns
    timed = np.stack([want[r] for r in order[:CASCADE_TIMED * B]])

    def backbone(n_batches):
        casc.submit("timed", np.arange(n_batches * B), timed[:n_batches * B])
        return casc.flush()

    gate = service()
    site(gate, False)
    walls = {}
    for what, fn in (("backbone", lambda: backbone(CASCADE_TIMED)),
                     ("gate", lambda: site(gate, False)),
                     ("site", lambda: site(svc)),
                     ("gate_again", lambda: site(gate, False))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
    # one batch alone, not pipelined: CUDA events around eager calls of one
    # frame (the copy in, the graph's launch and replay, the copy out)
    event_ms = time_ms(lambda: casc.eager(timed[:1]), runs=5, warmup=1)
    prof = device_profile(lambda: backbone(CASCADE_PROFILED))
    check(casc.rebuild_count() == 1, "cascade: rebuilt while timed")

    cost = casc.backbone_cost()
    hand = detector_matmul_flops(cfg, seq, CASCADE_PATCH)
    check(cost.flops == hand,
          f"cascade: backbone_cost {cost.flops} FLOPs/frame, hand count "
          f"{hand}")
    bounds = dict(bytes_ms=B * cost.bytes / HBM_BYTES_S * 1e3,
                  flops_ms=B * cost.flops / BF16_OPS_S * 1e3)
    rl = casc.roofline()
    check(math.isclose(rl.t_compute * 1e3, bounds["flops_ms"], rel_tol=1e-9)
          and math.isclose(rl.t_memory * 1e3, bounds["bytes_ms"],
                           rel_tol=1e-9),
          f"cascade: roofline {rl.t_compute}, {rl.t_memory} s against the "
          f"bounds {bounds}")
    refs = [cascade_reference(cfg.replace(n_layers=CASCADE_REF_LAYERS),
                              timed[:CASCADE_REF_FRAMES]),
            cascade_reference(configs.get_smoke(CASCADE_ARCH),
                              timed[:CASCADE_REF_FRAMES])]
    for r, rtol in zip(refs, (CASCADE_BF16_RTOL, CASCADE_F32_RTOL)):
        r["rtol"] = rtol
        check(r["max_abs_diff"] <= rtol * r["max_abs_logit"],
              f"cascade: card vs CPU at {r}")

    backbone_fps = CASCADE_TIMED * B / walls["backbone"]
    device_ms = (prof["device_ms"] / CASCADE_PROFILED
                 if prof["device_ms"] > 0 else "not measured")
    gate_fps = S * n / min(walls["gate"], walls["gate_again"])
    rec = dict(
        arch=CASCADE_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        compute_dtype=cfg.compute_dtype, backbone_params=n_params,
        frame=FRAME, patch=CASCADE_PATCH, seq=seq, batch=B,
        max_inflight=CASCADE_INFLIGHT, setup_s=setup_s,
        first_pass_s=first_s, hp_frames=len(want), batches=len(batches),
        launches=launches, rows_once=True, bitwise_vs_eager=True,
        eager_frames=len(frames), ragged_padded=B - 3,
        warm_submits_sync_free=True, rebuild_count=casc.rebuild_count(),
        backbone_fps=backbone_fps,
        ms_per_batch=walls["backbone"] / CASCADE_TIMED * 1e3,
        bound_ms_per_batch=bounds, alone_event_ms_per_batch=event_ms,
        device_ms_per_batch=device_ms,
        # the profiler's kernel time a batch over the unprofiled wall
        # time a batch of the pipelined pass
        device_share_of_wall=(device_ms / (walls["backbone"] * 1e3
                                           / CASCADE_TIMED)
                              if device_ms != "not measured"
                              else device_ms),
        device_busy_share=prof["device_busy_share"],
        top_kernels_ms=prof["top_kernels_ms"],
        site_fps=S * n / walls["site"], gate_fps=gate_fps,
        gate_duty=duty, hp_share=len(want) / (S * n),
        hp_fps_passed_by_gate=gate_fps * len(want) / (S * n),
        hp_fps_backbone_sustains=backbone_fps,
        backbone_cost=dataclasses.asdict(cost), flops_hand_count=hand,
        roofline=rl.to_dict(),
        energy_slot0={k: dict(dataclasses.asdict(v), total=v.total)
                      for k, v in bill.items()},
        energy_saving=energy.savings(bill["cascade"],
                                     bill["always_on"])["total_saving"],
        references=refs, walls_s=walls)
    emit({"cascade": rec})
    return rec, launches


# the encoder's training path (cells phase): the train cell at train_4k's
# sequence, its batch cut from 256 to CELLS_TRAIN_BATCH to fit one card;
# the prefill cell at prefill_32k's, its batch cut from 32 to
# CELLS_PREFILL_BATCH; CELLS_TIMED timed steps after a warm one
CELLS_TRAIN_BATCH, CELLS_PREFILL_BATCH, CELLS_TIMED = 4, 1, 3
# card against the CPU and the learning check: full width at
# CELLS_CHECK_LAYERS layers, (batch, seq) tokens, weights at
# CELLS_WEIGHT_STD (where the float32 problem is well conditioned; at
# Model.init's scale the attention is near one-hot and the difference is
# recorded beside the card's own response to a CELLS_PERTURB change);
# tolerances (loss relative, each gradient leaf of its largest |entry|)
CELLS_CHECK_LAYERS, CELLS_CHECK_TOKENS = 2, (2, 512)
CELLS_WEIGHT_STD, CELLS_PERTURB = 0.02, 1e-7
CELLS_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 5e-2)}
CELLS_LEARN_TOKENS, CELLS_LEARN_STEPS, CELLS_LEARN_LR = (1, 512), 10, 1e-4
# the production meshes analyze() is printed for
CELLS_MESHES = ({"data": 1, "model": 1}, {"data": 16, "model": 16},
                {"pod": 2, "data": 16, "model": 16})
# the LM phase, the dense and vlm families (ROADMAP.md §1 item 4(a)): the
# dense model at full width through the cells phase's runs and checks;
# OLMo's parameter-free norms and MHA at full width; the VLM at full width
# and LM_VLM_LAYERS of its 80 layers (their bf16 weights alone are
# ~150 GB), its prefill behind its image prefix
LM_ARCH, LM_OLMO, LM_VLM, LM_VLM_LAYERS = ("internlm2-1.8b", "olmo-1b",
                                           "internvl2-76b", 2)
# the cells and LM phases' train and prefill runs at CELLS_TIMED_LAYERS,
# a quarter of each stack (48, 24 and 16 layers), to keep the script
# inside its 1200 s on an H100 host with a slower CPU (with these runs at
# full depth the script took 1033.6 to 1194.6 s on H100 hosts, and 1031.9
# s at half depth before the loop over a mesh came); their counts on meta
# tensors and the dry run stay at full depth
CELLS_TIMED_LAYERS = {CASCADE_ARCH: 12, LM_ARCH: 6, LM_OLMO: 4}
# the "model" ranks of the production meshes the dry run counts
DRYRUN_MODEL = 16
# the mesh phase's sharded cells (mesh_cells, mesh_decodes): each
# architecture's rank record key and the seed of its full-width weights;
# their depth, cut to MESH_CELLS_LAYERS of 48 and 24 layers to make room
# in the script's 1200 s (12 and 6 for the xLSTM phase, 6 and 3 for the
# loop over a mesh; a layer of the stack repeats the same collectives)
MESH_CELLS = {CASCADE_ARCH: ("cells", SEED + 15), LM_ARCH: ("cells_lm",
                                                            SEED + 25)}
MESH_CELLS_LAYERS = {CASCADE_ARCH: 6, LM_ARCH: 3}


def mesh_cells_cfg(arch: str):
    """``arch`` at full width and its MESH_CELLS_LAYERS."""
    return configs.get_config(arch).replace(n_layers=MESH_CELLS_LAYERS[arch])


def attn_pairs(S_all: int, causal: bool, q_chunk: int = 1024) -> int:
    """(query, key) pairs the attention scores (``attention._sdpa``): the
    whole square in one query block; past it, each block ``[lo, hi)``
    against every key, or causally against its first ``hi``."""
    if S_all <= q_chunk:
        return S_all * S_all
    return sum((min(lo + q_chunk, S_all) - lo)
               * (min(lo + q_chunk, S_all) if causal else S_all)
               for lo in range(0, S_all, q_chunk))


def moe_capacity(cfg, n: int) -> int:
    """``mlp._capacity``: the buffer rows an expert keeps of ``n`` routed
    tokens."""
    return max(int(n * cfg.top_k * cfg.capacity_factor / cfg.n_experts),
               cfg.top_k)


def moe_matmul_flops(cfg, n: int, model: int = 1, data: int = 1
                     ) -> dict:
    """One mixture-of-experts layer's products over ``n`` routed tokens:
    the float32 router ``(n, d) x (d, E)`` and the bf16 experts, three
    products over ``E * C`` buffer rows at the capacity ``C`` of ``n``
    tokens. Over ``data`` ranks of the batch's dims and ``model`` of
    "model", what the ranks repeat: each data rank routes the whole
    gathered batch and runs its experts over every routed token; a router
    ``model`` does not split (fewer experts than ranks) runs whole on
    every rank."""
    if not cfg.n_experts:
        return {"bf16": 0, "float32": 0}
    e, d = cfg.n_experts, cfg.d_model
    router = data * (1 if e % model == 0 else model)
    return {"bf16": data * 3 * 2 * e * moe_capacity(cfg, n) * d * cfg.d_ff,
            "float32": router * 2 * n * d * e}


def cell_matmul_flops(cfg, b: int, s: int, train: bool,
                      model: int = 1, data: int = 1) -> dict:
    """Hand count of a cell's products, split into the bf16 ones (the
    projections, the MLP or the experts, the unembedding) and the
    float32 ones (the scores and ``P·V``; the router). Forward: per layer
    q, k, v, o, the MLP (SwiGLU: three products) over every position
    (the VLM's image prefix too) or the mixture of experts
    (:func:`moe_matmul_flops`), the scores and ``P·V`` over
    :func:`attn_pairs`; the unembedding over the ``s`` text positions.
    Train: the forward, the backward (two products a product: every
    layer's input takes a gradient, since the norms' weights or the
    embedding table do), with ``"full"`` remat each layer's recompute,
    which stops before ``w_down`` (``torch.utils.checkpoint``'s early
    stop: the backward pass saved that product's inputs; a layer with
    experts is recomputed whole, as its weighting reads the slot outputs
    after ``w_down``), and the chunked loss's recompute of the
    unembedding (a vocab of 8192 or more over more than 1024 positions
    that 1024 divides). Over ``model`` ranks of "model", what each rank
    repeats: kv heads ``model`` does not divide, one a rank
    (``attention.kv_heads_of_rank`` for the published configs), and a
    vocab it does not divide, whole on every rank; over ``data`` ranks,
    the experts' repeats (:func:`moe_matmul_flops`). The hybrid's:
    :func:`hybrid_matmul_flops`; the xLSTM's: :func:`xlstm_matmul_flops`."""
    if cfg.family == "hybrid":
        return hybrid_matmul_flops(cfg, b, s, "train" if train else
                                   "prefill", model, data)
    if cfg.family == "ssm":
        return xlstm_matmul_flops(cfg, b, s, "train" if train else
                                  "prefill", model, data)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    vocab = cfg.vocab
    if kv % model:
        kv = model * max(h // model // (h // kv), 1)
    if vocab % model:
        vocab *= model
    S_all = s + (cfg.n_image_tokens if cfg.family == "vlm"
                 and not cfg.embeds_in else 0)
    f, T = cfg.d_ff, b * S_all
    n_in = 2 if cfg.activation == "silu" else 1
    moe = moe_matmul_flops(cfg, T, model, data)
    down = 0 if cfg.n_experts else 2 * T * f * d
    proj = (2 * T * d * (h + 2 * kv) * hd + (moe["bf16"] if cfg.n_experts
                                             else n_in * 2 * T * d * f)
            + 2 * T * h * hd * d)
    attn = 2 * 2 * b * attn_pairs(S_all, cfg.causal and not cfg.is_encoder
                                  ) * h * hd + moe["float32"]
    unembed = 2 * b * s * d * vocab
    L = cfg.n_layers
    low = L * (proj + down) + unembed
    f32 = L * attn
    if train:
        remat = cfg.remat == "full"
        chunked = cfg.vocab >= 8192 and s > 1024 and s % 1024 == 0
        low = (3 * low + (L * proj if remat else 0)
               + (unembed if chunked else 0))
        f32 = 3 * f32 + (L * attn if remat else 0)
    return {"bf16": low, "float32": f32, "total": low + f32}


def hybrid_matmul_flops(cfg, b: int, s: int, kind: str, model: int = 1,
                        data: int = 1) -> dict:
    """Hand count of a hybrid cell's products (``kind`` train, prefill or
    decode), split as :func:`cell_matmul_flops` splits them. Per Mamba
    layer the bf16 in and out projections and, in train and prefill, the
    float32 SSD products by chunk of ``q = min(ssm_chunk, s)`` (``C·B``
    of each group, its heads' ``L * C·B`` against x, the chunk states
    and the off-diagonal term), in decode the state against C; per
    shared-block call ``h0 @ emb_proj``, q, k, v, o and the SwiGLU MLP
    in bf16, the causal scores and ``P·V`` in float32 (one token against
    the whole cache in decode); the unembedding. Train: three times the
    forward, and under remat "full" each layer again but for its last
    product (``out_proj``; the shared block's ``w_down``), and the
    chunked loss's unembedding again. Over ``model`` "model" ranks, what
    they repeat: ``C·B`` of the one group and ``h0 @ emb_proj`` on every
    rank, a vocab they do not divide; over ``data`` ranks of the batch's
    dims, a batch they do not split (long_500k's one sequence), whole on
    every one."""
    d, di, n, p = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    hs, h, kv = cfg.ssm_heads, cfg.n_heads, cfg.kv_heads
    hd, f, L = cfg.resolved_head_dim, cfg.d_ff, cfg.n_layers
    dproj = 2 * di + 2 * n + hs
    calls = len(range(cfg.shared_attn_every - 1, L, cfg.shared_attn_every)
                ) if cfg.shared_attn_every else 0
    vocab = cfg.vocab * (model if cfg.vocab % model else 1)
    rep = data if b % data else 1
    if kind == "decode":
        low = (L * b * (2 * d * dproj + 2 * di * d)
               + calls * b * (model * 2 * d * d + 2 * d * (h + 2 * kv) * hd
                              + 2 * h * hd * d + 3 * 2 * d * f)
               + b * 2 * d * vocab)
        f32 = L * b * 2 * hs * p * n + calls * b * 2 * 2 * h * s * hd
    else:
        q = min(cfg.ssm_chunk, s)
        c, t = s // q, b * s
        out_proj, w_down = 2 * t * di * d, 2 * t * f * d
        m_low = 2 * t * d * dproj + out_proj
        m_f32 = (model * 2 * b * c * q * q * n + 2 * b * c * hs * q * q * p
                 + 2 * 2 * t * hs * p * n)
        s_low = (model * 2 * t * d * d + 2 * t * d * (h + 2 * kv) * hd
                 + 2 * t * h * hd * d + 2 * 2 * t * d * f + w_down)
        s_f32 = 2 * 2 * b * attn_pairs(s, True) * h * hd
        unembed = 2 * t * d * vocab
        low = L * m_low + calls * s_low + unembed
        f32 = L * m_f32 + calls * s_f32
        if kind == "train":
            remat = cfg.remat == "full"
            chunked = cfg.vocab >= 8192 and s > 1024 and s % 1024 == 0
            low = (3 * low + (L * (m_low - out_proj) + calls * (s_low - w_down)
                              if remat else 0)
                   + (unembed if chunked else 0))
            f32 = 3 * f32 + (L * m_f32 + calls * s_f32 if remat else 0)
    return {"bf16": rep * low, "float32": rep * f32,
            "total": rep * (low + f32)}


def counted_flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def cells_counted(arch: str = CASCADE_ARCH) -> dict:
    """``arch``'s train and prefill cells at ``train_4k`` and
    ``prefill_32k``, full batches, on meta tensors: ``FlopCounterMode``
    FLOPs against the hand count, and ``analyze()`` on one card and the
    production meshes."""
    cfg = configs.get_config(arch)
    out = {}
    for name in ("train_4k", "prefill_32k"):
        shape = configs.SHAPES[name]
        cell = steps.build_cell(cfg, shape)
        got = counted_flops(cell.step_fn, *cell.abstract_args)
        hand = cell_matmul_flops(cfg, shape.global_batch, shape.seq_len,
                                 shape.kind == "train")
        check(got == hand["total"], f"cells: {arch} {name} counts {got} "
              f"FLOPs, hand count {hand}")
        out[name] = dict(batch=shape.global_batch, seq=shape.seq_len,
                         flops=got, flops_hand=hand, memory={
                             "x".join(map(str, m.values())):
                             memory_record(cfg, shape, m)
                             for m in CELLS_MESHES})
    return out


def memory_record(cfg, shape, mesh, rules=None) -> dict:
    mb = memory_model.analyze(cfg, shape, mesh, rules)
    return dict(dataclasses.asdict(mb), total_gb=mb.total_gb,
                fits_h100=mb.fits_h100)


def scaled_params(cfg, seed: int, device, draw_device="cpu") -> dict:
    """``cfg``'s parameters drawn on ``draw_device`` (the CPU) from
    ``seed``: normal leaves at CELLS_WEIGHT_STD, norm scales ``1 + 0.1
    N``, biases ``0.1 N``."""
    g = torch.Generator(device=draw_device).manual_seed(seed)

    def one(p):
        x = torch.randn(p.shape, generator=g, device=draw_device)
        x = (1 + 0.1 * x if p.init == "ones" else 0.1 * x
             if p.init == "zeros" else CELLS_WEIGHT_STD * x)
        return x.to(device)
    return model_common.tree_map(one, lm.Model(cfg).spec(),
                                 lambda x: isinstance(x, model_common.P))


def cell_batch(cfg, b: int, s: int, seed: int, device,
               image_seed: int | None = None) -> lm.Batch:
    """A cell's batch drawn on the CPU from ``seed``: for an embeds-in
    config embeddings ``N(0, 1)`` in bf16 (the cells' input spec), else
    int32 tokens in ``[0, vocab)``; int32 labels in ``[-1, vocab)`` (-1
    masked); for the VLM its ``(b, n_image_tokens, d_model)`` image
    prefix ``N(0, 1)`` in bf16, from ``image_seed`` if given."""
    g = torch.Generator().manual_seed(seed)
    emb = tokens = None
    if cfg.embeds_in:
        emb = torch.randn((b, s, cfg.d_model), generator=g).to(
            torch.bfloat16)
    else:
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=g,
                               dtype=torch.int32)
    labels = torch.randint(-1, cfg.vocab, (b, s), generator=g,
                           dtype=torch.int32)
    if cfg.family == "vlm" and not cfg.embeds_in:
        gi = g if image_seed is None else torch.Generator().manual_seed(
            image_seed)
        emb = torch.randn((b, cfg.n_image_tokens, cfg.d_model),
                          generator=gi).to(torch.bfloat16)
    return batch_to(lm.Batch(tokens, labels, emb), device)


def batch_to(batch: lm.Batch, device) -> lm.Batch:
    return lm.Batch(*(None if t is None else t.to(device) for t in batch))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|, in float32 on the
    CPU."""
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max() / want.abs().max())


def leaf_errs(got, want) -> float:
    """:func:`rel_err` of each leaf, the largest over all leaves."""
    return max(rel_err(a, b) for a, b in zip(model_common.leaves(got),
                                             model_common.leaves(want)))


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(model_common.leaves(a),
                                                 model_common.leaves(b)))


def max_abs(t: torch.Tensor) -> float:
    """The largest |entry| of ``t``, with no copy of it."""
    return max(float(t.max()), -float(t.min()))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor, dim: int = 1,
                 block: int = 4096) -> float:
    """The largest |a - b| in float32, ``block`` positions of ``dim`` at a
    time (full-width logits are GBs)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.split(block, dim), b.split(block, dim)))


def fingerprint(tree) -> list[int]:
    """:func:`digest` of every leaf of ``tree`` (a step's outputs, say):
    two runs' bits compared without holding both runs' tensors."""
    return [digest(t) for t in model_common.leaves(tree)]


def card_vs_cpu(cfg, params) -> dict:
    """``loss_and_grads`` on the card and on the CPU (``params`` copied),
    one CELLS_CHECK_TOKENS batch: the loss's relative difference and the
    gradients' largest difference of a leaf's largest |entry|."""
    model = lm.Model(cfg)
    b, s = CELLS_CHECK_TOKENS
    batch = cell_batch(cfg, b, s, SEED + 16, DEVICE)
    loss, grads = steps.loss_and_grads(model, params, batch)
    cpu = model_common.tree_map(lambda a: a.cpu(), params)
    closs, cgrads = steps.loss_and_grads(model, cpu, batch_to(batch, "cpu"))
    return dict(loss=float(closs),
                loss_rel_diff=abs(float(loss) - float(closs))
                / abs(float(closs)),
                grad_rel_diff=leaf_errs(grads, cgrads))


def cells_checks(arch: str = CASCADE_ARCH, model_init: bool = True) -> dict:
    """``arch`` at full width and CELLS_CHECK_LAYERS layers: the card
    against the CPU in float32 and bf16 (held); with ``model_init``, at
    ``Model.init``'s weights in float32, the difference recorded beside
    the card's own response to a CELLS_PERTURB relative change of every
    weight; the loss over CELLS_LEARN_STEPS AdamW steps at a constant
    CELLS_LEARN_LR on a fixed batch (must fall)."""
    base = configs.get_config(arch).replace(n_layers=CELLS_CHECK_LAYERS)
    out = {}
    for dt, (loss_tol, grad_tol) in CELLS_TOL.items():
        cfg = base.replace(compute_dtype=dt)
        r = card_vs_cpu(cfg, scaled_params(cfg, SEED + 17, DEVICE))
        r.update(loss_rtol=loss_tol, grad_rtol=grad_tol)
        check(r["loss_rel_diff"] <= loss_tol
              and r["grad_rel_diff"] <= grad_tol, f"cells: {arch} card vs "
              f"CPU {dt} at {CELLS_CHECK_LAYERS} layers: {r}")
        out[dt] = r
    if model_init:
        cfg = base.replace(compute_dtype="float32")
        model = lm.Model(cfg)
        params = model.init(torch.Generator(device=DEVICE).manual_seed(
            SEED + 18))
        rec = card_vs_cpu(cfg, params)
        gp = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
        moved = model_common.tree_map(lambda a: a * (1 + CELLS_PERTURB * (
            torch.randn(a.shape, generator=gp, device=DEVICE))), params)
        b, s = CELLS_CHECK_TOKENS
        batch = cell_batch(cfg, b, s, SEED + 16, DEVICE)
        _, g0 = steps.loss_and_grads(model, params, batch)
        _, g1 = steps.loss_and_grads(model, moved, batch)
        rec["perturbed_grad_rel_diff"] = leaf_errs(
            g1, model_common.tree_map(lambda a: a.cpu(), g0))
        out["float32_model_init"] = rec

    # the model learns: a constant learning rate (the cell's warmup gives
    # ~1e-7 in its first steps)
    cfg = base
    model = lm.Model(cfg)
    step = steps.train_step_fn(model, optim.AdamW(
        lr=optim.constant(CELLS_LEARN_LR)))
    params = scaled_params(cfg, SEED + 20, DEVICE)
    state = optim.AdamW().init(params)
    batch = cell_batch(cfg, *CELLS_LEARN_TOKENS, SEED + 21, DEVICE)
    losses = []
    for _ in range(CELLS_LEARN_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"cells: {arch}'s loss did not fall: {losses}")
    out["learn"] = dict(layers=cfg.n_layers, tokens=CELLS_LEARN_TOKENS,
                        lr=CELLS_LEARN_LR, losses=losses)
    return out


def timed_run(fn, *args):
    """``fn(*args)`` between CUDA events: (its output, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def deterministic_run_to_run(step, model, params, state, batch) -> dict:
    """Under ``torch.use_deterministic_algorithms(True)`` (``warn_only``:
    a cuBLAS product warns for want of ``CUBLAS_WORKSPACE_CONFIG``, which
    the process would have to set before its first product): two steps
    from one state and the loss and gradients twice, each pair bitwise;
    an op without a deterministic implementation on the path fails the
    check."""
    before = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a = fingerprint(list(step(params, state, batch)))
            b = fingerprint(list(step(params, state, batch)))
            la, ga = steps.loss_and_grads(model, params, batch)
            fa = fingerprint(ga)
            del ga
            lb, gb = steps.loss_and_grads(model, params, batch)
            fb = fingerprint(gb)
            del gb
        finally:
            torch.use_deterministic_algorithms(before)
    flagged = sorted({str(w.message)[:160] for w in seen
                      if "deterministic implementation" in str(w.message)})
    check(not flagged, f"cells: ops without a deterministic implementation "
          f"on the train step: {flagged}")
    check(a == b and torch.equal(la, lb) and fa == fb, "cells: under "
          "torch.use_deterministic_algorithms(True) two train steps or the "
          "loss and gradients differ")
    return dict(bitwise=True, nondeterministic_ops=flagged,
                other_warnings=len(seen))


def train_cell_run(cfg, params, deterministic: bool = False) -> dict:
    """The full-width train cell at train_4k's sequence, CELLS_TRAIN_BATCH
    sequences: a warm step, then CELLS_TIMED timed steps from the same
    state, each bitwise the warm one (loss, parameters, moments: their
    :func:`fingerprint`, so no two steps' outputs live at once); the loss
    and gradients twice, bitwise; with ``deterministic``, both again
    under :func:`deterministic_run_to_run`; one step profiled; the
    allocator's peak beside ``analyze()``."""
    shape = dataclasses.replace(configs.SHAPES["train_4k"],
                                global_batch=CELLS_TRAIN_BATCH)
    b, s = shape.global_batch, shape.seq_len
    cell = steps.build_cell(cfg, shape)
    step = cell.step_fn
    state = steps.make_optimizer(cfg).init(params)
    batch = cell_batch(cfg, b, s, SEED + 22, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    warm, first_ms = timed_run(step, params, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(warm[2].shape == () and math.isfinite(float(warm[2])),
          f"cells: {cfg.arch_id} train loss {warm[2]}")
    want = fingerprint(list(warm))
    del warm
    ms = []
    for _ in range(CELLS_TIMED):
        out, t = timed_run(step, params, state, batch)
        ms.append(t)
        check(fingerprint(list(out)) == want,
              f"cells: {cfg.arch_id}: two train steps from one state differ")
        del out
    model = lm.Model(cfg)
    la, ga = steps.loss_and_grads(model, params, batch)
    lb, gb = steps.loss_and_grads(model, params, batch)
    check(torch.equal(la, lb) and same_bits(ga, gb),
          f"cells: {cfg.arch_id}: the loss or a gradient differs run to run")
    del ga, gb
    det = (deterministic_run_to_run(step, model, params, state, batch)
           if deterministic else "not run")
    prof = device_profile(lambda: step(params, state, batch))
    flops = counted_flops(step, *cell.abstract_args)
    hand = cell_matmul_flops(cfg, b, s, True)
    check(flops == hand["total"], f"cells: {cfg.arch_id} train step {flops} "
          f"FLOPs, hand {hand}")
    step_ms = statistics.median(ms)
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=b, seq=s,
        cut=f"train_4k's batch 256 -> {b}", loss=float(la),
        first_step_ms=first_ms, ms_per_step=ms, median_ms=step_ms,
        tokens_per_s=b * s / (step_ms / 1e3), flops=flops, flops_hand=hand,
        tflops_per_s=flops / (step_ms / 1e3) / 1e12, bf16_peak_tflops=989,
        bound_ms={"bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                  "float32_at_67": hand["float32"] / F32_OPS_S * 1e3},
        bitwise_run_to_run=True, deterministic_algorithms=det,
        allocated_before_gb=before_gb, peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, shape, CELLS_MESHES[0]),
        profile=prof)


def prefill_cell_run(cfg, params, image_seed: int | None = None) -> dict:
    """The full-width prefill cell at prefill_32k's sequence,
    CELLS_PREFILL_BATCH sequence: logits of the right shape (the text
    positions), finite, bitwise ``Model.forward``'s on the same batch;
    ms of both runs and the allocator's peak beside ``analyze()``. For
    the VLM: another image prefix (``image_seed``) on the same tokens
    changes the text logits."""
    shape = dataclasses.replace(configs.SHAPES["prefill_32k"],
                                global_batch=CELLS_PREFILL_BATCH)
    b, s = shape.global_batch, shape.seq_len
    cell = steps.build_cell(cfg, shape)
    batch = cell_batch(cfg, b, s, SEED + 23, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got, step_ms = timed_run(cell.step_fn, params, batch)
        check(tuple(got.shape) == (b, s, cfg.vocab)
              and bool(torch.isfinite(got).all()), f"cells: {cfg.arch_id} "
              f"prefill logits {tuple(got.shape)} or not finite")
        want, forward_ms = timed_run(lm.Model(cfg).forward, params, batch)
        check(torch.equal(got, want), f"cells: {cfg.arch_id} prefill "
              f"logits differ from Model.forward")
        del want
        image = "no image prefix"
        if image_seed is not None:
            other = cell_batch(cfg, b, s, SEED + 23, DEVICE, image_seed)
            moved = cell.step_fn(params, other)
            diff = max_abs_diff(moved, got)
            check(diff > 0, f"cells: {cfg.arch_id}: another image prefix "
                  f"leaves the text logits as they were")
            image = dict(n_image_tokens=cfg.n_image_tokens,
                         max_abs_logit_change=diff,
                         max_abs_logit=max_abs(got))
            del moved
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del got
    hand = cell_matmul_flops(cfg, b, s, False)
    return dict(arch=cfg.arch_id, layers=cfg.n_layers, batch=b, seq=s,
                cut=f"prefill_32k's batch 32 -> {b}",
                logits_shape=[b, s, cfg.vocab], bitwise_vs_forward=True,
                image_prefix=image, ms=step_ms, forward_ms=forward_ms,
                flops_hand=hand,
                tflops_per_s=hand["total"] / (step_ms / 1e3) / 1e12,
                bound_ms={"bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                          "float32_at_67": hand["float32"] / F32_OPS_S
                          * 1e3},
                peak_allocated_gb=peak_gb,
                memory_model=memory_record(cfg, shape, CELLS_MESHES[0]))


# seconds the dry run's subprocesses may take once its records are wanted
# (its 56 cells take about eleven minutes of one host core, the longest
# architecture's, qwen3-moe's 94 layers, about three)
DRYRUN_TIMEOUT_S = 600


class DryRun:
    """The dry run's cells (``dryrun.all_cells()``, what ``--all``
    counts), one ``python -m repro_torch.launch.dryrun --arch --shape
    --mesh`` process a cell with its own ``--out``, the cells of one
    architecture in turn and the architectures in parallel (a shell
    chain each, at ``nice`` 10 beside the card's phases), on the host's
    CPU (it runs no card). ``wait`` merges the records in ``ARCH_IDS``
    order into ``out``, as ``--all`` writes them; ``log`` holds every
    process's output."""

    def __init__(self, root: pathlib.Path):
        from repro_torch.launch import dryrun
        self.root, self.out = root, root / "dryrun.jsonl"
        self.log = root / "dryrun.log"
        shutil.rmtree(root / "dryrun", ignore_errors=True)
        (root / "dryrun").mkdir(parents=True)
        self.out.unlink(missing_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        chains: dict[str, list[str]] = {}
        self.files = []
        for i, (arch, shape, mesh) in enumerate(dryrun.all_cells()):
            f = root / "dryrun" / f"{i:03d}.jsonl"
            self.files.append(f)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--mesh", mesh, "--out", str(f)]
            if shape is not None:
                cmd += ["--shape", shape]
            chains.setdefault(arch, []).append(shlex.join(cmd))
        self.procs = []
        for arch, cmds in chains.items():
            fh = open(root / "dryrun" / f"{arch}.log", "w")
            self.procs.append((arch, fh, subprocess.Popen(
                ["nice", "-n", "10", "sh", "-c", " && ".join(cmds)],
                cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT)))

    def wait(self, timeout: float) -> int:
        """The chains' worst exit code, once every one has ended (or
        ``timeout`` seconds have passed: a chain still running raises);
        the records merged, the logs joined."""
        t0 = time.perf_counter()
        rc = 0
        for _, fh, p in self.procs:
            rc = max(rc, p.wait(max(timeout - (time.perf_counter() - t0),
                                    1.0)))
            fh.close()
        self.log.write_text("".join(
            (self.root / "dryrun" / f"{a}.log").read_text()
            for a, _, _ in self.procs))
        self.out.write_text("".join(f.read_text() for f in self.files
                                    if f.exists()))
        return rc

    def poll(self):
        return None if any(p.poll() is None for _, _, p in self.procs) \
            else 0

    def kill(self) -> None:
        for _, fh, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            fh.close()


def dryrun_start():
    """The dry run (:class:`DryRun`) started on the host's CPU, its
    records to ``build/dryrun.jsonl``: ``(runner, records path, log
    path)``."""
    run = DryRun(ROOT / "build")
    return run, run.out, run.log


def dryrun_stop(dry) -> None:
    if dry is not None and dry[0].poll() is None:
        dry[0].kill()


def dryrun_records(proc, out, log) -> list[dict]:
    """The dry run's records once its processes end: exit 0; 62 ``ok``
    records, one for every cell (``train_4k`` and ``prefill_32k`` of each
    architecture, ``decode_32k`` of each decoder and the hybrid's and the
    xLSTM's ``long_500k`` on the 16x16 and 2x16x16 meshes), their FLOPs
    at least the hand count of the products and equal to it plus what the
    ranks repeat (:func:`cell_matmul_flops`, :func:`decode_matmul_flops`:
    over the 16 "model" ranks hubert-xlarge's unembedding, a vocab of 504,
    the k and v projections of the kv heads 16 does not divide, the
    hybrid's ``C·B`` and ``h0 @ emb_proj``, and every xLSTM block, whose 4
    heads 16 does not divide; over the 16 or 32 data ranks, the routing
    and the experts of the whole gathered batch, and long_500k's one
    sequence), their memory ``analyze()``'s on the mesh; no
    ``not_ported`` row, no ``fail``. Each record printed."""
    rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    check(rc == 0, f"dry run: exit {rc}\n{log.read_text()[-3000:]}")
    records = [json.loads(line) for line in out.read_text().splitlines()]
    for r in records:
        emit({"dryrun": r})
    ok = [r for r in records if r["status"] == "ok"]
    check(len(ok) == 62 and {r["arch"] for r in ok} == set(configs.ARCH_IDS),
          f"dry run: the ok records {[(r['arch'], r['shape']) for r in ok]}")
    check(len(records) == 62, "dry run: a record that is not ok")
    for r in ok:
        cfg = configs.get_config(r["arch"])
        shape = configs.SHAPES[r["shape"]]
        b, s = shape.global_batch, shape.seq_len
        data = 16 if r["mesh"] == "single" else 32
        if shape.kind == "decode":
            hand = decode_matmul_flops(cfg, b, s)["total"]
            want = decode_matmul_flops(cfg, b, s, DRYRUN_MODEL,
                                       data)["total"]
        else:
            train = shape.kind == "train"
            hand = cell_matmul_flops(cfg, b, s, train)["total"]
            want = cell_matmul_flops(cfg, b, s, train, DRYRUN_MODEL,
                                     data)["total"]
        got = r["hlo_gflops"] * 1e9
        what = f"dry run {r['arch']} {r['shape']} {r['mesh']}"
        check(got >= hand and math.isclose(got, want, rel_tol=1e-12),
              f"{what}: {got} FLOPs, hand count {hand}, with the repeats "
              f"{want}")
        mesh = ({"data": 16, "model": 16} if r["mesh"] == "single"
                else {"pod": 2, "data": 16, "model": 16})
        mem = memory_model.analyze(cfg, shape, mesh).total_gb
        check(r["per_device_peak_mem_gb"] == mem,
              f"{what}: memory {r['per_device_peak_mem_gb']} against "
              f"analyze() {mem}")
    return ok


def cells_phase(card: str, dry=None) -> dict:
    """The encoder's training path at full ``hubert-xlarge`` width (bf16
    compute, remat "full", weights from ``Model.init`` on a seeded
    generator): the cells counted on meta tensors at its 48 layers, the
    train and prefill cells run at CELLS_TIMED_LAYERS, the card against
    the CPU, the model learning; and
    the records of the dry run of the sharded cells on the production
    meshes (:func:`dryrun_records`), started at the top of the script on
    the host's CPU (``dry``: :func:`dryrun_start`'s; None starts it
    here). Every record carries the card's name and power limit."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = dry or dryrun_start()
    try:
        rec = {"card": card, "counted": cells_counted()}
        cfg = configs.get_config(CASCADE_ARCH).replace(
            n_layers=CELLS_TIMED_LAYERS[CASCADE_ARCH])
        params = lm.Model(cfg).init(
            torch.Generator(device=DEVICE).manual_seed(SEED + 15))
        rec["train"] = train_cell_run(cfg, params)
        torch.cuda.empty_cache()
        rec["prefill"] = prefill_cell_run(cfg, params)
        del params
        torch.cuda.empty_cache()
        rec["checks"] = cells_checks()
        rec["dryrun"] = dryrun_records(*dry)
    finally:
        dryrun_stop(dry)
    rec["phase_s"] = time.perf_counter() - t0
    emit({"cells": rec})
    return rec


def lm_phase(card: str) -> dict:
    """The dense and vlm families at full width (bf16 compute, remat
    "full", weights from ``Model.init`` on seeded generators):
    ``internlm2-1.8b`` (16 heads over 8 kv heads, vocab 92,544) through
    the cells phase's runs: counted on meta tensors at its 24 layers, the
    train step (its run-to-run check also under deterministic
    algorithms) and the prefill at CELLS_TIMED_LAYERS, the card against
    the CPU at 2 layers, the model learning; ``olmo-1b``'s train step and
    prefill at CELLS_TIMED_LAYERS (its norms hold no parameters);
    ``internvl2-76b`` at LM_VLM_LAYERS layers, its
    prefill behind 256 image embeddings. Every record carries the card's
    name and power limit."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = {"card": card, "counted": cells_counted(LM_ARCH)}
    emit({"lm": {"card": card, "counted": rec["counted"]}})
    for arch, seed in ((LM_ARCH, SEED + 25), (LM_OLMO, SEED + 26)):
        cfg = configs.get_config(arch).replace(
            n_layers=CELLS_TIMED_LAYERS[arch])
        params = lm.Model(cfg).init(
            torch.Generator(device=DEVICE).manual_seed(seed))
        rec[arch] = dict(train=train_cell_run(cfg, params,
                                              deterministic=arch == LM_ARCH))
        torch.cuda.empty_cache()
        rec[arch]["prefill"] = prefill_cell_run(cfg, params)
        del params
        torch.cuda.empty_cache()
        if arch == LM_ARCH:
            rec[arch]["checks"] = cells_checks(arch, model_init=False)
            torch.cuda.empty_cache()
        emit({"lm": {"card": card, arch: rec[arch]}})
    cfg = configs.get_config(LM_VLM).replace(n_layers=LM_VLM_LAYERS)
    params = lm.Model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(SEED + 27))
    rec[LM_VLM] = dict(cut=f"{LM_VLM_LAYERS} of 80 layers",
                       prefill=prefill_cell_run(cfg, params,
                                                image_seed=SEED + 28))
    del params
    torch.cuda.empty_cache()
    emit({"lm": {"card": card, LM_VLM: rec[LM_VLM]}})
    rec["phase_s"] = time.perf_counter() - t0
    emit({"lm_phase_s": rec["phase_s"]})
    return rec


# the decode phase (ROADMAP.md §1 item 4(b)): LM_ARCH at full width and
# DECODE_LAYERS (half of each stack since the loop over a mesh needed room
# in the script's 1200 s; full depth before) against decode_32k's cache
# of 32,768 positions, its batch cut 128 -> DECODE_BATCH (the bf16 cache
# 412 GB -> 12.9 GB at 12 layers); DECODE_PRIME tokens
# primed one at a time and held against Model.forward within
# DECODE_PREFILL_RTOL of the largest |logit| (bf16; weights at
# CELLS_WEIGHT_STD, where a random model is well conditioned; the
# difference at Model.init's weights recorded beside it, not held); the
# card against the CPU at CELLS_CHECK_LAYERS in float32 (DECODE_CHECK:
# batch, cache, tokens; with a float32 cache PR 26's float32 bound for a
# leaf, of the largest |logit|, with the bf16 cache its bf16 bound);
# greedy runs of DECODE_GREEDY (prompt, generated) tokens twice,
# bitwise; DECODE_TIMED steps at the cache's last index under
# set_sync_debug_mode("error") after DECODE_WARM; LM_OLMO's cache at the
# same batch and length; the launcher (DECODE_LAUNCHER: batch, prompt,
# generated) in a subprocess
DECODE_BATCH, DECODE_PRIME, DECODE_PREFILL_RTOL = 8, 64, 5e-2
DECODE_CHECK, DECODE_CPU_RTOL = (2, 256, 32), 1e-4
DECODE_GREEDY, DECODE_TIMED, DECODE_WARM = (16, 16), 10, 2
DECODE_LAUNCHER = (2, 8, 16)
DECODE_LAYERS = {LM_ARCH: 12, LM_OLMO: 8}


def decode_shape(batch: int = DECODE_BATCH, seq: int | None = None):
    """decode_32k with its batch (and, for a check, its cache) cut."""
    sh = configs.SHAPES["decode_32k"]
    return dataclasses.replace(sh, global_batch=batch,
                               seq_len=seq or sh.seq_len)


def filled_state(model, batch: int, max_seq: int, seed: int, device):
    """A decode state whose every position holds N(0, 1) bf16 keys and
    values (the hybrid's: N(0, 1) float32 SSM states and bf16
    convolution buffers besides), drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return lm.map_state(
        lambda t: torch.randn(t.shape, generator=g, device=device,
                              dtype=t.dtype),
        model.decode_state_spec(batch, max_seq))


def decode_tokens(cfg, shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=g,
                         dtype=torch.int32).to(device)


def primed_logits(model, params, tokens, max_seq: int, device,
                  cache_dtype=torch.bfloat16):
    """``tokens`` (b, n) fed one at a time into a zero cache of
    ``max_seq`` positions (bf16, the model's, or ``cache_dtype``; the
    hybrid's convolution buffers too, its SSM states float32): the
    ``(b, n, vocab)`` decode logits."""
    state = lm.map_state(
        lambda t: t.to(cache_dtype) if t.dtype == torch.bfloat16 else t,
        model.init_decode_state(tokens.shape[0], max_seq, device=device))
    index = torch.arange(tokens.shape[1], dtype=torch.int32, device=device)
    outs = []
    for t in range(tokens.shape[1]):
        logits, state = model.decode_step(params, state, lm.DecodeBatch(
            tokens[:, t:t + 1], index[t]))
        outs.append(logits)
    del state
    return torch.cat(outs, dim=1)


def decode_vs_prefill(cfg, params) -> dict:
    """DECODE_PRIME tokens primed into decode_32k's cut cache against
    ``Model.forward`` on the same tokens: the largest difference and the
    largest |logit|."""
    model = lm.Model(cfg)
    tokens = decode_tokens(cfg, (DECODE_BATCH, DECODE_PRIME), SEED + 31,
                           DEVICE)
    got = primed_logits(model, params, tokens, decode_shape().seq_len,
                        DEVICE)
    with torch.no_grad():
        want = model.forward(params, lm.Batch(tokens, None))
    out = dict(max_abs_diff=max_abs_diff(got, want),
               max_abs_logit=max_abs(want))
    del got, want
    torch.cuda.empty_cache()
    return out


def decode_card_vs_cpu(arch: str, layers: int = CELLS_CHECK_LAYERS
                       ) -> dict:
    """``arch`` at ``layers`` in float32 (weights at
    CELLS_WEIGHT_STD, drawn on the CPU): DECODE_CHECK's tokens primed on
    the card and on the CPU, the largest logit difference of the largest
    |logit|. With the cache in float32 (the reference's own float32
    parity setup) within DECODE_CPU_RTOL, PR 26's float32 bound; with
    the model's bf16 cache, where a new k or v entry that the two devices
    round to neighbouring bf16 values moves every later step, within PR
    26's bf16 bound (CELLS_TOL)."""
    cfg = configs.get_config(arch).replace(n_layers=layers,
                                           compute_dtype="float32")
    model = lm.Model(cfg)
    b, max_seq, n = DECODE_CHECK
    cpu = scaled_params(cfg, SEED + 32, "cpu")
    card = model_common.tree_map(lambda a: a.to(DEVICE), cpu)
    tokens = decode_tokens(cfg, (b, n), SEED + 33, "cpu")
    out = dict(layers=cfg.n_layers, batch=b, cache=max_seq, tokens=n)
    for name, dt, rtol in (
            ("float32_cache", torch.float32, DECODE_CPU_RTOL),
            ("bf16_cache", torch.bfloat16, CELLS_TOL["bfloat16"][1])):
        want = primed_logits(model, cpu, tokens, max_seq, "cpu", dt)
        got = primed_logits(model, card, tokens.to(DEVICE), max_seq, DEVICE,
                            dt)
        r = dict(logits_rel_diff=max_abs_diff(got.cpu(), want)
                 / max_abs(want), rtol=rtol)
        check(r["logits_rel_diff"] <= rtol, f"decode: {arch} card vs CPU "
              f"at {layers} layers, float32, {name}: {r}")
        out[name] = r
    return out


def decode_timed(cfg, params, batch: int = DECODE_BATCH,
                 shape=None) -> dict:
    """The decode cell's step at decode_32k's cache cut to ``batch`` (or
    at ``shape``), filled from a generator, ``index`` its last position
    (the hybrid's SSM states and buffers filled too): DECODE_WARM
    steps, then DECODE_TIMED between CUDA events under
    ``set_sync_debug_mode("error")`` (a host sync raises), each step's
    tokens bitwise the warm one's (the hybrid's recurrent states, which a
    step advances, copied back from a snapshot before each step, on the
    device: 38 x 3.2 MB a sequence); one step profiled; the allocator's
    peak beside ``analyze()`` on one device (mesh ``{}``); the bytes
    bound (the state and the bf16 weights once) and the FLOPs bound."""
    shape = shape or decode_shape(batch)
    batch = shape.global_batch
    model = lm.Model(cfg)
    cell = steps.build_cell(cfg, shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = filled_state(model, batch, shape.seq_len, SEED + 34, DEVICE)
    db = lm.DecodeBatch(
        decode_tokens(cfg, (batch, 1), SEED + 35, DEVICE),
        torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=DEVICE))
    recurrent = [(t, t.clone()) for t in model_common.leaves(
        state["mamba"] if isinstance(state, dict) else [])]

    def step():
        for t, t0 in recurrent:
            t.copy_(t0)
        return cell.step_fn(params, state, db)
    want = None
    for _ in range(DECODE_WARM):
        tokens, _ = step()
        want = fingerprint([tokens]) if want is None else want
    check(fingerprint([tokens]) == want, f"decode: {cfg.arch_id}: two "
          f"steps from one state differ")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with sync_free("decode timed steps"):
        start.record()
        for _ in range(DECODE_TIMED):
            tokens, _ = step()
        stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / DECODE_TIMED
    check(fingerprint([tokens]) == want, f"decode: {cfg.arch_id}: a timed "
          f"step's tokens differ from the warm one's")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = device_profile(step)
    del recurrent
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in model_common.leaves(state))
    del state
    torch.cuda.empty_cache()
    n_params = model_common.count_params(params)
    hand = decode_matmul_flops(cfg, batch, shape.seq_len)
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=batch,
        cache=shape.seq_len, cut=(
            f"{shape.name}'s batch {configs.SHAPES[shape.name].global_batch}"
            f" -> {batch}" if batch != configs.SHAPES[shape.name].global_batch
            else f"{shape.name} uncut"),
        index=shape.seq_len - 1, ms_per_step=ms,
        tokens_per_s=batch / (ms / 1e3), sync_free=True,
        bitwise_run_to_run=True, cache_gb=cache_bytes / 1e9,
        bf16_weights_gb=2 * n_params / 1e9,
        bound_ms={"bytes_at_3.35TBs": (cache_bytes + 2 * n_params)
                  / HBM_BYTES_S * 1e3,
                  "bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                  "float32_at_67": hand["float32"] / F32_OPS_S * 1e3},
        flops_hand=hand, peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, shape, {}), profile=prof)


def decode_matmul_flops(cfg, b: int, s: int, model: int = 1,
                        data: int = 1) -> dict:
    """Hand count of the decode step's products, one token a sequence:
    the bf16 ones (per layer q, k, v, o and the MLP or the experts at the
    capacity of the ``b`` tokens, :func:`moe_matmul_flops`; the
    unembedding) and the float32 ones (the scores and ``P·V`` over the
    whole cache; the router). Over ``model`` ranks of "model", what each
    rank repeats: where ``model`` does not divide the kv heads the cache
    splits along the sequence and every rank projects every kv head's k
    and v; a vocab it does not divide, whole on every rank; over
    ``data`` ranks, the experts' repeats. The hybrid's:
    :func:`hybrid_matmul_flops`; the xLSTM's: :func:`xlstm_matmul_flops`."""
    if cfg.family == "hybrid":
        return hybrid_matmul_flops(cfg, b, s, "decode", model, data)
    if cfg.family == "ssm":
        return xlstm_matmul_flops(cfg, b, s, "decode", model, data)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    n_in = 2 if cfg.activation == "silu" else 1
    kv_proj = 2 * 2 * d * kv * hd * (model if kv % model else 1)
    vocab = cfg.vocab * (model if cfg.vocab % model else 1)
    moe = moe_matmul_flops(cfg, b, model, data)
    ffn = 0 if cfg.n_experts else b * (n_in + 1) * 2 * d * cfg.d_ff
    low = (cfg.n_layers * (b * (2 * d * h * hd + kv_proj + 2 * h * hd * d)
                           + ffn + moe["bf16"])
           + b * 2 * d * vocab)
    f32 = cfg.n_layers * (b * 2 * 2 * h * s * hd + moe["float32"])
    return {"bf16": low, "float32": f32, "total": low + f32}


def greedy_run_to_run(cfg, params) -> dict:
    """Two greedy runs (DECODE_GREEDY) into decode_32k's cut cache:
    bitwise the same tokens and cache digests."""
    from repro_torch.launch.decode import greedy_decode
    model = lm.Model(cfg)
    p, n = DECODE_GREEDY
    prompts = decode_tokens(cfg, (DECODE_BATCH, p), SEED + 36, DEVICE)
    runs = []
    for _ in range(2):
        state = model.init_decode_state(DECODE_BATCH, decode_shape().seq_len,
                                        device=DEVICE)
        toks = greedy_decode(model, params, prompts, n,
                             decode_shape().seq_len, state=state)
        runs.append((fingerprint([toks]), fingerprint(state)))
        del state
        torch.cuda.empty_cache()
    check(runs[0] == runs[1], f"decode: {cfg.arch_id}: two greedy runs "
          f"differ")
    return dict(prompt=p, generated=n, tokens_digest=runs[0][0],
                cache_digests=runs[0][1], bitwise=True)


def decode_launcher_start(cfg) -> tuple:
    """``python -m repro_torch.launch.decode`` (full config, on the card)
    started in a subprocess, beside the decode phase's untimed work (a
    new process takes seconds to reach the card): (the process, its
    start time)."""
    b, p, n = DECODE_LAUNCHER
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.decode", "--arch",
         cfg.arch_id, "--batch", str(b), "--prompt-len", str(p), "--gen",
         str(n)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()


def decode_launcher_wait(started) -> tuple:
    """The launcher :func:`decode_launcher_start` started, ended: (its
    standard output, its seconds from the start)."""
    proc, t0 = started
    out, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"decode launcher: exit {proc.returncode}"
          f"\n{out[-2000:]}{err[-2000:]}")
    return out, time.perf_counter() - t0


def decode_launcher(cfg, out: str, wall_s: float) -> dict:
    """The launcher's output ``out``: its tokens, ``greedy_decode``'s on
    the same seeds."""
    from repro_torch.launch.decode import greedy_decode
    b, p, n = DECODE_LAUNCHER
    got = json.loads(out.strip().splitlines()[-1])["tokens"]
    model = lm.Model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    prompts = torch.randint(
        0, cfg.vocab, (b, p), dtype=torch.int32, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(1))
    want = greedy_decode(model, params, prompts, n, max_seq=p + n).tolist()
    del params
    torch.cuda.empty_cache()
    check(got == want, f"decode launcher: tokens {got} against "
          f"greedy_decode's {want}")
    return dict(args=[b, p, n], tokens_equal=True, wall_s=wall_s,
                printed=out.strip().splitlines()[0])


def decode_phase(card: str) -> dict:
    """The decode cell of the dense family on the card: LM_ARCH at full
    width and DECODE_LAYERS (bf16, weights from ``Model.init`` on a
    seeded generator) against decode_32k's cut cache: decode against
    prefill (held at CELLS_WEIGHT_STD's weights, recorded at
    ``Model.init``'s), the card against the CPU at CELLS_CHECK_LAYERS in
    float32, greedy run to run, the timed steps; LM_OLMO's timed steps;
    the launcher on the full config (started first, waited for before
    anything is timed). Every record carries the card's name and power
    limit."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = configs.get_config(LM_ARCH)
    launcher = decode_launcher_start(full)
    cfg = full.replace(n_layers=DECODE_LAYERS[LM_ARCH])
    rec = {"card": card, "layers": DECODE_LAYERS}
    try:
        std = scaled_params(cfg, SEED + 30, DEVICE, draw_device=DEVICE)
        r = decode_vs_prefill(cfg, std)
        del std
        r.update(rtol=DECODE_PREFILL_RTOL, weights=f"std {CELLS_WEIGHT_STD}",
                 tokens=[DECODE_BATCH, DECODE_PRIME])
        check(r["max_abs_diff"] <= DECODE_PREFILL_RTOL * r["max_abs_logit"],
              f"decode: {LM_ARCH} decode against prefill: {r}")
        rec["vs_prefill"] = r
        params = lm.Model(cfg).init(
            torch.Generator(device=DEVICE).manual_seed(SEED + 25))
        rec["vs_prefill_model_init"] = dict(
            decode_vs_prefill(cfg, params), held="no (recorded)")
        rec["greedy"] = greedy_run_to_run(cfg, params)
        launched = decode_launcher_wait(launcher)
    finally:
        host_stop(launcher[0])
    rec["timed"] = decode_timed(cfg, params)
    del params
    torch.cuda.empty_cache()
    emit({"decode": {"card": card, LM_ARCH: rec}})
    rec["card_vs_cpu"] = decode_card_vs_cpu(LM_ARCH)
    ocfg = configs.get_config(LM_OLMO).replace(
        n_layers=DECODE_LAYERS[LM_OLMO])
    params = lm.Model(ocfg).init(
        torch.Generator(device=DEVICE).manual_seed(SEED + 26))
    rec[LM_OLMO] = decode_timed(ocfg, params)
    del params
    torch.cuda.empty_cache()
    rec["launcher"] = decode_launcher(full, *launched)
    rec["phase_s"] = time.perf_counter() - t0
    emit({"decode": {"card": card, "card_vs_cpu": rec["card_vs_cpu"],
                     LM_OLMO: rec[LM_OLMO], "launcher": rec["launcher"],
                     "phase_s": rec["phase_s"]}})
    return rec


# the mixture of experts (ROADMAP.md §1 item 4(c)): MOE_ARCH at full width,
# MOE_LAYERS of its 94 layers (a full-width layer's float32 weights are
# 9.95 GB; a one-layer train step, ~60 GB of state before activations,
# does not fit one card, so training runs sharded on four cards, each
# rank a quarter), bf16 compute, weights from Model.init on a seeded
# generator: prefill_32k's 32,768 tokens (batch 32 -> 1, capacity 2560)
# bitwise run to run with its slots' drop share; decode_32k's cache cut to
# DECODE_BATCH, DECODE_TIMED sync-free steps; greedy run to run; decode
# against the prefill at the no-drop capacity (capacity_factor = E / k)
# and CELLS_WEIGHT_STD's weights within DECODE_PREFILL_RTOL; the card
# against the CPU at CELLS_CHECK_LAYERS in float32 on MOE_CPU_TOKENS (the
# expert ids equal wherever the CPU's routing margin exceeds MOE_MARGIN,
# the logits within DECODE_CPU_RTOL; a flip inside the margin reported);
# MOE_GROK at full width and MOE_GROK_LAYERS layer (prefill, capacity
# 10,240; timed decode steps); and MOE_ARCH sharded over every card
# (mesh_moe)
MOE_ARCH, MOE_GROK = "qwen3-moe-235b-a22b", "grok-1-314b"
MOE_LAYERS, MOE_GROK_LAYERS = 2, 1
MOE_CPU_TOKENS, MOE_MARGIN = (1, 64), 1e-6
# prefill logits positions each rank of a mesh of several keeps, for the
# meshes to be held against one another
MOE_MESH_SLICE = 64


def routing_records(fn, *args):
    """``fn(*args)`` with every routing the port's ``mlp.route`` makes
    recorded: ``(its output, [Routing, ...])``."""
    from repro_torch.models import mlp
    route, seen = mlp.route, []

    def recorded(logits, cfg):
        r = route(logits, cfg)
        seen.append(r)
        return r
    mlp.route = recorded
    try:
        out = fn(*args)
    finally:
        mlp.route = route
    return out, seen


def drop_shares(routes) -> list[float]:
    """Each routing's share of (token, slot) pairs past the capacity."""
    return [1.0 - float(r.keep.to(torch.float32).mean()) for r in routes]


def moe_prefill_run(cfg, params) -> dict:
    """The full-width prefill cell at prefill_32k's sequence,
    CELLS_PREFILL_BATCH sequence: finite logits of the right shape, twice
    bitwise (their :func:`digest`), the second run timed; each layer's
    capacity and drop share; ms, tokens/s and TFLOP/s against the hand
    count; the allocator's peak beside ``analyze()``."""
    shape = dataclasses.replace(configs.SHAPES["prefill_32k"],
                                global_batch=CELLS_PREFILL_BATCH)
    b, s = shape.global_batch, shape.seq_len
    cell = steps.build_cell(cfg, shape)
    batch = cell_batch(cfg, b, s, SEED + 41, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got, routes = routing_records(cell.step_fn, params, batch)
        check(tuple(got.shape) == (b, s, cfg.vocab)
              and bool(torch.isfinite(got).all()),
              f"moe: {cfg.arch_id} prefill logits {tuple(got.shape)} or not "
              f"finite")
        want = digest(got)
        del got
        again, ms = timed_run(cell.step_fn, params, batch)
        check(digest(again) == want, f"moe: {cfg.arch_id}: two prefills of "
              f"one batch differ")
        del again
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hand = cell_matmul_flops(cfg, b, s, False)
    torch.cuda.empty_cache()
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=b, seq=s,
        cut=f"prefill_32k's batch 32 -> {b}; {cfg.n_layers} layers",
        capacity=routes[0].capacity, drop_share=drop_shares(routes),
        bitwise_run_to_run=True, ms=ms, tokens_per_s=b * s / (ms / 1e3),
        flops_hand=hand, tflops_per_s=hand["total"] / (ms / 1e3) / 1e12,
        bound_ms={"bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                  "float32_at_67": hand["float32"] / F32_OPS_S * 1e3},
        peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, shape, CELLS_MESHES[0]))


def moe_vs_prefill(cfg) -> dict:
    """DECODE_PRIME tokens primed one at a time into decode_32k's cut cache
    against ``Model.forward`` on the same tokens, at the no-drop capacity
    (``capacity_factor = E / k``: nothing drops in either), weights at
    CELLS_WEIGHT_STD: in float32 with a float32 cache within
    DECODE_PREFILL_RTOL of the largest |logit| (held); in the config's
    bf16 with its bf16 cache (recorded: there the two paths' rounding
    moves router logits across the near ties of a token's 8th and 9th
    experts); in each, the tokens a layer whose experts differ between
    the two paths. Beside them, the share of slots the config's capacity
    drops in the prefill of those tokens and in one decode step."""
    free = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    k, L = cfg.top_k, cfg.n_layers
    tokens = decode_tokens(cfg, (DECODE_BATCH, DECODE_PRIME), SEED + 31,
                           DEVICE)
    out = dict(weights=f"std {CELLS_WEIGHT_STD}", rtol=DECODE_PREFILL_RTOL,
               tokens=[DECODE_BATCH, DECODE_PRIME],
               capacity_factor=free.capacity_factor)
    for dt, cache_dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        c = free.replace(compute_dtype=dt)
        model = lm.Model(c)
        params = scaled_params(c, SEED + 30, DEVICE, draw_device=DEVICE)
        got, dec = routing_records(primed_logits, model, params, tokens,
                                   decode_shape().seq_len, DEVICE, cache_dt)
        with torch.no_grad():
            want, pre = routing_records(model.forward, params,
                                        lm.Batch(tokens, None))
        differ = []
        for layer in range(L):
            p_e = pre[layer].gate_e.view(DECODE_BATCH, DECODE_PRIME, k)
            d_e = torch.stack([dec[t * L + layer].gate_e
                               for t in range(DECODE_PRIME)], dim=1)
            differ.append(int((torch.sort(p_e, -1).values
                               != torch.sort(d_e, -1).values).any(-1).sum()))
        out[dt] = dict(max_abs_diff=max_abs_diff(got, want),
                       max_abs_logit=max_abs(want), cache=str(cache_dt),
                       tokens_whose_experts_differ_by_layer=differ,
                       held=dt == "float32")
        del got, want, params
        torch.cuda.empty_cache()
    r = out["float32"]
    check(r["max_abs_diff"] <= DECODE_PREFILL_RTOL * r["max_abs_logit"],
          f"moe: {cfg.arch_id} decode against prefill at the no-drop "
          f"capacity, float32: {out}")
    model = lm.Model(cfg)
    params = scaled_params(cfg, SEED + 30, DEVICE, draw_device=DEVICE)
    with torch.no_grad():
        _, routes = routing_records(model.forward, params,
                                    lm.Batch(tokens, None))
        state = model.init_decode_state(DECODE_BATCH, DECODE_PRIME,
                                        device=DEVICE)
        _, droutes = routing_records(
            model.decode_step, params, state, lm.DecodeBatch(
                tokens[:, :1], torch.zeros((), dtype=torch.int32,
                                           device=DEVICE)))
    del params, state
    torch.cuda.empty_cache()
    out["drop_share_at_config"] = dict(
        capacity_factor=cfg.capacity_factor, prefill=drop_shares(routes),
        decode=drop_shares(droutes))
    return out


def routing_margins(r) -> torch.Tensor:
    """Each token's least gap among its k + 1 largest probabilities."""
    top = torch.sort(r.probs, dim=-1, descending=True).values[
        :, :r.gate_e.shape[1] + 1]
    return (top[:, :-1] - top[:, 1:]).amin(-1)


def moe_card_vs_cpu(arch: str) -> dict:
    """``arch`` at CELLS_CHECK_LAYERS in float32, weights at
    CELLS_WEIGHT_STD drawn on the card and copied to the CPU,
    ``Model.forward`` on MOE_CPU_TOKENS on both: every layer's expert ids
    equal wherever the CPU's routing margin exceeds MOE_MARGIN (a token
    whose experts differ inside it is reported with its margin); the
    logits within DECODE_CPU_RTOL of the largest |logit| where no token's
    experts differ."""
    cfg = configs.get_config(arch).replace(n_layers=CELLS_CHECK_LAYERS,
                                           compute_dtype="float32")
    model = lm.Model(cfg)
    card = scaled_params(cfg, SEED + 42, DEVICE, draw_device=DEVICE)
    cpu = cpu_tree(card)
    tokens = decode_tokens(cfg, MOE_CPU_TOKENS, SEED + 43, "cpu")
    with torch.no_grad():
        want, r_cpu = routing_records(model.forward, cpu,
                                      lm.Batch(tokens, None))
        got, r_card = routing_records(model.forward, card,
                                      lm.Batch(tokens.to(DEVICE), None))
    del card, cpu
    torch.cuda.empty_cache()
    flips, least = [], []
    for layer, (a, c) in enumerate(zip(r_cpu, r_card)):
        margin = routing_margins(a)
        least.append(float(margin.min()))
        differ = (a.gate_e != c.gate_e.cpu()).any(-1)
        for t in torch.arange(len(differ))[differ].tolist():
            flips.append(dict(layer=layer, token=t,
                              margin=float(margin[t])))
    check(all(f["margin"] <= MOE_MARGIN for f in flips),
          f"moe: {arch} card vs CPU: the experts of a token differ outside "
          f"the routing margin {MOE_MARGIN}: {flips}")
    rel = max_abs_diff(got.cpu(), want) / max_abs(want)
    out = dict(layers=cfg.n_layers, tokens=list(MOE_CPU_TOKENS),
               weights=f"std {CELLS_WEIGHT_STD}", margin_bound=MOE_MARGIN,
               least_margin_by_layer=least, flips=flips,
               expert_ids_equal=not flips, logits_rel_diff=rel,
               rtol=DECODE_CPU_RTOL)
    if not flips:
        check(rel <= DECODE_CPU_RTOL, f"moe: {arch} card vs CPU at "
              f"{CELLS_CHECK_LAYERS} layers, float32: {out}")
    return out


def mesh_moe(mesh, shape, world: int, root) -> dict:
    """MOE_ARCH at full width and MOE_LAYERS sharded on one mesh, in every
    rank, the weights drawn whole on the rank's card from the moe phase's
    seed and cut to this rank's blocks (on a (1, 1) mesh passed as they
    are): the prefill at prefill_32k's cut (the digest of its gathered
    logits for the parent to hold across ranks; on (1, 1) bitwise the
    unsharded prefill; on a mesh of several ranks, rank 0 keeps its first
    MOE_MESH_SLICE positions in ``root`` for the meshes to be held
    against one another); on (1, 1) the decode cell (bitwise the
    unsharded step's tokens and logits); on a mesh of several ranks the
    train step at train_4k's cut from a fresh AdamW state (a warm step,
    its collectives counted, and a second one from the same state,
    bitwise; the loss and the digests of the gathered parameters and
    moments); ms of each, the allocator's peak beside ``analyze()``."""
    cfg = configs.get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    model = lm.Model(cfg)
    one = tuple(shape) == (1, 1)
    what = f"sharded {MOE_ARCH} on a {shape} mesh"
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(
        SEED + 40))
    rec = dict(arch=MOE_ARCH, mesh=list(shape), layers=cfg.n_layers)
    prefill = cut_shape("prefill_32k")
    batch = cell_batch(cfg, prefill.global_batch, prefill.seq_len,
                       SEED + 41, DEVICE)
    if one:
        with torch.no_grad():
            want, rec["unsharded_prefill_ms"] = wall_ms(
                steps.build_cell(cfg, prefill).step_fn, params, batch)
        want = digest(want)
        torch.cuda.empty_cache()
        local = params
    else:
        local = model_common.local_params(params, model.param_specs(mesh),
                                          mesh)
        del params
        torch.cuda.empty_cache()
    pcell = steps.build_cell(cfg, prefill, mesh)
    pbatch = batch if one else steps.local_args(
        batch, pcell.in_shardings[1], mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, rec["prefill_ms"] = wall_ms(pcell.step_fn, local, pbatch)
        logits = sharding.whole_block(logits, pcell.out_shardings, mesh)
    rec["prefill_peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["prefill_digest"] = digest(logits)
    check(bool(torch.isfinite(logits).all()), f"{what}: prefill logits")
    if one:
        check(rec["prefill_digest"] == want, f"{what}: the (1, 1) prefill "
              f"differs from the unsharded one")
    elif torch.distributed.get_rank() == 0:
        torch.save(logits[:, :MOE_MESH_SLICE].float().cpu(),
                   pathlib.Path(root) / f"moe-{'x'.join(map(str, shape))}.pt")
    del logits, batch, pbatch
    torch.cuda.empty_cache()
    if one:
        rec["decode"] = mesh_moe_decode(model, local, mesh, what)
    else:
        rec["train"] = mesh_moe_train(model, local, mesh, what)
    rec.update(bitwise_vs_unsharded=one or "not held (a mesh of several "
               "ranks; the meshes are held against one another)")
    del local
    torch.cuda.empty_cache()
    return rec


def mesh_moe_decode(model, params, mesh, what: str) -> dict:
    """The (1, 1) decode cell against the unsharded one on one state: the
    next tokens' and the whole logits' digests equal; ms of each."""
    cfg = model.cfg
    dshape = decode_shape()
    rules = dict(sharding.DEFAULT_RULES)
    cell = steps.build_cell(cfg, dshape, mesh, rules)
    plain = steps.build_cell(cfg, dshape)
    state = filled_state(model, DECODE_BATCH, dshape.seq_len, SEED + 34,
                         DEVICE)
    db = lm.DecodeBatch(
        decode_tokens(cfg, (DECODE_BATCH, 1), SEED + 35, DEVICE),
        torch.tensor(dshape.seq_len - 1, dtype=torch.int32, device=DEVICE))
    (tokens, _), plain_ms = wall_ms(plain.step_fn, params, state, db)
    want = dict(tokens=digest(tokens), logits=digest(decode_logits(
        model, params, state, db, None, None, None)))
    (tokens, _), ms = wall_ms(cell.step_fn, params, state, db)
    got = dict(tokens=digest(tokens), logits=digest(decode_logits(
        model, params, state, db, cell, mesh, rules)))
    check(got == want, f"{what}: the (1, 1) decode step differs from the "
          f"unsharded step")
    del state
    torch.cuda.empty_cache()
    return dict(batch=DECODE_BATCH, cache=dshape.seq_len, digests=got,
                ms=ms, unsharded_ms=plain_ms)


def mesh_moe_train(model, params, mesh, what: str) -> dict:
    """The sharded train step at train_4k's cut on this rank's blocks
    from a fresh AdamW state: a warm step (collectives counted, the peak
    beside ``analyze()`` on the mesh), then a second one from the same
    state, bitwise (:func:`fingerprint`); the loss and the digests of the
    gathered parameters and moments."""
    cfg = model.cfg
    train = cut_shape("train_4k")
    cell = steps.build_cell(cfg, train, mesh)
    state = steps.make_optimizer(cfg).init(params)
    batch = steps.local_args(cell_batch(cfg, train.global_batch,
                                        train.seq_len, SEED + 22, DEVICE),
                             cell.in_shardings[2], mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    with sharding.count_collectives() as coll:
        warm, first_ms = wall_ms(cell.step_fn, params, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(warm[2])
    check(math.isfinite(loss), f"{what}: loss {loss}")
    p_sh, opt_sh, _ = cell.out_shardings
    want = fingerprint(list(warm))
    digests = dict(params=whole_digests(warm[0], p_sh, mesh),
                   mu=whole_digests(warm[1].mu, opt_sh.mu, mesh),
                   nu=whole_digests(warm[1].nu, opt_sh.nu, mesh))
    del warm
    torch.cuda.empty_cache()
    out, ms = wall_ms(cell.step_fn, params, state, batch)
    check(fingerprint(list(out)) == want,
          f"{what}: two train steps from one state differ")
    del out, state
    torch.cuda.empty_cache()
    return dict(tokens=[train.global_batch, train.seq_len], loss=loss,
                digests=digests, run_to_run_bitwise=True,
                first_step_ms=first_ms, ms=ms,
                collectives_per_step=dict(calls=coll.calls,
                                          bytes=coll.bytes),
                allocated_before_gb=before_gb, peak_allocated_gb=peak_gb,
                memory_model=memory_record(cfg, train,
                                           sharding.mesh_shape(mesh)))


def moe_world() -> dict:
    """MOE_ARCH sharded (:func:`mesh_moe`) in an NCCL world of every card
    of the host (:func:`run_world`): every rank's digests and losses the
    same on each mesh; on several meshes, their losses within CELLS_TOL's
    bf16 loss bound of the first mesh's and their prefill logits' first
    MOE_MESH_SLICE positions within CASCADE_BF16_RTOL of its largest
    |logit|."""
    root = ROOT / "build" / "moe_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    world = torch.cuda.device_count()
    ranks, world_s = run_world(root, world, "moe")
    def held(rec):
        return (rec["prefill_digest"], rec.get("decode", {}).get("digests"),
                rec.get("train", {}).get("loss"),
                rec.get("train", {}).get("digests"))
    for i, rec in enumerate(ranks[0]):
        check(all(held(r[i]["moe"]) == held(rec["moe"]) for r in ranks[1:]),
              f"sharded {MOE_ARCH} on a {rec['mesh']} mesh: the prefill "
              f"logits, the decode step, the loss or the gathered "
              f"parameters or moments differ between ranks")
    across = "one mesh"
    if len(ranks[0]) > 1:
        first = ranks[0][0]["moe"]
        key0 = "x".join(map(str, first["mesh"]))
        ref = torch.load(root / f"moe-{key0}.pt")
        across = {}
        for rec in ranks[0][1:]:
            key = "x".join(map(str, rec["moe"]["mesh"]))
            got = torch.load(root / f"moe-{key}.pt")
            r = dict(loss_rel_diff=abs(rec["moe"]["train"]["loss"]
                                       - first["train"]["loss"])
                     / abs(first["train"]["loss"]),
                     logits_rel_diff=max_abs_diff(got, ref) / max_abs(ref))
            check(r["loss_rel_diff"] <= CELLS_TOL["bfloat16"][0]
                  and r["logits_rel_diff"] <= CASCADE_BF16_RTOL,
                  f"sharded {MOE_ARCH}: the {key} mesh against the {key0} "
                  f"one: {r}")
            across[f"{key}_vs_{key0}"] = r
    shutil.rmtree(root, ignore_errors=True)
    return dict(world=world, ranks=ranks, meshes_agree=across,
                world_s=world_s)


def moe_phase(card: str) -> dict:
    """The mixture of experts on the card: MOE_ARCH sharded over every
    card (:func:`moe_world`, first, while this process holds nothing on
    the card); MOE_ARCH at full width and MOE_LAYERS layers: the prefill,
    the timed decode steps, greedy run to run, decode against prefill at
    the no-drop capacity, the card against the CPU; MOE_GROK at full
    width and MOE_GROK_LAYERS layer: the prefill and the timed decode
    steps. Every record carries the card's name and power limit; the
    phase's wall seconds are printed."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = {"card": card, "mesh": moe_world()}
    emit({"moe": {"card": card, "mesh": rec["mesh"]}})
    cfg = configs.get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    params = lm.Model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(SEED + 40))
    r = dict(cut=f"{MOE_LAYERS} of 94 layers",
             prefill=moe_prefill_run(cfg, params))
    r["timed"] = decode_timed(cfg, params)
    r["greedy"] = greedy_run_to_run(cfg, params)
    del params
    torch.cuda.empty_cache()
    r["vs_prefill"] = moe_vs_prefill(cfg)
    r["card_vs_cpu"] = moe_card_vs_cpu(MOE_ARCH)
    rec[MOE_ARCH] = r
    emit({"moe": {"card": card, MOE_ARCH: r}})
    gcfg = configs.get_config(MOE_GROK).replace(n_layers=MOE_GROK_LAYERS)
    params = lm.Model(gcfg).init(
        torch.Generator(device=DEVICE).manual_seed(SEED + 44))
    rec[MOE_GROK] = dict(cut=f"{MOE_GROK_LAYERS} of 64 layers",
                         prefill=moe_prefill_run(gcfg, params),
                         timed=decode_timed(gcfg, params))
    del params
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    emit({"moe": {"card": card, MOE_GROK: rec[MOE_GROK],
                  "phase_s": rec["phase_s"]}})
    return rec


# the hybrid (ROADMAP.md §1 item 4(d)): HYBRID_ARCH at full width and
# HYBRID_TIMED_LAYERS of its 38 Mamba-2 layers (the shared attention + MLP
# block after every 6th), bf16 compute, remat "full", weights from
# Model.init on a seeded generator: the train step at train_4k's sequence (batch 256 ->
# CELLS_TRAIN_BATCH), bitwise run to run, also under deterministic
# algorithms; the prefill at prefill_32k's (batch 32 ->
# CELLS_PREFILL_BATCH), bitwise Model.forward; the card against the CPU
# at HYBRID_CHECK_LAYERS (one group and one shared-block call; the
# cells' CELLS_CHECK_LAYERS would stop before the first block) on
# HYBRID_CHECK_TOKENS (two SSD chunks), weights at CELLS_WEIGHT_STD,
# float32 and bf16 within CELLS_TOL; decode_32k's state cut to
# DECODE_BATCH and long_500k's uncut, DECODE_TIMED sync-free steps each;
# greedy run to run; decode against Model.forward over DECODE_PRIME
# tokens in float32 with float32 buffers and caches at CELLS_WEIGHT_STD
# within DECODE_CPU_RTOL (the bf16 buffers' difference recorded); the
# decode card against the CPU at HYBRID_CHECK_LAYERS; and HYBRID_ARCH at
# HYBRID_MESH_LAYERS (two groups, two shared-block calls) sharded over
# every card (hybrid_world)
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_CHECK_LAYERS, HYBRID_CHECK_TOKENS = 6, (1, 512)
HYBRID_MESH_LAYERS = 12
# the timed train step, prefill and decode steps run HYBRID_TIMED_LAYERS
# of the 38 (one group and one shared-block call, the card-vs-CPU check's
# depth) to make room for the examples phase: on H100 hosts they took
# 32.2 s at full depth, 11.2 s at 12 layers on a slower host and 6.5 s
# at 6, and the examples phase 20.7-28.8 s; decode against
# Model.forward and the counts on meta tensors stay at full depth
HYBRID_TIMED_LAYERS = HYBRID_CHECK_LAYERS


def hybrid_train_run(cfg, params) -> dict:
    """The full-width train cell at train_4k's sequence, CELLS_TRAIN_BATCH
    sequences: a warm step, then CELLS_TIMED timed steps from the same
    state, each bitwise the warm one (:func:`fingerprint`), and one more
    under ``torch.use_deterministic_algorithms(True)`` (``warn_only``; an
    op flagged fails), bitwise too; one step profiled; ms, tokens/s and
    TFLOP/s against the hand count (:func:`hybrid_matmul_flops`), the
    allocator's peak beside ``analyze()``."""
    shape = cut_shape("train_4k")
    b, s = shape.global_batch, shape.seq_len
    step = steps.build_cell(cfg, shape).step_fn
    state = steps.make_optimizer(cfg).init(params)
    batch = cell_batch(cfg, b, s, SEED + 22, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    warm, first_ms = timed_run(step, params, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(warm[2])
    check(math.isfinite(loss), f"hybrid: {cfg.arch_id} train loss {loss}")
    want = fingerprint(list(warm))
    del warm
    ms = []
    for _ in range(CELLS_TIMED):
        out, t = timed_run(step, params, state, batch)
        ms.append(t)
        check(fingerprint(list(out)) == want, f"hybrid: {cfg.arch_id}: two "
              f"train steps from one state differ")
        del out
    before = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            same = fingerprint(list(step(params, state, batch))) == want
        finally:
            torch.use_deterministic_algorithms(before)
    flagged = sorted({str(w.message)[:160] for w in seen
                      if "deterministic implementation" in str(w.message)})
    check(not flagged and same, f"hybrid: {cfg.arch_id}: under "
          f"deterministic algorithms the step differs or flags {flagged}")
    prof = device_profile(lambda: step(params, state, batch))
    hand = hybrid_matmul_flops(cfg, b, s, "train")
    step_ms = statistics.median(ms)
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=b, seq=s,
        cut=f"train_4k's batch 256 -> {b}", loss=loss,
        first_step_ms=first_ms, ms_per_step=ms, median_ms=step_ms,
        tokens_per_s=b * s / (step_ms / 1e3), flops_hand=hand,
        tflops_per_s=hand["total"] / (step_ms / 1e3) / 1e12,
        bound_ms={"bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                  "float32_at_67": hand["float32"] / F32_OPS_S * 1e3},
        bitwise_run_to_run=True, deterministic_algorithms=dict(
            bitwise=True, nondeterministic_ops=flagged),
        allocated_before_gb=before_gb, peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, shape, CELLS_MESHES[0]),
        profile=prof)


def hybrid_check_inputs(dt: str):
    """HYBRID_ARCH at HYBRID_CHECK_LAYERS in ``dt``: its config, and its
    weights at CELLS_WEIGHT_STD and its HYBRID_CHECK_TOKENS batch, both
    drawn on the CPU from seeds (the same in every process)."""
    cfg = configs.get_config(HYBRID_ARCH).replace(
        n_layers=HYBRID_CHECK_LAYERS, compute_dtype=dt)
    return (cfg, scaled_params(cfg, SEED + 53, "cpu"),
            cell_batch(cfg, *HYBRID_CHECK_TOKENS, SEED + 54, "cpu"))


def hybrid_cpu_side(path: str) -> str:
    """The CPU side of :func:`hybrid_card_vs_cpu`, for a subprocess on the
    host's CPU (it runs no card): in each of CELLS_TOL's dtypes the loss,
    the gradients and the prefill logits of :func:`hybrid_check_inputs`,
    saved to ``path``, on half the host's cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    out = {}
    for dt in CELLS_TOL:
        cfg, params, batch = hybrid_check_inputs(dt)
        model = lm.Model(cfg)
        loss, grads = steps.loss_and_grads(model, params, batch)
        with torch.no_grad():
            logits = model.forward(params, batch)
        out[dt] = dict(loss=loss, grads=grads, logits=logits)
    torch.save(out, path)
    return path


def hybrid_card_vs_cpu(cpu: dict) -> dict:
    """HYBRID_ARCH at HYBRID_CHECK_LAYERS (one group of Mamba layers and
    one shared-block call), weights at CELLS_WEIGHT_STD drawn on the CPU,
    on HYBRID_CHECK_TOKENS, in float32 and bf16 (remat "full"):
    ``loss_and_grads`` and the prefill logits on the card against
    ``cpu``, :func:`hybrid_cpu_side`'s record of the same on the CPU; the
    loss within CELLS_TOL's loss bound (relative) and each gradient leaf
    and the logits within its gradient bound of their largest
    |entry|."""
    out = {}
    for dt, (loss_tol, grad_tol) in CELLS_TOL.items():
        cfg, params, batch = hybrid_check_inputs(dt)
        model = lm.Model(cfg)
        card = model_common.tree_map(lambda a: a.to(DEVICE), params)
        batch = batch_to(batch, DEVICE)
        loss, grads = steps.loss_and_grads(model, card, batch)
        with torch.no_grad():
            got = model.forward(card, batch).cpu()
        want = cpu[dt]
        r = dict(layers=cfg.n_layers, tokens=list(HYBRID_CHECK_TOKENS),
                 loss=float(want["loss"]),
                 loss_rel_diff=abs(float(loss) - float(want["loss"]))
                 / abs(float(want["loss"])),
                 grad_rel_diff=leaf_errs(grads, want["grads"]),
                 logits_rel_diff=max_abs_diff(got, want["logits"])
                 / max_abs(want["logits"]),
                 loss_rtol=loss_tol, grad_rtol=grad_tol)
        check(r["loss_rel_diff"] <= loss_tol and r["grad_rel_diff"] <=
              grad_tol and r["logits_rel_diff"] <= grad_tol,
              f"hybrid: card vs CPU {dt} at {cfg.n_layers} layers: {r}")
        out[dt] = r
        del card, grads, got
        torch.cuda.empty_cache()
    return out


def hybrid_vs_prefill() -> dict:
    """DECODE_PRIME tokens of DECODE_BATCH sequences primed one at a time
    against ``Model.forward`` on them, HYBRID_ARCH at full width and depth
    in float32, weights at CELLS_WEIGHT_STD: with float32 buffers and
    caches within DECODE_CPU_RTOL of the largest |logit| (held); with
    the model's bf16 ones, which round even the current token's ``xBC``
    before the convolution, recorded."""
    cfg = configs.get_config(HYBRID_ARCH).replace(compute_dtype="float32")
    model = lm.Model(cfg)
    params = scaled_params(cfg, SEED + 55, DEVICE, draw_device=DEVICE)
    tokens = decode_tokens(cfg, (DECODE_BATCH, DECODE_PRIME), SEED + 56,
                           DEVICE)
    with torch.no_grad():
        want = model.forward(params, lm.Batch(tokens, None))
    out = dict(weights=f"std {CELLS_WEIGHT_STD}", compute="float32",
               tokens=[DECODE_BATCH, DECODE_PRIME], rtol=DECODE_CPU_RTOL,
               max_abs_logit=max_abs(want))
    for name, dt in (("float32_states", torch.float32),
                     ("bf16_states", torch.bfloat16)):
        got = primed_logits(model, params, tokens, DECODE_PRIME, DEVICE, dt)
        out[name] = dict(max_abs_diff=max_abs_diff(got, want),
                         held=dt == torch.float32)
        del got
    check(out["float32_states"]["max_abs_diff"]
          <= DECODE_CPU_RTOL * out["max_abs_logit"],
          f"hybrid: decode against prefill with float32 states: {out}")
    del params, want
    torch.cuda.empty_cache()
    return out


def hybrid_decode(cfg, params) -> dict:
    """The decode cell at decode_32k's state cut to DECODE_BATCH and at
    long_500k's uncut (:func:`decode_timed`: sync-free timed steps beside
    the bytes bound, the peak beside ``analyze()``), and two greedy runs
    bitwise (:func:`greedy_run_to_run`)."""
    out = dict(decode_32k=decode_timed(cfg, params))
    torch.cuda.empty_cache()
    out["long_500k"] = decode_timed(cfg, params,
                                    shape=configs.SHAPES["long_500k"])
    torch.cuda.empty_cache()
    out["greedy"] = greedy_run_to_run(cfg, params)
    torch.cuda.empty_cache()
    return out


def mesh_hybrid(mesh, shape, world: int, root) -> dict:
    """HYBRID_ARCH at full width and HYBRID_MESH_LAYERS sharded on one
    mesh, in every rank, the weights drawn whole on the rank's card from
    a seed at CELLS_WEIGHT_STD (at ``Model.init``'s scale the random
    hybrid's bf16 logits lie 50% of the largest |logit| off its float32
    ones at the smoke width, so no two layouts could be held to 5%; at
    0.02, 1.3%) and cut to this rank's blocks (on a (1, 1) mesh passed as
    they are): the train step at train_4k's cut from a fresh AdamW state (its
    collectives counted; the loss and the digests of the gathered
    parameters and moments; a second step from the same state bitwise),
    the prefill at prefill_32k's cut (the digest of its gathered logits;
    on a mesh of several ranks rank 0 keeps its first MOE_MESH_SLICE
    positions in ``root``) and the decode step at decode_32k's cut (the
    digests of the next tokens and of the whole logits). On (1, 1) each
    is held bitwise the unsharded cell's on the same card. ms of each,
    the peaks beside ``analyze()``."""
    cfg = configs.get_config(HYBRID_ARCH).replace(
        n_layers=HYBRID_MESH_LAYERS)
    model = lm.Model(cfg)
    one = tuple(shape) == (1, 1)
    what = f"sharded {HYBRID_ARCH} on a {shape} mesh"
    torch.cuda.empty_cache()
    params = scaled_params(cfg, SEED + 57, DEVICE, draw_device=DEVICE)
    train, prefill, dshape = (cut_shape("train_4k"),
                              cut_shape("prefill_32k"), decode_shape())
    tbatch = cell_batch(cfg, train.global_batch, train.seq_len, SEED + 22,
                        DEVICE)
    pbatch = cell_batch(cfg, prefill.global_batch, prefill.seq_len,
                        SEED + 23, DEVICE)
    db = lm.DecodeBatch(
        decode_tokens(cfg, (DECODE_BATCH, 1), SEED + 35, DEVICE),
        torch.tensor(dshape.seq_len - 1, dtype=torch.int32, device=DEVICE))
    rec = dict(arch=HYBRID_ARCH, mesh=list(shape), layers=cfg.n_layers)
    want = {}
    if one:
        out, rec["unsharded_train_ms"] = wall_ms(
            steps.build_cell(cfg, train).step_fn, params,
            steps.make_optimizer(cfg).init(params), tbatch)
        want["train"] = fingerprint(list(out))
        del out
        with torch.no_grad():
            logits, rec["unsharded_prefill_ms"] = wall_ms(
                steps.build_cell(cfg, prefill).step_fn, params, pbatch)
        want["prefill"] = digest(logits)
        del logits
        want["decode"], rec["unsharded_decode_ms"] = hybrid_decode_digests(
            model, params, db, None, None)
        torch.cuda.empty_cache()
        local = params
    else:
        local = model_common.local_params(params, model.param_specs(mesh),
                                          mesh)
        del params
        torch.cuda.empty_cache()

    # the train step
    cell = steps.build_cell(cfg, train, mesh)
    ostate = steps.make_optimizer(cfg).init(local)
    b = tbatch if one else steps.local_args(tbatch, cell.in_shardings[2],
                                            mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with sharding.count_collectives() as coll:
        out, first_ms = wall_ms(cell.step_fn, local, ostate, b)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(out[2])
    check(math.isfinite(loss), f"{what}: loss {loss}")
    got = fingerprint(list(out))
    if one:
        check(got == want["train"], f"{what}: the (1, 1) train step "
              f"differs from the unsharded one")
    p_sh, opt_sh, _ = cell.out_shardings
    digests = dict(params=whole_digests(out[0], p_sh, mesh),
                   mu=whole_digests(out[1].mu, opt_sh.mu, mesh),
                   nu=whole_digests(out[1].nu, opt_sh.nu, mesh))
    del out
    torch.cuda.empty_cache()
    again, ms = wall_ms(cell.step_fn, local, ostate, b)
    check(fingerprint(list(again)) == got,
          f"{what}: two train steps from one state differ")
    del again, ostate, b
    torch.cuda.empty_cache()
    rec["train"] = dict(
        tokens=[train.global_batch, train.seq_len], loss=loss,
        digests=digests, run_to_run_bitwise=True, first_step_ms=first_ms,
        ms=ms, collectives_per_step=dict(calls=coll.calls, bytes=coll.bytes),
        peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, train, sharding.mesh_shape(mesh)))

    # the prefill
    pcell = steps.build_cell(cfg, prefill, mesh)
    pb = pbatch if one else steps.local_args(pbatch, pcell.in_shardings[1],
                                             mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, rec["prefill_ms"] = wall_ms(pcell.step_fn, local, pb)
        logits = sharding.whole_block(logits, pcell.out_shardings, mesh)
    rec["prefill_peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["prefill_digest"] = digest(logits)
    check(bool(torch.isfinite(logits).all()), f"{what}: prefill logits")
    if one:
        check(rec["prefill_digest"] == want["prefill"], f"{what}: the "
              f"(1, 1) prefill differs from the unsharded one")
    elif torch.distributed.get_rank() == 0:
        torch.save(logits[:, :MOE_MESH_SLICE].float().cpu(), pathlib.Path(
            root) / f"hybrid-{'x'.join(map(str, shape))}.pt")
    del logits, pb
    torch.cuda.empty_cache()

    # the decode step
    rec["decode_digests"], rec["decode_ms"] = hybrid_decode_digests(
        model, local, db, mesh, steps.build_cell(
            cfg, dshape, mesh, dict(sharding.DEFAULT_RULES)))
    if one:
        check(rec["decode_digests"] == want["decode"], f"{what}: the "
              f"(1, 1) decode step differs from the unsharded one")
    del local
    torch.cuda.empty_cache()
    rec.update(bitwise_vs_unsharded=one or "not held (a mesh of several "
               "ranks; the meshes are held against one another)")
    return rec


def hybrid_decode_digests(model, params, db, mesh, cell):
    """The decode step at decode_32k's cut from a filled state (unsharded
    with ``mesh`` None, else ``cell``'s on this rank's blocks of it, and
    ``params`` this rank's blocks), and
    its logits from a state filled again (the step writes the recurrent
    state in place): the digests of the next tokens and of the whole
    logits, and the step's ms."""
    cfg, dshape = model.cfg, decode_shape()

    def whole():
        return filled_state(model, DECODE_BATCH, dshape.seq_len, SEED + 34,
                            DEVICE)
    if mesh is None:
        (tokens, _), ms = wall_ms(steps.build_cell(cfg, dshape).step_fn,
                                  params, whole(), db)
        logits = decode_logits(model, params, whole(), db, None, None, None)
        return dict(tokens=digest(tokens), logits=digest(logits)), ms
    rules = dict(sharding.DEFAULT_RULES)
    _, st_sh, db_sh = cell.in_shardings
    ldb = steps.local_args(db, db_sh, mesh)
    (tokens, _), ms = wall_ms(cell.step_fn, params, steps.local_args(
        whole(), st_sh, mesh), ldb)
    tokens = sharding.whole_block(tokens, cell.out_shardings[0], mesh)
    logits = decode_logits(model, params, steps.local_args(
        whole(), st_sh, mesh), ldb, cell, mesh, rules)
    return dict(tokens=digest(tokens), logits=digest(logits)), ms


def hybrid_world() -> dict:
    """HYBRID_ARCH sharded (:func:`mesh_hybrid`) in an NCCL world of every
    card of the host (:func:`run_world`): every rank's digests and losses
    the same on each mesh; on several meshes, their losses within
    CELLS_TOL's bf16 loss bound of the first mesh's ((1, world)) and
    their prefill logits' first MOE_MESH_SLICE positions within
    CASCADE_BF16_RTOL of its largest |logit|."""
    root = ROOT / "build" / "hybrid_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    world = torch.cuda.device_count()
    ranks, world_s = run_world(root, world, "hybrid")

    def held(rec):
        return (rec["prefill_digest"], rec["decode_digests"],
                rec["train"]["loss"], rec["train"]["digests"])
    for i, rec in enumerate(ranks[0]):
        check(all(held(r[i]["hybrid"]) == held(rec["hybrid"])
                  for r in ranks[1:]),
              f"sharded {HYBRID_ARCH} on a {rec['mesh']} mesh: the train "
              f"step, the prefill or the decode step differ between ranks")
    across = "one mesh"
    if len(ranks[0]) > 1:
        first = ranks[0][0]["hybrid"]
        key0 = "x".join(map(str, first["mesh"]))
        ref = torch.load(root / f"hybrid-{key0}.pt")
        across = {}
        for rec in ranks[0][1:]:
            key = "x".join(map(str, rec["hybrid"]["mesh"]))
            got = torch.load(root / f"hybrid-{key}.pt")
            r = dict(loss_rel_diff=abs(rec["hybrid"]["train"]["loss"]
                                       - first["train"]["loss"])
                     / abs(first["train"]["loss"]),
                     logits_rel_diff=max_abs_diff(got, ref) / max_abs(ref))
            check(r["loss_rel_diff"] <= CELLS_TOL["bfloat16"][0]
                  and r["logits_rel_diff"] <= CASCADE_BF16_RTOL,
                  f"sharded {HYBRID_ARCH}: the {key} mesh against the "
                  f"{key0} one: {r}")
            across[f"{key}_vs_{key0}"] = r
    shutil.rmtree(root, ignore_errors=True)
    return dict(world=world, ranks=ranks, meshes_agree=across,
                world_s=world_s)


def host_start(call: str):
    """``chip_smoke.<call>`` in a subprocess on the host's CPU (the call
    runs no card), beside the card's work; the JSON of its result is read
    by :func:`host_wait`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = f"import json, chip_smoke; print(json.dumps(chip_smoke.{call}))"
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def host_wait(proc, what: str):
    """The result of :func:`host_start`'s process once it ends (exit 0:
    its checks passed)."""
    out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}\n"
          f"{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def host_stop(*procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def hybrid_helpers() -> tuple:
    """The hybrid phase's two subprocesses on the host's CPU
    (:func:`host_start`): the train and prefill cells counted on meta
    tensors and the CPU side of the card-vs-CPU check; ``(counting,
    cpu_side, the path the CPU side writes)``."""
    cpu_path = ROOT / "build" / "hybrid_cpu.pt"
    cpu_path.parent.mkdir(parents=True, exist_ok=True)
    return (host_start(f"cells_counted({HYBRID_ARCH!r})"),
            host_start(f"hybrid_cpu_side({str(cpu_path)!r})"), cpu_path)


def hybrid_phase(card: str, helpers: tuple | None = None) -> dict:
    """The hybrid on the card: HYBRID_ARCH sharded over every card
    (:func:`hybrid_world`, first, while this process holds nothing on the
    card); at full width and HYBRID_TIMED_LAYERS the train step, the
    prefill, the decode steps at decode_32k's cut and long_500k uncut,
    greedy run to run; at full depth decode against prefill; the card
    against the CPU at HYBRID_CHECK_LAYERS. Two subprocesses on the host's CPU
    (:func:`hybrid_helpers`, ``helpers`` where the caller started them a
    phase early) run beside the sharded world and the train step,
    both device-bound, and are waited for before the prefill and the
    decode steps are timed: the CPU side of the card-vs-CPU check
    (:func:`hybrid_cpu_side`), and the train and prefill cells counted on
    meta tensors at full batch (:func:`cells_counted`: FLOPs equal to
    the hand count, ``analyze()`` on one card and the production meshes;
    and for the decode shapes). Every record carries the card's name and
    power limit; the phase's wall seconds, and each part's, are
    printed."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    part_s = {}
    counting, cpu_side, cpu_path = helpers or hybrid_helpers()
    try:
        rec = {"card": card, "mesh": hybrid_world()}
        part_s["mesh"] = time.perf_counter() - t0
        emit({"hybrid": {"card": card, "mesh": rec["mesh"]}})
        cfg = configs.get_config(HYBRID_ARCH)
        timed = cfg.replace(n_layers=HYBRID_TIMED_LAYERS)
        params = lm.Model(timed).init(
            torch.Generator(device=DEVICE).manual_seed(SEED + 50))
        t = time.perf_counter()
        rec["train"] = hybrid_train_run(timed, params)
        torch.cuda.empty_cache()
        part_s["train"] = time.perf_counter() - t
        t = time.perf_counter()
        cpu = torch.load(host_wait(cpu_side, "hybrid: the CPU side of card "
                                   "vs CPU"), weights_only=False)
        cpu_path.unlink()
        rec["counted"] = host_wait(counting, f"{HYBRID_ARCH}'s cells "
                                   f"counted")
        part_s["host_wait"] = time.perf_counter() - t
    finally:
        host_stop(counting, cpu_side)
    for name, r in rec["counted"].items():
        check(r["flops"] == r["flops_hand"]["total"], f"{HYBRID_ARCH} "
              f"{name} counts {r['flops']} FLOPs, hand count "
              f"{r['flops_hand']}")
    rec["counted"]["memory_decode"] = {
        name: {"x".join(map(str, m.values())): memory_record(
            cfg, configs.SHAPES[name], m) for m in CELLS_MESHES}
        for name in ("decode_32k", "long_500k")}
    t = time.perf_counter()
    rec["prefill"] = prefill_cell_run(timed, params)
    rec["prefill"]["tokens_per_s"] = (
        CELLS_PREFILL_BATCH * configs.SHAPES["prefill_32k"].seq_len
        / (rec["prefill"]["ms"] / 1e3))
    torch.cuda.empty_cache()
    part_s["prefill"] = time.perf_counter() - t
    emit({"hybrid": {"card": card, "train": rec["train"],
                     "prefill": rec["prefill"]}})
    t = time.perf_counter()
    rec["decode"] = hybrid_decode(timed, params)
    del params
    torch.cuda.empty_cache()
    part_s["decode"] = time.perf_counter() - t
    emit({"hybrid": {"card": card, "decode": rec["decode"]}})
    for name, fn in (("vs_prefill", hybrid_vs_prefill),
                     ("card_vs_cpu", lambda: hybrid_card_vs_cpu(cpu)),
                     ("decode_card_vs_cpu", lambda: decode_card_vs_cpu(
                         HYBRID_ARCH, HYBRID_CHECK_LAYERS))):
        t = time.perf_counter()
        rec[name] = fn()
        part_s[name] = time.perf_counter() - t
    rec["phase_s"] = time.perf_counter() - t0
    emit({"hybrid": {"card": card, "counted": rec["counted"],
                     "vs_prefill": rec["vs_prefill"],
                     "card_vs_cpu": rec["card_vs_cpu"],
                     "decode_card_vs_cpu": rec["decode_card_vs_cpu"],
                     "part_s": part_s, "phase_s": rec["phase_s"]}})
    return rec


# the xLSTM (ROADMAP.md §1 item 4(e)): XLSTM_ARCH at full width and depth
# (24 blocks: 21 mLSTM, 3 sLSTM; bf16, remat "full", Model.init's weights
# on a seeded generator); the card against the CPU at XLSTM_CHECK_LAYERS
# (one sLSTM block) on XLSTM_CHECK_TOKENS, weights at CELLS_WEIGHT_STD,
# within XLSTM_CPU_TOL (loss relative; logits and each gradient leaf of
# their largest |entry|: float32 logits at the gradients' bound, since the
# check's own float32 error against float64 is 7.3e-6 of the largest
# |logit| and a 1e-7 relative change of the weights moves them 8.1e-6,
# measured on the CPU); decode states reached by XLSTM_REACH decode steps
# from zeros; the prefill warmed up, and checked bitwise against
# Model.forward, at XLSTM_WARM_SEQ; sharded over every card at
# XLSTM_MESH_LAYERS, the meshes' losses and bf16 prefill logits held
# within XLSTM_MESH_TOL of the first mesh's (the logits at the hybrid's
# CASCADE_BF16_RTOL: (2, 2) lay 2.34% off (1, 4) on four H100s)
XLSTM_ARCH = "xlstm-350m"
XLSTM_CHECK_LAYERS, XLSTM_CHECK_TOKENS = 8, (1, 512)
XLSTM_CPU_TOL = {"float32": {"loss": 1e-6, "logits": 1e-4, "grads": 1e-4},
                 "bfloat16": {"loss": 5e-2, "logits": 5e-2, "grads": 5e-2}}
XLSTM_REACH, XLSTM_MESH_LAYERS, XLSTM_WARM_SEQ = 4, 8, 4096
# the timed train step and prefill run XLSTM_TIMED_LAYERS of the 24 blocks
# (one sLSTM of three: the sLSTM loop is host-bound, ~20 s a step at full
# depth) to make room for the loop phase; decode and the counts on meta
# tensors stay at full depth
XLSTM_TIMED_LAYERS = 8
XLSTM_MESH_TOL = {"loss": 1e-4, "logits": CASCADE_BF16_RTOL}


def xlstm_matmul_flops(cfg, b: int, s: int, kind: str, model: int = 1,
                       data: int = 1) -> dict:
    """Hand count of an xLSTM cell's products (``kind`` train, prefill or
    decode), split as :func:`cell_matmul_flops` splits them. Per mLSTM
    block the bf16 ``w_up``, ``wq``, ``wk``, ``wv``, ``w_i``, ``w_f`` and
    ``w_down``, and the float32 chunkwise form by chunk of ``q =
    min(ssm_chunk, s)`` (``S_c = (ws k)^T v``, ``q k^T``, ``(qk s_intra)
    v``, ``q C_prev``; in decode ``q C``); per sLSTM block the bf16 ``w``
    and ``w_down`` and the float32 scan, ``2 b 4 h dh²`` a step (its
    registered count); the bf16 unembedding. Train: three times the
    forward, but the scan's backward pass, which runs the loop again and
    takes ``r``'s gradient at every step and the hidden state's at every
    step but the first (``4 s - 1`` steps in all); under remat "full"
    every block again but its ``w_down``; the chunked loss's unembedding
    again. Over ``model`` "model" ranks that do not divide the heads,
    every block whole on each of them; a vocab they do not divide whole
    on each; over ``data`` ranks, a batch they do not split whole on
    each."""
    d, h = cfg.d_model, cfg.n_heads
    di = 2 * d
    dh, dhs = di // h, d // h
    kinds = lm._xlstm_kinds(cfg)
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    rep_m = model if h % model else 1
    rep = data if b % data else 1
    vocab = cfg.vocab * (model if cfg.vocab % model else 1)
    step = 2 * b * 4 * h * dhs * dhs
    t = b if kind == "decode" else b * s
    m_down, s_down = 2 * t * di * d, 2 * t * d * d
    m_low = (2 * t * d * 2 * di + 3 * 2 * t * di * di + 2 * 2 * t * di * h
             + m_down)
    s_low = 2 * t * d * 4 * d + s_down
    unembed = 2 * t * d * vocab
    low = rep_m * (n_m * m_low + n_s * s_low) + unembed
    if kind == "decode":
        f32 = rep_m * (n_m * 2 * t * h * dh * dh + n_s * step)
    else:
        q = min(cfg.ssm_chunk, s)
        m_f32 = 2 * 2 * t * h * dh * dh + 2 * 2 * t * h * q * dh
        f32 = rep_m * (n_m * m_f32 + n_s * s * step)
        if kind == "train":
            remat = cfg.remat == "full"
            chunked = cfg.vocab >= 8192 and s > 1024 and s % 1024 == 0
            low = (rep_m * (3 * (n_m * m_low + n_s * s_low)
                            + (n_m * (m_low - m_down) + n_s * (s_low - s_down)
                               if remat else 0))
                   + 3 * unembed + (unembed if chunked else 0))
            f32 = rep_m * (3 * n_m * m_f32 + n_s * (4 * s - 1) * step
                           + (n_m * m_f32 + n_s * s * step if remat else 0))
    return {"bf16": rep * low, "float32": rep * f32,
            "total": rep * (low + f32)}


class ScanClock:
    """The sLSTM loop's wall time inside a run: each call of
    ``xlstm.scan_loop`` (the custom op's body) and of ``xlstm.scan_grads``
    (its backward pass: the loop again and autograd's pass over it)
    between synchronisations, on the host clock, while the scope is open
    (a call inside a clocked call is not clocked again). The loop is
    host-bound, so the dozen synchronisations a train step drain an
    almost empty queue."""

    def __enter__(self):
        self.s, self.calls, self._depth = 0.0, 0, 0
        self._fns = {name: getattr(xlstm, name)
                     for name in ("scan_loop", "scan_grads")}

        def clock(fn):
            def clocked(*args):
                if self._depth:
                    return fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self._depth += 1
                try:
                    out = fn(*args)
                finally:
                    self._depth -= 1
                torch.cuda.synchronize()
                self.s += time.perf_counter() - t0
                self.calls += 1
                return out
            return clocked
        for name, fn in self._fns.items():
            setattr(xlstm, name, clock(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._fns.items():
            setattr(xlstm, name, fn)


def scan_share(fn, *args) -> tuple:
    """``fn(*args)`` with the sLSTM loop clocked (:class:`ScanClock`):
    (its output, a record of the run's wall ms, the loop's ms, calls and
    share)."""
    with ScanClock() as clock:
        out, ms = wall_ms(fn, *args)
    return out, dict(run_ms=ms, slstm_loop_ms=clock.s * 1e3,
                     slstm_loop_calls=clock.calls,
                     slstm_loop_share=clock.s * 1e3 / ms)


def device_profile(fn, top: int = 6) -> dict:
    """``fn`` once under ``torch.profiler`` tracing the card, read from
    the raw kernel events (``key_averages`` takes ~0.4 ms an event on
    the host: minutes for the million launches of an xLSTM train step):
    the device busy share of the wall time (the union of the kernels'
    intervals), the kernels' summed ms, and the ms of the ``top`` kernel
    names (kernels whose names share their first 80 characters summed
    under them). The tracing lengthens the wall time the share is taken
    of. A window's first kernel went unrecorded on the H100, so each
    window opens with a one-element fill before ``fn``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        lo, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        spans.append((lo, lo + dur))
        key = e.name()[:80]
        by_name[key] = by_name.get(key, 0) + dur
    spans.sort()
    busy_ns, end = 0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy_ns += hi - lo
            end = hi
        elif hi > end:
            busy_ns += hi - end
            end = hi
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(wall_ms=wall_us / 1e3, kernels=len(spans),
                device_ms=sum(by_name.values()) / 1e6,
                device_busy_ms=busy_ns / 1e6,
                device_busy_share=(busy_ns / 1e3 / wall_us if spans
                                   else "not measured"),
                top_kernels_ms={k: ns / 1e6 for k, ns in rows[:top]})


def xlstm_train_run(cfg, params) -> dict:
    """The full-width train cell at train_4k's sequence, CELLS_TRAIN_BATCH
    sequences: a warm step, then a timed one from the same state under
    ``torch.use_deterministic_algorithms(True)`` (``warn_only``; an op
    flagged fails) with the sLSTM loop clocked (:func:`scan_share`),
    bitwise the warm one (:func:`fingerprint`); one step profiled
    (:func:`device_profile`); ms, tokens/s and TFLOP/s against the
    hand count (:func:`xlstm_matmul_flops`) and its bounds, the
    allocator's peak beside ``analyze()``. (A step takes ~20 s at full
    depth, the sLSTM loop host-bound; so one timed step.)"""
    shape = cut_shape("train_4k")
    b, s = shape.global_batch, shape.seq_len
    step = steps.build_cell(cfg, shape).step_fn
    state = steps.make_optimizer(cfg).init(params)
    batch = cell_batch(cfg, b, s, SEED + 62, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    warm, first_ms = timed_run(step, params, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(warm[2])
    check(math.isfinite(loss), f"xlstm: train loss {loss}")
    want = fingerprint(list(warm))
    del warm
    before = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out, share = scan_share(step, params, state, batch)
            same = fingerprint(list(out)) == want
            del out
        finally:
            torch.use_deterministic_algorithms(before)
    flagged = sorted({str(w.message)[:160] for w in seen
                      if "deterministic implementation" in str(w.message)})
    check(not flagged and same, f"xlstm: under deterministic algorithms "
          f"the step differs from the warm one or flags {flagged}")
    prof = device_profile(lambda: step(params, state, batch), top=10)
    hand = xlstm_matmul_flops(cfg, b, s, "train")
    step_ms = share["run_ms"]
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=b, seq=s,
        cut=f"train_4k's batch 256 -> {b}", loss=loss,
        first_step_ms=first_ms, ms=step_ms,
        tokens_per_s=b * s / (step_ms / 1e3), flops_hand=hand,
        tflops_per_s=hand["total"] / (step_ms / 1e3) / 1e12,
        bound_ms={"bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                  "float32_at_67": hand["float32"] / F32_OPS_S * 1e3},
        bitwise_run_to_run=True, deterministic_algorithms=dict(
            bitwise=True, nondeterministic_ops=flagged),
        slstm_loop=share, allocated_before_gb=before_gb,
        peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, shape, CELLS_MESHES[0]),
        profile=prof)


def xlstm_prefill_run(cfg, params) -> dict:
    """The full-width prefill cell at prefill_32k's sequence,
    CELLS_PREFILL_BATCH sequence, warmed up at XLSTM_WARM_SEQ, where its
    logits are bitwise ``Model.forward``'s on the same batch; then timed
    once at the full sequence with the sLSTM loop clocked
    (:func:`scan_share`): logits of the right shape, finite; ms, tokens/s
    and TFLOP/s beside the hand count's bounds, the allocator's peak
    beside ``analyze()``. (A prefill takes ~30 s, the sLSTM loop nearly
    all of it: so one run at 32,768 tokens.)"""
    shape = cut_shape("prefill_32k")
    b, s = shape.global_batch, shape.seq_len
    cell = steps.build_cell(cfg, shape)
    model = lm.Model(cfg)
    with torch.no_grad():
        warm_batch = cell_batch(cfg, b, XLSTM_WARM_SEQ, SEED + 63, DEVICE)
        warm, warm_ms = timed_run(cell.step_fn, params, warm_batch)
        check(torch.equal(warm, model.forward(params, warm_batch)),
              "xlstm: the prefill's logits differ from Model.forward's")
        del warm
        batch = cell_batch(cfg, b, s, SEED + 23, DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, share = scan_share(cell.step_fn, params, batch)
        step_ms = share["run_ms"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(tuple(got.shape) == (b, s, cfg.vocab)
              and bool(torch.isfinite(got).all()), f"xlstm: prefill logits "
              f"{tuple(got.shape)} or not finite")
        del got
    torch.cuda.empty_cache()
    hand = xlstm_matmul_flops(cfg, b, s, "prefill")
    return dict(arch=cfg.arch_id, layers=cfg.n_layers, batch=b, seq=s,
                cut=f"prefill_32k's batch 32 -> {b}",
                logits_shape=[b, s, cfg.vocab],
                bitwise_vs_forward=f"at {XLSTM_WARM_SEQ} tokens",
                warm_ms=warm_ms, ms=step_ms,
                tokens_per_s=b * s / (step_ms / 1e3), flops_hand=hand,
                tflops_per_s=hand["total"] / (step_ms / 1e3) / 1e12,
                bound_ms={"bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                          "float32_at_67": hand["float32"] / F32_OPS_S
                          * 1e3},
                slstm_loop=share, peak_allocated_gb=peak_gb,
                memory_model=memory_record(cfg, shape, CELLS_MESHES[0]))


def reached_state(model, params, batch: int, seed: int):
    """A decode state the recurrence reaches: XLSTM_REACH random tokens
    decoded from zeros (``Model.decode_step``, in place), and the tokens
    of the step after them."""
    cfg = model.cfg
    state = model.init_decode_state(batch, 1, device=DEVICE)
    tokens = decode_tokens(cfg, (batch, XLSTM_REACH + 1), seed, DEVICE)
    index = torch.arange(XLSTM_REACH + 1, dtype=torch.int32, device=DEVICE)
    for t in range(XLSTM_REACH):
        model.decode_step(params, state, lm.DecodeBatch(tokens[:, t:t + 1],
                                                        index[t]))
    return state, lm.DecodeBatch(tokens[:, -1:], index[-1])


def xlstm_decode_timed(cfg, params, shape) -> dict:
    """The decode cell's step at ``shape`` (decode_32k at its full batch,
    long_500k) from a reached state (:func:`reached_state`; the state has
    no positions, so the sequence only names the cell): DECODE_WARM
    steps; from a snapshot of the state, DECODE_TIMED steps between CUDA
    events under ``set_sync_debug_mode("error")`` (a host sync raises),
    each step advancing the state; from the snapshot again the same steps
    bitwise the same tokens and state; one step profiled; the
    allocator's peak beside ``analyze()`` on one device; the bytes bound
    (the state read and written once, the bf16 weights read once) and the
    FLOPs bound."""
    batch = shape.global_batch
    model = lm.Model(cfg)
    cell = steps.build_cell(cfg, shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, db = reached_state(model, params, batch, SEED + 64)
    snap = lm.map_state(torch.clone, state)

    def restore():
        for t, t0 in zip(model_common.leaves(state),
                         model_common.leaves(snap)):
            t.copy_(t0)

    def run():
        return torch.stack([cell.step_fn(params, state, db)[0]
                            for _ in range(DECODE_TIMED)])
    for _ in range(DECODE_WARM):
        cell.step_fn(params, state, db)
    restore()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with sync_free("decode timed steps"):
        start.record()
        tokens = run()
        stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / DECODE_TIMED
    want = fingerprint([tokens, *model_common.leaves(state)])
    restore()
    check(fingerprint([run(), *model_common.leaves(state)]) == want,
          f"xlstm: {shape.name}: two runs of decode steps from one state "
          f"differ")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    restore()
    prof = device_profile(lambda: cell.step_fn(params, state, db), top=10)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in model_common.leaves(state))
    del state, snap
    torch.cuda.empty_cache()
    n_params = model_common.count_params(params)
    hand = xlstm_matmul_flops(cfg, batch, shape.seq_len, "decode")
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=batch,
        seq=shape.seq_len, cut=f"{shape.name} uncut",
        state="reached: " + f"{XLSTM_REACH} decode steps from zeros",
        ms_per_step=ms, tokens_per_s=batch / (ms / 1e3), sync_free=True,
        bitwise_run_to_run=True, state_gb=state_bytes / 1e9,
        bf16_weights_gb=2 * n_params / 1e9,
        bound_ms={"bytes_at_3.35TBs": (2 * state_bytes + 2 * n_params)
                  / HBM_BYTES_S * 1e3,
                  "bf16_at_989": hand["bf16"] / BF16_OPS_S * 1e3,
                  "float32_at_67": hand["float32"] / F32_OPS_S * 1e3},
        flops_hand=hand, peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, shape, {}), profile=prof)


def xlstm_check_inputs(dt: str):
    """XLSTM_ARCH at XLSTM_CHECK_LAYERS in ``dt``: its config, and its
    weights at CELLS_WEIGHT_STD and its XLSTM_CHECK_TOKENS batch, both
    drawn on the CPU from seeds (the same in every process)."""
    cfg = configs.get_config(XLSTM_ARCH).replace(
        n_layers=XLSTM_CHECK_LAYERS, compute_dtype=dt)
    return (cfg, scaled_params(cfg, SEED + 65, "cpu"),
            cell_batch(cfg, *XLSTM_CHECK_TOKENS, SEED + 66, "cpu"))


def xlstm_cpu_side(path: str) -> str:
    """The CPU side of :func:`xlstm_card_vs_cpu`, for a subprocess on the
    host's CPU (it runs no card): in each of XLSTM_CPU_TOL's dtypes the
    loss, the gradients and the prefill logits of
    :func:`xlstm_check_inputs`, saved to ``path``, on half the host's
    cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    out = {}
    for dt in XLSTM_CPU_TOL:
        cfg, params, batch = xlstm_check_inputs(dt)
        model = lm.Model(cfg)
        loss, grads = steps.loss_and_grads(model, params, batch)
        with torch.no_grad():
            logits = model.forward(params, batch)
        out[dt] = dict(loss=loss, grads=grads, logits=logits)
    torch.save(out, path)
    return path


def named_leaves(tree, path: str = "") -> list:
    """``(path, tensor)`` of every leaf of nested dicts and lists, in
    ``model_common.leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in named_leaves(t, f"{path}/{i}")]
    return [(path, tree)]


def xlstm_card_vs_cpu(cpu: dict) -> dict:
    """XLSTM_ARCH at XLSTM_CHECK_LAYERS (seven mLSTM blocks and one
    sLSTM), weights at CELLS_WEIGHT_STD drawn on the CPU, on
    XLSTM_CHECK_TOKENS, in float32 and bf16 (remat "full"):
    ``loss_and_grads`` and the prefill logits on the card against
    ``cpu``, :func:`xlstm_cpu_side`'s record of the same on the CPU,
    within XLSTM_CPU_TOL. In bf16 each gradient leaf is held within the
    larger of that bound and the CPU's own bf16 gradient's distance from
    its float32 one: at this depth the random xLSTM's bf16 gradients lie
    5-54% of a leaf's largest |entry| off its float32 ones (the sLSTM's
    bias farthest; 22 of 24 leaves past 5%), so no two bf16 runs can be
    held to 5% there, while a wrong formula would land far outside that
    gap; the leaves past the bound are printed beside their gaps. Every
    record is printed before the checks."""
    out = {}
    for dt, tol in XLSTM_CPU_TOL.items():
        cfg, params, batch = xlstm_check_inputs(dt)
        model = lm.Model(cfg)
        card = model_common.tree_map(lambda a: a.to(DEVICE), params)
        batch = batch_to(batch, DEVICE)
        loss, grads = steps.loss_and_grads(model, card, batch)
        with torch.no_grad():
            got = model.forward(card, batch).cpu()
        want = cpu[dt]
        errs = [(name, rel_err(g, w)) for (name, g), w in zip(
            named_leaves(grads), model_common.leaves(want["grads"]),
            strict=True)]
        gaps = ([rel_err(b, f) for b, f in zip(
            model_common.leaves(want["grads"]),
            model_common.leaves(cpu["float32"]["grads"]))]
                if dt == "bfloat16" else [0.0] * len(errs))
        r = dict(layers=cfg.n_layers, tokens=list(XLSTM_CHECK_TOKENS),
                 loss=float(want["loss"]),
                 loss_rel_diff=abs(float(loss) - float(want["loss"]))
                 / abs(float(want["loss"])),
                 grad_rel_diff=max(e for _, e in errs),
                 grads_within_bound=all(e <= max(tol["grads"], gap) for
                                        (_, e), gap in zip(errs, gaps)),
                 grads_past_bound={name: dict(card_vs_cpu=e,
                                              cpu_bf16_vs_float32=gap)
                                   for (name, e), gap in zip(errs, gaps)
                                   if e > tol["grads"]},
                 logits_rel_diff=max_abs_diff(got, want["logits"])
                 / max_abs(want["logits"]), rtol=tol)
        out[dt] = r
        del card, grads, got
        torch.cuda.empty_cache()
    emit({"xlstm": {"card_vs_cpu": out}})
    for dt, r in out.items():
        tol = r["rtol"]
        check(r["loss_rel_diff"] <= tol["loss"] and r["grads_within_bound"]
              and r["logits_rel_diff"] <= tol["logits"],
              f"xlstm: card vs CPU {dt} at {r['layers']} layers: {r}")
    return out


def xlstm_vs_prefill() -> dict:
    """DECODE_PRIME tokens of DECODE_BATCH sequences primed one at a time
    against ``Model.forward`` on them, XLSTM_ARCH at full width and depth
    in float32, weights at CELLS_WEIGHT_STD: with float32 convolution
    buffers within DECODE_CPU_RTOL of the largest |logit| (held); with
    the model's bf16 ones, which round the current token's ``x_m`` before
    the convolution, recorded."""
    cfg = configs.get_config(XLSTM_ARCH).replace(compute_dtype="float32")
    model = lm.Model(cfg)
    params = scaled_params(cfg, SEED + 67, DEVICE, draw_device=DEVICE)
    tokens = decode_tokens(cfg, (DECODE_BATCH, DECODE_PRIME), SEED + 68,
                           DEVICE)
    with torch.no_grad():
        want = model.forward(params, lm.Batch(tokens, None))
    out = dict(weights=f"std {CELLS_WEIGHT_STD}", compute="float32",
               tokens=[DECODE_BATCH, DECODE_PRIME], rtol=DECODE_CPU_RTOL,
               max_abs_logit=max_abs(want))
    for name, dt in (("float32_buffers", torch.float32),
                     ("bf16_buffers", torch.bfloat16)):
        got = primed_logits(model, params, tokens, DECODE_PRIME, DEVICE, dt)
        out[name] = dict(max_abs_diff=max_abs_diff(got, want),
                         held=dt == torch.float32)
        del got
    check(out["float32_buffers"]["max_abs_diff"]
          <= DECODE_CPU_RTOL * out["max_abs_logit"],
          f"xlstm: decode against prefill with float32 buffers: {out}")
    del params, want
    torch.cuda.empty_cache()
    return out


def xlstm_decode(cfg, params) -> dict:
    """The decode cell at decode_32k's full batch and at long_500k
    (:func:`xlstm_decode_timed`), and two greedy runs bitwise
    (:func:`greedy_run_to_run`)."""
    out = {}
    for name in ("decode_32k", "long_500k"):
        out[name] = xlstm_decode_timed(cfg, params, configs.SHAPES[name])
        torch.cuda.empty_cache()
    out["greedy"] = greedy_run_to_run(cfg, params)
    torch.cuda.empty_cache()
    return out


def mesh_xlstm(mesh, shape, world: int, root) -> dict:
    """XLSTM_ARCH at full width and XLSTM_MESH_LAYERS (one sLSTM block)
    sharded on one mesh, in every rank, the weights drawn whole on the
    rank's card from a seed at CELLS_WEIGHT_STD and cut to this rank's
    blocks (on a (1, 1) mesh passed as they are): the train step at
    train_4k's cut from a fresh AdamW state (its collectives counted; the
    loss and the digests of the gathered parameters and moments), the
    prefill at prefill_32k's cut
    (the digest of its gathered logits; on a mesh of several ranks rank 0
    keeps its first MOE_MESH_SLICE positions in ``root``) and the decode
    step at decode_32k's full batch from a reached state (the digests of
    the next tokens and of the whole logits). On (1, 1) each is held
    bitwise the unsharded cell's on the same card. ms of each, the peaks
    beside ``analyze()``."""
    cfg = configs.get_config(XLSTM_ARCH).replace(
        n_layers=XLSTM_MESH_LAYERS)
    model = lm.Model(cfg)
    one = tuple(shape) == (1, 1)
    what = f"sharded {XLSTM_ARCH} on a {shape} mesh"
    torch.cuda.empty_cache()
    params = scaled_params(cfg, SEED + 69, DEVICE, draw_device=DEVICE)
    train, prefill = cut_shape("train_4k"), cut_shape("prefill_32k")
    dshape = configs.SHAPES["decode_32k"]
    tbatch = cell_batch(cfg, train.global_batch, train.seq_len, SEED + 62,
                        DEVICE)
    pbatch = cell_batch(cfg, prefill.global_batch, prefill.seq_len,
                        SEED + 23, DEVICE)
    rec = dict(arch=XLSTM_ARCH, mesh=list(shape), layers=cfg.n_layers)
    want = {}
    if one:
        out, rec["unsharded_train_ms"] = wall_ms(
            steps.build_cell(cfg, train).step_fn, params,
            steps.make_optimizer(cfg).init(params), tbatch)
        want["train"] = fingerprint(list(out))
        del out
        with torch.no_grad():
            logits, rec["unsharded_prefill_ms"] = wall_ms(
                steps.build_cell(cfg, prefill).step_fn, params, pbatch)
        want["prefill"] = digest(logits)
        del logits
        want["decode"], rec["unsharded_decode_ms"] = xlstm_decode_digests(
            model, params, None, None)
        torch.cuda.empty_cache()
        local = params
    else:
        local = model_common.local_params(params, model.param_specs(mesh),
                                          mesh)

    # the train step
    cell = steps.build_cell(cfg, train, mesh)
    ostate = steps.make_optimizer(cfg).init(local)
    b = tbatch if one else steps.local_args(tbatch, cell.in_shardings[2],
                                            mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with sharding.count_collectives() as coll:
        out, first_ms = wall_ms(cell.step_fn, local, ostate, b)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(out[2])
    check(math.isfinite(loss), f"{what}: loss {loss}")
    got = fingerprint(list(out))
    if one:
        check(got == want["train"], f"{what}: the (1, 1) train step "
              f"differs from the unsharded one")
    p_sh, opt_sh, _ = cell.out_shardings
    digests = dict(params=whole_digests(out[0], p_sh, mesh),
                   mu=whole_digests(out[1].mu, opt_sh.mu, mesh),
                   nu=whole_digests(out[1].nu, opt_sh.nu, mesh))
    del out, ostate, b
    torch.cuda.empty_cache()
    rec["train"] = dict(
        tokens=[train.global_batch, train.seq_len], loss=loss,
        digests=digests, ms=first_ms,
        collectives_per_step=dict(calls=coll.calls, bytes=coll.bytes),
        peak_allocated_gb=peak_gb,
        memory_model=memory_record(cfg, train, sharding.mesh_shape(mesh)))

    # the prefill
    pcell = steps.build_cell(cfg, prefill, mesh)
    pb = pbatch if one else steps.local_args(pbatch, pcell.in_shardings[1],
                                             mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, rec["prefill_ms"] = wall_ms(pcell.step_fn, local, pb)
        logits = sharding.whole_block(logits, pcell.out_shardings, mesh)
    rec["prefill_peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["prefill_digest"] = digest(logits)
    check(bool(torch.isfinite(logits).all()), f"{what}: prefill logits")
    if one:
        check(rec["prefill_digest"] == want["prefill"], f"{what}: the "
              f"(1, 1) prefill differs from the unsharded one")
    elif torch.distributed.get_rank() == 0:
        torch.save(logits[:, :MOE_MESH_SLICE].float().cpu(), pathlib.Path(
            root) / f"xlstm-{'x'.join(map(str, shape))}.pt")
    del logits, pb
    torch.cuda.empty_cache()

    # the decode step
    rec["decode_digests"], rec["decode_ms"] = xlstm_decode_digests(
        model, local, mesh, steps.build_cell(
            cfg, dshape, mesh, dict(sharding.DEFAULT_RULES)),
        params if not one else None)
    if one:
        check(rec["decode_digests"] == want["decode"], f"{what}: the "
              f"(1, 1) decode step differs from the unsharded one")
    del local, params
    torch.cuda.empty_cache()
    rec.update(bitwise_vs_unsharded=one or "not held (a mesh of several "
               "ranks; the meshes are held against one another)")
    return rec


def xlstm_decode_digests(model, params, mesh, cell, whole_params=None):
    """The decode step at decode_32k's full batch from a reached state
    (:func:`reached_state`, made unsharded from the whole weights,
    ``whole_params`` or ``params``; with ``mesh``, ``cell``'s step on
    this rank's blocks of it, and ``params`` this rank's blocks), and its
    logits from the state reached again: the digests of the next tokens,
    of the whole logits and of the state after the step, and the step's
    ms."""
    dshape = configs.SHAPES["decode_32k"]
    wparams = params if whole_params is None else whole_params

    def reached():
        return reached_state(model, wparams, dshape.global_batch,
                             SEED + 70)
    if mesh is None:
        state, db = reached()
        (tokens, state), ms = wall_ms(steps.build_cell(
            model.cfg, dshape).step_fn, params, state, db)
        states = fingerprint(state)
        del state
        state, db = reached()
        logits = decode_logits(model, params, state, db, None, None, None)
        return dict(tokens=digest(tokens), logits=digest(logits),
                    state=states), ms
    rules = dict(sharding.DEFAULT_RULES)
    _, st_sh, db_sh = cell.in_shardings
    state, db = reached()
    ldb = steps.local_args(db, db_sh, mesh)
    (tokens, local), ms = wall_ms(cell.step_fn, params, steps.local_args(
        state, st_sh, mesh), ldb)
    tokens = sharding.whole_block(tokens, cell.out_shardings[0], mesh)
    states = fingerprint(steps.whole_args(local, st_sh, mesh))
    del state, local
    state, db = reached()
    logits = decode_logits(model, params, steps.local_args(
        state, st_sh, mesh), ldb, cell, mesh, rules)
    return dict(tokens=digest(tokens), logits=digest(logits),
                state=states), ms


def xlstm_world() -> dict:
    """XLSTM_ARCH sharded (:func:`mesh_xlstm`) in an NCCL world of every
    card of the host (:func:`run_world`): every rank's digests and losses
    the same on each mesh; on several meshes, their losses within
    XLSTM_MESH_TOL's loss bound of the first mesh's ((1, world)) and
    their prefill logits' first MOE_MESH_SLICE positions within its
    logits bound of its largest |logit|."""
    root = ROOT / "build" / "xlstm_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    world = torch.cuda.device_count()
    ranks, world_s = run_world(root, world, "xlstm")

    def held(rec):
        return (rec["prefill_digest"], rec["decode_digests"],
                rec["train"]["loss"], rec["train"]["digests"])
    across = "one mesh"
    if len(ranks[0]) > 1:
        first = ranks[0][0]["xlstm"]
        key0 = "x".join(map(str, first["mesh"]))
        ref = torch.load(root / f"xlstm-{key0}.pt")
        across = {}
        for rec in ranks[0][1:]:
            key = "x".join(map(str, rec["xlstm"]["mesh"]))
            got = torch.load(root / f"xlstm-{key}.pt")
            across[f"{key}_vs_{key0}"] = dict(
                loss_rel_diff=abs(rec["xlstm"]["train"]["loss"]
                                  - first["train"]["loss"])
                / abs(first["train"]["loss"]),
                logits_rel_diff=max_abs_diff(got, ref) / max_abs(ref),
                tol=XLSTM_MESH_TOL)
    shutil.rmtree(root, ignore_errors=True)
    out = dict(world=world, ranks=ranks, meshes_agree=across,
               world_s=world_s)
    emit({"xlstm_world": out})
    for i, rec in enumerate(ranks[0]):
        check(all(held(r[i]["xlstm"]) == held(rec["xlstm"])
                  for r in ranks[1:]),
              f"sharded {XLSTM_ARCH} on a {rec['mesh']} mesh: the train "
              f"step, the prefill or the decode step differ between ranks")
    for key, r in (across.items() if isinstance(across, dict) else ()):
        check(r["loss_rel_diff"] <= XLSTM_MESH_TOL["loss"]
              and r["logits_rel_diff"] <= XLSTM_MESH_TOL["logits"],
              f"sharded {XLSTM_ARCH}: the {key} mesh: {r}")
    return out


def xlstm_phase(card: str) -> dict:
    """The xLSTM on the card: XLSTM_ARCH sharded over every card
    (:func:`xlstm_world`, first, while this process holds nothing on the
    card); at full width and XLSTM_TIMED_LAYERS blocks the train step at
    train_4k's cut and the prefill at prefill_32k's cut; at full depth the
    decode steps at decode_32k's full batch and at long_500k, greedy run
    to run, decode against prefill, the card against the CPU at
    XLSTM_CHECK_LAYERS, the decode card against the CPU there. Two
    subprocesses on the host's
    CPU (:func:`host_start`) run beside the sharded world and the train
    step and are waited for before the prefill is timed: the CPU side of
    the card-vs-CPU check (:func:`xlstm_cpu_side`), and the train and
    prefill cells counted on meta tensors at full batch
    (:func:`cells_counted`: FLOPs equal to the hand count, the sLSTM
    scan's registered counts among them; ``analyze()`` on one card and
    the production meshes; and for the decode shapes). Every record
    carries the card's name and power limit, and is printed as its part
    ends, with its seconds; the phase's wall seconds last."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    part_s = {}

    def done(name: str, t: float, **recs) -> None:
        part_s[name] = time.perf_counter() - t
        emit({"xlstm": dict(card=card, part=name, part_s=part_s[name],
                            **recs)})
    cpu_path = ROOT / "build" / "xlstm_cpu.pt"
    cpu_path.parent.mkdir(parents=True, exist_ok=True)
    counting = host_start(f"cells_counted({XLSTM_ARCH!r})")
    cpu_side = host_start(f"xlstm_cpu_side({str(cpu_path)!r})")
    try:
        rec = {"card": card, "mesh": xlstm_world()}
        done("mesh", t0, mesh=rec["mesh"])
        cfg = configs.get_config(XLSTM_ARCH)
        timed = cfg.replace(n_layers=XLSTM_TIMED_LAYERS)
        params = lm.Model(timed).init(
            torch.Generator(device=DEVICE).manual_seed(SEED + 60))
        t = time.perf_counter()
        rec["train"] = xlstm_train_run(timed, params)
        torch.cuda.empty_cache()
        done("train", t, train=rec["train"])
        t = time.perf_counter()
        cpu = torch.load(host_wait(cpu_side, "xlstm: the CPU side of card "
                                   "vs CPU"), weights_only=False)
        cpu_path.unlink()
        rec["counted"] = host_wait(counting, f"{XLSTM_ARCH}'s cells counted")
    finally:
        host_stop(counting, cpu_side)
    for name, r in rec["counted"].items():
        check(r["flops"] == r["flops_hand"]["total"], f"{XLSTM_ARCH} "
              f"{name} counts {r['flops']} FLOPs, hand count "
              f"{r['flops_hand']}")
    rec["counted"]["memory_decode"] = {
        name: {"x".join(map(str, m.values())): memory_record(
            cfg, configs.SHAPES[name], m) for m in CELLS_MESHES}
        for name in ("decode_32k", "long_500k")}
    done("host_wait", t, counted=rec["counted"])
    for name, fn in (("prefill", lambda: xlstm_prefill_run(timed, params)),
                     ("decode", lambda: xlstm_decode(cfg, lm.Model(
                         cfg).init(torch.Generator(device=DEVICE)
                                   .manual_seed(SEED + 60)))),
                     ("vs_prefill", xlstm_vs_prefill),
                     ("card_vs_cpu", lambda: xlstm_card_vs_cpu(cpu)),
                     ("decode_card_vs_cpu", lambda: decode_card_vs_cpu(
                         XLSTM_ARCH, XLSTM_CHECK_LAYERS))):
        t = time.perf_counter()
        rec[name] = fn()
        if name == "prefill":
            del params
        torch.cuda.empty_cache()
        done(name, t, **{name: rec[name]})
    rec["phase_s"] = time.perf_counter() - t0
    emit({"xlstm": {"card": card, "part_s": part_s,
                    "phase_s": rec["phase_s"]}})
    return rec


# the loop phase (ROADMAP.md §1 item 4(f)): the production train loop
# (train/loop.py) at full LOOP_ARCH width and LOOP_LAYERS of its 16 layers
# (the checkpoint's bytes: parameters, mu and nu are 12 B a parameter, 4.08
# GB a save at 2 layers against 15.36 GB at 16, and the phase writes
# several), bf16, remat "full", on LOOP_TOKENS (train_4k's 4096 tokens x 4)
# in LOOP_MICRO microbatches, AdamW at LOOP_LR after LOOP_WARMUP steps:
# (a) a run of LOOP_STEPS[1] steps checkpointed every LOOP_CKPT_EVERY,
# stopped at LOOP_STEPS[0] by its SIGTERM handler (the preemption save),
# (b) the same run relaunched in its directory, its steps past the warmup,
# (c) LOOP_STEPS[1] steps uninterrupted in another, (b) bitwise (c);
# LOOP_TIMED warm steps; one step at lr 0 with 1 and LOOP_MICRO
# microbatches: the losses within LOOP_MB_RTOL (the reference's bound,
# tests/test_train_runtime.py:194), the gradient norms within
# LOOP_GNORM_RTOL (the dense family's bf16 bound in
# tests/test_torch_train_loop.py; a microbatch's gradients dropped, or
# their sum not divided, moves the norm by ~1/2 or x2); the launcher on the
# smoke config (LOOP_LAUNCHER_ARGS) sent SIGTERM on its `step LOOP_KILL_AT/`
# line, of LOOP_LAUNCHER_STEPS, relaunched, its last checkpoint bitwise an
# uninterrupted main()'s; one step's loss and gradients under remat "none",
# "dots" and "full" from one state, each warmed, then LOOP_TIMED timed;
# compress_grads on those gradients against the CPU. Every run writes under
# LOOP_DIR, deleted at the end.
LOOP_ARCH, LOOP_LAYERS, LOOP_TOKENS, LOOP_MICRO = "olmo-1b", 2, (4, 4096), 2
LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_LR, LOOP_WARMUP = (12, 16), 6, 3e-4, 10
LOOP_TIMED, LOOP_MB_RTOL, LOOP_GNORM_RTOL = 3, 1e-3, 1e-2
LOOP_COMPRESS_CALLS = 5
LOOP_KILL_AT, LOOP_LAUNCHER_STEPS = 10, 200
LOOP_LAUNCHER_ARGS = ("--arch", LOOP_ARCH, "--smoke")
LOOP_DIR = ROOT / "build" / "loop"


def dir_gb(path) -> float:
    return sum(f.stat().st_size for f in pathlib.Path(path).iterdir()) / 1e9


class SaveClock:
    """The checkpoint's costs while the scope is open: each
    ``AsyncCheckpointer.save``'s blocking part (the wait for the write in
    flight, then the copy of every leaf to the host), each write
    (``checkpoint.save``, on the writer's thread or the caller's) with
    its GB on disk, each restore, and on a mesh each gather of the whole
    state (``MeshCheckpointer.whole``: its GB and the allocator's peak
    while it runs, between synchronisations), on the host clock."""

    def __enter__(self):
        self.records = []
        self._fns = save, restore, async_save, whole = (
            tckpt.save, tckpt.restore, tckpt.AsyncCheckpointer.save,
            tckpt.MeshCheckpointer.whole)
        rec = self.records

        def timed_whole(saver, blocks):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = whole(saver, blocks)
            torch.cuda.synchronize()
            rec.append(dict(what="gather", s=time.perf_counter() - t0,
                            gb=sum(t.numel() * t.element_size() for t in
                                   model_common.leaves(out)) / 1e9,
                            peak_allocated_gb=(
                                torch.cuda.max_memory_allocated() / 1e9)))
            return out

        def timed_save(ckpt_dir, step, tree, **kw):
            t0 = time.perf_counter()
            out = save(ckpt_dir, step, tree, **kw)
            rec.append(dict(what="write", step=step,
                            s=time.perf_counter() - t0, gb=dir_gb(out),
                            background=threading.current_thread()
                            is not threading.main_thread()))
            return out

        def timed_restore(ckpt_dir, like, **kw):
            t0 = time.perf_counter()
            out = restore(ckpt_dir, like, **kw)
            rec.append(dict(what="restore", s=time.perf_counter() - t0))
            return out

        def timed_async(saver, step, tree, extra=None):
            t0 = time.perf_counter()
            saver.wait()
            t1 = time.perf_counter()
            async_save(saver, step, tree, extra)
            rec.append(dict(what="host_copy", step=step, wait_s=t1 - t0,
                            s=time.perf_counter() - t1))
        tckpt.save, tckpt.restore = timed_save, timed_restore
        tckpt.AsyncCheckpointer.save = timed_async
        tckpt.MeshCheckpointer.whole = timed_whole
        return self

    def __exit__(self, *exc):
        (tckpt.save, tckpt.restore, tckpt.AsyncCheckpointer.save,
         tckpt.MeshCheckpointer.whole) = self._fns


def loop_cfg():
    return configs.get_config(LOOP_ARCH).replace(n_layers=LOOP_LAYERS)


def sigterm_at(stop: int):
    """An ``on_metrics`` that calls the installed SIGTERM handler (the
    loop's preemption save, then ``SystemExit(143)``) on step ``stop``."""
    def on_metrics(step, metrics):
        if step == stop:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
    return on_metrics


def loop_train(model, cfg, steps: int, ckpt_dir,
               ckpt_every: int = LOOP_CKPT_EVERY,
               stop_at: int | None = None) -> tuple:
    """``train_loop.train`` of ``steps`` in ``ckpt_dir`` (resumed from
    its latest checkpoint, the stream from that step), its ``[train]``
    lines captured: (its result, a record). With ``stop_at`` the run is
    preempted on that step and the result is ``{"exit": code}``."""
    b, s = LOOP_TOKENS
    tc = train_loop.TrainConfig(
        steps=steps, microbatches=LOOP_MICRO, ckpt_every=ckpt_every,
        ckpt_dir=str(ckpt_dir), keep=1, log_every=LOOP_CKPT_EVERY,
        lr=LOOP_LR, warmup=LOOP_WARMUP)
    start = tckpt.latest_step(str(ckpt_dir)) or 0
    data = train_loop.synthetic_lm_data(cfg, b, s, start_step=start,
                                        device=DEVICE)
    buf = io.StringIO()
    on_metrics = None if stop_at is None else sigterm_at(stop_at)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            out = train_loop.train(model, data, tc, on_metrics=on_metrics,
                                   device=DEVICE)
        except SystemExit as e:
            out = {"exit": e.code}
    torch.cuda.synchronize()
    return out, dict(steps=steps, stream_from=start, stop_at=stop_at,
                     wall_ms=(time.perf_counter() - t0) * 1e3,
                     log=buf.getvalue().splitlines())


def loop_resume(model, cfg) -> tuple:
    """(a), (b) and (c): (a) exits 143 with its checkpoint at
    LOOP_STEPS[0], the relaunch (b) of the same run prints that it resumed
    there, and its parameters, moments and step counter are the
    uninterrupted run's, bitwise (exact digests). Returns the record and
    (c)'s result. (a) writes ~4 GB checkpoints at step 6 (in the
    background) and 12 (the preemption save), (b) and (c) at 16."""
    first, second = LOOP_STEPS
    out, rec_a = loop_train(model, cfg, second, LOOP_DIR / "a",
                            stop_at=first)
    check(out == {"exit": 128 + signal.SIGTERM}
          and tckpt.latest_step(str(LOOP_DIR / "a")) == first
          and f"[train] preemption checkpoint at step {first}"
          in rec_a["log"],
          f"loop: run (a) preempted at {first}: {out}, checkpoint "
          f"{tckpt.latest_step(str(LOOP_DIR / 'a'))}")
    del out
    out, rec_b = loop_train(model, cfg, second, LOOP_DIR / "a")
    check(rec_b["stream_from"] == first
          and f"[train] resumed from step {first}" in rec_b["log"],
          f"loop: the relaunch did not resume from step {first}: {rec_b}")
    got = fingerprint([out["params"], list(out["opt_state"])])
    del out
    shutil.rmtree(LOOP_DIR / "a")
    # (c) saves only its last step: the writes change no bit
    out, rec_c = loop_train(model, cfg, second, LOOP_DIR / "c",
                            ckpt_every=second + 1)
    check(fingerprint([out["params"], list(out["opt_state"])]) == got,
          "loop: the resumed run differs from the uninterrupted one")
    shutil.rmtree(LOOP_DIR / "c")
    return dict(bitwise_uninterrupted=True, leaves=len(got), digests=got,
                runs={"a": rec_a, "b": rec_b, "c": rec_c}), out


def loop_sync_free(step, params, state, data) -> tuple:
    """One warm step, the batch drawn from the stream, under
    :func:`sync_free`: the first synchronizing call raises, named, and so
    does a rebuild."""
    torch.cuda.synchronize()
    with sync_free("loop warm step"):
        return step(params, state, next(data))


def loop_steps(model, cfg, params, state) -> dict:
    """The loop's step (``make_train_step``, LOOP_MICRO microbatches) from
    the uninterrupted run's state: one sync-free step, LOOP_TIMED timed
    ones (CUDA events), the allocator's peak beside ``analyze()``."""
    b, s = LOOP_TOKENS
    opt = optim.AdamW(lr=optim.warmup_cosine(LOOP_LR, LOOP_WARMUP,
                                             LOOP_STEPS[1]),
                      weight_decay=0.1)
    step = train_loop.make_train_step(model, opt, LOOP_MICRO)
    data = train_loop.synthetic_lm_data(cfg, b, s, start_step=LOOP_STEPS[1],
                                        device=DEVICE)
    params, state, _ = loop_sync_free(step, params, state, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LOOP_TIMED):
        batch = next(data)
        (params, state, metrics), ms = timed_run(step, params, state, batch)
        times.append(ms)
    loss = float(metrics["loss"])
    check(math.isfinite(loss), f"loop: loss {loss}")
    ms = statistics.median(times)
    shape = dataclasses.replace(configs.SHAPES["train_4k"], global_batch=b)
    return dict(sync_free=True, ms=ms, step_ms=times,
                tokens_per_s=b * s / (ms / 1e3), loss=loss,
                peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                memory_model=memory_record(cfg, shape, CELLS_MESHES[0]))


def loop_microbatch_scale(model, params, batch) -> dict:
    """One step at lr 0 with 1 and LOOP_MICRO microbatches: the losses
    within LOOP_MB_RTOL relative, the gradient norms (of the accumulated
    gradients, before AdamW) within LOOP_GNORM_RTOL."""
    opt = optim.AdamW(lr=0.0)
    losses, norms = {}, {}
    for mb in (1, LOOP_MICRO):
        _, _, m = train_loop.make_train_step(model, opt, mb)(
            params, opt.init(params), batch)
        losses[mb], norms[mb] = float(m["loss"]), float(m["grad_norm"])
    rel = abs(losses[1] - losses[LOOP_MICRO]) / abs(losses[1])
    gnorm_rel = abs(norms[1] - norms[LOOP_MICRO]) / abs(norms[1])
    check(rel <= LOOP_MB_RTOL and gnorm_rel <= LOOP_GNORM_RTOL,
          f"loop: microbatched loss {losses}, gradient norm {norms}")
    return dict(losses=losses, rel_diff=rel, rtol=LOOP_MB_RTOL,
                grad_norms=norms, grad_norm_rel_diff=gnorm_rel,
                grad_norm_rtol=LOOP_GNORM_RTOL)


def loop_remat(cfg, params, batch) -> tuple:
    """One step's loss and gradients (``train_loop.loss_and_grads``) under
    remat "none", "dots" and "full" from one state: each mode warmed by
    one call, then the median ms of LOOP_TIMED (CUDA events) and the
    allocator's peak above what was held before; every leaf bitwise
    "none"'s, or the leaves that differ with their largest difference.
    Returns the record and "none"'s gradients."""
    names = [n for n, _ in named_leaves(params)]
    rec, ref = {}, None
    for remat in ("none", "dots", "full"):
        model = lm.Model(cfg.replace(remat=remat))
        train_loop.loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(LOOP_TIMED):
            (loss, grads), ms = timed_run(train_loop.loss_and_grads, model,
                                          params, batch)
            times.append(ms)
        r = dict(ms=statistics.median(times), call_ms=times,
                 loss=float(loss), peak_above_held_gb=(
                     torch.cuda.max_memory_allocated() - held) / 1e9)
        if ref is None:
            ref = (loss, grads)
        else:
            diffs = {n: float((a - b).abs().max()) for n, a, b in zip(
                ["loss", *names], [loss, *model_common.leaves(grads)],
                [ref[0], *model_common.leaves(ref[1])])
                if not torch.equal(a, b)}
            r.update(bitwise_none=not diffs, differing=diffs)
        rec[remat] = r
        del loss, grads
    check(all(rec[r]["bitwise_none"] for r in ("dots", "full")),
          f"loop: remat changes the loss or gradients: {rec}")
    return rec, ref[1]


def qgrad_leaves(tree) -> list:
    out: list = []
    model_common.tree_map(out.append, tree,
                          lambda x: isinstance(x, compress.QGrad))
    return out


def loop_compress(grads) -> dict:
    """``compress_grads`` on the step's gradients, on the card and on the
    CPU: codes and scales bitwise, the error within one ulp; ms a call
    (CUDA events, the median of LOOP_COMPRESS_CALLS) beside its bytes
    bound (the gradients and the error feedback read, codes, scales and
    the new error written)."""
    ef = compress.init_error_feedback(grads)
    (q, err), _ = timed_run(compress.compress_grads, grads, ef)
    times = [timed_run(compress.compress_grads, grads, ef)[1]
             for _ in range(LOOP_COMPRESS_CALLS)]
    cpu = model_common.tree_map(lambda a: a.cpu(), grads)
    cq, cerr = compress.compress_grads(cpu, compress.init_error_feedback(cpu))
    n = sum(g.numel() for g in model_common.leaves(grads))
    qs = qgrad_leaves(q)
    q_same = all(torch.equal(a.q.cpu(), b.q) and torch.equal(
        a.scale.cpu(), b.scale) for a, b in zip(qs, qgrad_leaves(cq),
                                                 strict=True))
    ulps = 0.0
    for a, b in zip(model_common.leaves(err), model_common.leaves(cerr)):
        a = a.cpu()
        ulp = torch.nextafter(b.abs(), torch.full_like(b, math.inf)) \
            - b.abs()
        ulps = max(ulps, float(((a - b).abs() / ulp).max()))
    check(q_same and ulps <= 1.0, f"loop: compress_grads on the card: "
          f"codes and scales bitwise {q_same}, error {ulps} ulp")
    n_scales = sum(x.scale.numel() for x in qs)
    n_bytes = 4 * n + 4 * n + n + 4 * n + 4 * n_scales
    ms = statistics.median(times)
    return dict(params=n, ms=ms, call_ms=times, bytes=n_bytes,
                bound_ms=n_bytes / HBM_BYTES_S * 1e3, bound_by="bytes",
                bound_share=n_bytes / HBM_BYTES_S * 1e3 / ms,
                codes_scales_bitwise=True, error_max_ulp=ulps,
                ratio=compress.compression_ratio(grads))


class PreemptedLauncher(threading.Thread):
    """``python -u -m repro_torch.launch.train`` (LOOP_LAUNCHER_ARGS, on
    the card) in a subprocess, sent SIGTERM on its ``step LOOP_KILL_AT/``
    line, then relaunched in the same directory, on a thread beside the
    phase's first part (each process takes ~9 s to reach the card); its
    record and its first error wait for :meth:`result`."""

    def __init__(self, ckpt_dir):
        super().__init__(daemon=True)
        self.ckpt_dir = ckpt_dir
        self.args = [*LOOP_LAUNCHER_ARGS, "--steps", str(LOOP_LAUNCHER_STEPS)]
        self.cmd = [sys.executable, "-u", "-m", "repro_torch.launch.train",
                    *self.args, "--ckpt-dir", str(ckpt_dir)]
        self.rec, self.error, self.procs = {}, None, []

    def popen(self, **kw):
        proc = subprocess.Popen(
            self.cmd, cwd=ROOT, env=dict(os.environ,
                                         PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, text=True, **kw)
        self.procs.append(proc)
        return proc

    def run(self):
        try:
            self.preempt_and_relaunch()
        except BaseException as e:          # noqa: BLE001 - see result()
            self.error = e

    def preempt_and_relaunch(self):
        t0 = time.perf_counter()
        proc = self.popen(stderr=subprocess.STDOUT)
        lines, signalled_s = [], None
        for line in proc.stdout:
            lines.append(line.rstrip())
            if signalled_s is None and line.startswith(
                    f"[train] step {LOOP_KILL_AT}/"):
                proc.send_signal(signal.SIGTERM)
                signalled_s = time.perf_counter() - t0
        rc = proc.wait()
        preempted_s = time.perf_counter() - t0
        saved = [int(ln.rsplit(" ", 1)[1]) for ln in lines
                 if ln.startswith("[train] preemption checkpoint at step")]
        latest = tckpt.latest_step(str(self.ckpt_dir))
        check(rc == 128 + signal.SIGTERM and len(saved) == 1
              and latest == saved[0]
              and LOOP_KILL_AT <= saved[0] < LOOP_LAUNCHER_STEPS,
              f"loop: the launcher after SIGTERM: exit {rc}, checkpoint "
              f"{latest}\n" + "\n".join(lines[-20:]))
        k = saved[0]
        t1 = time.perf_counter()
        again = self.popen(stderr=subprocess.PIPE)
        out, err = again.communicate(timeout=300)
        check(again.returncode == 0
              and f"[train] resumed from step {k}" in out
              and f"done at step {LOOP_LAUNCHER_STEPS}" in out,
              f"loop: the relaunch: exit {again.returncode}\n"
              f"{out[-2000:]}{err[-2000:]}")
        self.rec = dict(args=self.args, signalled_after_s=signalled_s,
                        preempted_s=preempted_s, exit=rc,
                        preemption_step=k,
                        relaunch_s=time.perf_counter() - t1,
                        relaunch_tail=out.strip().splitlines()[-1])

    def result(self) -> dict:
        self.join(timeout=600)
        check(not self.is_alive(), "loop: the launcher runs did not end")
        if self.error is not None:
            raise self.error
        return self.rec

    def stop(self) -> None:
        host_stop(*self.procs)


def loop_launcher(runs: PreemptedLauncher) -> dict:
    """The preempted and relaunched launcher (``runs``, ended) against an
    uninterrupted ``main([...])`` in this process: the last checkpoints
    leaf by leaf bitwise."""
    rec = runs.result()
    whole = LOOP_DIR / "launcher_whole"
    before = signal.getsignal(signal.SIGTERM)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = launch_train.main([*runs.args, "--ckpt-dir", str(whole)])
    finally:
        signal.signal(signal.SIGTERM, before)
    check(rc == 0, f"loop: main() returned {rc}")
    return dict(rec, uninterrupted_s=time.perf_counter() - t0,
                leaves_bitwise=same_checkpoint(runs.ckpt_dir, whole,
                                               LOOP_LAUNCHER_STEPS))


# the loop over a mesh (ROADMAP.md §1 item 4(g)): train(mesh=) at the loop
# phase's configuration (the comment above LOOP_ARCH; every step logged, no
# periodic checkpoint) in an NCCL world of every card of the host
# (run_world), started while the parent holds nothing on the card, on each
# mesh of loop_mesh_shapes(world), every rank handed the whole stream and
# cutting its blocks: (a) LOOP_STEPS[1] steps whose last rank sends itself
# SIGTERM on step LOOP_STEPS[0] (every rank leaves train with 143 there,
# one checkpoint written, gathered whole, by rank 0); (b) that run
# relaunched in its directory, the digests of its gathered state; where
# world > 1 an uninterrupted run on the mesh (bitwise (b)) and, on every
# mesh but the first, (c) the previous mesh's (a) checkpoint restored onto
# this one (bitwise its leaves) and relaunched (losses within
# LOOP_MESH_LOSS_RTOL of that mesh's (b)); (e) from (b)'s state, a warm
# step (the batch cut, the step, the ranks' agreement) under
# set_sync_debug_mode, one with the allocator's peak beside analyze() on
# the mesh, LOOP_MESH_TIMED sharded and unsharded steps in turns, one of
# each profiled. The world exits with the last
# mesh's preempted train's SystemExit (143), raised once every rank has
# written its records. On one card (d): the (1, 1) relaunch bitwise the
# loop phase's uninterrupted run (c), and the (1, 1) checkpoint resumed by
# the unsharded loop bitwise (c) too. Two writes a mesh on one card. The
# multi-process launcher (MeshLauncher) runs beside the resume runs.
LOOP_MESH_DIR = ROOT / "build" / "loop_mesh"
LOOP_MESH_TIMED, LOOP_MESH_LOSS_RTOL = 3, 1e-2


def loop_mesh_shapes(world: int) -> list[tuple[int, int]]:
    """The meshes of ``mesh_shapes(world)`` the loop runs on: those whose
    "data" dim leaves each rank a block of LOOP_TOKENS' batch that cuts
    into LOOP_MICRO microbatches (four cards: (1, 4) and (2, 2); (4, 1)
    would leave each rank one of the 4 sequences)."""
    return [m for m in mesh_shapes(world)
            if LOOP_TOKENS[0] % (m[0] * LOOP_MICRO) == 0]


def loop_mesh_specs(cfg, mesh):
    """The train cell's ``in_shardings`` at LOOP_TOKENS on ``mesh``:
    ``(params, opt_state, batch)`` specs."""
    b, s = LOOP_TOKENS
    return steps.build_train_cell(
        cfg, configs.ShapeConfig("loop", s, b, "train"), mesh).in_shardings


def loop_mesh_run(mesh, ckpt_dir, preempt_rank: int | None = None) -> tuple:
    """``train(mesh=)`` of LOOP_STEPS[1] steps in ``ckpt_dir`` (resumed
    from its latest checkpoint, the stream from that step), every step
    logged: (its result, a record: the stream's start, every rank's
    ``[step, loss, grad norm]`` a step, rank 0's ``[train]`` lines, wall
    s). With ``preempt_rank``, that rank sends itself SIGTERM on step
    LOOP_STEPS[0], and the result is ``{"exit": code, "error": the
    SystemExit}``."""
    cfg = loop_cfg()
    b, s = LOOP_TOKENS
    tc = train_loop.TrainConfig(
        steps=LOOP_STEPS[1], microbatches=LOOP_MICRO,
        ckpt_every=LOOP_STEPS[1] + 1, ckpt_dir=str(ckpt_dir), keep=2,
        log_every=1, lr=LOOP_LR, warmup=LOOP_WARMUP)
    start = tckpt.latest_step(str(ckpt_dir)) or 0
    data = train_loop.synthetic_lm_data(cfg, b, s, start_step=start,
                                        device=DEVICE)
    me = torch.distributed.get_rank()
    metrics = []

    def on_metrics(step, m):
        metrics.append([step, m["loss"], m["grad_norm"]])
        if me == preempt_rank and step == LOOP_STEPS[0]:
            os.kill(os.getpid(), signal.SIGTERM)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            out = train_loop.train(lm.Model(cfg), data, tc,
                                   on_metrics=on_metrics, device=DEVICE,
                                   mesh=mesh)
        except SystemExit as e:
            out = {"exit": e.code, "error": e}
    torch.cuda.synchronize()
    return out, dict(stream_from=start, metrics=metrics,
                     wall_s=time.perf_counter() - t0,
                     log=buf.getvalue().splitlines())


def loop_mesh_rank(mesh, i: int, world: int, root) -> tuple:
    """(a), (b), on several cards the uninterrupted run, (c) from the
    previous mesh's checkpoint (on every mesh but the first), and (e) on
    mesh ``i`` of :func:`loop_mesh_shapes`, in every rank: (the records,
    the preempted run's SystemExit)."""
    shapes = loop_mesh_shapes(world)
    root = pathlib.Path(root)
    key = "x".join(map(str, shapes[i]))
    cfg = loop_cfg()
    b, s = LOOP_TOKENS
    p_sh, opt_sh, b_sh = loop_mesh_specs(cfg, mesh)
    like = steps.input_specs(cfg, configs.ShapeConfig("loop", s, b,
                                                      "train"))[:2]

    def digests(params, opt_state):
        # whole_digests reads a tuple as a spec: the trees as lists
        return whole_digests([params, list(opt_state)],
                             [p_sh, list(opt_sh)], mesh)
    a = root / key / "a"
    with SaveClock() as clock:
        out, rec = loop_mesh_run(mesh, a, preempt_rank=world - 1)
    preempted = out.get("error")
    rec.update(exit=out.get("exit"), listing=sorted(os.listdir(a)),
               checkpoints=clock.records)
    with SaveClock() as clock:
        out, rec["b"] = loop_mesh_run(mesh, a)
    rec["b"].update(checkpoints=clock.records,
                    digests=digests(out["params"], out["opt_state"]))
    state = out["params"], out["opt_state"]
    del out
    if world > 1:
        u, _ = loop_mesh_run(mesh, root / key / "u")
        rec["b"]["uninterrupted_digests"] = digests(u["params"],
                                                    u["opt_state"])
        del u
    if i > 0:
        src = "x".join(map(str, shapes[i - 1]))
        step_dir = f"step_{LOOP_STEPS[0]:010d}"
        c = root / key / "c"
        if torch.distributed.get_rank() == 0:
            shutil.copytree(root / src / "a" / step_dir, c / step_dir,
                            copy_function=os.link)
        torch.distributed.barrier(group=train_loop.control_group(mesh))
        blocks, _ = tckpt.restore(str(c), like, device=DEVICE,
                                  specs=(p_sh, opt_sh), mesh=mesh)
        restored = digests(*blocks)
        del blocks
        whole, _ = tckpt.restore(str(c), like, device=DEVICE)
        rec["c"] = dict(source=src, restored_digests=restored,
                        checkpoint_digests=fingerprint(whole))
        del whole
        out, rec["c"]["relaunch"] = loop_mesh_run(mesh, c)
        del out
    torch.cuda.empty_cache()
    rec["timed"] = loop_mesh_timed(mesh, shapes[i], state, b_sh)
    return rec, preempted


def loop_mesh_timed(mesh, shape, state, batch_specs) -> dict:
    """(e) from the relaunch's final ``state`` (this rank's blocks) and
    the stream after it: one warm step (the whole batch arranged and
    cut, the sharded step, the ranks' agreement, as the loop runs them)
    under :func:`sync_free`, the first synchronizing call raising; one with the allocator's peak beside
    ``analyze()`` on the mesh; LOOP_MESH_TIMED sharded steps and as many
    unsharded ones on the whole state on this rank's card, in turns
    (host clock between synchronisations: the collectives run on NCCL's
    streams); one of each profiled (:func:`device_profile`)."""
    cfg = loop_cfg()
    model = lm.Model(cfg)
    b, s = LOOP_TOKENS
    opt = optim.AdamW(lr=optim.warmup_cosine(LOOP_LR, LOOP_WARMUP,
                                             LOOP_STEPS[1]),
                      weight_decay=0.1)
    sharded = train_loop.make_train_step(model, opt, LOOP_MICRO,
                                         model_common.Parallel(
                                             mesh, sharding.current_rules(),
                                             b // LOOP_MICRO))
    arrange = train_loop.microbatch_rows(batch_specs.labels[0], mesh, b,
                                         LOOP_MICRO)
    group = train_loop.control_group(mesh)
    data = train_loop.synthetic_lm_data(cfg, b, s, start_step=LOOP_STEPS[1],
                                        device=DEVICE)
    specs = loop_mesh_specs(cfg, mesh)[:2]

    def sharded_step(st, batch):
        out = sharded(*st, steps.local_args(
            lm.Batch(*map(arrange, batch)), batch_specs, mesh))
        train_loop.agree(False, group)
        return out[:2]
    torch.cuda.synchronize()
    with sync_free(f"loop warm step on a {shape} mesh"):
        state = sharded_step(state, next(data))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, first_ms = wall_ms(sharded_step, state, next(data))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    whole = steps.whole_args(state, specs, mesh)
    unsharded = train_loop.make_train_step(model, opt, LOOP_MICRO)
    times = {"sharded": [], "unsharded": []}
    for i in range(LOOP_MESH_TIMED):
        batch = next(data)
        for kind in (("unsharded", "sharded") if i % 2 == 0
                     else ("sharded", "unsharded")):
            if kind == "sharded":
                state, ms = wall_ms(sharded_step, state, batch)
            else:
                out, ms = wall_ms(unsharded, *whole, batch)
                whole = out[:2]
                del out
            times[kind].append(ms)
    batch = next(data)
    profiles = dict(
        sharded=device_profile(lambda: sharded_step(state, batch), top=8),
        unsharded=device_profile(lambda: unsharded(*whole, batch), top=8))
    del state, whole
    torch.cuda.empty_cache()
    ms = statistics.median(times["sharded"])
    shape_cfg = dataclasses.replace(configs.SHAPES["train_4k"],
                                    global_batch=b)
    return dict(sync_free=True, ms=ms,
                unsharded_ms=statistics.median(times["unsharded"]),
                step_ms=times, peak_step_ms=first_ms,
                tokens_per_s=b * s / (ms / 1e3), peak_allocated_gb=peak_gb,
                profiles=profiles,
                memory_model=memory_record(cfg, shape_cfg,
                                           sharding.mesh_shape(mesh)))


def loop_mesh_world(card: str) -> dict:
    """The world (the comment above LOOP_MESH_DIR) on every card of the
    host, run while this process holds nothing on the card, and its
    records checked: every rank exits 143; on each mesh every rank's
    metrics and digests the same, (a) ending at LOOP_STEPS[0] with one
    checkpoint there, (b) resumed there; on several cards (b) bitwise the
    uninterrupted run, and (c) restored bitwise and within
    LOOP_MESH_LOSS_RTOL. Returns its record (rank 0's ``[train]`` lines
    dropped)."""
    shutil.rmtree(LOOP_MESH_DIR, ignore_errors=True)
    LOOP_MESH_DIR.mkdir(parents=True)
    world = torch.cuda.device_count()
    ranks, world_s = run_world(LOOP_MESH_DIR, world, "loop_mesh",
                               exit_code=128 + signal.SIGTERM)
    ranks = [[dict(r["loop_mesh"], mesh=r["mesh"]) for r in rank
              if "loop_mesh" in r] for rank in ranks]
    first, last = LOOP_STEPS
    shapes = [r["mesh"] for r in ranks[0]]
    for i, a in enumerate(ranks[0]):
        what = f"loop on a {a['mesh']} mesh"
        bb = a["b"]
        check(all(r[i]["exit"] == 128 + signal.SIGTERM
                  and r[i]["metrics"] == a["metrics"] for r in ranks)
              and [m[0] for m in a["metrics"]] == list(range(1, first + 1))
              and a["listing"] == [f"step_{first:010d}"]
              and f"[train] preemption checkpoint at step {first}"
              in a["log"],
              f"{what}: the run preempted on step {first}: "
              f"{[r[i]['exit'] for r in ranks]}, "
              f"{a['listing']}, {a['metrics'][-1:]}")
        check(all(r[i]["b"]["digests"] == bb["digests"]
                  and r[i]["b"]["metrics"] == bb["metrics"]
                  for r in ranks[1:]),
              f"{what}: the relaunch differs between ranks")
        check(bb["stream_from"] == first
              and f"[train] resumed from step {first}" in bb["log"]
              and [m[0] for m in bb["metrics"]]
              == list(range(first + 1, last + 1)),
              f"{what}: the relaunch did not resume at step {first}: "
              f"{bb['log'][:3]}")
        if world == 1:
            continue
        check(bb["uninterrupted_digests"] == bb["digests"],
              f"{what}: the relaunch differs from the uninterrupted run")
        if i == 0:
            continue
        c = a["c"]
        check(c["restored_digests"] == c["checkpoint_digests"],
              f"{what}: the {c['source']} checkpoint restored here differs "
              f"from its leaves")
        src = ranks[0][shapes.index([int(x) for x in c["source"].split(
            "x")])]["b"]
        rels = [abs(x[1] - y[1]) / abs(y[1]) for x, y in zip(
            c["relaunch"]["metrics"], src["metrics"], strict=True)]
        c["loss_rel_diff"] = max(rels)
        check(max(rels) <= LOOP_MESH_LOSS_RTOL,
              f"{what}: the {c['source']} checkpoint relaunched here: "
              f"losses {rels} off that mesh's")

    def quiet(x):
        if isinstance(x, dict):
            return {k: quiet(v) for k, v in x.items() if k != "log"}
        return x
    out = dict(card=card, world=world, world_s=world_s,
               ranks=quiet(ranks))
    emit({"loop_mesh": out})
    return out


class MeshLauncher(threading.Thread):
    """``python -u -m repro_torch.launch.train`` (LOOP_LAUNCHER_ARGS, on
    the cards) as one program over ``n`` processes, one a card
    (``--coordinator`` on a free port of this host, ``--process-id``,
    ``--num-processes``): ``n`` processes sent SIGTERM, every one, on
    rank 0's ``step LOOP_KILL_AT/`` line, beside ``n`` more running
    uninterrupted; then ``n`` relaunched (their last checkpoint bitwise
    the uninterrupted run's) and, where ``n > 1``, ``n // 2`` relaunched
    from a linked copy of the preemption checkpoint (resumed there,
    finished); on a thread beside the loop phase's resume runs, its
    record and first error waiting for :meth:`result`."""

    def __init__(self, root, n: int):
        super().__init__(daemon=True)
        self.root, self.n = pathlib.Path(root), n
        self.args = [*LOOP_LAUNCHER_ARGS, "--steps", str(LOOP_LAUNCHER_STEPS)]
        self.rec, self.error, self.procs = {}, None, []

    def launch(self, n: int, ckpt_dir, **kw) -> list:
        with contextlib.closing(socket.socket()) as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, "-u", "-m", "repro_torch.launch.train",
             *self.args, "--ckpt-dir", str(ckpt_dir), "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(r)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            **kw) for r in range(n)]
        self.procs += procs
        return procs

    @staticmethod
    def finish(procs, timeout: float = 300) -> list:
        return [(p.communicate(timeout=timeout)[0], p.returncode)
                for p in procs]

    def run(self):
        try:
            self.preempt_and_relaunch()
        except BaseException as e:          # noqa: BLE001 - see result()
            self.error = e

    def preempt_and_relaunch(self):
        t0 = time.perf_counter()
        ck, whole, half = (self.root / x for x in ("ck", "whole", "half"))
        procs = self.launch(self.n, ck)
        uninterrupted = self.launch(self.n, whole)
        lines, signalled_s = [], None
        for line in procs[0].stdout:
            lines.append(line.rstrip())
            if line.startswith(f"[train] step {LOOP_KILL_AT}/"):
                for p in procs:
                    p.send_signal(signal.SIGTERM)
                signalled_s = time.perf_counter() - t0
                break
        rest = self.finish(procs)
        lines += rest[0][0].splitlines()
        preempted_s = time.perf_counter() - t0
        saved = [int(ln.rsplit(" ", 1)[1]) for ln in lines
                 if ln.startswith("[train] preemption checkpoint at step")]
        check([rc for _, rc in rest] == [128 + signal.SIGTERM] * self.n
              and len(saved) == 1 and tckpt.latest_step(str(ck)) == saved[0]
              and os.listdir(ck) == [f"step_{saved[0]:010d}"]
              and LOOP_KILL_AT <= saved[0] < LOOP_LAUNCHER_STEPS,
              f"loop: {self.n} launcher processes after SIGTERM: exits "
              f"{[rc for _, rc in rest]}, checkpoint "
              f"{tckpt.latest_step(str(ck))}\n" + "\n".join(lines[-20:]))
        k = saved[0]
        if self.n > 1:
            shutil.copytree(ck, half, copy_function=os.link)
        t1 = time.perf_counter()
        again = self.launch(self.n, ck)
        fewer = self.launch(self.n // 2, half) if self.n > 1 else []
        again, fewer = self.finish(again), self.finish(fewer)
        for run in (again, fewer) if self.n > 1 else (again,):
            for out, rc in run:
                check(rc == 0, f"loop: a relaunched launcher process: exit "
                      f"{rc}\n{out[-2000:]}")
            check(f"[train] resumed from step {k}" in run[0][0]
                  and f"done at step {LOOP_LAUNCHER_STEPS}" in run[0][0],
                  f"loop: the relaunch of {len(run)} launcher processes did "
                  f"not resume at {k} and finish\n{run[0][0][-2000:]}")
        relaunch_s = time.perf_counter() - t1
        check(all(rc == 0 for _, rc in self.finish(uninterrupted)),
              "loop: the uninterrupted launcher processes failed")
        self.rec = dict(args=self.args, processes=self.n,
                        signalled_after_s=signalled_s,
                        preempted_s=preempted_s, exits=[rc for _, rc in rest],
                        preemption_step=k, relaunch_s=relaunch_s,
                        relaunched_half=self.n // 2 if self.n > 1 else None,
                        leaves_bitwise=same_checkpoint(
                            ck, whole, LOOP_LAUNCHER_STEPS))

    def result(self) -> dict:
        self.join(timeout=900)
        check(not self.is_alive(), "loop: the launcher processes did not end")
        if self.error is not None:
            raise self.error
        return self.rec

    def stop(self) -> None:
        host_stop(*self.procs)


def same_checkpoint(a, b, step: int) -> int:
    """Every leaf of ``a``'s and ``b``'s checkpoints at ``step``: the same
    names, dtypes and bits. Returns the number of leaves."""
    da, db = (pathlib.Path(d) / f"step_{step:010d}" for d in (a, b))
    names = [json.loads((d / "MANIFEST.json").read_text())["leaves"]
             for d in (da, db)]
    check(sorted(names[0]) == sorted(names[1]), "loop: the checkpoints' "
          "leaf names differ")
    for name in names[0]:
        x, y = (np.load(d / f"{name}.npy") for d in (da, db))
        check(x.dtype == y.dtype and np.array_equal(x, y),
              f"loop: the relaunched checkpoint's {name} differs from the "
              f"uninterrupted one's")
    return len(names[0])


def loop_phase(card: str) -> dict:
    """The training runtime on the card (the comment above LOOP_ARCH):
    first the loop over a mesh (:func:`loop_mesh_world`, while this
    process holds nothing on the card); then, beside the launcher's
    preempted runs (one process, and one a card), the loop's resume
    bitwise, and on one card (d); then the timed steps, the microbatch
    scale, remat "none", "dots" and "full", the gradients' compression against
    the CPU, the launchers' checkpoints against uninterrupted runs. Every
    record carries the card's name and power limit; the checkpoints' host
    copies, writes and restores (:class:`SaveClock`) and the phase's
    seconds last."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    part_s = {}

    def done(name: str, t: float, **recs) -> None:
        part_s[name] = time.perf_counter() - t
        emit({"loop": dict(card=card, part=name, part_s=part_s[name],
                           **recs)})
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    LOOP_DIR.mkdir(parents=True)
    world = torch.cuda.device_count()
    rec = {"card": card, "arch": LOOP_ARCH,
           "cut": f"{LOOP_LAYERS} of 16 layers, train_4k's batch 256 -> "
                  f"{LOOP_TOKENS[0]}"}
    rec["mesh"] = loop_mesh_world(card)
    done("mesh", t0)
    # the launchers' preemptions and relaunches run beside the resume
    # runs, and are waited for before anything is timed
    runs = PreemptedLauncher(LOOP_DIR / "launcher")
    runs.start()
    procs = MeshLauncher(LOOP_DIR / "mesh_launcher", world)
    procs.start()
    cfg = loop_cfg()
    model = lm.Model(cfg)
    handler = signal.getsignal(signal.SIGTERM)
    rec["params"] = model_common.count_params(model.abstract_params())
    try:
        with SaveClock() as clock:
            t = time.perf_counter()
            params = model.init(torch.Generator(device=DEVICE).manual_seed(
                SEED + 70))
            opt = optim.AdamW(lr=optim.warmup_cosine(
                LOOP_LR, LOOP_WARMUP, LOOP_STEPS[1]), weight_decay=0.1)
            batch = next(train_loop.synthetic_lm_data(
                cfg, *LOOP_TOKENS, device=DEVICE))
            _, rec["first_step_ms"] = timed_run(
                train_loop.make_train_step(model, opt, LOOP_MICRO), params,
                opt.init(params), batch)
            rec["resume"], out = loop_resume(model, cfg)
            done("resume", t, resume=rec["resume"],
                 first_step_ms=rec["first_step_ms"])
            if world == 1:
                t = time.perf_counter()
                rec["mesh_elastic"] = loop_mesh_elastic(
                    model, cfg, rec["mesh"], rec["resume"]["digests"])
                done("mesh_elastic", t, mesh_elastic=rec["mesh_elastic"])
            t = time.perf_counter()
            runs.result()
            procs.result()
            done("launcher_wait", t)
            t = time.perf_counter()
            rec["steps"] = loop_steps(model, cfg, out["params"],
                                      out["opt_state"])
            del out
            torch.cuda.empty_cache()
            rec["microbatch_scale"] = loop_microbatch_scale(model, params,
                                                            batch)
            done("steps", t, steps=rec["steps"],
                 microbatch_scale=rec["microbatch_scale"])
            t = time.perf_counter()
            rec["remat"], grads = loop_remat(cfg, params, batch)
            del params
            done("remat", t, remat=rec["remat"])
            t = time.perf_counter()
            rec["compress"] = loop_compress(grads)
            del grads
            torch.cuda.empty_cache()
            done("compress", t, compress=rec["compress"])
            t = time.perf_counter()
            rec["launcher"] = loop_launcher(runs)
            rec["mesh_launcher"] = procs.result()
            done("launcher", t, launcher=rec["launcher"],
                 mesh_launcher=rec["mesh_launcher"])
        rec["checkpoints"] = clock.records
        rec["written_gb"] = sum(r["gb"] for r in clock.records
                                if r["what"] == "write")
    finally:
        runs.stop()
        procs.stop()
        signal.signal(signal.SIGTERM, handler)
        shutil.rmtree(LOOP_DIR, ignore_errors=True)
        shutil.rmtree(LOOP_MESH_DIR, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t0
    emit({"loop": {"card": card, "checkpoints": rec["checkpoints"],
                   "written_gb": rec["written_gb"], "part_s": part_s,
                   "phase_s": rec["phase_s"]}})
    return rec


def loop_mesh_elastic(model, cfg, world_rec: dict, want: list) -> dict:
    """(d), on one card: the (1, 1) relaunch's digests (in
    ``world_rec``, :func:`loop_mesh_world`'s) against the loop phase's
    uninterrupted run's (``want``, bitwise), and the (1, 1) checkpoint
    (linked into LOOP_DIR) resumed by the unsharded loop, bitwise that
    run too."""
    check(world_rec["ranks"][0][0]["b"]["digests"] == want,
          "loop: the (1, 1) mesh's relaunch differs from the unsharded "
          "uninterrupted run")
    step_dir = f"step_{LOOP_STEPS[0]:010d}"
    d = LOOP_DIR / "d"
    shutil.copytree(LOOP_MESH_DIR / "1x1" / "a" / step_dir, d / step_dir,
                    copy_function=os.link)
    out, rec = loop_train(model, cfg, LOOP_STEPS[1], d)
    check(rec["stream_from"] == LOOP_STEPS[0]
          and fingerprint([out["params"], list(out["opt_state"])]) == want,
          "loop: the (1, 1) mesh's checkpoint resumed by the unsharded "
          "loop differs from the uninterrupted run")
    del out
    shutil.rmtree(d)
    return dict(mesh_relaunch_bitwise=True, unsharded_relaunch_bitwise=True,
                unsharded_relaunch=rec)


def loop_mesh_only(card: str) -> None:
    """``--only loop_mesh``: the loop over a mesh alone, then the
    launcher over a process a card."""
    t0 = time.perf_counter()
    try:
        loop_mesh_world(card)
        procs = MeshLauncher(LOOP_DIR / "mesh_launcher",
                             torch.cuda.device_count())
        procs.start()
        try:
            emit({"loop_mesh": dict(part="launcher", card=card,
                                    **procs.result())})
        finally:
            procs.stop()
    finally:
        shutil.rmtree(LOOP_MESH_DIR, ignore_errors=True)
        shutil.rmtree(LOOP_DIR, ignore_errors=True)
    emit({"loop_mesh": {"card": card, "phase_s": time.perf_counter() - t0}})


# the paper's loop as a user starts it: each port-side twin of the
# reference's last three examples (examples/*_torch.py) in a subprocess on
# the card, all at once, against the kernels built above, with every
# kernel's count zeroed right before the twin's main() and read right
# after it (COUNTED_RUN); the lines each must print (the twin's LINES) and
# their headline numbers. Meanwhile, in this process, the twins' stage
# functions on the card and on the CPU on the same inputs at the runs'
# shapes (examples_parity)
QS, GC, E2E = ("quickstart_torch", "gated_cascade_torch",
               "intelligent_sensing_e2e_torch")
#: what training a gate and scoring frames with it launch
GATE_KERNELS = ("hdc_encode_perm", "similarity", "sliding_scores_f32")
#: name: (twin, arguments, its LINES' key or None, the kernels it launches)
EXAMPLE_RUNS = {
    "quickstart": (QS, (), None, GATE_KERNELS),
    "gated_cascade": (GC, (), None, ("sliding_scores_f32",)),
    "e2e": (E2E, (), "stream", GATE_KERNELS),
    "e2e_sensors_4": (E2E, ("--sensors", "4"), "fleet", GATE_KERNELS),
    "e2e_drift": (E2E, ("--drift",), "drift", GATE_KERNELS),
    "e2e_control": (E2E, ("--control",), "control", GATE_KERNELS),
}
EXAMPLES_TIMEOUT_S = 300
EXAMPLES_DIR = ROOT / "build" / "examples"
#: ``python -c COUNTED_RUN <counts file> <{name: kernel module}> <script>
#: <arguments>``: the script as ``__main__``, every module's LAUNCHES set to
#: 0 right before it and written to the counts file right after it
COUNTED_RUN = """\
import importlib, json, runpy, sys
out, names, sys.argv = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
mods = {k: importlib.import_module(m) for k, m in names.items()}
for m in mods.values():
    m.LAUNCHES = 0
runpy.run_path(sys.argv[0], run_name="__main__")
with open(out, "w") as f:
    json.dump({k: m.LAUNCHES for k, m in mods.items()}, f)
"""
# energy totals and savings, for equal stats (the CPU tests' bound)
ENERGY_RTOL = 1e-6
_TWINS: dict = {}


def twin(name: str):
    """The module ``examples/<name>.py``, loaded once from its file."""
    if name not in _TWINS:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        _TWINS[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_TWINS[name])
    return _TWINS[name]


def example_lines(name: str) -> tuple:
    """The patterns of the lines the run ``name`` must print."""
    mod, mode = twin(EXAMPLE_RUNS[name][0]), EXAMPLE_RUNS[name][2]
    return mod.LINES if mode is None else mod.LINES[mode]


def example_numbers(name: str, out: str) -> dict:
    """The numbers named in the patterns of :func:`example_lines`, each
    matched in order on a line of the standard output ``out``; a pattern
    that matches the lines right after its first too gives the list of
    their numbers. Raises where a line is missing."""
    lines, numbers, at = out.splitlines(), {}, 0
    for pattern in example_lines(name):
        hits = []
        for i in range(at, len(lines)):
            m = re.fullmatch(pattern, lines[i])
            if m:
                hits.append(m)
                at = i + 1
            elif hits:
                break
        check(bool(hits), f"examples: {name} printed no line "
                          f"{pattern!r}:\n{out[-2000:]}")
        for key in hits[0].groupdict():
            values = [float(m[key]) for m in hits]
            numbers[key] = values[0] if len(hits) == 1 else values
    return numbers


def counted(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every kernel's count zeroed right
    before it: its result and the counts it left (those above 0)."""
    for mod in ID_KERNELS.values():
        mod.LAUNCHES = 0
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, {k: mod.LAUNCHES for k, mod in ID_KERNELS.items()
                 if mod.LAUNCHES}


def launched(what: str, counts: dict, kernels) -> dict:
    """``counts``, checked to hold every one of ``kernels``."""
    for k in kernels:
        check(counts.get(k, 0) > 0, f"examples: {what} never launched {k}")
    return counts


def score_err(got, want) -> float:
    """The largest |difference| of two score arrays where both are finite
    (the closed loop scores only the frames it samples)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"scores {got.shape} vs {want.shape}")
    both = np.isfinite(got) & np.isfinite(want)
    return float(np.abs(got[both] - want[both]).max(initial=0.0))


def auc_slack(scores, labels) -> float:
    """Share of positive-negative pairs whose scores lie within
    ``2 * SCORE_ATOL``: the most two AUCs of scores within SCORE_ATOL of
    each other can differ by."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels).astype(bool)
    close = np.abs(s[y][:, None] - s[~y][None, :]) <= 2 * SCORE_ATOL
    return float(close.sum()) / max(close.size, 1)


def same_stats(got, want) -> bool:
    return (np.array_equal(np.asarray(got.decisions),
                           np.asarray(want.decisions))
            and np.array_equal(np.asarray(got.gated_on),
                               np.asarray(want.gated_on)))


def rel_close(got: float, want: float, rtol: float = ENERGY_RTOL) -> bool:
    return abs(got - want) <= rtol * abs(want)


def decided(what: str, agree: bool, scores, t_score: float, got=None,
            want=None) -> dict:
    """The card's decisions against the CPU's. Every frame whose deciding
    score (the CPU's, in ``scores``) sits more than DECISION_MARGIN from
    ``t_score`` is decided alike (``got``, ``want``: the per-frame
    decisions, where given), and the whole run agrees (``agree``: its
    decisions, hysteresis and capture) unless a score sits nearer."""
    s = np.asarray(scores, np.float64)
    clear = np.isfinite(s) & (np.abs(s - t_score) > DECISION_MARGIN)
    ties = int((np.isfinite(s) & ~clear).sum())
    if got is not None:
        check(np.array_equal(np.asarray(got)[clear], np.asarray(want)[clear]),
              f"examples: {what}: the card decides a frame the CPU decides "
              f"apart, its score beyond DECISION_MARGIN")
    check(agree or ties > 0, f"examples: {what}: the card's run differs "
          f"from the CPU's with no score within DECISION_MARGIN")
    return {"decisions_agree": agree, "near_ties": ties}


def scores_held(what: str, got, want) -> float:
    err = score_err(got, want)
    check(err <= SCORE_ATOL, f"examples: {what}: card vs CPU scores {err}")
    return err


def quiet(fn, *args):
    """``fn(*args)`` with what it prints swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def cpu_gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def quickstart_parity() -> dict:
    """``quickstart_torch``'s steps 3-5 at its shapes: the fragment model
    trained on the card (counted) from a CPU generator's base; the
    training's encode and similarity at its shapes held against their
    plain versions on the same inputs; then ``fragment_auc`` and
    ``frame_decisions`` of that model on the card (counted) and on the
    CPU."""
    qs = twin(QS)
    h = qs.FRAG
    frames, masks, _ = synthetic.make_dataset(
        cpu_gen(SEED + 30), 80, synthetic.RadarConfig(height=qs.FRAME,
                                                      width=qs.FRAME),
        device="cpu")
    lp = adc.quantize(frames, bits=4)
    frags, flabels = fragments.sample_fragments(
        lp.numpy(), masks.numpy(), h=h, w=h, per_frame=2, seed=0)
    cut = int(len(frags) * 0.8)
    (model, _), train_counts = counted(
        fragment_model.train_fragment_model, cpu_gen(SEED + 31), frags[:cut],
        flabels[:cut], dim=qs.DIM, epochs=qs.EPOCHS, device=DEVICE)
    cpu = fragment_model.FragmentModel(
        *(a.cpu() for a in (model.class_hvs, model.B, model.b)))
    B0 = model.B.reshape(h, h, -1)[:, 0, :]
    x = encoding.normalize_flat(torch.as_tensor(frags[:cut]).reshape(cut,
                                                                     -1))
    hv = enc_perm.hdc_encode_perm(x, B0.cpu(), cpu.b, h=h, w=h)
    enc_err = float((enc_perm.hdc_encode_perm(
        x.to(DEVICE), B0, model.b, h=h, w=h).cpu() - hv).abs().max())
    check(enc_err <= HV_ATOL, f"examples: quickstart encode {enc_err}")
    sim_err = float(
        (fragment_model.scores(model.class_hvs, hv.to(DEVICE)).cpu()
         - fragment_model.scores(cpu.class_hvs, hv)).abs().max())
    check(sim_err <= SCORE_ATOL, f"examples: quickstart similarity "
                                 f"{sim_err}")

    (got, auc), auc_counts = counted(qs.fragment_auc, model, frags[cut:],
                                     flabels[cut:])
    want, want_auc = qs.fragment_auc(cpu, frags[cut:], flabels[cut:])
    err = scores_held("quickstart fragment scores", got, want)
    check(abs(auc - want_auc) <= auc_slack(want, flabels[cut:]),
          f"examples: quickstart AUC {auc} vs {want_auc}")
    dec, dec_counts = counted(qs.frame_decisions, model,
                              lp[:16].to(DEVICE))
    hs = hypersense.from_fragment_model(cpu, B0.cpu(), h=h, w=h,
                                        stride=qs.STRIDE)
    want_dec = qs.frame_decisions(cpu, lp[:16])
    return dict(
        train_launches=launched("quickstart training", train_counts,
                                ("hdc_encode_perm", "similarity")),
        encode_max_abs_err=enc_err, similarity_max_abs_err=sim_err,
        fragment_scores_max_abs_err=err, auc_card=auc, auc_cpu=want_auc,
        launches=launched("quickstart scoring", {
            k: auc_counts.get(k, 0) + dec_counts.get(k, 0)
            for k in {**auc_counts, **dec_counts}},
            ("similarity", "sliding_scores_f32")),
        frames=decided("quickstart frame decisions",
                       np.array_equal(dec, want_dec),
                       hypersense.frame_scores_batch(hs, lp[:16]).numpy(),
                       hs.t_score, dec, want_dec))


def e2e_gate(e2e, size: int, frag: int, dim: int, stride: int):
    """``train_gate`` at one of the twin's sizes on the card (counted),
    its print swallowed: the card's gate and the same gate on the CPU,
    and the counts."""
    cfg = synthetic.RadarConfig(height=size, width=size)
    op, counts = counted(quiet, e2e.train_gate, DEVICE, cfg, frag, dim,
                         stride)
    return cfg, op["gate"], op["gate"].to("cpu"), launched(
        f"e2e train_gate at {size}x{size}", counts, GATE_KERNELS)


def e2e_parity() -> dict:
    """``intelligent_sensing_e2e_torch``'s four modes at their shapes, on
    gates trained on the card: ``operating_point``, ``single_stream``,
    ``sensor_fleet``, ``drift`` and ``closed_loop`` on the card (counted)
    and on the CPU on the same frames, drawn from CPU generators."""
    e2e = twin(E2E)
    n = 150
    cfg, gate, cpu, counts64 = e2e_gate(e2e, 64, 16, 2048, 8)
    out = {"train_gate_64_launches": counts64}

    te, _, te_labels = synthetic.make_dataset(cpu_gen(SEED + 32), 24, cfg,
                                              device="cpu")
    te = adc.quantize(te, 4)
    op, c = counted(e2e.operating_point, gate, te.to(DEVICE), te_labels)
    want = e2e.operating_point(cpu, te, te_labels)
    slack = auc_slack(want["scores"], te_labels)
    check(abs(op["t_score"] - want["t_score"]) <= SCORE_ATOL
          and (slack > 0 or op["tpr"] == want["tpr"]),
          f"examples: operating point {op['t_score']}, {op['tpr']} vs "
          f"{want['t_score']}, {want['tpr']}")
    out["operating_point"] = dict(
        scores_max_abs_err=scores_held("operating point", op["scores"],
                                       want["scores"]),
        t_score_card=op["t_score"], t_score_cpu=want["t_score"],
        tpr_card=op["tpr"], tpr_cpu=want["tpr"], auc_slack=slack,
        launches=launched("operating point", c, ("sliding_scores_f32",)))

    control = ControllerConfig(hold_frames=3)
    stream, labels = synthetic.make_stream(cpu_gen(SEED + 33), n, cfg,
                                           event_prob=0.03, event_len=10,
                                           device="cpu")
    labels = labels.numpy()
    lp = adc.quantize(stream, 4)
    r, c = counted(e2e.single_stream, gate, stream.to(DEVICE), labels,
                   control)
    w = e2e.single_stream(cpu, stream, labels, control)
    rec = decided("single stream", same_stats(r["stats"], w["stats"]),
                  hypersense.frame_scores_batch(cpu, lp).numpy(),
                  cpu.t_score, r["stats"].decisions, w["stats"].decisions)
    if rec["decisions_agree"] and "energy" in w:
        check(all(rel_close(r[k], w[k]) for k in ("total_saving",
                                                  "edge_saving"))
              and rel_close(r["energy"].total, w["energy"].total),
              "examples: single stream energy")
    out["single_stream"] = dict(
        rec, scores_max_abs_err=scores_held(
            "single stream", hypersense.frame_scores_batch(
                gate, lp.to(DEVICE)).cpu().numpy(),
            hypersense.frame_scores_batch(cpu, lp).numpy()),
        launches=launched("single stream", c, ("sliding_scores_f32",)))

    streams = [synthetic.make_stream(cpu_gen(SEED + 34 + s), n, cfg,
                                     event_prob=0.03, event_len=10,
                                     device="cpu") for s in range(4)]
    fr = torch.stack([f for f, _ in streams])
    fl = np.stack([lb.numpy() for _, lb in streams])
    r, c = counted(e2e.sensor_fleet, gate, fr.to(DEVICE), fl, control)
    w = e2e.sensor_fleet(cpu, fr, fl, control)
    rec = decided("fleet", all(same_stats(a, b)
                               for a, b in zip(r.stats, w.stats)),
                  hypersense.frame_scores_batch(
                      cpu, adc.quantize(fr.reshape(-1, 64, 64), 4)).numpy(),
                  cpu.t_score,
                  np.concatenate([st.decisions for st in r.stats]),
                  np.concatenate([st.decisions for st in w.stats]))
    if rec["decisions_agree"]:
        check(r.duty_cycle == w.duty_cycle
              and all(rel_close(getattr(r, k), getattr(w, k)) for k in (
                  "energy_total_j", "baseline_total_j", "total_saving")),
              "examples: fleet duty and energy")
    out["sensor_fleet"] = dict(rec, launches=launched(
        "fleet", c, ("sliding_scores_f32",)))

    cfg, gate, cpu, counts32 = e2e_gate(e2e, 32, 8, 1024, 4)
    out["train_gate_32_launches"] = counts32
    shift = synthetic.DriftConfig(background_gain=(0.0, 0.6),
                                  noise_sigma=(0.12, 0.28),
                                  object_intensity=(0.8, 0.35))
    stream, labels = synthetic.make_drift_stream(
        cpu_gen(SEED + 38), n, cfg, shift, event_prob=0.05, event_len=10,
        device="cpu")
    labels = labels.numpy()
    r, c = counted(e2e.drift, gate, stream.to(DEVICE), labels, control)
    w = e2e.drift(cpu, stream, labels, control)
    half = n // 2
    drift_rec = {}
    for name in w:
        got, want = r[name], w[name]
        check(abs(got["auc"] - want["auc"]) <= auc_slack(
            want["scores"][half:], labels[half:]),
            f"examples: drift {name} AUC {got['auc']} vs {want['auc']}")
        drift_rec[name] = dict(
            scores_max_abs_err=scores_held(f"drift {name}", got["scores"],
                                           want["scores"]),
            auc_card=got["auc"], auc_cpu=want["auc"])
    out["drift"] = dict(drift_rec, launches=launched(
        "drift", c, ("sliding_scores_f32",)))

    rates = ControllerConfig(base_rate_hz=10, active_rate_hz=60,
                             hold_frames=6)
    stream, labels = synthetic.make_stream(cpu_gen(SEED + 39), n, cfg,
                                           event_prob=0.01, event_len=12,
                                           device="cpu")
    labels = labels.numpy()
    r, c = counted(e2e.closed_loop, gate, stream.to(DEVICE), labels, rates)
    w = e2e.closed_loop(cpu, stream, labels, rates)
    agree = (same_stats(r["stats"], w["stats"])
             and np.array_equal(r["log"].sampled, w["log"].sampled)
             and np.array_equal(r["log"].gated, w["log"].gated))
    rec = decided("closed loop", agree, w["scores"], cpu.t_score,
                  r["stats"].decisions, w["stats"].decisions)
    if agree:
        check(np.array_equal(r["hp_idx"], w["hp_idx"])
              and np.array_equal(np.asarray(r["hp_frames"]),
                                 np.asarray(w["hp_frames"]))
              and r["hp_dropped"] == w["hp_dropped"]
              and all(rel_close(r[k].total, w[k].total)
                      for k in ("ours", "always", "conv"))
              and rel_close(r["saving"], w["saving"]),
              "examples: closed loop HP drain and energy")
    out["closed_loop"] = dict(
        rec, scores_max_abs_err=scores_held("closed loop", r["scores"],
                                            w["scores"]),
        saving_card=r["saving"], saving_cpu=w["saving"],
        launches=launched("closed loop", c, ("sliding_scores_f32",)))
    return out


def gated_cascade_parity() -> dict:
    """``gated_cascade_torch``'s loop, drawn as its ``main()`` draws it
    (CPU generators), on the card (counted) and on the CPU: the open-loop
    scores, then at the CPU's q75 threshold the capture log, the
    backbone's batches and logits, one build, and the system energy."""
    gc = twin(GC)
    hw = (gc.FRAME, gc.FRAME)

    def gen(seed):
        return cpu_gen(gc.SEED + seed)

    B0, b = encoding.make_perm_base_rows(gen(1), 8, 256)
    cpu = hypersense.HyperSenseModel(
        torch.randn((2, 256), generator=gen(2)), B0, b, h=8, w=8, stride=4,
        t_score=0.0, t_detection=1)
    stream, _ = synthetic.make_drift_stream(
        gen(3), 8 * gc.CHUNK, synthetic.RadarConfig(height=gc.FRAME,
                                                    width=gc.FRAME),
        event_prob=0.03, event_len=10, device="cpu")
    (card, got), c0 = counted(gc.open_loop_threshold, cpu.to(DEVICE),
                              stream.to(DEVICE))
    cpu, want = gc.open_loop_threshold(cpu, stream)
    open_err = scores_held("cascade open loop", got, want)
    card = dataclasses.replace(card, t_score=cpu.t_score)
    cfg = configs.get_smoke("hubert-xlarge")
    params = steps.init_detector_params(gen(7), cfg, frame_hw=hw, patch=8)
    r, c = counted(gc.gated_cascade, card, stream.to(DEVICE),
                   CascadeService(params, cfg, batch_size=gc.BATCH,
                                  frame_hw=hw, device=DEVICE))
    w = gc.gated_cascade(cpu, stream,
                         CascadeService(params, cfg, batch_size=gc.BATCH,
                                        frame_hw=hw, device="cpu"))
    check(r["builds"] == 1, f"examples: cascade {r['builds']} builds")
    log, wlog = r["runner"].capture_log, w["runner"].capture_log
    agree = (np.array_equal(log.sampled, wlog.sampled)
             and np.array_equal(log.gated, wlog.gated))
    rec = decided("cascade", agree,
                  hypersense.frame_scores_batch(cpu, stream).numpy(),
                  cpu.t_score)
    check(len(w["batches"]) > 0, "examples: the CPU cascade saw no frame")
    if agree:
        idx = np.concatenate([x.frame_idx for x in r["batches"]])
        check(np.array_equal(idx, np.concatenate(
            [x.frame_idx for x in w["batches"]])),
            "examples: cascade frame indices")
        logits = np.concatenate([x.logits for x in r["batches"]])
        want_l = np.concatenate([x.logits for x in w["batches"]])
        rec["logits_max_abs_err"] = float(np.abs(logits - want_l).max())
        rec["max_abs_logit"] = float(np.abs(want_l).max())
        check(rec["logits_max_abs_err"]
              <= CASCADE_F32_RTOL * rec["max_abs_logit"],
              f"examples: cascade logits {rec['logits_max_abs_err']}")
        e, we = r["energy"], w["energy"]
        check(all(rel_close(e[k].total, we[k].total)
                  for k in ("cascade", "always_on")),
              "examples: cascade system energy")
    return dict(rec, open_loop_max_abs_err=open_err, builds=r["builds"],
                batches=len(r["batches"]), duty_card=r["duty"],
                duty_cpu=w["duty"],
                launches=launched("cascade", {
                    k: c0.get(k, 0) + c.get(k, 0) for k in {**c0, **c}},
                    ("sliding_scores_f32",)))


def examples_parity() -> dict:
    t0 = time.perf_counter()
    out = {"quickstart": quickstart_parity(),
           "gated_cascade": gated_cascade_parity(), "e2e": e2e_parity()}
    out["parity_s"] = time.perf_counter() - t0
    return out


def examples_phase(card: str) -> dict:
    """Every run of EXAMPLE_RUNS as its own process on the card, all
    started at once (the kernels already built under ``build/kernels``),
    and :func:`examples_parity` in this process meanwhile: each run must
    exit 0, print its lines and launch its kernels;
    ``gated_cascade_torch.py`` one backbone build across its ragged
    drains. Records each run's wall seconds (from its start to its exit,
    beside the five others and the parity), its counts and its headline
    numbers; every process is stopped on the way out."""
    torch.cuda.empty_cache()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    EXAMPLES_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    modules = json.dumps({k: m.__name__ for k, m in ID_KERNELS.items()})
    t0 = time.perf_counter()
    procs, files, walls, waiters = {}, [], {}, []

    def wait(name, p, start):
        p.wait()
        walls[name] = time.perf_counter() - start

    try:
        for name, (script, args, _, _) in EXAMPLE_RUNS.items():
            out = open(EXAMPLES_DIR / f"{name}.out", "w")
            err = open(EXAMPLES_DIR / f"{name}.err", "w")
            files += [out, err]
            p = subprocess.Popen(
                [sys.executable, "-c", COUNTED_RUN,
                 str(EXAMPLES_DIR / f"{name}.json"), modules,
                 str(ROOT / "examples" / f"{script}.py"), *args],
                cwd=ROOT, env=env, stdout=out, stderr=err)
            procs[name] = p
            waiters.append(threading.Thread(
                target=wait, args=(name, p, time.perf_counter()),
                daemon=True))
            waiters[-1].start()
        parity = examples_parity()
        for th in waiters:
            th.join(max(0.0, EXAMPLES_TIMEOUT_S - (time.perf_counter() - t0)))
        check(len(walls) == len(procs),
              f"examples: {sorted(set(procs) - set(walls))} still running "
              f"after {EXAMPLES_TIMEOUT_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    runs = {}
    for name, (script, args, _, kernels) in EXAMPLE_RUNS.items():
        p = procs[name]
        out = (EXAMPLES_DIR / f"{name}.out").read_text()
        err = (EXAMPLES_DIR / f"{name}.err").read_text()
        check(p.returncode == 0, f"examples: {script} {' '.join(args)} "
              f"exited {p.returncode}:\n{err[-3000:]}")
        counts = json.loads((EXAMPLES_DIR / f"{name}.json").read_text())
        runs[name] = dict(
            command=" ".join([f"examples/{script}.py", *args]),
            wall_s=walls[name],
            launches=launched(name, {k: v for k, v in counts.items() if v},
                              kernels),
            **example_numbers(name, out))
    check(runs["gated_cascade"]["builds"] == 1,
          f"gated_cascade: {runs['gated_cascade']['builds']} backbone "
          f"builds across its ragged drains, 1 expected")
    check(0.0 <= runs["quickstart"]["auc"] <= 1.0, "quickstart: AUC")
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    rec = {"card": card, "concurrent_processes": len(runs), "runs": runs,
           "parity": parity, "phase_s": time.perf_counter() - t0}
    emit({"examples": rec})
    return rec


TRAIN_KERNELS = {"hdc_encode_perm": enc_perm, "hdc_encode": enc,
                 "similarity": sim, "sliding_scores_f32": ss}


def fragment_sets(g):
    """Training and held-out sets: half the frames carry a blob; balanced
    fragments sampled from each (2 and 3 per frame, seeds 0 and 1)."""
    sets = []
    for n, per_frame, seed in ((N_TRAIN, 2, 0), (N_HELD_OUT, 3, 1)):
        labels = torch.arange(n, device=g.device) % 2
        frames, centres = synthetic_frames(g, labels)
        # object mask: where a labelled frame's blob is above half its peak
        masks = (blobs(centres) > 0.5) & (labels[:, None, None] == 1)
        frags, flabels = fragments.sample_fragments(
            frames.cpu().numpy(), masks.cpu().numpy(), h=FRAG, w=FRAG,
            per_frame=per_frame, seed=seed)
        sets.append((frames, labels.cpu().numpy(), frags, flabels))
    return sets


def generators(B):
    """The ``(h, D)`` permutation generators of a flat ``(h*w, D)`` base:
    row ``r*w`` is ``roll(B0[r], 0)``."""
    return B.reshape(FRAG, FRAG, DIM)[:, 0, :].contiguous()


def train_path(frags, flabels, test):
    """The training path once: train, score the held-out fragments and
    frames. Returns the model, its outputs and each step's wall seconds."""
    test_frames, test_labels, tfrags, tflabels = test
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    wall = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    model, info = step("train_s", lambda: fragment_model.train_fragment_model(
        gen, frags, flabels, dim=DIM, epochs=EPOCHS, base_kind="perm",
        device=DEVICE))
    hv_te = step("encode_held_out_s", lambda: fragment_model.encode(
        model, torch.as_tensor(tfrags, device=DEVICE)))
    scores = step("positive_score_s", lambda: fragment_model.positive_score(
        model.class_hvs, hv_te)).cpu().numpy()
    fpr, tpr, _ = metrics.roc_curve(scores, tflabels)
    B0 = generators(model.B)
    hs = hypersense.from_fragment_model(model, B0, h=FRAG, w=FRAG,
                                        stride=STRIDE)
    frame_scores = step("frame_scores_s", lambda: hypersense.frame_scores_batch(
        hs, test_frames)).cpu().numpy()
    ffpr, ftpr, _ = metrics.roc_curve(frame_scores, test_labels)
    out = dict(val_accuracy=info["val_accuracy"], best=info["best"],
               fragment_auc=metrics.auc(fpr, tpr),
               fragment_partial_auc=metrics.partial_auc_above_tpr(fpr, tpr),
               frame_auc=metrics.auc(ffpr, ftpr))
    return model, hv_te, scores, frame_scores, out, wall


def train_phase(g):
    """The training path at the paper's width, counted, then again for a
    bitwise comparison; then its three kernels against their plain
    versions at the path's shapes. Returns the path's record, its
    launches per kernel and the kernels' records."""
    t0 = time.perf_counter()
    (_, _, frags, flabels), test = fragment_sets(g)
    sample_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for mod in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    model, hv_te, scores, frame_scores, out, wall = train_path(
        frags, flabels, test)
    launches = {k: mod.LAUNCHES for k, mod in TRAIN_KERNELS.items()}
    again = train_path(frags, flabels, test)
    check(torch.equal(model.class_hvs, again[0].class_hvs)
          and np.array_equal(scores, again[2])
          and np.array_equal(frame_scores, again[3]) and out == again[4],
          "the training path differs run to run")
    check(np.isfinite(scores).all() and scores.shape == (len(test[2]),)
          and np.isfinite(frame_scores).all()
          and frame_scores.shape == (N_HELD_OUT,),
          "held-out scores not finite or of the wrong shape")
    check(out["fragment_auc"] > 0.6 and out["frame_auc"] > 0.6,
          f"the fragment model did not learn the blobs: {out}")

    # the retraining loop alone: one epoch of per-sample updates
    x_tr = encoding.normalize_flat(torch.as_tensor(
        frags, device=DEVICE).reshape(len(frags), -1))
    B0 = generators(model.B)
    hv_tr = enc_perm.hdc_encode_perm(x_tr, B0, model.b, h=FRAG, w=FRAG)
    labels_t = torch.as_tensor(flabels, device=DEVICE).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fragment_model.retrain_epoch(model.class_hvs, hv_tr, labels_t)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_profile = device_profile(lambda: fragment_model.retrain_epoch(
        model.class_hvs, hv_tr, labels_t))

    record = dict(
        frames=N_TRAIN, held_out_frames=N_HELD_OUT,
        fragments=len(frags), positives=int(flabels.sum()),
        held_out_fragments=len(test[2]), epochs=EPOCHS, sample_s=sample_s,
        **wall, retrain_epoch_s=epoch_s,
        update_us=epoch_s / len(frags) * 1e6,
        retrain_epoch_profile=epoch_profile, launches=launches,
        run_to_run_bitwise=True, **out)
    x_te = encoding.normalize_flat(torch.as_tensor(
        test[2], device=DEVICE).reshape(len(test[2]), -1))
    return record, launches, train_kernel_checks(model, B0, x_tr, x_te,
                                                 hv_te)


def train_kernel_checks(model, B0, x_tr, x_te, hv_te):
    """Each training kernel against its plain version, a second run
    bitwise, and timings, on the training path's own inputs: the training
    fragments through ``hdc_encode_perm``, the held-out ones through
    ``hdc_encode`` against the expanded base, and the held-out
    hypervectors through ``similarity`` (``similarity_checks`` for its
    other shapes); then both encoders at the RAGGED shapes
    (``ragged_encode_checks``). The library yardsticks (``torch.matmul``
    in float32) run without TF32."""
    with pin_fp32_matmul():
        return _train_kernel_checks(model, B0, x_tr, x_te, hv_te)


def _train_kernel_checks(model, B0, x_tr, x_te, hv_te):
    B, b = model.B, model.b
    lib = _build.load("similarity")
    check(all(sim.chunk(D) == lib.similarity_chunk(D) for D in SIM_PLAN_DS),
          "python and CUDA similarity chunk plans differ")
    records = []
    K = FRAG * FRAG

    def hold(name, got, again, plain, atol):
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(err <= atol, f"{name} kernel vs plain: {err}")
        check(torch.equal(got, again), f"{name} kernel differs run to run")
        check(bool(torch.isfinite(got).all()), f"{name}: not finite")
        return err

    # --- hdc_encode_perm: the training encode
    N = x_tr.shape[0]
    got = enc_perm.hdc_encode_perm(x_tr, B0, b, h=FRAG, w=FRAG)
    err = hold("hdc_encode_perm", got,
               enc_perm.hdc_encode_perm(x_tr, B0, b, h=FRAG, w=FRAG),
               enc_perm.hdc_encode_perm_plain(x_tr, B0, b, w=FRAG),
               HV_ATOL)
    hv_tr = got
    dense = enc.hdc_encode(x_tr, B, b)
    torch.cuda.synchronize()
    check(torch.equal(got, dense),
          "hdc_encode_perm differs from hdc_encode on the expanded base")
    records.append(dict(
        name="hdc_encode_perm", route="cuda",
        source="src/repro_torch/kernels/csrc/hdc_encode_perm.cu",
        replaces="src/repro/kernels/hdc_encode_perm.py:36",
        max_abs_err=err, vs_dense_bitwise=True, run_to_run_bitwise=True,
        shape=[N, K, DIM], **occupancy("hdc_encode_perm", N, DIM),
        ms=time_ms(lambda: enc_perm.hdc_encode_perm(x_tr, B0, b, h=FRAG,
                                                    w=FRAG)),
        plain_ms=time_ms(lambda: enc_perm.hdc_encode_perm_plain(
            x_tr, B0, b, w=FRAG)),
        library_ms=time_ms(lambda: torch.matmul(x_tr, B)),
        **encode_bounds(4 * (N * K + FRAG * DIM + DIM + N * DIM), N, K)))

    # --- hdc_encode: the held-out encode against the expanded base
    N = x_te.shape[0]
    got = enc.hdc_encode(x_te, B, b)
    err = hold("hdc_encode", got, enc.hdc_encode(x_te, B, b),
               enc.hdc_encode_plain(x_te, B, b), HV_ATOL)
    records.append(dict(
        name="hdc_encode", route="cuda",
        source="src/repro_torch/kernels/csrc/hdc_encode.cu",
        replaces="src/repro/kernels/hdc_encode.py:27",
        max_abs_err=err, run_to_run_bitwise=True, shape=[N, K, DIM],
        **occupancy("hdc_encode", N, DIM),
        ms=time_ms(lambda: enc.hdc_encode(x_te, B, b)),
        plain_ms=time_ms(lambda: enc.hdc_encode_plain(x_te, B, b)),
        library_ms=time_ms(lambda: torch.matmul(x_te, B)),
        **encode_bounds(4 * (N * K + K * DIM + DIM + N * DIM), N, K)))

    # --- similarity: the held-out hypervectors against the two classes
    C = model.class_hvs
    got = sim.similarity(hv_te, C)
    err = hold("similarity", got, sim.similarity(hv_te, C),
               sim.similarity_plain(hv_te, C), SCORE_ATOL)
    nc = C.shape[0]
    records.append(dict(
        name="similarity", route="cuda",
        source="src/repro_torch/kernels/csrc/similarity.cu",
        replaces="src/repro/kernels/similarity.py:26",
        max_abs_err=err, run_to_run_bitwise=True, shape=[N, DIM, nc],
        ms=time_ms(lambda: sim.similarity(hv_te, C)),
        plain_ms=time_ms(lambda: sim.similarity_plain(hv_te, C)),
        library_ms=time_ms(lambda: torch.nn.functional.cosine_similarity(
            hv_te[:, None], C[None], dim=-1)),
        **sim_bound(N, nc), **similarity_checks(hv_te, hv_tr, C)))
    # each kernel's device time alone, from the profiler: ``ms`` above is a
    # whole wrapper call, which includes the host's enqueue
    calls = {"hdc_encode_perm": (lambda: enc_perm.hdc_encode_perm(
                 x_tr, B0, b, h=FRAG, w=FRAG), ("encode_kernel",)),
             "hdc_encode": (lambda: enc.hdc_encode(x_te, B, b),
                            ("encode_kernel",)),
             "similarity": (lambda: sim.similarity(hv_te, C),
                            ("sim_cluster",))}
    for r in records:
        r["kernel_device_ms"], r["kernel_device_by_kernel_ms"] = \
            kernel_device_ms(*calls[r["name"]])
    ragged = ragged_encode_checks()
    for r in records:
        if r["name"] in ragged:
            r["ragged_max_abs_err"] = ragged[r["name"]]
            r["beats_library"] = r["ms"] <= r["library_ms"]
    return records


def sim_bound(N: int, C: int) -> dict:
    """``similarity``'s bound at (N, DIM, C): each input read once, the
    scores written once; 2 (C + 1) float32 operations per query element
    (the dots and q.q) and 2 per class element."""
    return bound(4 * (N * DIM + C * DIM + N * C),
                 2 * N * DIM * (C + 1) + 2 * C * DIM, F32_OPS_S)


def kernel_counts(fn, calls: int) -> dict:
    """Device kernels of ``calls`` calls of ``fn`` under the profiler, by
    name, between one-element fills on either side (not counted): the
    profiler has lost a window's edge launches on the H100."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU \
                and e.self_device_time_total > 0 \
                and "FillFunctor" not in e.key:
            counts[e.key[:60]] = counts.get(e.key[:60], 0) + e.count
    return counts


def one_launch_per_call(fn, name: str, calls: int = 3,
                        windows: int = 3) -> int:
    """Check from the profiler's events that each call of ``fn`` launches
    kernel ``name`` once and no other kernel. A window that recorded
    fewer launches than the calls made (the profiler has lost events
    right after a large profile) is taken again, up to ``windows`` times;
    more launches, or another kernel, fails at once. Returns the windows
    taken."""
    for taken in range(1, windows + 1):
        counts = kernel_counts(fn, calls)
        check(len(counts) <= 1 and all(name in k for k in counts)
              and sum(counts.values()) <= calls,
              f"{name}: more than one launch per call: {counts}")
        if sum(counts.values()) == calls:
            return taken
    raise AssertionError(f"{name}: {counts} in {calls} calls, "
                         f"{windows} windows")


def similarity_launches() -> dict:
    """``similarity`` at the held-out call's shape (384 x DIM, seeded
    random rows) for C = 2, 9, 17 and 33 classes: one ``sim_cluster``
    launch per call at every C, counted from the profiler's events. Run
    before any other profile of the process: after the training epoch's
    profile the H100's profiler lost one launch in every window."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 6)
    q = torch.randn((384, DIM), generator=g, device=DEVICE)
    windows = {}
    for nc in (2, 9, 17, 33):
        c = torch.randn((nc, DIM), generator=g, device=DEVICE)
        sim.similarity(q, c)
        windows[nc] = one_launch_per_call(lambda: sim.similarity(q, c),
                                          "sim_cluster")
    return dict(launches_per_call={nc: 1 for nc in windows},
                profile_windows=windows)


def first_profile_device_ms() -> dict:
    """The device ms of ``similarity`` (``sim_cluster``) at the held-out
    call's shape (384 x DIM, 2 classes) and of ``hdc_encode_perm``
    (``encode_kernel``) at the training encode's (512 x FRAG^2 x DIM),
    on seeded random inputs, from the process's first profiles (right
    after :func:`similarity_launches`): after the large profiles of the
    later phases the H100's profiler has recorded none of these
    single-launch calls."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 25)
    q = torch.randn((384, DIM), generator=g, device=DEVICE)
    c = torch.randn((2, DIM), generator=g, device=DEVICE)
    x = torch.rand((512, FRAG * FRAG), generator=g, device=DEVICE)
    B0 = torch.randn((FRAG, DIM), generator=g, device=DEVICE)
    b = 2 * math.pi * torch.rand((DIM,), generator=g, device=DEVICE)
    sim.similarity(q, c)
    enc_perm.hdc_encode_perm(x, B0, b, h=FRAG, w=FRAG)
    return {"similarity": kernel_device_ms(
                lambda: sim.similarity(q, c), ("sim_cluster",))[0],
            "hdc_encode_perm": kernel_device_ms(
                lambda: enc_perm.hdc_encode_perm(x, B0, b, h=FRAG, w=FRAG),
                ("encode_kernel",))[0]}


def similarity_checks(q, hv_tr, C) -> dict:
    """``similarity`` beyond the held-out call, each result within
    SCORE_ATOL of the plain version and bitwise the same run to run:
    C = 9, 17 and 33 classes; a row bitwise the same in a 7-row call and
    inside the held-out call; the two classes' columns bitwise the same
    inside a 17-class call; a misaligned view (storage offset 1) bitwise
    equal to its aligned copy; and, timed, the training path's N = 512
    (``accuracy``) and a held-out split of 16,384 hypervectors (327.9 MB,
    past the 50 MB L2)."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 5)
    D = q.shape[1]
    out = dict(many_classes_max_abs_err={})

    def hold(what, got, again, plain):
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(err <= SCORE_ATOL, f"similarity {what}: {err}")
        check(torch.equal(got, again), f"similarity {what} run to run")
        check(bool(torch.isfinite(got).all()), f"similarity {what}: not "
              f"finite")
        return err

    for nc in (9, 17, 33):
        c = torch.randn((nc, D), generator=g, device=DEVICE)
        out["many_classes_max_abs_err"][nc] = hold(
            f"at C={nc}", sim.similarity(q, c), sim.similarity(q, c),
            sim.similarity_plain(q, c))
    full = sim.similarity(q, C)
    seven = sim.similarity(q[13:20].clone(), C)
    wide = sim.similarity(q, torch.cat([C, torch.randn(
        (15, D), generator=g, device=DEVICE)]))
    storage = torch.empty(q.numel() + 1, device=DEVICE)
    view = storage[1:].view(q.shape)
    view.copy_(q)
    check(view.data_ptr() % 16 != 0, "the view is not misaligned")
    torch.cuda.synchronize()
    check(torch.equal(seven, full[13:20]),
          "similarity: a 7-row call differs from the held-out call")
    check(torch.equal(wide[:, :2], full),
          "similarity: the two classes differ inside a 17-class call")
    check(torch.equal(sim.similarity(view, C), full),
          "similarity: a misaligned view differs from its aligned copy")
    out.update(rows_bitwise=True, classes_bitwise=True,
               misaligned_bitwise=True)

    big = torch.randn((16384, D), generator=g, device=DEVICE)
    out["shapes"] = {}
    for x in (hv_tr, big):
        N = x.shape[0]
        err = hold(f"at N={N}", sim.similarity(x, C), sim.similarity(x, C),
                   sim.similarity_plain(x, C))
        dev, _ = kernel_device_ms(lambda: sim.similarity(x, C),
                                  ("sim_cluster",))
        rec = dict(max_abs_err=err, ms=time_ms(lambda: sim.similarity(x, C)),
                   kernel_device_ms=dev,
                   plain_ms=time_ms(lambda: sim.similarity_plain(x, C)),
                   library_ms=time_ms(
                       lambda: torch.nn.functional.cosine_similarity(
                           x[:, None], C[None], dim=-1)),
                   **sim_bound(N, C.shape[0]))
        if isinstance(dev, float):
            rec["share_of_bound"] = rec["bound_ms"] / dev
        out["shapes"][N] = rec
    return out


def encode_bounds(n_bytes: int, N: int, K: int) -> dict:
    """An encoder's two bounds: 2*N*K*D float32 operations on the CUDA
    cores (``bound_ms``), and the 3*2*N*K*D TF32 operations of the 3xTF32
    split on the tensor cores (``bound_tc_ms``)."""
    tc = bound(n_bytes, 3 * 2 * N * K * DIM, TF32_OPS_S)
    return dict(**bound(n_bytes, 2 * N * K * DIM, F32_OPS_S),
                bound_tc_ms=tc["bound_ms"], bound_tc_by=tc["bound_by"])


def occupancy(name: str, N: int, D: int) -> dict:
    """The encoder's launch at (N, D): its output tile, blocks, resident
    blocks per SM, dynamic shared memory per block, waves on this card and
    the share of the waves' block slots the blocks fill."""
    vals = [ctypes.c_int() for _ in range(4)]
    _build.check(getattr(_build.load(name), f"{name}_occupancy")(
        N, D, *map(ctypes.byref, vals)), f"{name}_occupancy")
    tile_n, blocks, per_sm, smem = (v.value for v in vals)
    slots = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    waves = math.ceil(blocks / slots)
    return dict(tile=[128, tile_n], blocks=blocks, blocks_per_sm=per_sm,
                smem_bytes=smem, waves=waves,
                wave_efficiency=blocks / (waves * slots))


def ragged_encode_checks() -> dict:
    """Both encoders at the RAGGED shapes, for each nonlinearity: within
    HV_ATOL of the plain version, bitwise equal run to run, and
    ``hdc_encode_perm`` bitwise equal to ``hdc_encode`` on the expanded
    base. ``sign`` is held where the projection is clear of 0 by more than
    HV_ATOL (elsewhere float32 rounding may flip it). Returns each
    encoder's largest error."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 2)
    worst = {"hdc_encode_perm": 0.0, "hdc_encode": 0.0}
    for N, h, w, D in RAGGED:
        x = encoding.normalize_flat(torch.rand((N, h * w), generator=g,
                                               device=DEVICE))
        B0 = torch.randn((h, D), generator=g, device=DEVICE)
        b = 2 * math.pi * torch.rand(D, generator=g, device=DEVICE)
        B = encoding.flat_perm_base(B0, w)
        proj = enc.hdc_encode_plain(x, B, b, nonlinearity="linear")
        for nl in ("rff", "linear", "sign"):
            keep = proj.abs() > HV_ATOL if nl == "sign" else \
                torch.ones_like(proj, dtype=torch.bool)
            plain = enc.hdc_encode_plain(x, B, b, nonlinearity=nl)
            outs = {"hdc_encode_perm": [enc_perm.hdc_encode_perm(
                        x, B0, b, h=h, w=w, nonlinearity=nl)
                        for _ in range(2)],
                    "hdc_encode": [enc.hdc_encode(x, B, b, nonlinearity=nl)
                                   for _ in range(2)]}
            torch.cuda.synchronize()
            what = f"(N, h, w, D) = {(N, h, w, D)}, {nl}"
            check(keep.float().mean() > 0.99, f"{what}: projections near 0")
            for name, (got, again) in outs.items():
                err = float((got - plain)[keep].abs().max())
                check(err <= HV_ATOL, f"{name} vs plain at {what}: {err}")
                check(torch.equal(got, again),
                      f"{name} differs run to run at {what}")
                worst[name] = max(worst[name], err)
            check(torch.equal(outs["hdc_encode_perm"][0],
                              outs["hdc_encode"][0]),
                  f"hdc_encode_perm differs from hdc_encode at {what}")
    return worst


# the int-datapath phase: the claims of benchmarks/int_datapath.py (its
# constants, :57-74) and its --check gates (:441-486) on the port, the
# race also at the paper's operating point (configs/hypersense.py)
PAPER = paper_config.config()
INT_BITS = 8
# race shapes: (frame, fragment, stride, D, block_d, chunk)
RACE_SHAPES = {"reference": (32, 8, 4, 256, 128, 16),
               "paper": (PAPER.frame_h, PAPER.fragment, PAPER.stride,
                         PAPER.dim, BLOCK_D, CHUNK)}
# the expanded kernel against the live int kernel (the reference's
# assert_allclose, int_datapath.py:215)
RACE_RTOL = RACE_ATOL = 1e-6
# the AUC scenario (a gate trained on make_dataset(60) at 32x32, 2
# fragments a frame, 8 epochs; streams of 160 frames, bursts of 10 at 0.08)
AUC_FRAG, AUC_STRIDE, AUC_DIM, AUC_FRAMES, AUC_TOL = 8, 4, 512, 160, 0.01
AUC_DRIFT = dict(background_gain=(0.0, 0.5), noise_sigma=(0.12, 0.25),
                 object_intensity=(0.8, 0.45))
# The binary curve's D and the reference's claim on its best point. The
# claim is reported, not enforced: with sign-quantized slabs AND class
# hypervectors, a gate trained on 60 frames lands on either side of 0.85 at
# random, in the JAX package as in the port (CPU, D = 128, 256, 512: the
# reference's protocol best at 0.831 on its own keys, 0.537-0.946 on 8
# others, 4 of them >= 0.85; the port 0.513-0.987 on 12 seeds, 6 >= 0.85);
# each binary score map of the curve is held to its plain version instead.
BINARY_DIMS, BINARY_MIN_BEST_AUC = (128, 256, 512), 0.85
# the large-W check: 4x the reference's frame width, its dims; the
# reference's tolerance for it, printed beside the port's SCORE_ATOL
LARGE_W, LARGE_W_DIM, LARGE_W_BLOCK_D, LARGE_W_TOL = 128, 256, 128, 1e-6
# the deployment geometry of the reference's byte model
# (int_datapath.py:236): 4-bit codes, 128x4096 frames, 16x16 windows,
# stride 16
DEPLOY = dict(adc_bits=4, H=128, W=4096, h=16, w=16, stride=16)
GATE_FRAMES = 256
# every score a gate decision rests on sits this far from t_score
# (tests/test_golden.py:59)
DECISION_MARGIN = 5 * SCORE_ATOL
# every kernel wrapper the phase's main path may reach
ID_KERNELS = {"sliding_scores_f32": ss, "sliding_scores_int": ssi,
              "int_expanded": ie, "hdc_encode_perm": enc_perm,
              "hdc_encode": enc, "similarity": sim}


def race_inputs(g, frame, frag, stride, dim, block_d, chunk):
    """One model and one ADC capture for the race: uniform frames in
    [0, 1.5], their 8-bit codes for the int kernels and the float
    reconstruction of the same codes for the float kernel; the float and
    int tiles and the expanded operand."""
    B0, b = encoding.make_perm_base_rows(g, frag, dim)
    chvs = torch.randn((2, dim), generator=g, device=DEVICE)
    frames = 1.5 * torch.rand((chunk, frame, frame), generator=g,
                              device=DEVICE)
    codes = adc.pack_codes(adc.quantize_codes(frames, INT_BITS), INT_BITS)
    tkw = dict(W=frame, w=frag, stride=stride, block_d=block_d)
    itiles = ops.precompute_tiles_int(B0, b, chvs, **tkw)
    return dict(B0=B0, b=b, chvs=chvs, codes=codes,
                recon=adc.quantize(frames, INT_BITS),
                ftiles=ops.precompute_tiles(B0, b, chvs, **tkw),
                itiles=itiles, E=ie.expand_slabs(itiles.geom, frame),
                tkw=tkw, kw=dict(h=frag, w=frag, stride=stride))


def race_calls(inp):
    """The three scorers on the capture, through their entry points."""
    kw, model = inp["kw"], (inp["chvs"], inp["B0"], inp["b"])
    return {
        "float32": (ss, lambda: ops.fragment_score_map_batch(
            inp["recon"], *model, tiles=inp["ftiles"], **kw)),
        "int8": (ssi, lambda: ops.fragment_score_map_batch_int(
            inp["codes"], *model, tiles=inp["itiles"], **kw)),
        "expanded": (ie, lambda: ie.expanded_scores(
            inp["codes"], inp["E"], inp["itiles"], **kw))}


def race_scores(inp):
    """Each scorer once; each call must be one call of its C entry."""
    out = {}
    for name, (mod, fn) in race_calls(inp).items():
        before = mod.LAUNCHES
        out[name] = fn()
        check(mod.LAUNCHES == before + 1,
              f"race {name}: {mod.LAUNCHES - before} launches in one call")
    return out


def expanded_gates(what, codes, E, tiles, fresh, kw, got=None, live=None):
    """The expanded kernel's gates on one capture: its int32 window sums
    bitwise the live kernel's, its scores finite, within 1e-6 of the live
    kernel's and within SCORE_ATOL of its plain version; bitwise run to
    run, across a fresh precompute (``fresh``, its operand expanded anew)
    and for 7 frames called alone as inside the whole call. ``got`` and
    ``live``: the two kernels' scores where the caller has them. Returns
    the largest errors against plain and against the live kernel."""
    if got is None:
        got = ie.expanded_scores(codes, E, tiles, **kw)
    if live is None:
        live = ssi.fragment_scores_batch_int(codes, tiles, **kw)
    acc = ie.expanded_window_acc(codes, E, tiles.geom, **kw)
    acc_live = ssi.int_window_acc(codes, tiles.geom, **kw)
    plain = ie.expanded_scores_plain(codes, E, tiles, **kw)
    E2 = ie.expand_slabs(fresh.geom, codes.shape[-1])
    again = ie.expanded_scores(codes, E, tiles, **kw)
    from_fresh = ie.expanded_scores(codes, E2, fresh, **kw)
    lo = min(20, codes.shape[0] - 7)
    seven = ie.expanded_scores(codes[lo:lo + 7], E, tiles, **kw)
    torch.cuda.synchronize()
    check(torch.equal(acc, acc_live),
          f"{what}: expanded window sums differ from the live ones")
    live_err = float((got - live).abs().max())
    check(bool(torch.allclose(got, live, rtol=RACE_RTOL, atol=RACE_ATOL)),
          f"{what}: expanded vs live int8 kernel {live_err}")
    plain_err = float((got - plain).abs().max())
    check(plain_err <= SCORE_ATOL,
          f"{what}: expanded kernel vs plain {plain_err}")
    check(bool(torch.isfinite(got).all()) and got.shape == live.shape,
          f"{what}: expanded scores not finite or of the wrong shape")
    check(torch.equal(E2, E), f"{what}: a fresh operand differs")
    check(torch.equal(again, got) and torch.equal(from_fresh, got),
          f"{what}: expanded scores not bitwise run to run or across a "
          f"fresh precompute")
    check(torch.equal(seven, got[lo:lo + 7]),
          f"{what}: an expanded 7-frame call differs from the "
          f"{codes.shape[0]}-frame one")
    return plain_err, live_err


def race_checks(name, inp, scores):
    """The race's gates and times at one shape: the expanded kernel's gates
    (``expanded_gates``); the live int path bitwise run to run and across
    a fresh precompute; ms per chunk (CUDA events), fps and speedups; the
    expanded kernels' device ms."""
    kw, codes, itiles, E = inp["kw"], inp["codes"], inp["itiles"], inp["E"]
    s_f, s_i, s_e = scores["float32"], scores["int8"], scores["expanded"]
    check(bool(torch.isfinite(s_f).all()) and s_f.shape == s_i.shape,
          f"race {name}: float32 scores not finite or of the wrong shape")
    fresh = ops.precompute_tiles_int(inp["B0"], inp["b"], inp["chvs"],
                                     **inp["tkw"])
    plain_err, live_err = expanded_gates(f"race {name}", codes, E, itiles,
                                         fresh, kw, got=s_e, live=s_i)
    # the live int path: run to run, and across a fresh precompute
    again = race_calls(inp)["int8"][1]()
    s_i2 = ssi.fragment_scores_batch_int(codes, fresh, **kw)
    torch.cuda.synchronize()
    check(torch.equal(s_i, again) and torch.equal(s_i, s_i2),
          f"race {name}: int8 not bitwise deterministic")
    ms = {n: time_ms(fn) for n, (_, fn) in race_calls(inp).items()}
    expanded_device = kernel_device_ms(
        race_calls(inp)["expanded"][1],
        ("window_norms", "score_expanded", "expanded_epilogue",
         "fold_epilogue"))
    N = codes.shape[0]
    return dict(
        frames=N, frame=inp["tkw"]["W"], fragment=kw["h"],
        stride=kw["stride"], D=inp["chvs"].shape[1],
        td=itiles.geom.block_d, n_dt=itiles.geom.slabs_q.shape[0],
        operand_bytes=E.numel(), batch_position_bitwise=True, ms=ms,
        fps={n: N / (t / 1e3) for n, t in ms.items()},
        speedup_int8_vs_float32=ms["float32"] / ms["int8"],
        speedup_int8_vs_expanded=ms["expanded"] / ms["int8"],
        expanded_device_ms=expanded_device[0],
        expanded_device_by_kernel_ms=expanded_device[1],
        acc_bitwise=True, expanded_vs_live_max_abs=live_err,
        expanded_bitwise_live=bool(torch.equal(s_e, s_i)),
        expanded_vs_plain_max_abs=plain_err, deterministic=True)


def expanded_occupancy(lib, codes, itiles, h, w, stride) -> dict:
    """The expanded kernel's launch from its C entry: the row tile, ring
    slots, blocks, resident blocks per SM, shared memory, waves on this
    card and K steps."""
    N, H, W = codes.shape
    n_dt, td = itiles.geom.slabs_q.shape[0], itiles.geom.block_d
    layout = ie._LAYOUTS.get(codes.dtype, ie._LAYOUTS[torch.int32])
    vals = [ctypes.c_int() for _ in range(6)]
    _build.check(lib.int_expanded_occupancy(
        N, H, W, h, w, stride, td, n_dt, layout, *map(ctypes.byref, vals)),
        "int_expanded_occupancy")
    tile_m, ring, blocks, per_sm, smem, steps = (v.value for v in vals)
    slots = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    waves = math.ceil(blocks / slots)
    return dict(tile=[tile_m, ie.COL_TILE], blocks=blocks,
                blocks_per_sm=per_sm, smem_bytes=smem, ring_slots=ring,
                k_steps=steps, waves=waves,
                wave_efficiency=blocks / (waves * slots))


def expanded_record(inp, race):
    """The expanded kernel's line at the paper's shape: its time, the
    device time of its four kernels, the plain version's, the library
    yardstick's (the int row's: the windows against the expanded base in
    one ``torch.matmul``), the bound (each input read once) and the
    tensor-core bound of its ``2*N*my*W*h*D`` int8 operations; its tile,
    blocks, waves and shared memory; what it reads of the operand (once
    per M tile, the M tiles of a column tile side by side). Beside them,
    the same call on a copy of the codes at an odd address, where every
    code group takes the kernel's byte route instead of its 4-byte copies:
    its scores bitwise the same, its ms and device ms."""
    kw, codes, itiles, E = inp["kw"], inp["codes"], inp["itiles"], inp["E"]
    h, w, stride = kw["h"], kw["w"], kw["stride"]
    N, H, W = codes.shape
    my, mx = (H - h) // stride + 1, (W - w) // stride + 1
    n_dt, td = itiles.geom.slabs_q.shape[0], itiles.geom.block_d
    lib = _build.load("int_expanded")
    check(ie.COL_TILE == lib.int_expanded_col_tile(),
          "python and CUDA expanded column tiles differ")
    occ = expanded_occupancy(lib, codes, itiles, h, w, stride)
    win = codes.unfold(1, h, stride).unfold(2, w, stride).reshape(
        N * my * mx, h * w).to(torch.float32)
    base = encoding.flat_perm_base(inp["B0"], h)
    device_ms, by_kernel = kernel_device_ms(
        lambda: ie.expanded_scores(codes, E, itiles, **kw),
        ("window_norms", "score_expanded", "expanded_epilogue",
         "fold_epilogue"))
    odd = torch.empty(codes.numel() + 1, dtype=codes.dtype,
                      device=DEVICE)[1:].view(codes.shape)
    odd.copy_(codes)
    check(torch.equal(ie.expanded_scores(odd, E, itiles, **kw),
                      ie.expanded_scores(codes, E, itiles, **kw)),
          "expanded scores differ when the codes are loaded byte by byte")
    odd_device_ms, odd_by_kernel = kernel_device_ms(
        lambda: ie.expanded_scores(odd, E, itiles, **kw),
        ("window_norms", "score_expanded", "expanded_epilogue",
         "fold_epilogue"))
    n_bytes = (codes.numel() * codes.element_size() + E.numel()
               + 4 * itiles.geom.bias_t.numel() + 2 * itiles.cpos_t.numel()
               + 4 * N * my * mx)
    tc_ops = 2 * N * my * W * h * n_dt * td
    m_tiles = -(-N * my // occ["tile"][0])
    return dict(
        name="int_expanded", route="cuda",
        source="src/repro_torch/kernels/csrc/int_expanded.cu",
        replaces="benchmarks/int_datapath.py:96",
        max_abs_err=race["expanded_vs_plain_max_abs"],
        expanded_vs_live_max_abs=race["expanded_vs_live_max_abs"],
        bitwise_live=race["expanded_bitwise_live"],
        ms=race["ms"]["expanded"], kernel_device_ms=device_ms,
        kernel_device_by_kernel_ms=by_kernel,
        plain_ms=time_ms(lambda: ie.expanded_scores_plain(codes, E, itiles,
                                                          **kw)),
        library_ms=time_ms(lambda: torch.matmul(win, base)),
        shape=[N, H, W, h, w, stride, n_dt * td], **occ,
        **bound(n_bytes, 2 * N * my * W * n_dt * td * (h + mx), INT8_OPS_S),
        bound_tc_ms=tc_ops / INT8_OPS_S * 1e3, bound_tc_ops=tc_ops,
        # what this design reads: the operand once per M tile (from L2 but
        # for about one pass from device memory)
        operand_reads_bytes=m_tiles * E.numel(),
        codes_by_bytes=dict(
            ms=time_ms(lambda: ie.expanded_scores(odd, E, itiles, **kw)),
            kernel_device_ms=odd_device_ms,
            kernel_device_by_kernel_ms=odd_by_kernel),
        ragged=ragged_expanded_checks())


#: frames of the expanded kernel's captures at the ragged int shapes and at
#: large W: a chunk, so that its 7-frame call is held against a 32-frame one
EXPANDED_CHECK_FRAMES = 32


def ragged_expanded_checks() -> dict:
    """The expanded kernel at the RAGGED_INT shapes (EXPANDED_CHECK_FRAMES
    frames each) with single-model class tiles, for uint8 and 10-bit
    uint16 codes (INT_CASES' int8 and u10): ``expanded_gates``; its tile.
    Returns the largest errors and the tiles."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 5)
    lib = _build.load("int_expanded")
    worst, live_worst, tiles_m = 0.0, 0.0, {}
    for _, _, H, W, h, w, stride, D, block_d in RAGGED_INT:
        N = EXPANDED_CHECK_FRAMES
        kw = dict(h=h, w=w, stride=stride)
        tkw = dict(W=W, w=w, stride=stride, block_d=block_d)
        frames = 1.5 * torch.rand((N, H, W), generator=g, device=DEVICE)
        B0 = torch.randn((h, D), generator=g, device=DEVICE)
        b = 2 * math.pi * torch.rand(D, generator=g, device=DEVICE)
        chvs = torch.randn((2, D), generator=g, device=DEVICE)
        tiles = ssi.precompute_tiles_int(B0, b, chvs, **tkw)
        fresh = ssi.precompute_tiles_int(B0, b, chvs, **tkw)
        E = ie.expand_slabs(tiles.geom, W)
        for precision in ("int8", "u10"):
            codes = stream.adc_view_codes(frames, INT_CASES[precision][1])
            err, live_err = expanded_gates(
                f"expanded {precision} at {(N, H, W, h, w, stride, D)}",
                codes, E, tiles, fresh, kw)
            worst, live_worst = max(worst, err), max(live_worst, live_err)
            tiles_m[f"{precision}@{(H, W, h, w, stride, D)}"] = \
                expanded_occupancy(lib, codes, tiles, h, w, stride)["tile"]
    return dict(max_abs_err=worst, vs_live_max_abs=live_worst,
                tiles=tiles_m)


def large_w_checks(g):
    """The reference's large-W check (int_datapath.py:225-260): at W = 4x
    its frame the live int kernel matches its plain version (SCORE_ATOL;
    the reference's 1e-6 printed beside it) and the expanded kernel the
    live one; the expanded kernel's gates (``expanded_gates``) on a
    capture of EXPANDED_CHECK_FRAMES frames at that width; then the
    expanded operand's bytes at the deployment geometry beside the live
    kernel's fixed block and its im2col bytes per frame."""
    frame, frag, stride = RACE_SHAPES["reference"][:3]
    H, W = frame, LARGE_W
    kw = dict(h=frag, w=frag, stride=stride)
    ops.assert_int_datapath_fits(INT_BITS, H, W, frag, frag, stride=stride)
    B0, b = encoding.make_perm_base_rows(g, frag, LARGE_W_DIM)
    chvs = torch.randn((2, LARGE_W_DIM), generator=g, device=DEVICE)
    frames = 1.5 * torch.rand((4, H, W), generator=g, device=DEVICE)
    codes = adc.pack_codes(adc.quantize_codes(frames, INT_BITS), INT_BITS)
    tiles = ssi.precompute_tiles_int(B0, b, chvs, W=W, w=frag, stride=stride,
                                     block_d=LARGE_W_BLOCK_D)
    got = ssi.fragment_scores_batch_int(codes, tiles, **kw)
    want = ssi.fragment_scores_batch_int_plain(codes, tiles, **kw)
    E = ie.expand_slabs(tiles.geom, W)
    s_e = ie.expanded_scores(codes, E, tiles, **kw)
    acc_e = ie.expanded_window_acc(codes, E, tiles.geom, **kw)
    acc_i = ssi.int_window_acc(codes, tiles.geom, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= SCORE_ATOL, f"large W={W}: live int kernel vs plain {err}")
    check(torch.equal(acc_e, acc_i) and bool(torch.allclose(
        s_e, got, rtol=RACE_RTOL, atol=RACE_ATOL)),
        f"large W={W}: expanded vs live kernel")
    # a chunk at this width from its own generator (g's draws unchanged)
    gc = torch.Generator(device=DEVICE)
    gc.manual_seed(SEED + 14)
    chunk = 1.5 * torch.rand((EXPANDED_CHECK_FRAMES, H, W), generator=gc,
                             device=DEVICE)
    chunk = adc.pack_codes(adc.quantize_codes(chunk, INT_BITS), INT_BITS)
    fresh = ssi.precompute_tiles_int(B0, b, chvs, W=W, w=frag, stride=stride,
                                     block_d=LARGE_W_BLOCK_D)
    chunk_err, chunk_live_err = expanded_gates(
        f"large W={W}, {EXPANDED_CHECK_FRAMES} frames", chunk, E, tiles,
        fresh, kw)
    d = DEPLOY
    bounds = ssi.int_datapath_bounds(d["adc_bits"], d["H"], d["W"], d["h"],
                                     d["w"], stride=d["stride"])
    check(bounds["fits"], "the live layout must admit deployment scale")
    expanded = ie.expanded_bytes(d["h"], d["W"], PAPER.dim, BLOCK_D)
    return dict(
        W=W, D=LARGE_W_DIM, td=LARGE_W_BLOCK_D, live_vs_plain_max_abs=err,
        reference_tol=LARGE_W_TOL, within_reference_tol=err <= LARGE_W_TOL,
        expanded_vs_live_max_abs=float((s_e - got).abs().max()),
        expanded_chunk_vs_plain_max_abs=chunk_err,
        expanded_chunk_vs_live_max_abs=chunk_live_err,
        expanded_operand_bytes=E.numel(),
        deploy=dict(d, D=PAPER.dim, block_d=BLOCK_D,
                    expanded_operand_bytes=expanded,
                    expanded_over_l2=expanded > 50e6,
                    live_smem_bytes=bounds["smem_bytes"],
                    live_im2col_bytes_per_frame=bounds[
                        "im2col_bytes_per_frame"]))


def train_gate(g, cfg, dim, frag, stride):
    """A gate trained as the reference's benchmark trains it (its
    ``_train_gate``): ``make_dataset(60)``, 2 fragments a frame, 8 epochs,
    the generator rows read back from the model's base, ``t_detection``
    1."""
    frames, masks, _ = synthetic.make_dataset(g, 60, cfg, device=DEVICE)
    frs, labs = fragments.sample_fragments(
        frames.cpu().numpy(), masks.cpu().numpy(), h=frag, w=frag,
        per_frame=2, seed=0)
    model, _ = fragment_model.train_fragment_model(g, frs, labs, dim=dim,
                                                   epochs=8, device=DEVICE)
    B0 = model.B.reshape(frag, frag, -1)[:, 0, :]
    return hypersense.from_fragment_model(model, B0, h=frag, w=frag,
                                          stride=stride, t_detection=1)


def frame_auc(scores, labels) -> float:
    fpr, tpr, _ = metrics.roc_curve(scores.cpu().numpy(),
                                    labels.cpu().numpy())
    return float(metrics.auc(fpr, tpr))


def auc_streams(g, cfg):
    """The scenario's synthetic stream and its drifted one."""
    drift = synthetic.DriftConfig(**AUC_DRIFT)
    kw = dict(event_prob=0.08, event_len=10, device=DEVICE)
    return {"synthetic": synthetic.make_stream(g, AUC_FRAMES, cfg, **kw),
            "drift": synthetic.make_drift_stream(g, AUC_FRAMES, cfg, drift,
                                                 **kw)}


def auc_parity(hs, streams) -> dict:
    """Frame-score AUC on each stream: float at 8 bits vs int8, and float
    at 4 bits vs packed int4, each pair on the same ADC capture."""
    out = {}
    for name, (frames, labels) in streams.items():
        def auc(view, **kw):
            return frame_auc(hypersense.frame_scores_batch(hs, view, **kw),
                             labels)
        f8 = auc(adc.quantize(frames, 8))
        i8 = auc(frames, precision="int8", adc_bits=8)
        f4 = auc(adc.quantize(frames, 4))
        i4 = auc(frames, precision="int4", adc_bits=4)
        out[name] = dict(float_auc=f8, int8_auc=i8, gap=abs(f8 - i8),
                         float4_auc=f4, int4_auc=i4, int4_gap=abs(f4 - i4),
                         positives=int(labels.sum()))
    return out


def binary_curve(g, cfg, frames, labels) -> dict:
    """The binary gate's D-vs-AUC curve on the synthetic stream (a gate
    trained per D) beside the float gate's at 8 bits, each binary score
    map held to the plain version's within SCORE_ATOL."""
    out = {}
    codes = adc.pack_codes(adc.quantize_codes(frames, 8), 8)
    for dim in BINARY_DIMS:
        hs = train_gate(g, cfg, dim, AUC_FRAG, AUC_STRIDE)
        tiles = ops.precompute_tiles_int(hs.B0, hs.b, hs.class_hvs,
                                         W=codes.shape[-1], w=hs.w,
                                         stride=hs.stride, mode="binary")
        kw = dict(h=hs.h, w=hs.w, stride=hs.stride)
        maps = ssi.fragment_scores_batch_int(codes, tiles, **kw)
        err = float((maps - ssi.fragment_scores_batch_int_plain(
            codes, tiles, **kw)).abs().max())
        check(err <= SCORE_ATOL and bool(torch.isfinite(maps).all()),
              f"binary scores at D={dim}: kernel vs plain {err}")
        out[f"d{dim}"] = dict(
            float_auc=frame_auc(hypersense.frame_scores_batch(
                hs, adc.quantize(frames, 8)), labels),
            binary_auc=frame_auc(frame_detection_score(
                maps, hs.t_detection), labels),
            binary_vs_plain_max_abs=err)
    out["best_binary_auc"] = max(v["binary_auc"] for v in out.values())
    return out


def gate_model(g, hs, cfg):
    """``hs`` at a ``t_score`` on the 80th percentile of the frame scores
    of the object-free frames of 64 calibration frames at the gate's ADC
    depth (the reference's gate test calibrates so)."""
    frames, _, labels = synthetic.make_dataset(g, 64, cfg, device=DEVICE)
    neg = adc.quantize(frames[labels == 0], PAPER.adc_low_bits)
    s = hypersense.frame_scores_batch(hs, neg)
    return dataclasses.replace(hs, t_score=float(torch.quantile(s, 0.8)))


def gate_checks(hs, lp, gate, kept, flops_per_frame):
    """The card's gate against the same gate on the CPU (plain versions):
    equal decisions on every frame whose deciding score sits more than
    DECISION_MARGIN from ``t_score``, equal kept indices where all do;
    then frames/s of ``select`` on the card, the duty cycle and the
    backend account."""
    cpu = hs_gate.HyperSenseGate(hs.to("cpu"), ControllerConfig())
    fired_card = gate.decide(lp)
    fired_cpu = cpu.decide(lp.cpu())
    kept_cpu = cpu.select_fired(fired_cpu)
    # the deciding scores (the card's are within SCORE_ATOL of the CPU's)
    scores = hypersense.frame_scores_batch(hs, lp).cpu().numpy()
    clear = np.abs(scores - hs.t_score) > DECISION_MARGIN
    check(np.array_equal(fired_card[clear], fired_cpu[clear]),
          "gate: card and CPU decisions differ on a frame clear of t_score")
    if clear.all():
        check(np.array_equal(kept_cpu, kept),
              "gate: card and CPU kept indices differ")
    timed = hs_gate.HyperSenseGate(hs, ControllerConfig())
    timed.select(lp)   # makes the float tiles, once per frame width
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed.select(lp)
    select_s = time.perf_counter() - t0
    return dict(
        frames=len(lp), t_score=hs.t_score, fired=int(fired_card.sum()),
        kept=len(kept), kept_cpu=len(kept_cpu),
        frames_within_margin=int((~clear).sum()), decisions_equal_cpu=True,
        kept_equal_cpu=bool(np.array_equal(kept_cpu, kept)),
        select_fps=len(lp) / select_s, flops_per_frame=flops_per_frame,
        **hs_gate.backend_flops_saved(gate.stats, flops_per_frame))


def int_datapath_phase(g, flops_per_frame):
    """The int-datapath path: its main run (each race scorer once at the
    reference's shape and at the paper's, the AUC parity at the
    reference's scenario and at the paper's operating point, the binary
    curve, the stream gate over GATE_FRAMES frames at the paper's point),
    counted from zero; then its checks and times. Returns the phase's
    record, its launches per kernel and the expanded kernel's record."""
    t0 = time.perf_counter()
    inputs = {k: race_inputs(g, *v) for k, v in RACE_SHAPES.items()}
    side = RACE_SHAPES["reference"][0]
    small = synthetic.RadarConfig(height=side, width=side)
    paper = synthetic.RadarConfig(height=PAPER.frame_h, width=PAPER.frame_w)
    torch.cuda.synchronize()
    for mod in ID_KERNELS.values():
        mod.LAUNCHES = 0
    # --- the main path
    scores = {k: race_scores(v) for k, v in inputs.items()}
    streams = auc_streams(g, small)
    auc = auc_parity(train_gate(g, small, AUC_DIM, AUC_FRAG, AUC_STRIDE),
                     streams)
    paper_hs = train_gate(g, paper, PAPER.dim, PAPER.fragment, PAPER.stride)
    auc_paper = auc_parity(paper_hs, auc_streams(g, paper))
    binary = binary_curve(g, small, *streams["synthetic"])
    gate_hs = gate_model(g, paper_hs, paper)
    frames, labels = synthetic.make_stream(g, GATE_FRAMES, paper,
                                           device=DEVICE)
    lp = adc.quantize(frames, PAPER.adc_low_bits)
    gate = hs_gate.HyperSenseGate(gate_hs, ControllerConfig())
    kept = gate.select(lp)
    torch.cuda.synchronize()
    launches = {k: mod.LAUNCHES for k, mod in ID_KERNELS.items()}
    main_s = time.perf_counter() - t0
    # --- the reference's --check gates, then the race's
    for name, a in auc.items():
        check(a["gap"] <= AUC_TOL and a["int4_gap"] <= AUC_TOL,
              f"AUC parity on the {name} stream: {a}")
    binary["claim_min_best_auc"] = BINARY_MIN_BEST_AUC
    binary["claim_met"] = binary["best_binary_auc"] >= BINARY_MIN_BEST_AUC
    for k in ("sliding_scores_f32", "sliding_scores_int", "int_expanded"):
        check(launches[k] > 0, f"{k} never ran on the int-datapath path")
    race = {k: race_checks(k, inputs[k], scores[k]) for k in inputs}
    record = expanded_record(inputs["paper"], race["paper"])
    rec = dict(
        race=race, large_w=large_w_checks(g), auc=auc,
        auc_paper_point=auc_paper, binary_curve=binary,
        gate=gate_checks(gate_hs, lp, gate, kept, flops_per_frame),
        gate_stream_positives=int(labels.sum()), launches=launches,
        main_path_s=main_s, phase_s=time.perf_counter() - t0)
    emit({"int_datapath": rec})
    return rec, launches, record


# Table I (benchmarks/table1_auc.py on benchmarks/common.py's data): noisy
# 4-bit training frames, noisier held-out frames with 3% impulse spikes;
# per block (frame, fragment, D, training frames, held-out frames)
TABLE1_BLOCKS = {"paper": (128, 96, 5000, N_TRAIN, N_HELD_OUT),
                 "reference": (64, 16, 8192, 60, 100)}
TABLE1_NOISE = (0.20, 0.30)
IMPULSE_P, IMPULSE, LOW_BITS, LP_SIGMA = 0.03, 1.2, 4, 0.01
BASELINE_EPOCHS = {"mlp2": 25, "mlp4": 25, "tiny_conv": 15}
# partial AUC above TPR 0.8 in the paper's Table I (YOLO-tiny for tiny_conv)
PAPER_PAUC = {"hdc": 0.1739, "mlp2": 0.1685, "mlp4": 0.1681,
              "tiny_conv": 0.0803}
PAPER_SPEEDUP_VS_MLP = 2.4      # Fig. 16 (benchmarks/fig16_speedup.py:100)
BASELINE_RTOL = 1e-5
ENCODE_FRAMES_N = 2


def table1_data(g, frame: int, frag: int, n_train: int, n_test: int):
    """``benchmarks/common.py``'s dataset on the port: training and held-out
    frames from ``sensing.synthetic`` (noise 0.20 and 0.30), impulse
    spikes on the held-out ones, both at 4 bits; balanced fragments (2 and
    3 per frame, seeds 0 and 1), and the same held-out windows cut from a
    ``low_precision_view`` of the spiked frames."""
    def cfg(noise):
        return synthetic.RadarConfig(
            height=frame, width=frame, noise_sigma=noise, intensity_lo=0.25,
            intensity_hi=0.6, blob_sigma_lo=1.5, blob_sigma_hi=4.0)

    ftr, mtr, _ = synthetic.make_dataset(g, n_train, cfg(TABLE1_NOISE[0]),
                                         device=DEVICE)
    fte, mte, _ = synthetic.make_dataset(g, n_test, cfg(TABLE1_NOISE[1]),
                                         device=DEVICE)
    spikes = (torch.rand(fte.shape, generator=g, device=DEVICE)
              < IMPULSE_P).to(torch.float32)
    fte = torch.clamp(fte + spikes * IMPULSE, 0, 1.5)
    lp = adc.low_precision_view(fte, LOW_BITS, LP_SIGMA, generator=g)
    test = adc.quantize(fte, LOW_BITS)
    sets = {}
    for name, frames, masks, per_frame, seed in (
            ("train", adc.quantize(ftr, LOW_BITS), mtr, 2, 0),
            ("test", test, mte, 3, 1),
            ("low_precision", lp, mte, 3, 1)):
        frags, labels = fragments.sample_fragments(
            frames.cpu().numpy(), masks.cpu().numpy(), h=frag, w=frag,
            per_frame=per_frame, seed=seed)
        sets[name] = (torch.as_tensor(frags, device=DEVICE), labels)
    check(np.array_equal(sets["test"][1], sets["low_precision"][1]),
          "the low-precision view cut other windows")
    return sets, test


def roc_row(scores, labels, paper) -> dict:
    fpr, tpr, _ = metrics.roc_curve(scores, labels)
    return dict(auc=metrics.auc(fpr, tpr),
                partial_auc_tpr08=metrics.partial_auc_above_tpr(fpr, tpr,
                                                                0.8),
                paper_partial_auc=paper)


def timed_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def baseline_inits(n_in: int) -> dict:
    """The three baselines' initial weights, each from its own seeded
    generator on the card (the reference's keys 1, 2, 3)."""
    def gen(k):
        return torch.Generator(device=DEVICE).manual_seed(SEED + k)

    return {"mlp2": (baselines.init_mlp(gen(1), n_in, n_layers=2),
                     baselines.mlp_apply),
            "mlp4": (baselines.init_mlp(gen(2), n_in, n_layers=4),
                     baselines.mlp_apply),
            "tiny_conv": (baselines.init_tiny_conv(gen(3)),
                          baselines.tiny_conv_apply)}


def train_baseline(name, init, apply_fn, sets):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    return baselines.train_classifier(
        gen, init, apply_fn, *sets["train"], epochs=BASELINE_EPOCHS[name],
        batch_size=64, lr=1e-3)


def table1_block(g, frame, frag, dim, n_train, n_test):
    """Table I once: the HDC Fragment model and the three baselines trained
    on one block's fragments, each scored on the held-out fragments and on
    their low-precision view. Returns the rows, the trained models and
    the held-out frames."""
    sets, test_frames = table1_data(g, frame, frag, n_train, n_test)
    rows, models = {}, {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 42)
    (hdc, _), train_s = timed_s(lambda: fragment_model.train_fragment_model(
        gen, *sets["train"], dim=dim, epochs=EPOCHS, base_kind="perm",
        device=DEVICE))
    models["hdc"] = hdc
    rows["hdc"] = {"train_s": train_s}
    for name, (init, apply_fn) in baseline_inits(frag * frag).items():
        trained, s = timed_s(lambda: train_baseline(name, init, apply_fn,
                                                    sets))
        models[name] = (init, trained, apply_fn)
        rows[name] = {"train_s": s}
    for view in ("test", "low_precision"):
        frags, labels = sets[view]
        for name in rows:
            if name == "hdc":
                scores = fragment_model.positive_score(
                    hdc.class_hvs, fragment_model.encode(hdc, frags))
            else:
                _, trained, apply_fn = models[name]
                scores = baselines.positive_score(apply_fn, trained, frags)
            check(bool(torch.isfinite(scores).all())
                  and scores.shape == (len(labels),),
                  f"{name} scores on {view}: not finite or mis-shaped")
            rows[name][view] = roc_row(scores.cpu().numpy(), labels,
                                       PAPER_PAUC[name])
    info = dict(frame=frame, fragment=frag, D=dim, train_frames=n_train,
                held_out_frames=n_test, train_fragments=len(sets["train"][1]),
                train_positives=int(sets["train"][1].sum()),
                held_out_fragments=len(sets["test"][1]))
    return rows, models, sets, test_frames, info


def leaf_rel_err(card, cpu) -> float:
    """The largest over the leaves of ``max |card - cpu| / max |cpu|``."""
    return max(float((p.detach().cpu() - q.detach()).abs().max())
               / max(float(q.detach().abs().max()), 1e-30)
               for p, q in zip(model_common.leaves(card),
                               model_common.leaves(cpu)))


def baseline_checks(models, sets) -> dict:
    """The paper block's baselines: training lowered the training-set
    cross-entropy; the card's logits equal the CPU's on the same weights
    within BASELINE_RTOL of the largest |logit|; one training step on the
    card equals the CPU's within BASELINE_RTOL of each leaf's largest
    entry, its gradients and its AdamW update each; a second training run
    gives the same bits (required of the MLPs, reported for TinyConv)."""
    x, y = sets["train"]
    y_t = torch.as_tensor(y, device=DEVICE).long()
    held = sets["test"][0][:64]
    out = {}
    for name in BASELINE_EPOCHS:
        init, trained, apply_fn = models[name]
        with torch.no_grad():
            xent0 = float(baselines._xent(apply_fn(init, x), y_t))
            xent1 = float(baselines._xent(apply_fn(trained, x), y_t))
        check(xent1 < xent0, f"{name}: training did not lower the "
                             f"cross-entropy ({xent0} -> {xent1})")
        # the card against the CPU on the same weights
        cpu = copy.deepcopy(trained).to("cpu")
        card = apply_fn(trained, held).detach().cpu()
        host = apply_fn(cpu, held.cpu()).detach()
        scale = float(host.abs().max())
        logit_err = float((card - host).abs().max())
        check(logit_err <= BASELINE_RTOL * scale,
              f"{name}: card logits vs CPU {logit_err} of {scale}")
        # one training step on each: the gradients, then AdamW.update and
        # apply_updates from the same (the CPU's) gradients; a tiny
        # gradient whose sign rounds differently would turn the first
        # step's mhat / sqrt(vhat) around, so the two halves are held
        # apart
        xb, yb = x[:64], y_t[:64]
        cpu_init = copy.deepcopy(init).to("cpu")
        _, g_card = baselines.loss_and_grads(init, apply_fn, xb, yb)
        _, g_cpu = baselines.loss_and_grads(cpu_init, apply_fn, xb.cpu(),
                                            yb.cpu())
        grad_err = leaf_rel_err(g_card, g_cpu)
        check(grad_err <= BASELINE_RTOL,
              f"{name}: gradients on the card vs CPU: {grad_err}")
        opt = optim.AdamW(lr=1e-3, weight_decay=1e-4)
        stepped = {}
        with torch.no_grad():
            for dev, model in ((DEVICE, init), ("cpu", cpu_init)):
                tree = model.tree()
                grads = model_common.tree_map(lambda t: t.to(dev), g_cpu)
                updates, _ = opt.update(grads, opt.init(tree), tree)
                stepped[dev] = optim.apply_updates(tree, updates)
        step_err = leaf_rel_err(stepped[DEVICE], stepped["cpu"])
        check(step_err <= BASELINE_RTOL,
              f"{name}: an AdamW step on the card vs CPU: {step_err}")
        again = train_baseline(name, init, apply_fn, sets)
        bitwise = all(torch.equal(p, q) for p, q in zip(
            model_common.leaves(trained.tree()),
            model_common.leaves(again.tree())))
        check(bitwise or name == "tiny_conv",
              f"{name}: training differs run to run")
        out[name] = dict(train_xent_init=xent0, train_xent_trained=xent1,
                         card_vs_cpu_logit_err=logit_err, logit_scale=scale,
                         card_vs_cpu_grad_rel_err=grad_err,
                         card_vs_cpu_step_rel_err=step_err,
                         run_to_run_bitwise=bitwise)
    return out


def fig16_compare(models, frames) -> dict:
    """Fig. 16's model comparison at the paper's point, per 32-frame chunk:
    the float32 HDC scorer (``frame_scores_batch`` through
    ``sliding_scores_f32``, its tiles made once per model as the stream
    makes them, as the MLP's weights are) against MLP2 on every window of
    each frame;
    ``encode_frames`` with and without reuse on ENCODE_FRAMES_N frames.
    CUDA events, the median of 20 after 3 warm-ups; ms per frame."""
    hdc = models["hdc"]
    hs = hypersense.from_fragment_model(hdc, generators(hdc.B), h=FRAG,
                                        w=FRAG, stride=STRIDE)
    tiles = stream.model_tiles(hs, FRAME, BLOCK_D, "float32")
    chunk = frames[:CHUNK]
    _, mlp, _ = models["mlp2"]
    my = (FRAME - FRAG) // STRIDE + 1

    def mlp_chunk():
        windows = chunk.unfold(1, FRAG, STRIDE).unfold(2, FRAG, STRIDE)
        return baselines.mlp_apply(mlp, windows.reshape(-1, FRAG, FRAG))

    def hdc_chunk():
        return hypersense.frame_scores_batch(hs, chunk, tiles=tiles)

    check(mlp_chunk().shape == (CHUNK * my * my, 2)
          and hdc_chunk().shape == (CHUNK,),
          "Fig. 16 outputs of the wrong shape")
    hdc_ms = time_ms(hdc_chunk)
    mlp_ms = time_ms(mlp_chunk)
    few = frames[:ENCODE_FRAMES_N]
    kw = dict(h=FRAG, w=FRAG, stride=STRIDE)
    reuse = encoding.encode_frames(few, hs.B0, hs.b, reuse=True, **kw)
    naive = encoding.encode_frames(few, hs.B0, hs.b, reuse=False, **kw)
    gap = float((reuse - naive).abs().max())
    check(bool(torch.isfinite(reuse).all())
          and reuse.shape == (ENCODE_FRAMES_N, my, my, DIM) and gap <= 1e-4,
          f"encode_frames: reuse vs naive {gap}")
    del reuse, naive
    reuse_ms = time_ms(lambda: encoding.encode_frames(
        few, hs.B0, hs.b, reuse=True, **kw))
    naive_ms = time_ms(lambda: encoding.encode_frames(
        few, hs.B0, hs.b, reuse=False, **kw))
    return dict(
        chunk=CHUNK, windows_per_frame=my * my,
        hdc_scorer_ms_per_frame=hdc_ms / CHUNK,
        mlp2_ms_per_frame=mlp_ms / CHUNK,
        hdc_speedup_vs_mlp2=mlp_ms / hdc_ms,
        paper_speedup_vs_mlp=PAPER_SPEEDUP_VS_MLP,
        encode_frames_reuse_ms_per_frame=reuse_ms / ENCODE_FRAMES_N,
        encode_frames_naive_ms_per_frame=naive_ms / ENCODE_FRAMES_N,
        encode_frames_reuse_vs_naive_max_abs=gap)


def baselines_phase(g):
    """Table I and Fig. 16's model comparison: the paper block's rows (the
    HDC row's kernels counted from zero), the reference-scale block's,
    the baselines' checks and the Fig. 16 times. Returns the phase's
    record and its launches per kernel."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for mod in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    rows, models, sets, test_frames, info = table1_block(
        g, *TABLE1_BLOCKS["paper"])
    torch.cuda.synchronize()
    launches = {k: mod.LAUNCHES for k, mod in TRAIN_KERNELS.items()}
    for k in ("hdc_encode_perm", "hdc_encode", "similarity"):
        check(launches[k] > 0, f"{k} never ran on the Table I path")
    blocks = {"paper": dict(info, rows=rows)}
    ref_rows, *_, ref_info = table1_block(g, *TABLE1_BLOCKS["reference"])
    blocks["reference"] = dict(ref_info, rows=ref_rows)
    for block in blocks.values():
        for view in ("test", "low_precision"):
            first = max(block["rows"],
                        key=lambda k: block["rows"][k][view][
                            "partial_auc_tpr08"])
            block[f"hdc_first_in_partial_auc_{view}"] = first == "hdc"
    rec = dict(table1=blocks, checks=baseline_checks(models, sets),
               fig16=fig16_compare(models, test_frames), launches=launches,
               phase_s=time.perf_counter() - t0)
    emit({"baselines": rec})
    return rec, launches


def kernel_device_ms(fn, names, calls: int = 5, windows: int = 3):
    """Device time of one call of ``fn`` spent in the kernels whose names
    contain one of ``names``: ``calls`` calls under ``torch.profiler``, each
    kernel's mean over the launches the profiler recorded (it has dropped
    single launches on the H100, so the window opens and closes with a
    one-element fill), summed over the kernels. A window in which a
    kernel was never recorded (the profiler has lost every event of a
    window after a large profile) is taken again, up to ``windows``
    times; "not measured" if none recorded them all. Returns the sum and
    the means."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(windows):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            torch.zeros(1, device=DEVICE)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            torch.zeros(1, device=DEVICE)
            torch.cuda.synchronize()
        means = {n: e.self_device_time_total / e.count / 1e3
                 for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CPU
                 and e.self_device_time_total > 0
                 for n in names if n in e.key}
        if len(means) == len(names):
            return sum(means.values()), means
    return "not measured", means


def analysis_phase() -> dict:
    """The port's lint over ``src/repro_torch`` (zero unwaived findings,
    every C entry point of ``_build.SIGNATURES`` held against its
    prototype) and two negative probes that the sanitizers are armed on
    the card: ``.item()`` of a CUDA tensor inside
    ``sanitize.no_implicit_transfers()`` and a CUDA graph captured inside
    ``sanitize.steady_state()`` must each raise."""
    t0 = time.perf_counter()
    stats = {}
    found = port_lint.lint_paths([str(ROOT / "src" / "repro_torch")], stats)
    lint_s = time.perf_counter() - t0
    unwaived = [f.render() for f in found if not f.waived]
    check(not unwaived, "analysis: unwaived findings:\n" + "\n".join(unwaived))
    entries = sum(len(v) for v in _build.SIGNATURES.values())
    check(stats["c_entries"] == entries, f"analysis: RA006 held "
          f"{stats['c_entries']} of {entries} C entry points")
    x = torch.arange(4.0, device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    item_error = None
    try:
        with sanitize.no_implicit_transfers(always=True):
            x.sum().item()
    except RuntimeError as e:
        item_error = str(e).splitlines()[0][:200]
    check(item_error is not None,
          "analysis: .item() passed inside no_implicit_transfers()")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "analysis: the sync debug mode was not restored")
    static = torch.zeros(8, device=DEVICE)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        static.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph_error = None
    try:
        with sanitize.steady_state("graph probe"):
            with torch.cuda.graph(graph):
                static.mul_(2.0)
    except AssertionError as e:
        graph_error = str(e)[:200]
    check(graph_error is not None and "CUDA graph capture" in graph_error,
          "analysis: a graph captured inside steady_state() passed")
    graph.replay()
    torch.cuda.synchronize()
    check(bool((static == 2.0).all()), "analysis: the probe graph misran")
    return {"findings": len(found), "unwaived": len(unwaived),
            "waived": sum(f.waived for f in found),
            "files": stats["files"], "c_files": stats["c_files"],
            "c_entries_held": stats["c_entries"],
            "smem_sizes": dict(stats["smem_sizes"]),
            "sync_free_reachable": stats["sync_free_reachable"],
            "capture_reachable": stats["capture_reachable"],
            "lint_s": lint_s, "item_probe_raised": item_error,
            "graph_probe_raised": graph_error,
            "probes_s": time.perf_counter() - t1}


def ok_line() -> None:
    emit({"guarded_regions": guarded_summary()})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def mesh_only(model, cal) -> int:
    """``--only mesh``: the fleet's frames and the mesh phase alone."""
    gf = torch.Generator(device=DEVICE)
    gf.manual_seed(SEED + 7)
    fleet_raw, fleet_labels = fleet_data(gf)
    t0 = time.perf_counter()
    mesh, mesh_launches = mesh_phase(model, cal, fleet_raw, fleet_labels)
    emit({"mesh": dict(mesh, launches=mesh_launches,
                       phase_s=time.perf_counter() - t0)})
    ok_line()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", choices=("mesh", "cells", "lm", "decode", "mesh_decode",
                           "moe", "hybrid", "hybrid_mesh", "xlstm",
                           "xlstm_mesh", "loop", "loop_mesh", "examples"),
        help="mesh: build the kernels and run the mesh phase alone (on a "
             "host with several cards: the NCCL world takes every card); "
             "cells, lm, decode, moe, hybrid, xlstm, loop: that phase alone "
             "(moe's, hybrid's and xlstm's sharded runs in an NCCL world of "
             "every card); mesh_decode, hybrid_mesh, xlstm_mesh: the mesh "
             "phase's sharded decode cell, the hybrid's or the xLSTM's "
             "sharded runs alone, in an NCCL world of every card; "
             "loop_mesh: the train loop over a mesh of every card and the "
             "launcher over a process a card (none of these runs any of "
             "the kernels); examples: build the kernels and run the "
             "examples phase alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    # the dry run counts on the host's CPU while the card works
    dry = dryrun_start() if args.only in (None, "cells") else None
    try:
        return run_phases(args, smi, dry)
    finally:
        dryrun_stop(dry)


def run_phases(args, smi: str, dry) -> int:
    """The phases :func:`main` was asked for, the dry run ``dry`` (or
    None) running meanwhile."""
    if args.only == "cells":
        cells_phase(smi, dry)
        ok_line()
        return 0
    if args.only in ("lm", "decode", "mesh_decode", "moe", "hybrid",
                     "hybrid_mesh", "xlstm", "xlstm_mesh", "loop",
                     "loop_mesh"):
        if args.only == "lm":
            lm_phase(smi)
        elif args.only == "decode":
            decode_phase(smi)
        elif args.only == "moe":
            moe_phase(smi)
        elif args.only == "hybrid":
            hybrid_phase(smi)
        elif args.only == "hybrid_mesh":
            t0 = time.perf_counter()
            emit({"hybrid": {"card": smi, "mesh": hybrid_world(),
                             "phase_s": time.perf_counter() - t0}})
        elif args.only == "xlstm":
            xlstm_phase(smi)
        elif args.only == "loop":
            loop_phase(smi)
        elif args.only == "loop_mesh":
            loop_mesh_only(smi)
        elif args.only == "xlstm_mesh":
            t0 = time.perf_counter()
            emit({"xlstm": {"card": smi, "mesh": xlstm_world(),
                            "phase_s": time.perf_counter() - t0}})
        else:
            mesh_decode_phase()
        ok_line()
        return 0

    emit({"analysis": analysis_phase()})
    t0 = time.perf_counter()
    logs = _build.build()
    emit({"build_s": time.perf_counter() - t0, "ptxas": {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "entry" in ln]
        for name, log in logs.items()}})
    if args.only == "examples":
        examples_phase(smi)
        ok_line()
        return 0

    sim_launches = similarity_launches()
    emit({"similarity_launches": sim_launches})
    first_ms = first_profile_device_ms()
    emit({"first_profile_device_ms": first_ms})

    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    model, *cal = make_model(g)
    if args.only == "mesh":
        return mesh_only(model, cal)
    labels = ((torch.arange(N_STREAM, device=DEVICE) // 16) % 3 == 2).long()
    raw, _ = synthetic_frames(g, labels)
    emit({"model": {"frame": FRAME, "fragment": FRAG, "stride": STRIDE,
                    "D": DIM, "nonlinearity": "rff", "t_detection": 0,
                    "seed": SEED, "setup_s": time.perf_counter() - t0}})

    records = kernel_phase(calibrated(model, *cal, "float32", 4),
                           raw[:CHUNK])
    for r in records:
        emit({"kernel_check": r})
    runs, launches = stream_phase(model, cal, raw, labels)
    emit({"profile": profile_phase(model, cal, raw)})
    t0 = time.perf_counter()
    gf = torch.Generator(device=DEVICE)
    gf.manual_seed(SEED + 7)
    fleet_raw, fleet_labels = fleet_data(gf)
    _, fleet_launches = fleet_phase(model, cal, fleet_raw, fleet_labels)
    emit({"fleet": {"streams": FLEET_S, "frames_per_stream": N_STREAM,
                    "runs": len(FLEET_RUNS), "launches": fleet_launches,
                    "phase_s": time.perf_counter() - t0,
                    "stacked_forms": stacked_forms(gf)}})
    t0 = time.perf_counter()
    _, service_launches = service_phase(model, cal, fleet_raw)
    emit({"service": {"slots": FLEET_S, "ticks": N_STREAM // CHUNK,
                      "launches": service_launches,
                      "phase_s": time.perf_counter() - t0}})
    t0 = time.perf_counter()
    mesh, mesh_launches = mesh_phase(model, cal, fleet_raw, fleet_labels)
    emit({"mesh": dict(mesh, launches=mesh_launches,
                       phase_s=time.perf_counter() - t0)})
    t0 = time.perf_counter()
    cascade, cascade_launches = cascade_phase(model, cal, fleet_raw)
    del fleet_raw
    emit({"cascade_phase_s": time.perf_counter() - t0})
    cells_phase(smi, dry)
    lm_phase(smi)
    decode_phase(smi)
    # the hybrid's host subprocesses run beside the MoE phase's card work
    helpers = hybrid_helpers()
    try:
        moe_phase(smi)
    except BaseException:
        host_stop(*helpers[:2])
        raise
    hybrid_phase(smi, helpers)
    xlstm_phase(smi)
    loop_phase(smi)
    examples_phase(smi)
    train, train_launches, train_records = train_phase(g)
    emit({"train": train})
    for r in train_records:
        if r["name"] == "similarity":
            r.update(sim_launches)
        if r["kernel_device_ms"] == "not measured" and \
                r["name"] in first_ms:
            r["kernel_device_ms"] = first_ms[r["name"]]
            r["kernel_device_ms_from"] = "the process's first profile"
        emit({"kernel_check": r})
    records += train_records
    gi = torch.Generator(device=DEVICE)
    gi.manual_seed(SEED + 11)
    _, int_launches, expanded = int_datapath_phase(
        gi, cascade["backbone_cost"]["flops"])
    emit({"kernel_check": expanded})
    records.append(expanded)
    gb = torch.Generator(device=DEVICE)
    gb.manual_seed(SEED + 13)
    _, baseline_launches = baselines_phase(gb)
    # launches: the six stream runs', the six fleet runs', the three
    # service runs', the mesh phase's first rank's (the split entries'
    # calls), the cascade's gate, the training path's, the int-datapath
    # path's and Table I's, each counted from zero right before its run
    for r in records:
        r["launches"] = sum(n.get(r["name"], 0) for n in (
            launches, fleet_launches, service_launches, mesh_launches,
            cascade_launches, train_launches, int_launches,
            baseline_launches))
        check(r["launches"] > 0, f"{r['name']} never ran on a main path")
    for name, n in train_launches.items():
        check(n > 0, f"{name} never ran on the training path")
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bound_tc_ms") if k in r} for r in records]})
    ok_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
