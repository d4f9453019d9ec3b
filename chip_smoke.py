"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (``nvcc``).  Phases, each raising on failure:

  1. device: the card's name and power limit (from ``nvidia-smi``);
  2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card over edge
     shapes and widths (exact for K1-K3, whose outputs are verdicts, codes
     and bit patterns; K4 at 2e-5 in float32 and one step in bfloat16, each
     case through the kernel of its dtype, also over a preallocated cache
     with ``kv_len`` 1, a 64-key tile's edge and one past it and T, NaN past
     kv_len (``tests/library_cases.py``'s ``KV_LEN_CASES``), and with a value
     width of its own, MLA's D = 192 and Dv = 128 among them
     (``ATTENTION_DV_CASES``, also over a cache), in float32 on the
     short-row kernel's pieces and merge (``SPLIT_CASES``: decode over
     4,096 and 4,097 keys, windows at a piece's edge, S = 15 at rep 4; out
     and lse, one launch a call), K5 and K6 at 1e-5); the
     backwards of K4 (``flash_attention_bwd``, both dtypes, each through the
     kernel of its dtype: bfloat16 ``flash_attention_bwd_sm90`` on the
     tensor cores, reading the lse K4's bfloat16 forward keeps (held to the
     plain lse within ``ATTENTION_LSE_TOL``), float32 ``flash_attention_bwd``
     on the CUDA cores, reading the float32 forward's lse with no forward
     launch; within ``ATTENTION_BWD_TOL``, rows that see no key without a
     gradient, a dk missing its last key tile rejected, in float32 a dq
     missing the last key tile's parts too), K5 and its transposed launch
     (the narrow-row kernel's widths among them) and K6
     (``embedding_bag_bwd``, repeated ids) at 1e-5 on ``ATTENTION_BWD_CASES``,
     ``SPMM_BWD_CASES`` and ``BAG_BWD_CASES``.  K1 has two
     kernels: its batch form ``serve_batch`` (the engine's kernel backend,
     a whole batch in one launch), whose cases are
     ``tests/serve_batch_cases.py``'s, and its tier form ``label_intersect``
     (the counterpart of ``repro.kernels.ops.label_intersect``).  K2 has two
     kernels: its slab form ``frontier_or`` (the counterpart of
     ``repro.kernels.ops.frontier_or``) and its frontier form
     ``frontier_expand`` (the device build's BFS level), whose cases are
     ``tests/frontier_cases.py``'s; K3's and K5's cases are
     ``tests/library_cases.py``'s; the tier form's and the slab form's
     edges (widths, wm and d not a multiple of 4, bases 4 bytes into their
     buffers, ids outside the range) are ``tests/tier_slab_cases.py``'s;
  3b. the kernel library (K3 bitset_mm, K4 flash_attention, K5 ell_spmm,
     K6 embedding_bag), which no oracle path calls, at the widths of
     configurations the repo has: the transitive closure of the "human"
     analogue (byte for byte against ``transitive_closure_bits``),
     attention in bfloat16 (the tensor-core kernel ``flash_attention_sm90``)
     at granite-3-2b prefill, h2o-danube-1.8b sliding-window prefill and
     granite decode_32k and in float32 (the CUDA-core kernel
     ``flash_attention``) at granite prefill, ELL SpMM at ogb_products,
     embedding bags at xDeepFM's serve_bulk batch; the launch counts read
     around exactly that drive; K4's backward kernels, bfloat16 and
     float32, at deepseek-7b's heads of 128 and MLA's (192, 128), 1 x 4,096
     causal (``ATTENTION_BWD_CONFIGS``, comparison launches, beside SDPA's
     backward in the same dtype); each kernel against its plain version, timed
     beside its bound, its plain version and the PyTorch library call (K3,
     K5 and K6 also beside their gather floor: the bytes a gather moves when
     no source row is reused from L2, K6's in whole 32-byte sectors);
  4. the main path: the citeseer analogue at full size (n = 693,947) through
     ``repro_torch.core.api.build_oracle(g, device="cuda").serve(q)``: the
     build with ``impl="auto"``, which must resolve to the host
     ``speculative`` engine with the JAX package's 2,965 schedule boundaries
     and speculation counts (``SPEC_COUNTS``) and labels byte for byte equal
     to a ``reference`` build of the same graph, by their sha256
     (``DL_SHA256``, printed by ``tools/build_counts.py``; the truth of
     phases 4-4c);
     serving with ``backend="auto"`` (which must resolve to the kernel),
     about 1M queries mixing uniform and reachable pairs, in batches of
     4,096; verdicts held against the host merge on every query and against
     BFS truth on a sample; the kernels' launch counts read around exactly
     this run (``serve_batch`` once a batch, ``label_intersect`` never); the
     batch latency p50/p99 of this run;
  4b. the device wave build: ``build_oracle(g, device="cuda", impl="device")``
     on the citeseer analogue at ``FULL_RUN_DEVICE_BUILD_SCALE`` (0.05; 1.0
     with ``--only-device-build``), the launch counts read around exactly this
     build (``frontier_expand`` once a BFS level, ``frontier_or`` never); its
     labels byte for byte against the reference build (by ``DL_SHA256``
     where the scale has one, else a reference build of its own), queries
     served through ``serve_batch`` on it with the reference's verdicts (the
     host merge of the labels the sha256 holds) and every degradation
     counter 0; its build
     seconds, host reads a wave and cone rows a sweep; K2's slab form against its plain version on a real slab
     and frontier; launches a wave and the card's busy share over a
     profiled window of ``PROFILED_WAVES`` (100) waves;
  4c. the host batched engines at citeseer@0.5 (``HOST_ENGINES_SCALE``), in
     a child process of the script that runs beside phases 1-4b (the kernel
     builds leave most cores idle) and is waited for after 4b, each build
     byte for byte against the reference build there (``DL_SHA256``):
     ``impl="wave"`` (23,423 waves), and a speculative build with a
     checkpoint every ``CKPT_EVERY`` boundaries, killed by an injected
     failure at chunk ``KILL_AT_CHUNK`` and resumed from its last checkpoint
     with the JAX package's speculation counts at that scale
     (``HALF_SPEC_COUNTS``); the seconds of each build, to the kill and of
     the resume, the checkpoints' seconds, count and bytes on disk;
  4e. Hierarchical-Labeling of phase 4's graph,
     ``build_oracle(g, method="hierarchical", device="cuda")``: the JAX
     package's level sizes, label shapes, label ints and sha256
     (``HL_LEVEL_SIZES``, ``HL_SHAPE``, ``HL_LABEL_INTS``, ``HL_SHA256``);
     phase 4's traffic served with ``backend="auto"`` (``serve_batch`` once a
     batch, ``label_intersect`` never, every degradation counter 0), every
     verdict equal to phase 4's DL verdict; the build's seconds by stage,
     ``kernel_qps``, batch p50/p99, the resident label bytes;
  4f. the ported quickstart at amaze: the five §6 baselines, ``OnlineBFS``,
     DL and HL (served on the card) agree on 2,000 queries, each index's
     size; ``examples/quickstart_torch.py`` on the card;
  4g. the serving daemon over phase 4's oracle through ``run_open_loop`` at
     the JAX driver's defaults (400 arrivals/s of 64 queries, 3 s, deadline
     150 ms, ``max_batch`` 4,096, a 2 ms window): clean; with the driver's
     ``--inject-device-latency 2-6:60 --inject-device-failure 8-10`` (the
     breaker trips, its host-rung batches counted); under a
     ``BudgetController`` whose pressure watermark is 0.75 of the full label
     bytes at 100 arrivals/s for 2 s (at least one step down).  In each run
     every dispatched answer equals phase 4's oracle's, the registry's
     counters equal the daemon's books, ``serve_batch`` launched once for
     each warm-up rung and each dispatch that reached the kernel; sheds
     printed, not asserted;
  4h. the dynamic oracle on phase 4's graph: ``DurableDynamicOracle(g,
     state_dir, device="cuda")``, whose epoch 0 gives phase 4's verdict on
     all of phase 4's traffic; ``DYN_ROUNDS`` (1) rounds of ``DYN_UPDATES``
     (100) DAG-preserving updates at insert share 0.6, each applied and
     published (a repair publish, a snapshot and a WAL marker), then 4,096
     of phase 4's queries on the current epoch (``serve_batch``, one launch)
     and on the epoch before it, pinned (K1's tier form ``label_intersect``,
     one launch, equal to that epoch's host merge), 1,024 of them against
     BFS truth of the mutated graph; the seconds of apply, publish stage and
     commit, snapshot, refresh and the first ``ServeBatch`` rebuild;
     ``memory_allocated`` after each publish (within the epoch window's
     label copies); one more batch acknowledged in the WAL only, a crash,
     ``recover`` on the card with the never-crashed oracle's verdicts; the
     daemon over the recovered oracle through ``run_open_loop`` (400
     arrivals/s of 64 queries for 2 s, one ``daemon.publish`` 1 s in; with
     ``--publish-stall S`` stalled S seconds more at its fault site): pinned
     batches > 0, each through ``label_intersect``, every answer equal to
     the host merge of the epoch that served it, the registry equal to the
     daemon's books; the dispatches, the event loop's lag and the
     collector's passes during the publish.  Phases 4e-4h, 4j and 4k run
     before 4d;
  4i. the multi-device modes.  (a) Phase 4's oracle cold-started from its
     snapshot (``oracle_from_snapshot(mesh=)``) behind a (1, 1) mesh over a
     one-rank NCCL process group in this process: all of phase 4's traffic
     through ``sharded`` and then ``sharded_hop``, every verdict equal to
     phase 4's, K1's tier form ``label_intersect`` launched once a batch a
     backend (512, read around exactly that run), each backend's batch
     p50/p99.  (b) ``MESH_SHAPE`` (2, 2) ranks over gloo on the one card
     (NCCL puts no two ranks on one device), spawned once (a) has ended
     (they load the kernels the script built), building and cold-starting
     beside phase 4b alone and serving once 4b has ended, so that no
     measured window of another phase runs beside them and their serving
     runs beside nothing: the ``mesh=`` device build of citeseer@
     ``MESH_BUILD_SCALE`` (0.02), its labels equal to ``DL_SHA256`` there
     on every rank and K2's slab form ``frontier_or`` launched once a slab
     call (read around exactly that build); then phase 4's snapshot
     cold-started on every rank and its first ``MESH_PREFIX_QUERIES``
     (65,536) queries through both sharded backends with the column blocks
     really split, every verdict equal to phase 4's on every rank;
  4j. the substrate's serving paths, before 4d, at ``full_config()`` widths
     with weights from the port's ``init_params`` and a seeded generator:
     each LM at ``SUBSTRATE_LAYERS`` (6) of its layers: granite-3-2b in
     bfloat16 (prefill 1 x 4,096 and 1 x 32,768, its
     logits at 4,096 against the same model through K4's plain version,
     max abs and top-1 agreement within ``SUBSTRATE_BF16``; 8 prompts of
     256 fed through ``decode_step`` and 64 greedy tokens, a cache of 320),
     h2o-danube-1.8b (prefill 1 x 8,192, where the window cuts),
     deepseek-7b, granite-moe-1b-a400m and deepseek-v2-lite-16b (1 x 4,096;
     MLA through K4 at D = 192, Dv = 128), these four then 16 decode steps
     at batch 8 over a cache filled with random keys and values (MLA: random
     latents) to 4,160 positions.  Each non-MLA LM's check step (a step of its decode
     once more, granite's at kv_len 300, the others' at 4,161) against the
     plain version, a dense LM's within ``SUBSTRATE_BF16``'s max abs, which
     must reject the step through an attention that drops chunks of keys;
     the step under torch.profiler: K4's share of the device time.  granite
     and the MoE once more in float32 on K4's CUDA-core kernel (the check
     step; granite's prefill 1 x 4,096, its logits against the plain
     version and decode against forward) within ``SUBSTRATE_F32_ATOL``, and
     deepseek-v2-lite at 2 of its layers with no token dropped (prefill, its
     logits against the plain version, decode against forward); the GNN
     family: GCN at full_graph_sm and ogb_products (K5, 2 launches a
     forward, against its forward through K5's plain version within 1e-5),
     gatedgcn and schnet against the same forward on the CPU (1e-4) and
     graphcast in bfloat16 against its float32 re-run (``GRAPHCAST_BF16``),
     each forward's ms, nodes/s and edges/s;
     xDeepFM serve_p99 (200 batches of 512, p50/p99, a batch's logits
     against the plain gathers within 1e-5), serve_bulk (262,144 rows in
     slabs of 16,384) and retrieval_cand (1 x 1,000,000 in chunks of
     25,000; the first chunk equal to forward on the broadcast ids).
     Launch counts read around exactly each call: K4 n_layers a prefill
     and a decode step (MLA's decode step none), K5 2 a GCN forward, K6 2
     a forward.  Then K4 at the last layer's call of every prefill (a 32k
     one on its last 1,024 query rows) and check step, K5 at GCN's two
     calls at ogb_products (F = 16 and 7), the path's own inputs and output,
     and K6's two gathers of a serve_bulk slab, each against its plain
     version with its controls, timed beside its bound, its plain version
     and the PyTorch call; these and the counts become K4's, K5's and K6's
     entries of the kernels line;
  4k. training at ``full_config()`` widths through ``repro_torch.launch.train``
     (``TRAIN_LM``): granite-3-2b, one step's gradients through K4 and its
     backward kernel against the same step through their plain versions in
     float32 at 2 layers (``TRAIN_F32_REL``, which the step with every dk's
     last key tile dropped must exceed) and in bfloat16 at 40
     (``TRAIN_BF16_REL``; each of the step's 40 K4 backward calls held to
     its plain version at ``ATTENTION_BWD_TOL`` as it happens, a dk without
     its last key tile rejected on each), then ``launch.train.main`` for 3
     steps of 4 x 1,024 tokens with every plain version refused (K4 2 x 40
     launches a step with the layers recomputed, its backward 40, each on
     the tensor cores: ``flash_attention_bwd_sm90``), the step time and the
     peak memory; xDeepFM over its whole table at batch 4,096 and GCN at
     d_in 1,433 on ``random_dag(50,000, 150,000)``, each checked the same way
     in float32 and trained (K6 and its backward 2 a step each, K5 and its
     transposed launch 2 a step each), GCN then through ``--ckpt-dir
     --fail-at 3``, resuming to the same losses; then the three backward
     kernels at the path's own calls against their plain versions, timed
     beside their bound, their plain versions and the PyTorch call (SDPA's
     backward, ``F.embedding_bag``'s, ``torch.sparse.mm`` on the
     transpose): the kernels line's ``flash_attention_bwd_sm90`` (the
     bfloat16 step's layer 0), ``flash_attention_bwd`` (float32: the float32
     check's layer 0, its launches that check's), ``embedding_bag_bwd`` and
     ``ell_spmm_bwd``, and 4k's launches join the forward kernels' counts;
  4l. training across ranks, after 4k and before 4d: ``DIST_WORLD`` (4)
     gloo ranks on the one card, spawned once 4i (b)'s have ended (they warm
     up beside 4e) and let go once 4k has ended (see ``DIST_WORLD``'s comment): (a)
     granite-3-2b at full width through ``lm_cells.make_train_step`` over a
     (4, 1) data mesh with ZeRO-sharded AdamW, ``n_accum`` 2: in float32 at
     2 layers one step against a one-rank step over the whole batch (loss,
     master and moments within ``TRAIN_F32_REL``; a step without the last
     rank's gradient rejected), in bfloat16 at ``DIST_LM["layers"]`` (2)
     layers ``DIST_LM["steps"]`` (1) timed step with every rank's params
     equal byte for byte after each (sha256), and ``quantized_psum_grads`` over a step's
     gradient tree held to a numpy model of its formula; (b)
     ``dist.pipeline_apply`` over 4 stages of one granite layer each, 4
     microbatches of 1 x 1,024, float32 and bfloat16, output and gradients
     against the sequential run (``DIST_GPIPE_REL``; two stages swapped
     rejected); (c) ``gatedgcn.make_dstlocal_loss`` at ``full_config()`` on
     full_graph_sm's padded shape against ``loss_fn`` on one rank within
     JAX's bounds (the node stream in the wrong rank order rejected), and a
     ``make_gnn_train_step`` step; (d) the data-sharded GNN losses
     (``make_sharded_loss``: a rank's node rows and edges, JAX's layout) on
     4 data ranks at ``full_config()``: schnet at molecule and gatedgcn at
     full_graph_sm in float32, graphcast at its mesh_dims in float64 (its
     float32 run measured beside the one-rank program's own spread), loss
     and every gradient leaf within ``TRAIN_F32_REL`` of ``loss_fn`` on one
     rank (the partials scattered onto the wrong owners rejected),
     graphcast once more in bfloat16 (``DIST_GRAPHCAST_BF16_REL``), a step
     on schnet, gatedgcn and graphcast bfloat16 with the params equal on
     every rank; (e) xDeepFM over a (2, 2) ("data",
     "model") mesh, its 39M x 10 table row-sharded over "model": serve_p99
     and a 25,000-candidate retrieval chunk within ``XDEEPFM_MESH_TOL`` of
     the one-rank forward (no model all-reduce rejected), a train step at
     batch 4,096 whose gradient norm passes the clip against the one-rank
     step within ``TRAIN_F32_REL`` (the table cut to
     ``DIST_XDEEPFM["train_vocab_per_field"]`` for the step alone), K6 and
     its backward timed at the path's shapes; (f) Megatron tensor
     parallelism over a (2, 2) ("data", "model") mesh: granite-3-2b at full
     width, a float32 step at 2 layers against one rank (loss, gradient
     norm, each rank's slice of master and moments gathered over the
     model ranks by ``gather_params``, within
     ``TRAIN_F32_REL``; the step without ``wo``'s ``reduce_from_model``
     rejected), a timed bfloat16 step with the params equal over each data
     group, a bfloat16 prefill of 1 x 4,096 against one rank within 4j's
     bound; granite-moe's expert-parallel float32 step against one rank;
     deepseek-7b's 16 decode steps over a cache split by kv heads within
     1e-3; (g) decode over a cache split along its sequence over the data
     ranks and along ``head_dim`` or ``kv_lora`` over the model ranks
     (``SPLIT_DECODE``), every step against the one-rank ``decode_step`` on
     the whole cache: h2o-danube-1.8b at full width over a (4, 1) sequence
     split in bfloat16 and float32 (K4 with its lse on each rank that keeps
     a key), deepseek-v2-lite-16b at full width over ``kv_lora`` on (1, 4)
     and with the sequence on (2, 2), then granite-3-2b at full width over
     ``head_dim`` on 16 model ranks (JAX's single mesh's model axis),
     ``SPLIT_WORLD`` ranks of their own, forked once 4l's have ended from a
     server that imported what they run beside 4l (their start-up timed);
     K4's lse at danube's
     decode shapes in both kernels.  K4 and its backward counted
     on every rank around exactly the 4-rank steps and pipeline runs and
     (f)'s and (g)'s calls, K6
     and its backward around (e)'s 4-rank calls; a step's seconds,
     tokens/s, peak memory a rank, the collectives' seconds and the bytes
     on the wire by route;
  4m. the paper's production cells (``configs/reachability.py``), after 4l
     and before 4d: each cell's own ``fn`` once at its global shapes on the
     card, on one rank (``mesh`` None, the single-device program), data
     from ``PRODUCTION_SEED`` made on the card.  ``serve_1m`` (n = 10M,
     L 64) and ``serve_xl`` (n = 25M, L 32): label rows sorted and
     INVALID-padded, lengths uniform in [1, L], hops skewed to the first
     ``PRODUCTION_HOPS`` ranks (20-80% of the verdicts true, a gate), 1M
     uniform queries through one K1 tier-form launch at the full width,
     every verdict equal to ``ref.tier_intersect_ref`` in chunks, queries
     reading rows past byte 2^31 counted (> 0, a gate) and the plain
     version at width L - 1 rejected; a K1 record each.  ``build_sweep``
     (n = 10M, m = 30M, L 64) and ``build_sweep_xl`` (25M, 25M, L 32): a
     random DAG made on the card (``production_dag``), ``distribute_one``
     from the top vertex of the §5.2 order on a fresh state, its labels
     equal to a 64-level BFS both ways (``bfs_levels_device``; the truth
     less its last level rejected); at ``build_sweep`` a second iteration
     from the next vertex, pruning > 0, equal to a numpy transcription on
     the host.  Each cell also traced by the dry run on a one-rank fake
     mesh: its argument bytes equal to the card's tensors', its
     bytes-accessed bound beside the measured time.  The full script runs
     all four (``FULL_RUN_PRODUCTION``);
  4d. cold start and budget, on phase 4's oracle and traffic: the oracle
     saved (``persist.save_oracle``) and cold-started
     (``core.api.oracle_from_snapshot``), labels byte for byte and every
     verdict equal to phase 4's through ``serve_batch``; one row block
     corrupted: a strict load raises, quarantine mode answers 4,096 queries
     on the corrupt rows through exact search; phase 4's engine under a
     ``BudgetController`` at 0.75 of the full label bytes (``rank_cut``
     theta*, 44,412,608 resident bytes), phase 4's traffic (a prefix when
     its searches pass 60 s or would end the script past 330 s, said in
     ``prefix_why``) through ``serve_batch`` with the truncation
     masks, the kernel's uncertain marks held against the plain version and
     every verdict equal to phase 4's; at 0.5 the padded floor on one batch;
     the cut store saved and reloaded byte for byte; ``apply(None)`` and
     ``refresh`` back to phase 4's verdicts; the launch counts read around
     each of the three served paths;
  5. timing of K1's and K2's two kernels and their plain versions with CUDA
     events at the main path's shapes (``serve_batch`` at a batch of 4,096
     and at the whole traffic in one call, each also under phase 4d's
     budget, with the bytes, compares and 32-byte sectors its queries need; ``frontier_expand`` at a real level
     from the middle of the build's schedule), and the kernels JSON line
     (all twelve kernels: K1, K2 and K4 have two each, and phase 4k's three
     backward kernels; K1's batch form
     counts the launches of phases 4, 4e, 4f, 4g and 4h, its tier form
     those of phase 4h's pinned epochs and of phase 4i's sharded backends
     (every rank's), timed at phase 4h's pinned batch size, at 4,096 and at
     2^20 queries, where its byte bound binds; K2's slab form those of
     phase 4i's mesh= build (every rank's); K4's, K5's and K6's those of
     phases 4j, 4k and 4l (phase 3b's beside them; 4l's every rank's); K1's
     tier form
     and K2's slab form also after an L2 flush, the time their shares of
     the DRAM-rate bound are taken from, the tier form beside its gather
     floor too);
  6. where a serving batch spends its time: the device's busy share over a
     window of the main path (torch.profiler), the host's CUDA calls a
     batch, and the engine's spans (``device_call`` is the fused call);
  7. the serve driver (``repro_torch.launch.serve``) on a small graph, a
     second path on the card: its own launch counts, every degradation
     counter 0.

``--only-distributed-training`` runs phases 1-3 and 4l alone (with (g)'s
16 ranks);
``--only-production-cells`` phases 1-3 and 4m, all four cells.
``--only-device-build`` runs phases 1-3 and 4b alone, at
``--device-build-scale`` (default 1.0), and times
``frontier_expand``; in the full script the flag sets phase 4b's scale.
``--only-kernels`` runs phases 1-3b alone; ``--only-substrate`` phases
1-3b and 4j; ``--only-training`` phases 1-3 and 4k; ``--only-dynamic`` phases 1-3,
4 and 4h, and times K1's tier form; ``--only-multi-device`` phases 1-4 and
4i, and times K1's tier form and K2's slab form (at the mesh= build's
graph).

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# tests/frontier_cases.py, serve_batch_cases.py, library_cases.py and
# tier_slab_cases.py: edge cases shared with the card tests; tools/build_counts.py's labels_sha256
sys.path.insert(1, str(ROOT / "tests"))
sys.path.insert(2, str(ROOT / "tools"))

# H100 SXM peaks.  HBM bytes/s: NVIDIA's data sheet.  The data sheet gives
# no INT32 rate; its 67 TFLOP/s float32 rate counts an FMA as two operations
# on 128 float32 lanes per SM, and a Hopper SM has 64 INT32 lanes (NVIDIA
# H100 Tensor Core GPU Architecture whitepaper), so one int32 compare per
# lane per clock is 67e12 / 2 / 2
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4
# dense bf16 tensor-core rate (data sheet): K4's bound in bfloat16, on the
# tensor cores; K4 in float32 runs on the CUDA cores and is bound at their
# 67 TFLOP/s float32 rate (data sheet), which K5 and K6 use too
PEAK_BF16_FLOPS_PER_S = 989e12
PEAK_F32_FLOPS_PER_S = 67e12

MAIN_DATASET = "citeseer"
MAIN_SCALE = 1.0
MAIN_QUERIES = 1 << 20
BATCH = 4096
BFS_SAMPLE = 4096
# the device build's first waves, profiled in phase 4b: 500 took 40 s of the
# script, most of it the profiler's own work on their events
PROFILED_WAVES = 100
LABEL_FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")
# citeseer@1.0's builds as the JAX package (repro.build.engine) counts them on
# a host: impl="auto" resolves to its speculative engine with these schedule
# boundaries and speculation counts.  The counts are deterministic; the port's
# host engines must reproduce them exactly.  ``tools/build_counts.py --scale
# 1.0`` prints them from both packages where JAX is installed.
SPEC_BOUNDARIES = 2965
SPEC_COUNTS = {"spec_waves": 9144, "spec_members": 401152, "clean_waves": 753,
               "violations": 33576, "replayed_members": 33576, "replayed_sides": 33576,
               "exact_waves": 1398, "annotated_pairs": 51676, "violation_rate": 0.0837,
               "scalar_bailout": False}
# the sha256 of the five label fields of citeseer's Distribution-Labeling
# (tools/build_counts.py's labels_sha256), by scale.  At 1.0: the port's
# ``reference`` build (the scalar one, a pruned BFS from each vertex, where
# the speculative, wave and device engines these constants check batch the
# same labeling each their own way), printed by
# ``tools/build_counts.py --scale 1.0 --package repro_torch --impl reference``
# on an H100 machine's host, where JAX is absent (15.2-17.0 s there).  At 0.5:
# ``--scale 0.5 --package both``, the two packages' reference and auto
# builds equal.  Phase 4 holds its auto build to it in place of a reference
# build of its own; 4b its device build, 4c its host engines.
DL_SHA256 = {1.0: "7168b6766ec19b8c4e564c3a445567e3465a8cec40edcf7bdebb4ec6377d01f6",
             0.5: "21dbb15a4e65983ef94b29b3501f29ee79c0e1f4dbbcd2132637998ab021007c",
             # phase 4b's device build: ``--scale 0.25 --impl reference auto
             # --package both`` (both packages, both impls equal), and 0.15,
             # 0.1 and 0.05 the same way
             0.25: "2fe11bfe8066e54ac280caf9c69faa2e73d14db01f525add04a7cad6bc611f09",
             0.15: "047490a39da4915250a1fbcbf4bb3275b7ac06b73e368bcef3464d2d4865090c",
             0.1: "3deb7d508256e17ce0d102744148def36a05424dcbb3d0bdd15653631fcc790d",
             0.05: "d95ad1a030d4ddeaa892b34f4ffd023386f043dca7cb5ed63859a41c2c4c7e9f",
             # phase 4i's mesh= build: ``--scale 0.02 --package both``
             0.02: "935b2f82fa6fd7575bf3d0efd999fa5b37bd5e5f64146369d9ab3a2b542d9174"}
# phase 4c's host engines at citeseer@0.5, held to DL_SHA256[0.5]
# (``tools/build_counts.py --scale 0.5 --package both``: both packages
# give these counts and equal labels): auto -> speculative with these
# boundaries and counts, the exact wave schedule with HALF_WAVE_BOUNDARIES
HOST_ENGINES_SCALE = 0.5
HALF_SPEC_BOUNDARIES = 1477
HALF_WAVE_BOUNDARIES = 23423
HALF_SPEC_COUNTS = {"spec_waves": 4500, "spec_members": 202752, "clean_waves": 350,
                    "violations": 16942, "replayed_members": 16942, "replayed_sides": 16942,
                    "exact_waves": 685, "annotated_pairs": 26022, "violation_rate": 0.0836,
                    "scalar_bailout": False}
# citeseer@1.0's Hierarchical-Labeling as the JAX package labels it
# (repro.core.hierarchy on a host): decompose's level sizes, the label
# matrices' shape, the label ints and the sha256 of L_out.tobytes() +
# L_in.tobytes().  ``tools/build_counts.py --method hierarchical --scale 1.0``
# prints them from both packages (``--package repro_torch`` where JAX is
# absent).
HL_LEVEL_SIZES = [693947, 72149, 3263, 21]
HL_SHAPE = (693947, 16)
HL_LABEL_INTS = 1991740
HL_SHA256 = "ec4fa5ca0a742737c74f01dae1ee23eea2d790831fb9125337fc9dfa39307790"
# phase 4c's killed speculative build at citeseer@0.5: a checkpoint every 512
# of its 5,185 boundaries (a save holds the whole label store), and the kill
# at the 3,001st optimistic chunk, past the middle of the build
CKPT_EVERY = 512
KILL_AT_CHUNK = 3000
# the device build (phase 4b) of the full script at 0.05 of the main graph,
# held to DL_SHA256 there: at 1.0 it took 77-153 s, at 0.5 62-76 s, at 0.25
# 34-48 s, at 0.15 30-35 s and at 0.1 22-25 s of a script that must end
# within 330 s beside phases 4j, 4k and 4l (0.1 until phase 4l gained (d)
# and (e), 0.05 since, for their time); ``--only-device-build`` keeps 1.0
# as its default
FULL_RUN_DEVICE_BUILD_SCALE = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()


def record(obj: dict) -> None:
    """One JSON line per phase, stamped with the seconds since the start."""
    print(json.dumps({**obj, "at_seconds": time.perf_counter() - _T0}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 1


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    record({"phase": "device", "name": name, "count": torch.cuda.device_count(),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda})
    return name, smi.splitlines()[0]


# ------------------------------------------------------------------ phase 2


def phase_build():
    from repro_torch.kernels import build

    from concurrent.futures import ThreadPoolExecutor

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SIGNATURES)) as pool:
        futures = {name: pool.submit(build.build, name) for name in build.SIGNATURES}
        info = {name: fut.result() for name, fut in futures.items()}
    seconds = time.perf_counter() - t0
    resources = {name: _ptxas_resources(rec["log"]) for name, rec in info.items()}
    for name, entries in resources.items():
        for entry, r in entries.items():
            log(f"[{name}] {entry}: {r['registers']} registers, {r['spill_stores']} bytes "
                f"spill stores, {r['spill_loads']} bytes spill loads")
    record({"phase": "build", "seconds": seconds,
            "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"],
                            "resources": resources[k]} for k, v in info.items()}})


def _ptxas_resources(build_log: str) -> dict:
    """Each entry function's registers and spill bytes from ``nvcc -Xptxas
    -v``'s log, by a short name: the kernel and its integer template
    arguments (``attention_bwd_sm90_kernel<64,64>``)."""
    out, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = _entry_name(m.group(1))
            out[entry] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[entry]["spill_stores"], out[entry]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def _entry_name(mangled: str) -> str:
    """A mangled kernel name's identifier ending in "kernel" (found by its
    length prefix) and integer template arguments; else the name as given."""
    for m in re.finditer(r"\d+", mangled):
        at = m.end()
        for i in range(m.start(), at):   # the run may begin with the digits before it
            n = int(mangled[i:at])
            name = mangled[at:at + n]
            if len(name) == n and re.fullmatch(r"[A-Za-z_]\w*kernel", name):
                args = []
                if mangled[at + n:at + n + 1] == "I":
                    args = re.findall(r"Li(\d+)E", mangled[at + n:].split("EE")[0] + "E")
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


# ------------------------------------------------------------------ phase 3


def _random_rows(rng, n, width, lo_valid, hi_valid, value_range, sorted_prefix):
    """int32[n, width] label rows: a valid prefix of random length, INVALID
    after it (the oracle's layout) or INVALID scattered anywhere."""
    mat = rng.integers(0, value_range, size=(n, width)).astype(np.int32)
    if sorted_prefix:
        mat.sort(axis=1)
        lens = rng.integers(lo_valid, hi_valid + 1, size=n)
        mat[np.arange(width)[None, :] >= lens[:, None]] = -1
    else:
        mat[rng.random((n, width)) < 0.3] = -1
    return mat


def phase_kernel_vs_plain(device) -> dict:
    """Every kernel against its plain version on the card, exact equality.
    Returns {kernel name: number of cases checked}."""
    import torch

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(11)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731

    def identity(B):   # queries (i, i): row i of L_out against row i of L_in
        return t(np.repeat(np.arange(B, dtype=np.int32)[:, None], 2, axis=1))

    cases = 0
    # the shapes of the JAX package's kernel sweep, rows taken as they lie
    for B, La, Lb in [(7, 8, 8), (64, 24, 16), (300, 64, 48), (1, 128, 128)]:
        a = _random_rows(rng, B, La, 0, La, 60, sorted_prefix=False)
        b = _random_rows(rng, B, Lb, 0, Lb, 60, sorted_prefix=False)
        got = ops.tier_intersect(t(a), t(b), identity(B), max(La, Lb))
        torch.cuda.synchronize()
        exp = ref.label_intersect_ref(t(a), t(b))
        check(torch.equal(got, exp), f"label_intersect B={B} La={La} Lb={Lb}")
        cases += 1
    # all-INVALID rows
    allpad = np.full((16, 8), -1, np.int32)
    got = ops.tier_intersect(t(allpad), t(allpad), identity(16), 8)
    torch.cuda.synchronize()
    check(not bool(got.any()), "all-INVALID rows must never intersect")
    cases += 1
    # the fused gather: resident matrices shaped like the main path's
    # (L_out 16 wide, L_in 8 wide) and a wide pair, every tier width,
    # B = 1 and B not a multiple of any block size, ids up to n - 1
    n = 5000
    for Lo, Li in [(16, 8), (128, 40)]:
        for sorted_prefix in (True, False):
            L_out = t(_random_rows(rng, n, Lo, 0, Lo, 400, sorted_prefix))
            L_in = t(_random_rows(rng, n, Li, 0, Li, 400, sorted_prefix))
            for B in (1, 4099):
                q = rng.integers(0, n, size=(B, 2)).astype(np.int32)
                q[-1] = (n - 1, n - 1)
                for width in (8, 16, 24, 128):
                    got = ops.tier_intersect(L_out, L_in, t(q), width)
                    torch.cuda.synchronize()
                    exp = ref.tier_intersect_ref(L_out, L_in, t(q), width)
                    check(torch.equal(got, exp),
                          f"tier_intersect Lo={Lo} Li={Li} B={B} width={width} "
                          f"sorted={sorted_prefix}")
                    check(B == 1 or bool(exp.any()) and not bool(exp.all()),
                          "the check needs hits and misses")
                    cases += 1
    cases += _tier_intersect_edges(device)
    k1b = _serve_batch_vs_plain(device)
    k2 = _frontier_or_vs_plain(rng, t)
    k2f = _frontier_expand_vs_plain(device)
    library = _library_vs_plain(rng, device)
    record({"phase": "kernel_vs_plain", "serve_batch_cases": k1b,
            "label_intersect_cases": cases, "frontier_or_cases": k2,
            "frontier_expand_cases": k2f,
            **{f"{k}_cases": v for k, v in library.items()}, "matches_plain": True})
    return {"serve_batch": k1b, "label_intersect": cases, "frontier_or": k2,
            "frontier_expand": k2f, **library}


def _tier_intersect_edges(device) -> int:
    """K1's tier form on the edges of ``tests/tier_slab_cases.py``: widths
    not a multiple of 4 (13 and 7, 17 and 5) beside the main path's 16 and 8,
    each on 16-byte aligned matrices and on a copy 4 bytes into its buffer
    (with queries 4 bytes into theirs);
    rows with INVALID before their valid values; a width above both
    matrices; B = 1, 31, 33 and 4,099; ids -1, n and 2**31 - 1, answered
    false.  Exact equality with the plain version, one launch a call.
    Returns the cases checked."""
    import tier_slab_cases as tc
    import torch

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(23)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    n, cases = tc.TIER_N, 0
    for Lo, Li in tc.TIER_SHAPES:
        for layout in tc.TIER_LAYOUTS:
            L_out, L_in = t(tc.tier_rows(rng, n, Lo, layout)), t(tc.tier_rows(rng, n, Li, layout))
            for lo, li, base in ((L_out, L_in, "aligned"),
                                 (tc.unaligned(L_out), tc.unaligned(L_in), "unaligned")):
                for B in tc.TIER_BATCHES:
                    q = t(tc.tier_queries(rng, n, B))
                    q = q if base == "aligned" else tc.unaligned(q)
                    for width in tc.TIER_WIDTHS:
                        what = f"tier_intersect Lo={Lo} Li={Li} {layout} {base} B={B} w={width}"
                        before = ops.LAUNCHES["label_intersect"]
                        got = ops.tier_intersect(lo, li, q, width)
                        torch.cuda.synchronize()
                        check(ops.LAUNCHES["label_intersect"] == before + 1, f"{what}: launches")
                        check(torch.equal(got, ref.tier_intersect_ref(lo, li, q, width)), what)
                        cases += 1
            q, bad = tc.bad_id_queries(rng, n, 4099)
            got = ops.tier_intersect(L_out, L_in, t(q), 16)
            torch.cuda.synchronize()
            ok = t(~bad)
            exp = ref.tier_intersect_ref(L_out, L_in, t(q[~bad]), 16)
            check(not bool(got[t(bad)].any()) and torch.equal(got[ok], exp),
                  f"tier_intersect Lo={Lo} Li={Li} {layout}: ids outside [0, n)")
            cases += 1
    return cases


def _serve_batch_vs_plain(device) -> int:
    """K1's batch form on the edge cases of ``tests/serve_batch_cases.py``:
    B = 0, 1 and 4,097, every query prefiltered and none, no level, one and
    three tiers, ids 0 and n - 1, rows full to their width, an INVALID inside
    a row, ids in [-n, 0), rows wider than a lane group's 16 entries, widths
    not a multiple of 4 (the one-entry-a-lane loop), a truncating last tier,
    ids n and -n - 1, which must raise, and under a budget's truncation
    masks a random cut, rows cut to length 0, u == v and level[u] >=
    level[v] with both rows cut, one side cut only, no level and a partial
    last mask byte.  Codes byte for byte against the plain version and the
    numpy loop; one launch a non-empty call."""
    import serve_batch_cases as sc
    import torch

    from repro_torch.kernels import ops, ref

    for i, name in enumerate(sc.CASES):
        case = sc.make_case(np.random.default_rng(i), name)
        args = [None if case[k] is None else torch.from_numpy(case[k]).to(device)
                for k in sc.BINDING] + [case["widths"]]
        masks = {k: None if case[k] is None else torch.from_numpy(case[k]).to(device)
                 for k in sc.MASKS}
        sb = ops.ServeBatch(*args, **masks)
        q = case["queries"]
        before = ops.LAUNCHES["serve_batch"]
        if name.startswith("bad_"):
            try:
                sb(q)
            except IndexError:
                pass
            else:
                check(False, f"serve_batch {name}: an id outside [-n, n) did not raise")
            continue
        got = sb(q)
        check(ops.LAUNCHES["serve_batch"] - before == int(q.shape[0] > 0),
              f"serve_batch {name}: {ops.LAUNCHES['serve_batch'] - before} launches")
        exp = ref.serve_batch_ref(*args, torch.from_numpy(q).to(device),
                                  **masks).cpu().numpy()
        check(got.dtype == np.uint8 and np.array_equal(got, exp),
              f"serve_batch {name}: {int((got != exp).sum())} codes differ from the plain "
              "version")
        check(np.array_equal(got, sc.numpy_codes(case)), f"serve_batch {name}: the numpy loop")
    return len(sc.CASES)


def _check_frontier_expand(case: dict, device, what: str) -> dict:
    """frontier_expand against its plain version on one level's inputs (a
    dict of numpy arrays and ints, ``frontier_cases.ORDER``), on the card:
    every word, stamp and count exactly, the ring's and the cone's new
    entries as sets.  The kernel must launch once unless the level is
    empty.  Returns the kernel's outputs as numpy."""
    import frontier_cases as fc
    import torch

    from repro_torch.kernels import ops, ref

    res = []
    for fn in (ops.frontier_expand, ref.frontier_expand_ref):
        args = {k: (torch.from_numpy(case[k].copy()).to(device) if k in fc.ARRAYS
                    else case[k]) for k in fc.ORDER}
        before = ops.LAUNCHES["frontier_expand"]
        fn(*(args[k] for k in fc.ORDER))
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["frontier_expand"] - before
        check(launched == int(fn is ops.frontier_expand and case["hi"] > case["lo"]),
              f"frontier_expand {what}: {launched} launches")
        res.append({k: (args[k].cpu().numpy() if k in fc.ARRAYS else args[k])
                    for k in fc.ORDER})
    try:
        fc.assert_same_level(case, res[0], res[1], what)
    except AssertionError as e:
        raise AssertionError(f"frontier_expand differs from its plain version: {e}") from None
    return res[0]


def _frontier_expand_vs_plain(device) -> int:
    """K2's frontier form on the edge cases of ``tests/frontier_cases.py``:
    an empty frontier, every row, contention on one target, wm of 1, 2 and
    8, rows of degree 0, a hub of 1,500 neighbors, a bad neighbor id and a
    bad frontier id (both must set the flag), fully pruned rows."""
    import frontier_cases as fc

    for i, name in enumerate(fc.CASES):
        case = fc.make_case(np.random.default_rng(i), name)
        out = _check_frontier_expand(case, device, name)
        check(int(out["counts"][2]) == int(name.startswith("bad_")),
              f"frontier_expand {name}: bad-id flag {int(out['counts'][2])}")
    return len(fc.CASES)


def _check_frontier_or(nbr, f, rng, what: str) -> int:
    """K2 against its plain version on one slab and frontier, in both forms
    (a new output; OR into permuted rows of a running output with flags).
    Exact equality: the words are bit patterns.  Returns the cases checked."""
    import torch

    from repro_torch.kernels import ops, ref

    got = ops.frontier_or(nbr, f)
    exp = ref.frontier_or_ref(nbr, f)
    torch.cuda.synchronize()
    check(torch.equal(got, exp), f"frontier_or {what}")
    r, wm = nbr.shape[0], f.shape[1]
    n_out = r + 3
    perm = torch.from_numpy(rng.permutation(n_out)[:r].astype(np.int64)).to(f.device)
    out0 = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n_out, wm),
                                         dtype=np.int64).astype(np.int32)).to(f.device)
    res = []
    for fn in (ops.frontier_or, ref.frontier_or_ref):
        out, flags = out0.clone(), torch.zeros(2, dtype=torch.int32, device=f.device)
        fn(nbr, f, out=out, perm=perm, flags=flags)
        res.append((out, flags))
    torch.cuda.synchronize()
    check(torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1]),
          f"frontier_or fused form {what}")
    # a second pass over the kernel's result adds no bit: flags[0] stays 0
    flags = torch.zeros(2, dtype=torch.int32, device=f.device)
    ops.frontier_or(nbr, f, out=res[0][0], perm=perm, flags=flags)
    torch.cuda.synchronize()
    check(torch.equal(res[0][0], res[1][0]) and flags.tolist() == [0, 0],
          f"frontier_or fused form {what}: a second pass")
    return 3


def _frontier_or_vs_plain(rng, t) -> int:
    """K2 at the JAX package's sweep shapes and at the edges: all-INVALID
    rows, r = 1 with wm = 8, ids at n_src - 1, bit 31 set in every word;
    then ``tests/tier_slab_cases.py``'s: every wm of 1, 3, 8, 9, 32 with
    every d of 1, 7, 16, 20, 32, 33 in both forms (the fused form with flags, and a
    second pass that adds no bit), f and out or the slab 4 bytes into their
    buffers, ids n_src and -2 and a perm entry n_out (skipped, flags[1])."""
    import tier_slab_cases as tc
    import torch

    from repro_torch.kernels import ops, ref

    cases = 0
    shapes = [(13, 4, 50, 1), (128, 16, 200, 2), (1, 7, 9, 3), (1, 16, 40, 8),
              (70001, 16, 90001, 8)]
    for r, d, n_src, wm in shapes:
        for edge in (None, "all_invalid", "last_id", "bit31"):
            nbr = rng.integers(0, n_src, size=(r, d)).astype(np.int32)
            nbr[rng.random((r, d)) < 0.35] = -1
            f = rng.integers(0, 2**32, size=(n_src, wm), dtype=np.uint32)
            if edge == "all_invalid":
                nbr[: max(r // 2, 1)] = -1
            elif edge == "last_id":
                nbr[:, 0] = n_src - 1
            elif edge == "bit31":
                f |= np.uint32(1 << 31)
            cases += _check_frontier_or(t(nbr), t(f.view(np.int32)), rng,
                                        f"r={r} d={d} n_src={n_src} wm={wm} edge={edge}")
    r, n_src = tc.SLAB_R, tc.SLAB_N_SRC
    for wm in tc.SLAB_WM:
        for d in tc.SLAB_D:
            nbr, f = tc.slab_case(rng, r, d, n_src, wm)
            cases += _check_frontier_or(t(nbr), t(f.view(np.int32)), rng, f"wm={wm} d={d}")
    nbr, f = tc.slab_case(rng, r, 16, n_src, 8)
    nbr, f = t(nbr), t(f.view(np.int32))
    cases += _check_frontier_or(tc.unaligned(nbr), tc.unaligned(f), rng, "unaligned slab and f")
    for wm, d in ((8, 16), (3, 7)):
        nbr, f, perm, out0 = tc.bad_slab(rng, r, d, n_src, wm)
        nbr, f, perm, out0 = t(nbr), t(f.view(np.int32)), t(perm), t(out0.view(np.int32))
        for fn in (ops.frontier_or, ref.frontier_or_ref):
            try:
                fn(nbr, f)
            except ValueError:
                pass
            else:
                check(False, f"frontier_or {fn.__name__}: an id outside [-1, n_src) did "
                             "not raise")
        res = []
        for fn in (ops.frontier_or, ref.frontier_or_ref):
            out, flags = out0.clone(), torch.zeros(2, dtype=torch.int32, device=f.device)
            fn(nbr, f, out=out, perm=perm, flags=flags)
            res.append((out, flags))
        torch.cuda.synchronize()
        check(torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1])
              and res[0][1].tolist()[1] == 1, f"frontier_or bad ids wm={wm} d={d}")
        cases += 1
    return cases


# the JAX package's kernel sweeps (tests/test_kernels.py), then edge cases,
# then the shapes of benchmarks/kernel_bench.py (K3's, K5's, K6's and K4's
# float32 tiled-kernel edges in tests/library_cases.py)
ATTENTION_CASES = [(1, 2, 2, 128, 128, 32, True, None), (2, 4, 2, 256, 256, 64, True, None),
                   (1, 4, 1, 128, 128, 64, True, 48), (2, 2, 2, 1, 256, 32, True, None),
                   (1, 2, 2, 128, 256, 32, True, None), (1, 2, 2, 128, 128, 32, False, None),
                   (1, 2, 1, 192, 64, 32, True, None),      # S > T: zero rows
                   (1, 4, 2, 130, 97, 80, True, 40),        # D = 80, window < S
                   (1, 2, 2, 64, 100, 128, False, 24),      # window without causal
                   (1, 8, 2, 1024, 1024, 64, True, None),
                   # the bfloat16 kernel's tile edges (64 packed query rows, 64 keys)
                   (1, 4, 4, 100, 100, 64, True, None),     # rep 1, ragged S and T
                   (1, 2, 2, 256, 256, 64, True, 63),       # window one key inside a tile
                   (1, 2, 2, 256, 256, 64, True, 64),       # window on a tile boundary
                   (1, 2, 2, 256, 256, 64, True, 65),       # window one key past it
                   (1, 2, 2, 128, 192, 32, False, 64),      # window without causal, T > S
                   (1, 8, 1, 77, 200, 64, True, None),      # rep 8
                   (2, 8, 2, 33, 129, 8, True, None),       # D = 8, T one past a tile
                   (1, 4, 2, 70, 130, 24, False, 33),       # D = 24
                   (1, 4, 2, 70, 127, 80, True, 65),        # D = 80, T one short of a tile
                   (1, 4, 1, 50, 190, 128, True, None),     # D = 128
                   (2, 32, 8, 1, 777, 64, True, None),      # decode, ragged last key tile
                   (2, 32, 8, 1, 4097, 128, True, 1000),    # decode, window, D = 128
                   (1, 4, 2, 150, 70, 24, True, None),      # S > T
                   (1, 4, 2, 40, 20, 8, True, None),        # T under one key tile
                   (1, 4, 2, 70, 100, 40, True, None),      # D = 40
                   (1, 2, 1, 64, 90, 72, False, None),      # D = 72
                   (1, 4, 2, 64, 64, 96, True, None),       # D = 96
                   (1, 2, 2, 65, 65, 112, True, 30)]        # D = 112


SPLIT_CASES_SEED = 36   # the inputs of phase 3's SPLIT_CASES


def _library_vs_plain(rng, device) -> dict:
    """K3-K6 against their plain versions on the card: exact for K3 (bit
    patterns); K4 against the float32 plain version on the same values
    (``_attention_excess``: 2e-5 in float32, one bfloat16 step in
    bfloat16), each case through the kernel of its dtype
    (``ops.attention_kernel``: bfloat16 on the tensor cores, float32 on the
    CUDA cores); 1e-5 for K5 and K6.  Bad ids must raise.  Returns {kernel:
    cases}."""
    import library_cases as lc
    import torch

    from repro_torch.kernels import ops, ref

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    cases = dict.fromkeys(("bitset_mm", "flash_attention", "flash_attention_sm90", "ell_spmm",
                           "embedding_bag"), 0)
    for n, k, m, edge in lc.BITSET_CASES:
        a, x = (t(v) for v in lc.make_bitset_case(rng, n, k, m, edge))
        got = ops.bitset_mm(a, x)
        torch.cuda.synchronize()
        check(torch.equal(got, ref.bitset_mm_ref(a, x)), f"bitset_mm n={n} k={k} m={m} {edge}")
        cases["bitset_mm"] += 1
    for B, Hq, Hkv, S, T, D, causal, window in ATTENTION_CASES:
        q = t(rng.standard_normal((B, Hq, S, D)).astype(np.float32))
        k = t(rng.standard_normal((B, Hkv, T, D)).astype(np.float32))
        v = t(rng.standard_normal((B, Hkv, T, D)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            name = ops.attention_kernel(dtype)
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention(qd, kd, vd, causal=causal, window=window)
            exp = ref.flash_attention_ref(qd.float(), kd.float(), vd.float(), causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            what = f"flash_attention {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} T={T} D={D} " \
                   f"causal={causal} window={window}"
            check({n: ops.LAUNCHES[n] - before[n] for n in before} ==
                  {n: int(n == name) for n in before}, f"{what}: not one launch of {name}")
            check(_attention_excess(got, exp) <= 1, what)
            check(not (causal and S > T) or not got[:, :, : S - T].any(), f"{what}: zero rows")
            cases[name] += 1
    # over a preallocated cache (the decode path's call), NaN past kv_len
    for B, Hq, Hkv, S, T, kv_len, D, window in lc.KV_LEN_CASES:
        q, k, v = (t(x) for x in lc.make_kv_len_case(rng, B, Hq, Hkv, S, T, kv_len, D))
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            name = ops.attention_kernel(dtype)
            before = ops.LAUNCHES[name]
            got = ops.flash_attention(qd, kd, vd, causal=True, window=window, kv_len=kv_len)
            exp = ref.flash_attention_ref(qd.float(), kd.float(), vd.float(), causal=True,
                                          window=window, kv_len=kv_len)
            torch.cuda.synchronize()
            what = f"flash_attention {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} T={T} " \
                   f"kv_len={kv_len} D={D} window={window}"
            check(ops.LAUNCHES[name] == before + 1, f"{what}: not one launch of {name}")
            check(bool(torch.isfinite(got).all()), f"{what}: a key past kv_len was read")
            check(_attention_excess(got, exp) <= 1, what)
            cases[name] += 1
    # a value width of its own (MLA's prefill: D = 192, Dv = 128), also over a cache
    for B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window in lc.ATTENTION_DV_CASES:
        q, k, v = (t(x) for x in lc.make_kv_len_case(rng, B, Hq, Hkv, S, T, kv_len or T, D,
                                                     Dv))
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            name = ops.attention_kernel(dtype)
            before = ops.LAUNCHES[name]
            got = ops.flash_attention(qd, kd, vd, causal=causal, window=window, kv_len=kv_len)
            exp = ref.flash_attention_ref(qd.float(), kd.float(), vd.float(), causal=causal,
                                          window=window, kv_len=kv_len)
            torch.cuda.synchronize()
            what = f"flash_attention {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} T={T} " \
                   f"kv_len={kv_len} D={D} Dv={Dv} causal={causal} window={window}"
            check(ops.LAUNCHES[name] == before + 1, f"{what}: not one launch of {name}")
            check(got.shape == (B, Hq, S, Dv) and bool(torch.isfinite(got).all()),
                  f"{what}: shape {tuple(got.shape)} or a key past kv_len was read")
            check(_attention_excess(got, exp) <= 1, what)
            cases[name] += 1
    # float32 rows of a head cut into pieces over blocks and merged, with the
    # lse; inputs made on the card (a 1 GB case) from a generator of their
    # own, so that the cases after them keep theirs; NaN past kv_len
    gen = torch.Generator(device=device)
    gen.manual_seed(SPLIT_CASES_SEED)
    for B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window in lc.SPLIT_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   for shape in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv)))
        k[:, :, kv_len:], v[:, :, kv_len:] = math.nan, math.nan
        before = ops.LAUNCHES["flash_attention"]
        got, lse = ops.flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len,
                                       return_lse=True)
        exp, exp_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                               kv_len=kv_len, return_lse=True)
        torch.cuda.synchronize()
        what = f"flash_attention float32 {lc.case_id((B, Hq, Hkv, S, T, kv_len, D, Dv))} " \
               f"causal={causal} window={window}"
        seen = torch.isfinite(exp_lse)
        check(ops.LAUNCHES["flash_attention"] == before + 1, f"{what}: not one launch")
        check(bool(torch.isfinite(got).all()) and _attention_excess(got, exp) <= 1, what)
        check(torch.equal(torch.isfinite(lse), seen) and not bool(
            (lse[seen] - exp_lse[seen]).abs().gt(lc.ATTENTION_LSE_TOL).any()), f"{what}: lse")
        cases["flash_attention"] += 1
    for B, Hq, Hkv, S, T, D, causal, window in lc.ATTENTION_F32_CASES:
        q = t(rng.standard_normal((B, Hq, S, D)).astype(np.float32))
        k = t(rng.standard_normal((B, Hkv, T, D)).astype(np.float32))
        v = t(rng.standard_normal((B, Hkv, T, D)).astype(np.float32))
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        what = f"flash_attention float32 B={B} Hq={Hq} Hkv={Hkv} S={S} T={T} D={D} " \
               f"causal={causal} window={window}"
        check(_attention_excess(got, exp) <= 1, what)
        check(not (causal and S > T) or not got[:, :, : S - T].any(), f"{what}: zero rows")
        check(window != 0 or not got.any(), f"{what}: window 0 must give zeros")
        cases["flash_attention"] += 1
    for n, d, ns, F, edge in lc.SPMM_CASES:
        nbr, wgt, x = (t(v) for v in lc.make_spmm_case(rng, n, d, ns, F, edge))
        if edge == "unaligned":   # rows off 16-byte lines: the 4-byte loads
            x = torch.empty(ns * F + 1, device=device)[1:].view(ns, F).copy_(x)
        got = ops.ell_spmm(nbr, wgt, x)
        torch.cuda.synchronize()
        check(torch.allclose(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=1e-5, atol=1e-5),
              f"ell_spmm n={n} d={d} n_src={ns} F={F} {edge}")
        check(not got[lc.padding_rows(n, edge)].any(), f"ell_spmm padding rows {edge}")
        cases["ell_spmm"] += 1
    for bad, d, slot in ((-2, 2, 1), (6, 2, 1), (6, 40, 37)):
        nbr = np.zeros((3, d), np.int32)
        nbr[1, slot] = bad
        try:
            ops.ell_spmm(t(nbr), t(np.ones((3, d), np.float32)), t(np.ones((6, 4), np.float32)))
        except ValueError:
            cases["ell_spmm"] += 1
        else:
            check(False, f"ell_spmm accepted the id {bad} in slot {slot}")
    for V, D, B, bag, edge in lc.BAG_CASES:
        table, idx = (t(v) for v in lc.make_bag_case(rng, V, D, B, bag, edge))
        if edge == "unaligned":   # rows off 8-byte lines: the 4-byte loads
            table = torch.empty(V * D + 1, device=device)[1:].view(V, D).copy_(table)
        got = ops.embedding_bag(table, idx)
        torch.cuda.synchronize()
        check(torch.allclose(got, ref.embedding_bag_ref(table, idx), rtol=1e-5, atol=1e-5),
              f"embedding_bag V={V} D={D} B={B} bag={bag} {edge}")
        check(not got[lc.padding_rows(B, edge)].any(), f"embedding_bag padding bags {edge}")
        cases["embedding_bag"] += 1
    # the id V in slot 1 of a 2-slot bag, slot 37 of a 40-slot bag beside good
    # bags (a later slot group) and slot 8 of a 9-slot bag at D = 64
    for D, bag, slot in ((10, 2, 1), (11, 40, 37), (64, 9, 8)):
        idx = np.zeros((3, bag), np.int32)
        idx[1, slot] = 6
        try:
            ops.embedding_bag(t(np.ones((6, D), np.float32)), t(idx))
        except ValueError:
            cases["embedding_bag"] += 1
        else:
            check(False, f"embedding_bag accepted the id V in slot {slot}")
    cases.update(_backwards_vs_plain(rng, device))
    return cases


def _backwards_vs_plain(rng, device) -> dict:
    """The backwards of K4, K5 and K6 against their plain backwards on the
    card, on ``tests/library_cases.py``'s backward cases: K4's
    ``flash_attention_bwd`` in float32 and bfloat16 (causal, windows, GQA,
    MLA's (192, 128), rows that see no key: no gradient there; the bfloat16
    kernel also counted as ``flash_attention_bwd_sm90``, with the lse it
    reads made by K4's bfloat16 forward, held against the plain lse within
    ``ATTENTION_LSE_TOL``; the float32 kernel given its forward's lse, with
    no forward launch) within ``ATTENTION_BWD_TOL``, the plain backward
    recomputing its softmax, and the controls it must reject (the dk of the
    last key tile zeroed; in float32 a dq without the last key tile's
    parts); K6's ``embedding_bag_bwd`` (repeated ids, padding, xDeepFM's two
    layouts) and K5 and K5 over the transposed rows (empty rows, rows past a
    warp's slots both ways, the narrow-row kernel's widths and F = 65)
    within 1e-5, each through its autograd Function too, one launch counted
    under its own name.  Returns {kernel: cases}."""
    import library_cases as lc
    import torch

    from repro_torch.kernels import ops, ref

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    tol = lc.SPMM_BAG_BWD_TOL
    cases = dict.fromkeys(("flash_attention_bwd", "embedding_bag_bwd", "ell_spmm_bwd"), 0)
    for case in lc.ATTENTION_BWD_CASES:
        B, Hq, Hkv, S, T, D, Dv, causal, window = case
        arrays = lc.make_attention_bwd_case(rng, *case)
        blind = t(~lc.attention_rows_seeing_a_key(S, T, causal, window))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (t(a).to(dtype) for a in arrays)
            f32 = dtype == torch.float32
            # float32: the forward's lse, as training hands it over (no forward launch)
            o, f_lse = (ops.flash_attention(q, k, v, causal=causal, window=window,
                                            return_lse=True) if f32 else
                        (ops.flash_attention(q, k, v, causal=causal, window=window), None))
            torch.cuda.synchronize()
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window,
                                          lse=f_lse)
            torch.cuda.synchronize()
            what = f"flash_attention_bwd {dtype} {lc.case_id(case)}"
            own = ops.attention_bwd_kernel(dtype)
            check(ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
                  and ops.LAUNCHES[own] == before[own] + 1, f"{what}: not one launch")
            check(not f32 or ops.LAUNCHES["flash_attention"] == before["flash_attention"],
                  f"{what}: a forward launch beside the backward given the forward's lse")
            if dtype == torch.bfloat16:
                _, lse = ops._flash_attention(q, k, v, causal, window, 1 / math.sqrt(D), T,
                                              return_lse=True)
                _, exp_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                                     return_lse=True)
                seen = torch.isfinite(exp_lse)
                check(torch.equal(torch.isfinite(lse), seen) and not bool(
                    (lse[seen] - exp_lse[seen]).abs().gt(lc.ATTENTION_LSE_TOL).any()),
                      f"{what}: the forward's lse differs from the plain lse")
            exp = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
            excess = [_bwd_excess(g, e) for g, e in zip(got, exp)]
            check(max(excess) <= 1, f"{what}: dq, dk, dv at {excess} x the tolerance")
            check(not got[0][:, :, blind].any(), f"{what}: a row that sees no key has a dq")
            if T >= 128 and bool(exp[1][:, :, -64:].abs().max() > 0):
                cut = got[1].clone()
                cut[:, :, -64:] = 0
                check(_bwd_excess(cut, exp[1]) > 1,
                      f"{what}: the check passes a dk without its last key tile")
            if f32:   # dq without the last key tile's parts (its keys keep their positions)
                last = ref.flash_attention_bwd_ref(
                    q, k[:, :, -64:].contiguous(), v[:, :, -64:].contiguous(), o, do,
                    causal=causal, window=window, lse=f_lse)[0]
                check(not bool(last.abs().max() > 0) or _bwd_excess(got[0] - last, exp[0]) > 1,
                      f"{what}: the check passes a dq without its last key tile's parts")
            cases["flash_attention_bwd"] += 1
    for case in lc.BAG_BWD_CASES:
        V = case[0]
        idx, dout = (t(a) for a in lc.make_bag_bwd_case(rng, *case))
        before = ops.LAUNCHES["embedding_bag_bwd"]
        got = ops.embedding_bag_bwd(idx, dout, V)
        torch.cuda.synchronize()
        exp = ref.embedding_bag_bwd_ref(idx, dout, V)
        check(ops.LAUNCHES["embedding_bag_bwd"] == before + 1 and
              torch.allclose(got, exp, rtol=tol, atol=tol),
              f"embedding_bag_bwd {lc.case_id(case)}: {float((got - exp).abs().max())}")
        table = torch.zeros((V, case[1]), device=device, requires_grad=True)
        (ops.embedding_bag(table, idx) * dout).sum().backward()
        check(torch.allclose(table.grad, exp, rtol=tol, atol=tol),
              f"embedding_bag's autograd Function {lc.case_id(case)}")
        cases["embedding_bag_bwd"] += 1
    for case in lc.SPMM_BWD_CASES:
        nbr, wgt, nbr_t, wgt_t, x, dout = (t(a) for a in lc.make_spmm_bwd_case(rng, *case))
        x.requires_grad_(True)
        before = dict(ops.LAUNCHES)
        out = ops.ell_spmm(nbr, wgt, x, nbr_t, wgt_t)
        (out * dout).sum().backward()
        torch.cuda.synchronize()
        fwd = ref.ell_spmm_ref(nbr, wgt, x.detach())
        check(torch.allclose(out.detach(), fwd, rtol=tol, atol=tol),
              f"ell_spmm {lc.case_id(case)}: {float((out.detach() - fwd).abs().max())}")
        exp = ref.ell_spmm_ref(nbr_t, wgt_t, dout)
        check(ops.LAUNCHES["ell_spmm_bwd"] == before["ell_spmm_bwd"] + 1
              and ops.LAUNCHES["ell_spmm"] == before["ell_spmm"] + 1,
              f"ell_spmm_bwd {lc.case_id(case)}: not one launch each way")
        check(torch.allclose(x.grad, exp, rtol=tol, atol=tol),
              f"ell_spmm_bwd {lc.case_id(case)}: {float((x.grad - exp).abs().max())}")
        cases["ell_spmm_bwd"] += 1
    return cases


def _bwd_excess(got, exp) -> float:
    """A gradient of K4's backward against the plain one: max |got - exp| /
    (atol max|exp| + rtol |exp|) by ``ATTENTION_BWD_TOL`` of got's dtype (the
    plain one rounded to it); the check passes at 1 or less."""
    import library_cases as lc

    rtol, atol = lc.ATTENTION_BWD_TOL[str(got.dtype).removeprefix("torch.")]
    exp = exp.to(got.dtype).float()
    scale = max(float(exp.abs().max()), 1e-30)
    return float(((got.float() - exp).abs() / (atol * scale + rtol * exp.abs())).max())


# ------------------------------------------------------------------ phase 3b

# K4 at the widths of two LM configurations of the repo (batch cut to 1 for
# prefill) and of the decode_32k cell (src/repro/configs/lm_cells.py), in
# bfloat16 (the tensor-core kernel); granite prefill once more in float32
# (the CUDA-core kernel)
ATTENTION_CONFIGS = [
    ("granite-3-2b prefill (configs/granite_3_2b.py, train_4k length)",
     dict(B=1, Hq=32, Hkv=8, S=4096, T=4096, D=64, causal=True, window=None,
          dtype="bfloat16")),
    ("h2o-danube-1.8b SWA prefill (configs/h2o_danube_1_8b.py, window 4096)",
     dict(B=1, Hq=32, Hkv=8, S=8192, T=8192, D=80, causal=True, window=4096,
          dtype="bfloat16")),
    ("granite-3-2b decode_32k (configs/lm_cells.py)",
     dict(B=128, Hq=32, Hkv=8, S=1, T=32768, D=64, causal=True, window=None,
          dtype="bfloat16")),
    ("granite-3-2b prefill in float32 (configs/granite_3_2b.py, train_4k length)",
     dict(B=1, Hq=32, Hkv=8, S=4096, T=4096, D=64, causal=True, window=None,
          dtype="float32")),
]
# K4's backward at the widths of two more LM configurations than training's
# granite (batch cut to 1): deepseek-7b's heads of 128 and deepseek-v2-lite's
# MLA (q and k 192 wide, v 128), bfloat16, causal
ATTENTION_BWD_CONFIGS = [
    ("deepseek-7b backward (configs/deepseek_7b.py: 32 heads of 128), 1 x 4,096",
     dict(B=1, Hq=32, Hkv=32, S=4096, T=4096, D=128, Dv=128)),
    ("deepseek-v2-lite MLA backward (configs/deepseek_v2_lite_16b.py: 16 heads, D 192, "
     "Dv 128), 1 x 4,096", dict(B=1, Hq=16, Hkv=16, S=4096, T=4096, D=192, Dv=128)),
]
# the kernels each K4 kernel name counts: float32 has a tiled kernel for
# heads of 64 packed rows or more and, for fewer (decode), the short-row
# kernel over pieces of the keys and, where it cut them into more than one,
# the merge of the pieces; a call's device time is the sum of its launches
ATTENTION_SYMBOLS = {"flash_attention_sm90": ("flash_attention_sm90_kernel",),
                     "flash_attention": ("flash_attention_tiled_kernel",
                                         "flash_attention_split_kernel",
                                         "flash_attention_merge_kernel")}
# K4's two backward kernels, each a record of the kernels line (by its source
# file's name) and the dtype it runs: ops counts every backward call as
# flash_attention_bwd and the bfloat16 ones also as flash_attention_bwd_sm90,
# so the float32 kernel's launches are the difference (_own_launches)
BWD_RECORD_KERNELS = (("flash_attention_bwd_sm90", "bfloat16"),
                      ("flash_attention_bwd", "float32"))


def _own_launches(counts: dict) -> dict:
    """Launch counts by the kernels line's records: ``flash_attention_bwd``
    the float32 backward's alone (every backward call less the bfloat16
    ones)."""
    out = dict(counts)
    if "flash_attention_bwd" in out:
        out["flash_attention_bwd"] -= out.get("flash_attention_bwd_sm90", 0)
    return out


# K5's kernels, of which a call launches one: narrow rows (F <= 64) and wide
SPMM_SYMBOLS = ("ell_spmm_narrow_kernel", "ell_spmm_kernel")
# K5 at ogb_products (src/repro/configs/gnn_cells.py): n, m, d_feat; ELL width 32
PRODUCTS = dict(n=2_449_029, m=61_859_140, F=100, d=32)
# K6 at xDeepFM's table (src/repro/configs/xdeepfm_cfg.py: 39 fields x
# 1,000,000 rows, embed_dim 10) and its serve_bulk batch, bags of 8
XDEEPFM = dict(V=39 * 1_000_000, D=10, B=262_144, bag=8, padding=0.25)
PLAIN_CHUNK_BYTES = 1 << 30   # the plain versions' largest intermediate, per chunk
# K4 against its float32 plain version, by output type (rtol, atol): float32
# at the JAX package's 2e-5; bfloat16 against the plain result rounded to
# bfloat16, from which a sound kernel differs by at most one step (2^-7 of the
# value), with an atol far below a decode output (~0.009 at T = 32,768)
ATTENTION_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}


def products_inputs(gen, device) -> tuple:
    """K5's inputs at ogb_products, made on the card from ``gen``: (nbr,
    wgt, x, lens), each row's 18-32 valid slots first (as an ELL row lies)
    with ids drawn uniformly, ``PRODUCTS["m"]`` valid slots in all."""
    import torch

    P = PRODUCTS
    lens = torch.randint(18, 33, (P["n"],), generator=gen, device=device)
    deficit = P["m"] - int(lens.sum())
    room = (lens < P["d"]).nonzero().flatten()
    check(0 <= deficit <= room.numel(), f"cannot reach {P['m']} valid slots")
    lens[room[torch.randperm(room.numel(), generator=gen, device=device)[:deficit]]] += 1
    slot = torch.arange(P["d"], device=device)[None, :]
    nbr = torch.randint(0, P["n"], (P["n"], P["d"]), generator=gen, device=device,
                        dtype=torch.int32)
    nbr[slot >= lens[:, None]] = -1
    wgt = torch.randn((P["n"], P["d"]), generator=gen, device=device)
    x = torch.randn((P["n"], P["F"]), generator=gen, device=device)
    return nbr, wgt, x, lens


def xdeepfm_inputs(gen, device, width=None) -> tuple:
    """K6's inputs at xDeepFM's serve_bulk batch, made on the card from
    ``gen``: (table, idx), a quarter of the slots padding with negative ids
    drawn from the whole negative range; ``width`` replaces the table's row
    width D (the ids stay the same)."""
    import torch

    X = XDEEPFM
    table = torch.randn((X["V"], width or X["D"]), generator=gen, device=device)
    idx = torch.randint(0, X["V"], (X["B"], X["bag"]), generator=gen, device=device,
                        dtype=torch.int32)
    pad = torch.rand((X["B"], X["bag"]), generator=gen, device=device) < X["padding"]
    idx[pad] = -1 - torch.randint(0, 2**31 - 1, (int(pad.sum()),), generator=gen,
                                  device=device, dtype=torch.int32)
    return table, idx


def _timed_once(fn) -> tuple:
    """(ms by CUDA events, result) of one call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _kernel_device_ms(fn, symbols, calls: int, attempts: int = 3) -> float:
    """torch.profiler's device time of one call of ``fn``, over ``calls``
    calls: for each of the kernels ``symbols`` (a name, or a tuple of names
    of which a call launches some, as K4 in float32 picks its kernels by the
    rows a head has and by the pieces it cuts the keys into), matched as
    whole identifiers, the mean over the trace's launches of it, summed over
    the kernels the trace holds.  The means are taken over the launches the
    trace holds: a trace has been seen to hold one of two, and once none of
    50, so a trace that holds none is taken again, up to ``attempts``
    times."""
    symbols = (symbols,) if isinstance(symbols, str) else tuple(symbols)
    patterns = [re.compile(rf"(?<!\w){re.escape(s)}[<(]") for s in symbols]
    for _ in range(attempts):
        _, events = _device_events(lambda: [fn() for _ in range(calls)])
        times = [[us for cat, name, us in events if cat == "kernel" and pat.search(name)]
                 for pat in patterns]
        if any(times):
            break
    check(any(times) and all(len(t) <= calls for t in times),
          f"torch.profiler recorded {[len(t) for t in times]} launches of {symbols} in "
          f"{calls} calls, {attempts} times")
    return sum(sum(t) / len(t) for t in times if t) / 1e3


def _each_kernel_device_ms(fn, symbols: tuple, calls: int, attempts: int = 3) -> dict:
    """``_kernel_device_ms`` of each of the kernels ``symbols`` that every
    call of ``fn`` launches (K4's backward launches three), from one trace:
    {symbol: its mean device ms}.  A trace that misses one is taken again,
    up to ``attempts`` times."""
    patterns = {s: re.compile(rf"(?<!\w){re.escape(s)}[<(]") for s in symbols}
    for _ in range(attempts):
        _, events = _device_events(lambda: [fn() for _ in range(calls)])
        times = {s: [us for cat, name, us in events if cat == "kernel" and pat.search(name)]
                 for s, pat in patterns.items()}
        if all(times.values()):
            break
    check(all(1 <= len(t) <= calls for t in times.values()),
          f"torch.profiler recorded {({s: len(t) for s, t in times.items()})} launches of "
          f"{symbols} in {calls} calls, {attempts} times")
    return {s: sum(t) / len(t) / 1e3 for s, t in times.items()}


def _library_kernels(fn, calls: int = 10) -> list:
    """The kernels a call of a library function runs, by device time over
    ``calls`` calls (a trace of one call has been seen to hold none)."""
    _, events = _device_events(lambda: [fn() for _ in range(calls)])
    by_name = {}
    for cat, name, us in events:
        if cat == "kernel":
            by_name[name] = by_name.get(name, 0.0) + us
    return [name[:120] for name, _ in sorted(by_name.items(), key=lambda x: -x[1])[:3]]


def _bound(bytes_moved: int, operations: int, peak_ops: float) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = operations / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "operations": operations}


def tier_intersect_bound(L_out, L_in, q, width: int) -> dict:
    """K1's tier form on the queries ``q`` at ``width`` (wa, wb: the width
    clamped to each matrix): the ids read, each truncated row the batch
    names read once however many queries name it, a verdict byte written;
    one int32 compare per pair of valid entries of a query's two rows.  The
    gather floor counts two rows gathered anew for every query, as the
    kernel gathers them."""
    import torch

    n, B = L_out.shape[0], q.shape[0]
    wa, wb = min(width, L_out.shape[1]), min(width, L_in.shape[1])
    u, v = q[:, 0].long(), q[:, 1].long()
    ok = (u >= 0) & (u < n) & (v >= 0) & (v < n)
    u, v = u[ok], v[ok]
    rows = [int(torch.unique(u).numel()), int(torch.unique(v).numel())]
    pairs = int((L_out[u, :wa].ne(-1).sum(1) * L_in[v, :wb].ne(-1).sum(1)).sum())
    floor_bytes = B * (8 + 4 * (wa + wb)) + B
    return {**_bound(B * 8 + 4 * (rows[0] * wa + rows[1] * wb) + B, pairs,
                     PEAK_INT32_OPS_PER_S),
            "rows_read": rows, "gather_floor_bytes": floor_bytes,
            "gather_floor_ms": floor_bytes / PEAK_BYTES_PER_S * 1e3}


def frontier_or_bound(slab, wm: int) -> dict:
    """K2's slab form, fused, on ``slab`` with wm words a row: the ids once,
    the frontier words of every valid slot, perm and the out rows read
    once; a timed call after the first writes no word (the first already
    ORed everything in), so no write is counted; one OR per gathered word."""
    r, d = slab.shape
    valid = int(slab.ne(-1).sum())
    return _bound(r * d * 4 + valid * wm * 4 + r * 8 + r * wm * 4, valid * wm,
                  PEAK_INT32_OPS_PER_S)


def _l2_flush(device):
    """A read of 256 MB, five times the card's 50 MB L2: a kernel launched
    after it finds none of its inputs there."""
    import torch

    buf = torch.ones(1 << 26, dtype=torch.float32, device=device)
    return lambda: buf.sum()


def _cold_device_ms(fn, symbols, calls: int, flush) -> float:
    """``_kernel_device_ms`` with the L2 flushed before every call, the
    flush's own kernel left out: a time to hold against a bound at the
    DRAM rate."""
    return _kernel_device_ms(lambda: (flush(), fn()), symbols, calls)


def _rows_chunked(fn, n: int, rows: int):
    """fn(slice) over row chunks of ``rows``, concatenated."""
    import torch

    return torch.cat([fn(slice(i, min(i + rows, n))) for i in range(0, n, rows)])


def _attention_excess(got, exp) -> float:
    """The check of K4's output ``got`` against the float32 plain result
    ``exp``: max |got - exp'| / (atol + rtol |exp'|), exp' being exp rounded
    to got's type; the check passes at 1 or less."""
    rtol, atol = ATTENTION_TOL[str(got.dtype).removeprefix("torch.")]
    exp = exp.to(got.dtype).float()
    return float(((got.float() - exp).abs() / (atol + rtol * exp.abs())).max())


def _attention_pairs(S: int, T: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks keep: what the computation needs."""
    from repro_torch.kernels.ops import attention_pairs

    return attention_pairs(S, T, causal, window)[0]


def _attention_keys(S: int, T: int, causal: bool, window) -> int:
    """The keys some query sees, the union of the mask's rows: what the
    computation must read of k and v."""
    from repro_torch.kernels.ops import attention_pairs

    return attention_pairs(S, T, causal, window)[1]


def _attention_plain_chunked(q, k, v, causal, window):
    """K4's plain version over (batch, kv head) chunks, so no chunk's float32
    logits exceed PLAIN_CHUNK_BYTES; returns the whole output."""
    import torch

    from repro_torch.kernels import ref

    B, Hq, S, _ = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    # logits, mask, exp; k, v
    per_pair = max(rep * S * T * 4 * 3, T * (k.shape[3] + v.shape[3]) * 4)
    units = max(1, PLAIN_CHUNK_BYTES // per_pair)
    hc = min(Hkv, units)
    bc = max(1, units // Hkv) if hc == Hkv else 1
    out = q.new_empty((B, Hq, S, v.shape[3]))
    for b0 in range(0, B, bc):
        for h0 in range(0, Hkv, hc):
            b1, h1 = min(b0 + bc, B), min(h0 + hc, Hkv)
            out[b0:b1, h0 * rep:h1 * rep] = ref.flash_attention_ref(
                q[b0:b1, h0 * rep:h1 * rep], k[b0:b1, h0:h1], v[b0:b1, h0:h1],
                causal=causal, window=window)
    return out


def attention_bound(c: dict) -> dict:
    """K4's bound at a record's configuration ``c`` (``_attention_record``'s
    keys; ``c["dtype"]`` "float32" or "bfloat16"): two products, q k^T over
    D and p v over Dv, a multiply and an add each, over the (query, key)
    pairs the masks keep, at the dtype's peak; q and out, and the keys some
    query sees of k and v (``_attention_keys``: a window cuts the rest of the
    prefix), read or written once.  Also ``visible_pairs`` and
    ``visible_keys``."""
    kv_len = c.get("kv_len") or c["T"]
    pairs = _attention_pairs(c["S"], kv_len, c["causal"], c["window"])
    keys = _attention_keys(c["S"], kv_len, c["causal"], c["window"])
    D, Dv = c["D"], c.get("Dv", c["D"])
    size, peak = ((2, PEAK_BF16_FLOPS_PER_S) if c["dtype"] == "bfloat16" else
                  (4, PEAK_F32_FLOPS_PER_S))
    nbytes = size * (c["B"] * c["Hq"] * c["S"] * (D + Dv) + c["B"] * c["Hkv"] * keys * (D + Dv))
    return {**_bound(nbytes, 2 * pairs * (D + Dv) * c["Hq"] * c["B"], peak),
            "visible_pairs": pairs, "visible_keys": keys}


# the keys of a kernel record taken from its head configuration
HEAD_KEYS = ("config", "shape", "max_abs_err", "ms", "ms_runs", "device_ms", "plain_ms",
             "plain_ms_runs", "bound_ms", "bound_by", "bytes", "operations", "library_ms")


def _attention_record(label: str, c: dict, q, k, v, out, device) -> dict:
    """K4's output ``out`` at one configuration against the float32 plain
    version (``_attention_excess``) and the controls it must reject; then the
    wrapper's time, its device time, the plain version's and SDPA's, and the
    bound.  ``c`` holds B, Hq, Hkv, S, T, D, causal, window, dtype, v's width
    Dv where it differs from D (MLA) and, for a call over a preallocated
    cache, kv_len: the plain version and SDPA then take the contiguous
    prefix.  Only the keys some query sees count as bytes
    (``_attention_keys``): a window cuts the rest of the prefix."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    kv_len = c.get("kv_len") or c["T"]
    kp, vp = k[:, :, :kv_len], v[:, :, :kv_len]      # what exists
    kernel = ops.attention_kernel(q.dtype)
    exp = _attention_plain_chunked(q.float(), kp.float(), vp.float(), c["causal"], c["window"])
    err = float((out.float() - exp).abs().max())
    excess = _attention_excess(out, exp)
    check(excess <= 1, f"flash_attention differs from its plain version at {label}: "
                       f"max abs error {err}, {excess} times the tolerance")
    # controls the check must reject: a zeroed output and, at decode, the
    # output without every fourth 32-key chunk, taken on the first 8 batch
    # entries
    controls = {"zeroed": _attention_excess(torch.zeros_like(out), exp)}
    if c["S"] == 1:
        keep = (torch.arange(kv_len, device=device) // 32) % 4 != 0
        part = _attention_plain_chunked(q[:8].float(), kp[:8, :, keep].float(),
                                        vp[:8, :, keep].float(), c["causal"], c["window"])
        controls["dropped_chunks"] = _attention_excess(part.to(out.dtype), exp[:8])
        del part
    check(all(x > 1 for x in controls.values()),
          f"the flash_attention check at {label} passes a wrong output: {controls}")
    exp_rms = float(exp.pow(2).mean().sqrt())
    del exp
    kern = lambda: ops.flash_attention(q, k, v, causal=c["causal"],  # noqa: E731
                                       window=c["window"], kv_len=c.get("kv_len"))
    plain = lambda: _attention_plain_chunked(q, kp, vp, c["causal"], c["window"])  # noqa: E731
    # SDPA aligns a causal mask top-left: a query block shorter than the
    # keys and longer than one row takes the right-aligned mask explicitly
    explicit = c["window"] is not None or (c["causal"] and c["S"] not in (1, kv_len))
    if not explicit:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kp, vp, is_causal=c["causal"] and c["S"] > 1, enable_gqa=True)
    else:
        mask = ref.attention_mask(c["S"], kv_len, c["causal"], c["window"], device)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kp, vp, attn_mask=mask, enable_gqa=True)
    lib_err = float((lib().float() - out.float()).abs().max())
    p1, _ = _timed_once(plain)
    k1, k2 = _event_ms(kern, 3, warmup=1), _event_ms(kern, 3, warmup=1)
    p2, _ = _timed_once(plain)
    l1, l2 = _event_ms(lib, 3, warmup=1), _event_ms(lib, 3, warmup=1)
    bound = attention_bound(c)
    pairs, keys = bound["visible_pairs"], bound["visible_keys"]
    flops, nbytes = bound["operations"], bound["bytes"]
    # a trace of two launches has been seen to hold none, three times in a
    # row, both of a 10 us decode call and, late in the script, of a 1 ms
    # prefill call (alone in a process, two of the latter are traced); fifty
    # have always been traced
    device_ms = _kernel_device_ms(kern, ATTENTION_SYMBOLS[kernel], 50)
    rec = {
        "kernel": kernel, "config": label, "shape": c, "dtype": c["dtype"],
        "visible_pairs": pairs, "visible_keys": keys,
        "max_abs_err": err, "max_excess": excess, "controls_excess": controls,
        "exp_rms": exp_rms,
        "tolerance": dict(zip(("rtol", "atol"), ATTENTION_TOL[c["dtype"]]),
                          against=f"the float32 plain result rounded to {c['dtype']}"),
        "ms": min(k1, k2), "ms_runs": [k1, k2], "device_ms": device_ms,
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2], **bound,
        # the rates the kernel reached on the device, and its share of the bound
        "tflop_per_s": flops / device_ms / 1e9, "gb_per_s": nbytes / device_ms / 1e6,
        "bound_share": bound["bound_ms"] / device_ms,
        "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
        "library": "F.scaled_dot_product_attention(enable_gqa=True"
                   + (", explicit mask" if explicit else "")
                   + (", the filled prefix of the cache)" if c.get("kv_len") else ")"),
        "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err}
    log(f"K4 {kernel} {label}: {min(k1, k2):.3f} ms (device {device_ms:.3f} ms, "
        f"{rec['tflop_per_s']:.1f} TFLOP/s), plain {min(p1, p2):.3f} ms, "
        f"SDPA {min(l1, l2):.3f} ms, bound {bound['bound_ms']:.4f} ms")
    return rec


def _bag_record(label: str, table, idx, out) -> dict:
    """K6's output ``out`` = ``ops.embedding_bag(table, idx)`` against its
    plain version within 1e-5; then the wrapper's time (one launch and one
    synchronisation), its device time, the plain version's and
    ``F.embedding_bag``'s, the bound and the gather floor."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    B, bag = idx.shape
    valid = int((idx >= 0).sum())
    kern = lambda: ops.embedding_bag(table, idx)  # noqa: E731
    plain = lambda: ref.embedding_bag_ref(table, idx)  # noqa: E731
    p1, exp = _timed_once(plain)
    err = float((out - exp).abs().max())
    check(torch.allclose(out, exp, rtol=1e-5, atol=1e-5),
          f"embedding_bag differs from its plain version at {label}: {err}")
    del exp
    k1, k2 = _event_ms(kern, 50), _event_ms(kern, 50)
    p2, _ = _timed_once(plain)
    idx_lib, weights = idx.clamp_min(0).long(), (idx >= 0).float()
    lib = lambda: F.embedding_bag(idx_lib, table, mode="sum",  # noqa: E731
                                  per_sample_weights=weights)
    lib_err = float((lib() - out).abs().max())
    l1, l2 = _event_ms(lib, 50), _event_ms(lib, 50)
    D = table.shape[1]
    device_ms = _kernel_device_ms(kern, "embedding_bag_kernel", 20)
    # a gather reads the ids, the 32-byte sectors each valid slot's row spans
    # (no row reused from L2: the tables are 1.56 GB and 156 MB), and writes out
    start = idx[idx >= 0].long() * (D * 4)
    sectors = int(((start + D * 4 - 1) // 32 - start // 32 + 1).sum())
    floor_bytes = B * bag * 4 + sectors * 32 + B * D * 4
    floor_ms = floor_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"K6 embedding_bag {label}: {min(k1, k2):.3f} ms (device {device_ms:.4f} ms), "
        f"plain {min(p1, p2):.3f} ms, F.embedding_bag {min(l1, l2):.3f} ms")
    return {
        "config": label, "max_abs_err": err,
        "shape": {"V": table.shape[0], "D": D, "B": B, "bag": bag, "valid_slots": valid},
        # the wrapper's call: one launch, whose kernel writes the bad-id flag
        # to pinned host memory, and one synchronisation
        "ms": min(k1, k2), "ms_runs": [k1, k2],
        "device_ms": device_ms,
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
        # ids once, one table row per valid slot, out once; one add per value
        **_bound(B * bag * 4 + valid * D * 4 + B * D * 4, valid * D, 67e12),
        "gather_floor_bytes": floor_bytes, "gather_floor_ms": floor_ms,
        "gather_floor_share": floor_ms / device_ms,
        "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
        "library": "F.embedding_bag(idx.clamp_min(0), table, mode='sum', "
                   "per_sample_weights=(idx >= 0)), both made outside the timed window",
        "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err}


def _spmm_record(label: str, nbr, wgt, x, out, device) -> dict:
    """K5's output ``out`` = ``ops.ell_spmm(nbr, wgt, x)`` against its plain
    version (in row chunks) within 1e-5; then the wrapper's time, its device
    time, the plain version's and ``torch.sparse.mm``'s over the same rows
    as CSR, the bound and the gather floor."""
    import torch

    from repro_torch.kernels import ops, ref

    n, d = nbr.shape
    keep = nbr >= 0
    valid = int(keep.sum())
    kern = lambda: ops.ell_spmm(nbr, wgt, x)  # noqa: E731
    plain = lambda: _rows_chunked(  # noqa: E731
        lambda sl: ref.ell_spmm_ref(nbr[sl], wgt[sl], x), n, 1 << 17)
    p1, exp = _timed_once(plain)
    err = float((out - exp).abs().max())
    check(torch.allclose(out, exp, rtol=1e-5, atol=1e-5),
          f"ell_spmm differs from its plain version at {label}: {err}")
    del exp
    k1, k2 = _event_ms(kern, 10, warmup=2), _event_ms(kern, 10, warmup=2)
    p2, _ = _timed_once(plain)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=device)
    crow[1:] = keep.sum(1).cumsum(0)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, nbr[keep].long(), wgt[keep], size=(n, x.shape[0]))
    lib = lambda: torch.sparse.mm(csr, x)  # noqa: E731
    lib_err = float((lib() - out).abs().max())
    l1, l2 = _event_ms(lib, 10, warmup=2), _event_ms(lib, 10, warmup=2)
    F_ = x.shape[1]
    # fifty calls, as K4's record traces: a trace of five held none of GCN's F = 16
    # launches three times running once
    device_ms = _kernel_device_ms(kern, SPMM_SYMBOLS, 50)
    # ids, weights and out once, and one source row per valid slot: uniform ids
    # leave x no reuse from the 50 MB L2 where it is larger
    floor_ms = (n * d * 8 + n * F_ * 4 + valid * F_ * 4) / PEAK_BYTES_PER_S * 1e3
    log(f"K5 ell_spmm {label}: {min(k1, k2):.3f} ms (device {device_ms:.4f} ms), "
        f"plain {min(p1, p2):.3f} ms, torch.sparse.mm {min(l1, l2):.3f} ms")
    return {
        "config": label, "max_abs_err": err,
        "shape": {"n": n, "d": d, "n_src": x.shape[0], "F": F_, "valid_slots": valid},
        "ms": min(k1, k2), "ms_runs": [k1, k2],
        "device_ms": device_ms,
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
        # ids, weights and out once, and x once; one multiply-add per valid
        # slot and feature
        **_bound(n * d * 8 + n * F_ * 4 + x.numel() * 4, 2 * valid * F_, 67e12),
        "gather_bytes_no_reuse": valid * F_ * 4,
        "gather_floor_ms": floor_ms, "gather_floor_share": floor_ms / device_ms,
        "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
        "library": "torch.sparse.mm(CSR built outside the timed window, x)",
        "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err}


def phase_kernel_library(device, cases: dict) -> list:
    """The kernel library (K3-K6) at the widths of configurations the repo
    has, through ``repro_torch.kernels.ops``: the transitive closure of the
    "human" analogue by repeated ``R | bitset_mm(R, R)``; attention at
    granite-3-2b prefill, h2o-danube-1.8b sliding-window prefill and granite
    decode_32k in bfloat16 and granite prefill in float32; ELL SpMM at
    ogb_products; embedding bags at xDeepFM's table and serve_bulk batch.
    The launch counts are read around exactly that drive.  Then each kernel
    against its plain version (chunked where its intermediate would be
    large) and its timing beside its bound, the plain version and the
    library call.  Returns the five kernel records (K4 has two kernels)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.reach import adjacency_bits, transitive_closure_bits
    from repro_torch.kernels import ops, ref

    t_start = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(13)

    # ---- inputs, made on the card from the seed (K3's from the graph)
    human = paper_dataset_analogue("human", scale=1.0)
    A = torch.from_numpy(adjacency_bits(human).view(np.int32)).to(device)
    att = []
    for label, c in ATTENTION_CONFIGS:
        shape_q = (c["B"], c["Hq"], c["S"], c["D"])
        shape_kv = (c["B"], c["Hkv"], c["T"], c["D"])
        att.append((label, c, *(torch.randn(sh, generator=gen, device=device,
                                            dtype=getattr(torch, c["dtype"]))
                                for sh in (shape_q, shape_kv, shape_kv))))
    nbr, wgt, x, lens = products_inputs(gen, device)
    table, idx = xdeepfm_inputs(gen, device)
    torch.cuda.synchronize()
    t_inputs = time.perf_counter() - t_start

    # ---- the counted run: each kernel once at its configuration's widths
    ops.reset_launches()
    R, steps = A, 0
    while True:
        new = R | ops.bitset_mm(R, R)
        steps += 1
        if torch.equal(new, R):
            break
        R = new
    att_out = [ops.flash_attention(q, k, v, causal=c["causal"], window=c["window"])
               for _, c, q, k, v in att]
    spmm_out = ops.ell_spmm(nbr, wgt, x)
    bag_out = ops.embedding_bag(table, idx)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    # ----
    for name in ("bitset_mm", "flash_attention", "flash_attention_sm90", "ell_spmm",
                 "embedding_bag"):
        check(launches[name] > 0, f"{name} never launched in the kernel library phase")
    records = []

    # ---- K3: the closure, byte for byte; one step against the plain version
    truth = transitive_closure_bits(human)
    check(np.array_equal(R.cpu().numpy().view(np.uint32), truth),
          "the bitset_mm closure of the human analogue differs from transitive_closure_bits")
    n, wm = R.shape
    kern = lambda: ops.bitset_mm(R, R)  # noqa: E731
    plain = lambda: _rows_chunked(lambda sl: ref.bitset_mm_ref(R[sl], R), n, 256)  # noqa: E731
    p1, exp = _timed_once(plain)
    got = kern()
    torch.cuda.synchronize()
    check(torch.equal(got, exp), "bitset_mm differs from its plain version on the closure step")
    k1, k2 = _event_ms(kern, 20, warmup=3), _event_ms(kern, 20, warmup=3)
    p2, _ = _timed_once(plain)
    row_bits = torch.cat([ref.unpack_bits(R[i:i + 4096], n).sum(1) for i in range(0, n, 4096)])
    set_bits, max_row_bits = int(row_bits.sum()), int(row_bits.max())
    device_ms = _kernel_device_ms(kern, "bitset_mm_kernel", 10)
    # a gather reads a once, one row of x per set bit (no reuse), and writes out
    floor_ms = (2 * n * wm * 4 + set_bits * wm * 4) / PEAK_BYTES_PER_S * 1e3
    records.append({
        "name": "bitset_mm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitset_mm.cu",
        "replaces": "src/repro/kernels/bitset_mm.py:67",
        "launches": launches["bitset_mm"], "matches_plain": True,
        "cases_checked": cases["bitset_mm"] + 1, "max_abs_err": 0,
        "config": 'closure of paper_dataset_analogue("human", 1.0)',
        "shape": {"n": n, "k": n, "wm": wm, "set_bits": set_bits,
                  "max_row_bits": max_row_bits, "closure_steps": steps, "closure_equal": True},
        "ms": min(k1, k2), "ms_runs": [k1, k2],
        "device_ms": device_ms,
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
        # R is both a and x: read once, out written once; one OR per set bit
        # and word
        **_bound(2 * n * wm * 4, set_bits * wm, PEAK_INT32_OPS_PER_S),
        "gather_floor_ms": floor_ms, "gather_floor_share": floor_ms / device_ms,
        # no PyTorch call computes an OR-AND product of packed words
        "library_ms": None})
    del A, R, new, got, exp
    torch.cuda.empty_cache()

    # ---- K4: each configuration against the float32 plain version and SDPA,
    # through the kernel of its dtype (the plain version's products in full
    # float32: TF32 stays off)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    configs = [_attention_record(label, c, q, k, v, out, device)
               for (label, c, q, k, v), out in zip(att, att_out)]
    del att, att_out
    torch.cuda.empty_cache()
    for kernel, source in (("flash_attention_sm90", "flash_attention_sm90.cu"),
                           ("flash_attention", "flash_attention.cu")):
        mine = [rec for rec in configs if rec["kernel"] == kernel]
        head = mine[0]
        records.append({
            "name": kernel, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:110",
            "launches": launches[kernel], "matches_plain": True,
            "cases_checked": cases[kernel] + len(mine),
            **{k: head[k] for k in HEAD_KEYS}, "configs": mine})

    # ---- K4's backward at ATTENTION_BWD_CONFIGS, each kernel in its dtype:
    # inputs from the seed, the forward's output and lse through K4
    # (comparison launches, not counted)
    t_bwd = time.perf_counter()
    for name, dtype in BWD_RECORD_KERNELS:
        bwd = []
        for label, c in ATTENTION_BWD_CONFIGS:
            q, k, v, do = (torch.randn(sh, generator=gen, device=device,
                                       dtype=getattr(torch, dtype))
                           for sh in ((c["B"], c["Hq"], c["S"], c["D"]),
                                      (c["B"], c["Hkv"], c["T"], c["D"]),
                                      (c["B"], c["Hkv"], c["T"], c["Dv"]),
                                      (c["B"], c["Hq"], c["S"], c["Dv"])))
            o, lse = ops._flash_attention(q, k, v, True, None, 1 / math.sqrt(c["D"]), c["T"],
                                          return_lse=True)
            kw = dict(causal=True, window=None, lse=lse)
            got = ops.flash_attention_bwd(q, k, v, o, do, **kw)
            bwd.append(_attention_bwd_record(label + " (phase 3b)", (q, k, v, o, do), kw, got,
                                             device))
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()
        records.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": "src/repro/kernels/flash_attention.py:110",
            "backward_of": "src/repro/kernels/flash_attention.py:110",
            # no path of this phase trains: phase 4k's training counts its launches
            "launches": 0, "matches_plain": True,
            "cases_checked": cases["flash_attention_bwd"] // 2 + len(bwd),
            **{k: bwd[0][k] for k in HEAD_KEYS}, "configs": bwd})
    t_bwd = time.perf_counter() - t_bwd

    # ---- K5: ogb_products against the plain version (row chunks) and CSR SpMM
    spmm_rec = _spmm_record("ogb_products, random rows of 18-32 slots (configs/gnn_cells.py)",
                            nbr, wgt, x, spmm_out, device)
    records.append({
        "name": "ell_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_spmm.cu",
        "replaces": "src/repro/kernels/ell_spmm.py:61",
        "launches": launches["ell_spmm"], "matches_plain": True,
        "cases_checked": cases["ell_spmm"] + 1,
        **{k: spmm_rec[k] for k in HEAD_KEYS}, "configs": [spmm_rec]})
    del nbr, wgt, x, spmm_out, lens
    torch.cuda.empty_cache()

    # ---- K6: xDeepFM's table and serve_bulk batch
    bag_rec = _bag_record("xDeepFM table, serve_bulk batch, bags of 8 (configs/xdeepfm_cfg.py)",
                          table, idx, bag_out)
    records.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:52",
        "launches": launches["embedding_bag"], "matches_plain": True,
        "cases_checked": cases["embedding_bag"] + 1,
        **{k: bag_rec[k] for k in HEAD_KEYS}, "configs": [bag_rec]})
    del table, idx, bag_out
    torch.cuda.empty_cache()

    record({"phase": "kernel_library", "seconds": time.perf_counter() - t_start,
            "inputs_seconds": t_inputs, "backward_seconds": t_bwd, "launches": launches,
            "closure_steps": steps,
            "kernels": records})
    return records


# ------------------------------------------------------------------ phase 4


def make_traffic(g, co, n_queries: int, seed: int = 0) -> np.ndarray:
    """int32[n_queries, 2] original-id queries: half uniform pairs, a quarter
    reachable pairs from random sources, an eighth reachable pairs from
    sources with long L_out rows (so the widest tier sees hits) and an eighth
    uniform targets of those sources (so it sees misses)."""
    from repro_torch.graph.reach import reachable_set

    rng = np.random.default_rng(seed)
    n = g.n
    out_deg = g.out_degree()
    long_src = np.flatnonzero(co.oracle.out_len[co.comp] > co.engine.widths[0])
    check(long_src.size > 0, "no vertex has a label wider than the first tier")

    def reach_pool(sources):
        us, vs = [], []
        for u in sources:
            cone = np.flatnonzero(reachable_set(g, int(u)))
            us.append(np.full(cone.size, u, np.int64))
            vs.append(cone)
        return np.concatenate(us), np.concatenate(vs)

    pool_any = reach_pool(rng.choice(np.flatnonzero(out_deg > 0), 20000))
    pool_long = reach_pool(rng.choice(long_src, min(long_src.size, 2000), replace=False))
    k_uni, k_any, k_long = n_queries // 2, n_queries // 4, n_queries // 8
    k_long_miss = n_queries - k_uni - k_any - k_long
    pick_any = rng.integers(0, pool_any[0].size, k_any)
    pick_long = rng.integers(0, pool_long[0].size, k_long)
    q = np.concatenate([
        rng.integers(0, n, size=(k_uni, 2)),
        np.stack([pool_any[0][pick_any], pool_any[1][pick_any]], 1),
        np.stack([pool_long[0][pick_long], pool_long[1][pick_long]], 1),
        np.stack([rng.choice(long_src, k_long_miss), rng.integers(0, n, k_long_miss)], 1),
    ]).astype(np.int32)
    return q[rng.permutation(q.shape[0])]


def serve_all(co, queries: np.ndarray, backend, latencies=None) -> tuple:
    """Serve ``queries`` in batches of BATCH; (verdicts, seconds).  With a
    list given, each batch's host-clock seconds are appended to it (every
    backend returns host verdicts, so a batch's call ends with its work)."""
    import torch

    outs = []
    t0 = time.perf_counter()
    for i in range(0, queries.shape[0], BATCH):
        t_batch = time.perf_counter()
        outs.append(co.serve(queries[i:i + BATCH], backend=backend))
        if latencies is not None:
            latencies.append(time.perf_counter() - t_batch)
    torch.cuda.synchronize()
    return np.concatenate(outs), time.perf_counter() - t0


def tier_outcomes(co, cq: np.ndarray, rest: np.ndarray, verdicts: np.ndarray) -> dict:
    """Hits and misses of the intersection residue (``rest`` marks the
    condensation-id queries ``cq`` the prefilters left), per tier width
    (the planner's assignment, recomputed from the labels)."""
    o, eng = co.oracle, co.engine
    need = np.maximum(o.out_len[cq[rest, 0]], o.in_len[cq[rest, 1]])
    tier = np.minimum(np.searchsorted(eng.widths, need), len(eng.widths) - 1)
    v = verdicts[rest]
    return {int(w): {"hits": int((v & (tier == i)).sum()),
                     "misses": int((~v & (tier == i)).sum())}
            for i, w in enumerate(eng.widths)}


def check_labels(want, got, what: str) -> None:
    """The five label fields of ``got`` byte for byte against ``want``."""
    for f in LABEL_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        check(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
              f"{what}: {f} differs from the reference build")


def check_spec_counts(spec: dict, what: str, want: dict = SPEC_COUNTS) -> None:
    """A speculative build's counts against the JAX package's (citeseer@1.0's
    by default)."""
    got = {k: spec[k] for k in want}
    check(got == want, f"{what}: speculation counts {got} != {want}")


def check_sha256(o, scale: float, what: str) -> None:
    from build_counts import labels_sha256

    got = labels_sha256(o)
    check(got == DL_SHA256[scale],
          f"{what}: label sha256 {got} != the reference build's {DL_SHA256[scale]}")


def phase_main_path(device):
    import torch

    from repro_torch.core.api import build_oracle
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.reach import reachable_set
    from repro_torch.kernels import ops
    from repro_torch.serve.prefilter import apply_prefilters

    t0 = time.perf_counter()
    g = paper_dataset_analogue(MAIN_DATASET, scale=MAIN_SCALE)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    co = build_oracle(g, device=device)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    o, eng = co.oracle, co.engine
    check(eng.backend == "kernel", f"backend auto resolved to {eng.backend!r}, not kernel")
    st = o.build_stats
    check(st["impl"] == "speculative", f"auto build resolved to {st['impl']!r}, not speculative")
    check(st["n_waves"] == SPEC_BOUNDARIES,
          f"speculative schedule has {st['n_waves']} boundaries, not {SPEC_BOUNDARIES}")
    check_spec_counts(st["speculation"], "the auto build")
    # the truth: the reference build's labels, by their sha256
    check_sha256(o, MAIN_SCALE, "the speculative auto build")
    record({"phase": "build_oracle", "dataset": MAIN_DATASET, "scale": MAIN_SCALE,
            "n": g.n, "m": g.m, "graph_seconds": t_graph, "build_seconds": t_build,
            "build_stats": st, "labels_sha256": DL_SHA256[MAIN_SCALE],
            "labels_equal_reference": True,
            "L_out": list(o.L_out.shape), "L_in": list(o.L_in.shape),
            "label_bytes": int(o.L_out.nbytes + o.L_in.nbytes),
            "label_ints": o.total_label_size, "tier_widths": eng.widths})
    log(f"build: speculative {t_build:.3f} s (build_oracle), {st['n_waves']} boundaries, "
        f"labels equal the reference build's (sha256)")

    t0 = time.perf_counter()
    queries = make_traffic(g, co, MAIN_QUERIES)
    t_traffic = time.perf_counter() - t0
    co.serve(queries[:BATCH])                     # warm-up, outside the count
    torch.cuda.synchronize()
    eng.reset_stats()

    # ---- the counted run: the main path, backend auto
    latencies = []
    ops.reset_launches()
    kernel_out, t_kernel = serve_all(co, queries, None, latencies)
    launches = dict(ops.LAUNCHES)
    degradation = dict(eng.degradation)
    last = eng.last_stats
    # ----
    n_batches = len(latencies)
    check(last["backend"] == "kernel", f"served on {last['backend']!r}")
    check(launches["serve_batch"] == n_batches,
          f"serve_batch launched {launches['serve_batch']} times for {n_batches} batches")
    check(launches["label_intersect"] == 0,
          f"the tier form label_intersect launched {launches['label_intersect']} times")
    check(not any(degradation.values()), f"degradation counters moved: {degradation}")

    dense_out, t_dense = serve_all(co, queries, "dense")
    host_out, t_host = serve_all(co, queries, "host")
    check(np.array_equal(kernel_out, host_out),
          f"kernel != host merge on {int((kernel_out != host_out).sum())} queries")
    check(np.array_equal(dense_out, host_out),
          f"dense != host merge on {int((dense_out != host_out).sum())} queries")
    check(not any(eng.degradation.values()), f"degradation counters moved: {eng.degradation}")

    rng = np.random.default_rng(1)
    sample = rng.choice(queries.shape[0], BFS_SAMPLE, replace=False)
    truth = np.array([u == v or bool(reachable_set(g, int(u))[v])
                      for u, v in queries[sample]])
    check(np.array_equal(truth, kernel_out[sample]),
          f"kernel != BFS truth on {int((truth != kernel_out[sample]).sum())} of "
          f"{BFS_SAMPLE} sampled queries")
    cq = co.comp[queries]
    rest = ~apply_prefilters(cq, o.out_len, o.in_len, eng.level).decided
    tiers = tier_outcomes(co, cq, rest, kernel_out)
    for w, rec in tiers.items():
        check(rec["hits"] > 0 and rec["misses"] > 0,
              f"tier {w} must see hits and misses: {rec}")

    record({"phase": "main_path", "n_queries": int(queries.shape[0]), "batch": BATCH,
            "traffic_seconds": t_traffic, "backend": last["backend"],
            "launches": launches, "degradation": degradation,
            "kernel_qps": queries.shape[0] / t_kernel,
            "batches": n_batches,
            "batch_ms": {"p50": float(np.percentile(latencies, 50)) * 1e3,
                         "p99": float(np.percentile(latencies, 99)) * 1e3,
                         "max": max(latencies) * 1e3, "mean": t_kernel / n_batches * 1e3},
            "dense_qps": queries.shape[0] / t_dense,
            "host_qps": queries.shape[0] / t_host,
            "prefiltered_share": 1.0 - rest.sum() / queries.shape[0],
            "positives": int(kernel_out.sum()), "tiers": tiers,
            "equal_host": True, "bfs_sample": BFS_SAMPLE, "equal_bfs": True})
    log(f"main path: kernel {queries.shape[0] / t_kernel:.1f} queries/s, batch p50 "
        f"{np.percentile(latencies, 50) * 1e3:.4f} ms p99 {np.percentile(latencies, 99) * 1e3:.4f} "
        f"ms, serve_batch launches {launches['serve_batch']}")
    return g, co, queries, cq, rest, launches, kernel_out


# ------------------------------------------------------------------ phase 4b


def _device_window(dag, order, waves, device) -> dict:
    """Profile the device build over the schedule's first ``len(waves)``
    waves: the card's busy share between the first wave's start and the last
    wave's end (the engine's ``build.wave`` spans, mirrored into
    torch.profiler), with the device time by kind, the host's time in CUDA
    runtime calls and its time by operator.  The same window is first run
    without the profiler, timed by the tracer's own ``build.wave`` spans,
    since the profiler slows the host."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.build.engine_device import distribution_labeling_device
    from repro_torch.obs import trace

    def wave_window_us(evs):
        spans = [ev for ev in evs if ev.get("name") == "build.wave" and ev.get("ph") == "X"]
        check(len(spans) == len(waves), f"{len(spans)} build.wave spans for {len(waves)} waves")
        return (min(float(ev["ts"]) for ev in spans),
                max(float(ev["ts"]) + float(ev["dur"]) for ev in spans))

    trace.TRACER.clear()
    distribution_labeling_device(dag, order=order, waves=waves, device=device)
    torch.cuda.synchronize()
    u0, u1 = wave_window_us(list(trace.TRACER.events))
    trace.TRACER.clear()
    trace.TRACER.profiler_annotations = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            distribution_labeling_device(dag, order=order, waves=waves, device=device)
            torch.cuda.synchronize()
    finally:
        trace.TRACER.profiler_annotations = False
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [ev for ev in json.loads(path.read_text()).get("traceEvents", [])
                  if ev.get("ph") == "X"]
    t0, t1 = wave_window_us([ev for ev in events if ev.get("cat") == "user_annotation"])
    by_kind = {"frontier_expand": 0.0, "other_kernels": 0.0, "memcpy": 0.0, "memset": 0.0}
    for ev in events:
        cat = ev.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
        us = max(0.0, min(b, t1) - max(a, t0))
        if cat == "kernel":
            key = ("frontier_expand" if "frontier_expand_kernel" in ev.get("name", "")
                   else "other_kernels")
        else:
            key = "memcpy" if cat == "gpu_memcpy" else "memset"
        by_kind[key] += us
    busy_us = sum(by_kind.values())
    check(by_kind["frontier_expand"] > 0, "the profiled window ran no frontier_expand kernel")
    # host time in CUDA runtime calls inside the window (leaf events: their
    # durations are their own): launches, copies and synchronisations
    runtime = {}
    for ev in events:
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= float(ev["ts"]) <= t1:
            ms, count = runtime.get(ev.get("name", ""), (0.0, 0))
            runtime[ev.get("name", "")] = (ms + float(ev.get("dur", 0.0)) / 1e3, count + 1)
    # the host's time by operator over the whole profiled build (the torch
    # ops and CUDA runtime calls that cost it the most, self time)
    ops_by_host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    return {"waves": len(waves), "members": int(np.sum(waves)),
            "host_ops": [{"name": e.key, "count": e.count, "self_ms": e.self_cpu_time_total / 1e3}
                         for e in ops_by_host],
            "window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / (t1 - t0),
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "ms_per_wave": (t1 - t0) / 1e3 / len(waves),
            "unprofiled_window_ms": (u1 - u0) / 1e3,
            "unprofiled_ms_per_wave": (u1 - u0) / 1e3 / len(waves),
            # the profiled device time over the unprofiled window: an estimate
            # of the busy share without the profiler's host overhead
            "device_busy_share_unprofiled_window": busy_us / (u1 - u0),
            "host_runtime_calls": {k: {"ms": ms, "count": c} for k, (ms, c) in
                                   sorted(runtime.items(), key=lambda x: -x[1][0])}}


class _LevelCapture:
    """Wraps ``ops.FrontierExpand.__call__`` (the build's one call a level)
    for one build and keeps a copy of the inputs of one real level: the
    first with at least ``min_rows`` frontier rows at or after sweep
    ``sweep_at`` (a sweep's first level starts at ring position 0), in the
    order of ``frontier_expand``'s arguments.  The wrapped call runs
    unchanged and counts its launch as before; the copies are
    device-to-device copies, not kernel launches."""

    def __init__(self, sweep_at: int, min_rows: int = 8):
        self.sweep_at, self.min_rows = sweep_at, min_rows
        self.sweeps, self.args, self.at = 0, None, None

    def __enter__(self):
        from repro_torch.kernels import ops

        self.wrapped = ops.FrontierExpand.__call__
        capture = self

        def call(ex, lo, hi, delta_cur, delta_next, L_tgt, sweep, level):
            capture.sweeps += lo == 0
            if (capture.args is None and capture.sweeps > capture.sweep_at
                    and hi - lo >= capture.min_rows):
                capture.args = [t.clone() if hasattr(t, "clone") else t for t in (
                    ex.frontier, lo, hi, ex.indptr, ex.indices, ex.v, ex.pruned, delta_cur,
                    delta_next, L_tgt, ex.hop_mask, ex.stamps, sweep, level, ex.cone,
                    ex.counts)]
                capture.at = {"sweep": capture.sweeps - 1, "frontier_rows": hi - lo}
            return capture.wrapped(ex, lo, hi, delta_cur, delta_next, L_tgt, sweep, level)

        ops.FrontierExpand.__call__ = call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.FrontierExpand.__call__ = self.wrapped


def real_out_slab(dag, order, waves, member_width: int, device) -> tuple:
    """K2's slab form at a real shape: the out-slab (reverse sweeps) of
    ``dag``'s degree-sorted ELL layout, 16 wide, and the first wave's
    members (``order[:waves[0]]``, ``member_width`` bits a row) expanded
    three unpruned levels through it by the plain version.  Returns (slab
    int32[r, 16], frontier int32[n, wm], perm int64[r]) on ``device``;
    ``tools/kernel_ab.py`` times the kernel on the same inputs."""
    import torch

    from repro_torch.build import bitset
    from repro_torch.kernels import ref

    perm, _, slabs = bitset.ell_slabs(dag.indptr.astype(np.int64),
                                      dag.indices.astype(np.int64), dag.n, width=16)
    wm = (member_width + 31) // 32
    slab = torch.from_numpy(slabs[0]).to(device)
    perm_r = torch.from_numpy(perm[: slabs[0].shape[0]].copy()).to(device)
    j = np.arange(int(waves[0]))
    v = torch.zeros((dag.n, wm), dtype=torch.int32, device=device)
    v[torch.from_numpy(order[: j.size]).to(device), torch.from_numpy(j // 32).to(device)] = \
        torch.from_numpy((np.uint32(1) << (j % 32).astype(np.uint32)).view(np.int32)).to(device)
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    for _ in range(3):
        ref.frontier_or_ref(slab, v.clone(), out=v, perm=perm_r, flags=flags)
    return slab, v, perm_r


def mesh_build_slab(device) -> tuple:
    """``real_out_slab`` of phase 4i's mesh= build graph (citeseer@
    ``MESH_BUILD_SCALE``), for ``--only-multi-device``'s timing of K2's
    slab form."""
    from repro_torch.build.waves import wave_schedule
    from repro_torch.core.order import get_order
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag

    dag, _ = condense_to_dag(paper_dataset_analogue(MAIN_DATASET, scale=MESH_BUILD_SCALE))
    order = get_order(dag, "degree_product")
    waves = wave_schedule(dag, order, max_wave=256)
    return real_out_slab(dag, order, waves, 256, device)


def phase_device_build(device, scale) -> dict:
    """The device wave build of citeseer@``scale`` on the card, held byte for
    byte against the reference build: by its sha256 ``DL_SHA256[scale]``
    where the scale has one, else against a reference build of its own;
    served through K1 with the reference's verdicts (the host merge of the
    sha-checked labels, or the reference oracle's).  Returns
    {"launches": the build's kernel launches, "frontier_or_cases": K2 slab
    cases checked, "real_slab": a real slab and frontier for phase 5,
    "level": a real level's inputs from the middle of the schedule}."""
    import torch

    from repro_torch.build.waves import wave_schedule
    from repro_torch.core.api import build_oracle
    from repro_torch.core.order import get_order
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    g = paper_dataset_analogue(MAIN_DATASET, scale=scale)
    rec = {"phase": "device_build", "dataset": MAIN_DATASET, "scale": scale,
           "n": g.n, "m": g.m}
    queries = np.random.default_rng(0).integers(0, g.n, (64 * BATCH, 2)).astype(np.int32)
    by_sha = scale in DL_SHA256
    if not by_sha:
        t0 = time.perf_counter()
        ref_co = build_oracle(g, device=device, impl="reference")
        rec["reference_build_seconds"] = time.perf_counter() - t0
        verdicts, _ = serve_all(ref_co, queries, None)
        ref_labels = ref_co.oracle
    t0 = time.perf_counter()
    dag, _ = condense_to_dag(g)
    order = get_order(dag, "degree_product")
    waves = wave_schedule(dag, order, max_wave=256)
    rec["host_schedule_seconds"] = time.perf_counter() - t0

    # ---- the counted run: the device build (a copy of one level's inputs
    # is kept from the middle sweep on, for phase 5)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _LevelCapture(sweep_at=waves.shape[0]) as level:
        co = build_oracle(g, device=device, impl="device")
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # ----
    st = co.oracle.build_stats
    dev = st["device"]
    check(st["impl"] == "device", f"impl={st['impl']!r}")
    check(launches["frontier_expand"] > 0, "frontier_expand never launched in the device build")
    check(launches["frontier_expand"] == dev["levels"],
          f"{launches['frontier_expand']} frontier_expand launches for {dev['levels']} levels")
    check(launches["frontier_or"] == 0, "the device build launched the slab-form frontier_or")
    check(dev["host_reads"] == dev["levels"] + dev["sweeps"],
          f"{dev['host_reads']} host reads for {dev['levels']} levels and {dev['sweeps']} sweeps")
    check(level.args is not None, "no level of the middle sweeps was captured")
    if by_sha:
        check_sha256(co.oracle, scale, "the device build")
        verdicts, _ = serve_all(co, queries, "host")
    else:
        check_labels(ref_labels, co.oracle, "the device build")
    co.engine.reset_stats()
    ops.reset_launches()
    got, t_serve = serve_all(co, queries, None)
    serve_launches = dict(ops.LAUNCHES)
    check(co.engine.last_stats["backend"] == "kernel", "the device-built oracle was not "
          "served on the kernel backend")
    check(serve_launches["serve_batch"] == -(-queries.shape[0] // BATCH),
          f"serve_batch launched {serve_launches['serve_batch']} times")
    check(serve_launches["label_intersect"] == 0, "the tier form label_intersect launched")
    check(np.array_equal(got, verdicts),
          f"device-built oracle differs on {int((got != verdicts).sum())} verdicts")
    check(not any(co.engine.degradation.values()),
          f"degradation counters moved: {co.engine.degradation}")
    check(waves.shape[0] == st["n_waves"], "the schedule differs from the build's")
    rec.update({
        "build_seconds": t_build, "schedule_seconds": st["schedule_seconds"],
        "sweep_seconds": st["sweep_seconds"], "n_waves": st["n_waves"],
        "sweeps": dev["sweeps"], "bfs_levels": dev["levels"],
        "host_reads": dev["host_reads"], "regrows": dev["regrows"],
        "host_reads_per_wave": dev["host_reads"] / st["n_waves"],
        "levels_per_sweep": dev["levels"] / dev["sweeps"],
        "cone_rows_per_sweep": {"mean": dev["cone_rows_mean"], "p99": dev["cone_rows_p99"],
                                "max": dev["cone_rows_max"]},
        "l_max": dev["l_max"], "member_width": dev["member_width"],
        "launches": launches, "labels_equal_reference": True,
        "sweep_ms_per_wave": st["sweep_seconds"] * 1e3 / st["n_waves"],
        "served_queries": int(queries.shape[0]), "serve_seconds": t_serve,
        "serve_launches": serve_launches, "verdicts_equal_reference": True,
        "degradation": dict(co.engine.degradation), "timed_level": level.at})
    del co

    # K2's slab form on a real slab and frontier
    t0 = time.perf_counter()
    slab, v, perm_r = real_out_slab(dag, order, waves, int(dev["member_width"]), device)
    rng = np.random.default_rng(5)
    cases = _check_frontier_or(slab, v, rng, "real out-slab and frontier")
    rec["real_slab"] = {"r": int(slab.shape[0]), "d": int(slab.shape[1]), "wm": v.shape[1],
                        "frontier_rows": int(v.ne(0).any(1).sum())}

    rec["slab_check_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    win = rec["profiled_window"] = _device_window(dag, order, waves[:PROFILED_WAVES], device)
    rec["window_seconds"] = time.perf_counter() - t0
    calls = win["host_runtime_calls"]
    rec["launches_per_wave"] = {name: calls[name]["count"] / win["waves"]
                                for name in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                                if name in calls}
    rec["seconds"] = time.perf_counter() - t_phase
    record(rec)
    log(f"device build {MAIN_DATASET}@{scale}: build_seconds {t_build:.3f}, "
        f"{st['n_waves']} waves, {dev['levels']} levels, {launches['frontier_expand']} "
        f"frontier_expand launches; launches a wave {rec['launches_per_wave']} (first "
        f"{win['waves']} waves); host reads a wave {rec['host_reads_per_wave']:.3f}; cone "
        f"rows a sweep mean {dev['cone_rows_mean']:.2f} p99 {dev['cone_rows_p99']:.1f}; "
        f"busy {win['device_busy_share']:.4f} profiled")
    return {"launches": launches, "frontier_or_cases": cases, "real_slab": (slab, v, perm_r),
            "level": level.args}


# ------------------------------------------------------------------ phase 4c


def _dir_bytes(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_host_engines() -> None:
    """The host batched engines at citeseer@``HOST_ENGINES_SCALE``, each held
    byte for byte against the reference build there by its labels' sha256
    (``DL_SHA256``, which phase 4b's reference build of the same graph is
    held to as well): ``impl="wave"`` with its exact schedule, then a
    checkpointed speculative build killed by an injected failure at a chunk
    boundary past the middle and resumed from its last checkpoint, with the
    JAX package's speculation counts.  Host work only: the full script runs
    it in a child process beside phases 1-4b."""
    import tempfile

    from repro_torch.build.engine import build_distribution_labels
    from repro_torch.ft import inject
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag

    t_phase = time.perf_counter()
    rec = {"phase": "host_engines", "dataset": MAIN_DATASET, "scale": HOST_ENGINES_SCALE,
           "in": "a child process, beside phases 1-4b"}
    dag, _ = condense_to_dag(paper_dataset_analogue(MAIN_DATASET, scale=HOST_ENGINES_SCALE))
    rec["n"] = dag.n

    t0 = time.perf_counter()
    wave = build_distribution_labels(dag, impl="wave")
    t_wave = time.perf_counter() - t0
    st = wave.build_stats
    check(st["impl"] == "wave", f"impl={st['impl']!r}")
    check(st["n_waves"] == HALF_WAVE_BOUNDARIES,
          f"the wave build has {st['n_waves']} waves, not {HALF_WAVE_BOUNDARIES}")
    check_sha256(wave, HOST_ENGINES_SCALE, "the wave build")
    rec["wave"] = {"seconds": t_wave, "build_stats": st, "labels_equal_reference": True}
    del wave

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        d = pathlib.Path(tmp)
        t0 = time.perf_counter()
        killed = False
        try:
            with inject.active(inject.Injector({"build.chunk": KILL_AT_CHUNK})):
                build_distribution_labels(dag, impl="speculative", checkpoint_dir=tmp,
                                          checkpoint_every=CKPT_EVERY)
        except inject.SimulatedFailure:
            killed = True
        t_kill = time.perf_counter() - t0
        check(killed, f"the injected failure at chunk {KILL_AT_CHUNK} never fired")
        kept = sorted(p.name for p in d.iterdir() if p.name.startswith("ckpt_"))
        check(bool(kept), "the killed build left no checkpoint")
        kept_bytes = _dir_bytes(d)
        last = int(kept[-1].split("_")[1])

        t0 = time.perf_counter()
        spec = build_distribution_labels(dag, impl="speculative", checkpoint_dir=tmp,
                                         checkpoint_every=CKPT_EVERY)
        t_resume = time.perf_counter() - t0
        st = spec.build_stats
        ck = st["checkpoint"]
        check(st["impl"] == "speculative", f"impl={st['impl']!r}")
        check(ck["resumed_from"] == last,
              f"resumed from {ck['resumed_from']}, not the last checkpoint {last}")
        check(st["n_waves"] == HALF_SPEC_BOUNDARIES, f"{st['n_waves']} boundaries")
        check_spec_counts(st["speculation"], "the resumed build", HALF_SPEC_COUNTS)
        check_sha256(spec, HOST_ENGINES_SCALE, "the killed and resumed speculative build")
        rec["killed_and_resumed"] = {
            "checkpoint_every": CKPT_EVERY, "kill_at_chunk": KILL_AT_CHUNK,
            "seconds_to_kill": t_kill, "checkpoints_kept_at_kill": kept,
            "checkpoint_bytes_at_kill": kept_bytes, "resume_seconds": t_resume,
            "resumed_from": ck["resumed_from"], "written_by_resume": ck["written"],
            "checkpoint_seconds_in_resume": st["stages"]["checkpoint"],
            "checkpoint_bytes_after": _dir_bytes(d), "build_stats": st,
            "labels_equal_reference": True, "speculation_equal_uninterrupted": True}
    rec["seconds"] = time.perf_counter() - t_phase
    record(rec)
    k = rec["killed_and_resumed"]
    log(f"host engines at {HOST_ENGINES_SCALE}: wave {t_wave:.3f} s ({HALF_WAVE_BOUNDARIES} "
        f"waves); speculative killed "
        f"after {t_kill:.3f} s with {kept} ({kept_bytes} bytes), resumed from "
        f"{k['resumed_from']} in {t_resume:.3f} s ({k['written_by_resume']} checkpoints, "
        f"{k['checkpoint_seconds_in_resume']} s); labels equal; phase {rec['seconds']:.3f} s")


def _host_engines_child(out_path: str, t0: float) -> None:
    global _T0
    _T0 = t0   # the parent's start: perf_counter is the machine's monotonic clock
    with open(out_path, "w") as f, contextlib.redirect_stdout(f):
        phase_host_engines()


def start_host_engines():
    """Start phase 4c in a spawned child process, its standard output to a
    temporary file; ``finish_host_engines`` waits for it and relays it."""
    import multiprocessing
    import tempfile

    fd, out_path = tempfile.mkstemp(prefix="chip_smoke_4c_", suffix=".log")
    os.close(fd)
    child = multiprocessing.get_context("spawn").Process(
        target=_host_engines_child, args=(out_path, _T0))
    child.start()
    return child, out_path


def finish_host_engines(started, timeout: float = 300.0) -> None:
    """Wait for phase 4c's child, relay its lines, fail if it failed."""
    child, out_path = started
    child.join(timeout)
    with open(out_path) as f:
        text = f.read()
    os.unlink(out_path)
    for line in text.splitlines():
        print(line, flush=True)
    check(child.exitcode == 0,
          f"phase 4c (host engines) failed in its child process, exit {child.exitcode}")


def stop_host_engines(started) -> None:
    child, out_path = started
    if child.is_alive():
        child.kill()
    child.join()
    if os.path.exists(out_path):
        os.unlink(out_path)


# ------------------------------------------------------------------ phase 4i

# (b): a (2, 2) mesh of gloo ranks on the one card (NCCL puts no two ranks
# on one device), each rank a process; its mesh= build at citeseer@
# MESH_BUILD_SCALE, held to DL_SHA256 there, and this many of phase 4's
# queries served through both sharded backends
MESH_SHAPE = (2, 2)
MESH_BUILD_SCALE = 0.02
MESH_PREFIX_QUERIES = 16 * BATCH
MESH_RANK_TIMEOUT_S = 120      # a rank left in a collective raises after this
MESH_SERVE_WAIT_S = 300.0      # how long a rank waits for the script to let it serve
MESH_BACKENDS = ("sharded", "sharded_hop")


def _serve_sharded(co, queries: np.ndarray, backend: str) -> tuple:
    """``queries`` through ``backend`` in batches of BATCH after one warm-up
    batch (which makes the collectives' communicators), counted from a
    fresh launch count: (verdicts, batch seconds, launches, residues)."""
    import torch

    from repro_torch.kernels import ops

    co.serve(queries[:BATCH], backend=backend)       # warm-up, outside the count
    torch.cuda.synchronize()
    co.engine.reset_stats()
    latencies, outs, residues = [], [], []
    ops.reset_launches()
    for i in range(0, queries.shape[0], BATCH):
        t_batch = time.perf_counter()
        outs.append(co.serve(queries[i:i + BATCH], backend=backend))
        latencies.append(time.perf_counter() - t_batch)
        last = co.engine.last_stats
        residues.append(last["n_queries"] - last["n_prefiltered"])
    launches = dict(ops.LAUNCHES)
    check(co.engine.last_stats["backend"] == backend, f"served on {co.engine.last_stats}")
    check(launches["label_intersect"] == len(latencies) and launches["serve_batch"] == 0,
          f"[{backend}] launches {launches} for {len(latencies)} batches")
    check(all(residues), f"[{backend}] a batch had no intersection residue")
    check(not any(co.engine.degradation.values()),
          f"[{backend}] degradation counters moved: {co.engine.degradation}")
    return np.concatenate(outs), latencies, launches, residues


def _latency_ms(latencies: list) -> dict:
    return {"p50": float(np.percentile(latencies, 50)) * 1e3,
            "p99": float(np.percentile(latencies, 99)) * 1e3,
            "max": max(latencies) * 1e3}


def share_main_path(co, queries: np.ndarray, verdicts: np.ndarray) -> tuple:
    """Phase 4's oracle saved (``persist.save_oracle``) with its queries and
    verdicts in a temporary directory, for phase 4i (a) and (b)'s ranks to
    cold-start from; returns ``([], directory)``, the ranks' handle, which
    ``start_mesh_ranks`` fills."""
    import tempfile

    from repro_torch.persist import save_oracle

    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_4i_"))
    save_oracle(str(d / "snap"), co.oracle)
    np.save(d / "queries.npy", queries[:MESH_PREFIX_QUERIES])
    np.save(d / "verdicts.npy", verdicts[:MESH_PREFIX_QUERIES])
    return [], str(d)


def phase_multi_device_one_rank(device, g, co, queries: np.ndarray,
                                verdicts: np.ndarray, snap_dir: str) -> dict:
    """Phase 4i (a): phase 4's oracle cold-started from its snapshot
    (``oracle_from_snapshot(mesh=)``) behind a (1, 1) mesh over a one-rank
    NCCL process group in this process; all of phase 4's traffic through
    ``sharded`` and then ``sharded_hop``, every verdict equal to phase 4's,
    K1's tier form launched once a batch a backend (read around exactly
    that run), each backend's batch p50/p99."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core.api import oracle_from_snapshot
    from repro_torch.launch.mesh import form_mesh

    t_phase = time.perf_counter()
    rec = {"phase": "multi_device_one_rank", "mesh": [1, 1], "process_group": "nccl",
           "n_queries": int(queries.shape[0])}
    torch.cuda.set_device(device)   # the communicator's device, before the mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S))
    try:
        mesh = form_mesh((1, 1), ("data", "model"))
        t0 = time.perf_counter()
        mco = oracle_from_snapshot(g, snap_dir, mesh=mesh, device=device)
        torch.cuda.synchronize()
        rec["cold_start_seconds"] = time.perf_counter() - t0
        check(mco.engine.backend == "sharded",
              f"backend auto resolved to {mco.engine.backend!r} with a mesh")
        launches, residues = {}, []
        for be in MESH_BACKENDS:
            got, lat, launches[be], res = _serve_sharded(mco, queries, be)
            check(np.array_equal(got, verdicts),
                  f"[{be}] differs from phase 4 on {int((got != verdicts).sum())} queries")
            rec[be] = {"qps": queries.shape[0] / sum(lat), "batches": len(lat),
                       "batch_ms": _latency_ms(lat), "launches": launches[be],
                       "residue_mean": float(np.mean(res)), "verdicts_equal_phase_4": True}
            residues += res
            log(f"4i one-rank NCCL [{be}]: {rec[be]['qps']:.1f} queries/s, batch p50 "
                f"{rec[be]['batch_ms']['p50']:.4f} ms p99 {rec[be]['batch_ms']['p99']:.4f} ms, "
                f"label_intersect {launches[be]['label_intersect']} launches")
        del mco
    finally:
        dist.destroy_process_group()
    rec["label_intersect"] = sum(launches[be]["label_intersect"] for be in MESH_BACKENDS)
    rec["seconds"] = time.perf_counter() - t_phase
    record(rec)
    return {"label_intersect": rec["label_intersect"],
            "residue_median": int(np.median(residues))}


def _mesh_rank(rank: int, tmp: str, t0: float) -> None:
    """Phase 4i (b), one rank of ``MESH_SHAPE`` (spawned): the mesh= build,
    then phase 4's snapshot cold-started and a prefix of its traffic served
    through both sharded backends; exits non-zero on any failure."""
    global _T0
    _T0 = t0
    d = pathlib.Path(tmp)
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    with open(d / f"rank{rank}.log", "w") as logf, contextlib.redirect_stdout(logf):
        try:
            _mesh_rank_phases(rank, world, d)
        except BaseException:
            import traceback

            traceback.print_exc(file=logf)
            logf.flush()
            os._exit(1)


def _mesh_rank_phases(rank: int, world: int, d: pathlib.Path) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.build.engine import build_distribution_labels
    from repro_torch.core.api import oracle_from_snapshot
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import form_mesh

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    timeout = datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), world), rank=rank,
                            world_size=world, timeout=timeout)
    try:
        mesh = form_mesh(MESH_SHAPE, ("data", "model"), device_type="cuda", timeout=timeout)
        rec = {"phase": "multi_device_ranks", "rank": rank, "mesh": list(MESH_SHAPE),
               "coordinate": list(mesh.get_coordinate()), "process_group": "gloo"}
        # ---- the mesh= build, its launches read around exactly it
        dag, _ = condense_to_dag(paper_dataset_analogue(MAIN_DATASET, scale=MESH_BUILD_SCALE))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        o = build_distribution_labels(dag, impl="device", mesh=mesh, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        # ----
        st = o.build_stats["device"]
        check_sha256(o, MESH_BUILD_SCALE, f"rank {rank}'s mesh= build")
        check(launches["frontier_or"] == st["slab_calls"] > 0,
              f"frontier_or launched {launches['frontier_or']} times for "
              f"{st['slab_calls']} slab calls")
        check(launches["frontier_expand"] == 0, "the mesh= build launched frontier_expand")
        check(st["collectives"] == st["levels"], f"{st['collectives']} collectives for "
              f"{st['levels']} levels")
        rec["build"] = {"scale": MESH_BUILD_SCALE, "n": dag.n, "seconds": t_build,
                        "n_waves": o.build_stats["n_waves"], "launches": launches,
                        "levels": st["levels"], "slab_calls": st["slab_calls"],
                        "collectives": st["collectives"], "host_reads": st["host_reads"],
                        "ms_per_level": t_build * 1e3 / st["levels"],
                        "labels_sha256": DL_SHA256[MESH_BUILD_SCALE]}
        del o
        # ---- phase 4's snapshot, which the parent wrote before it started us
        queries, verdicts = np.load(d / "queries.npy"), np.load(d / "verdicts.npy")
        g = paper_dataset_analogue(MAIN_DATASET, scale=MAIN_SCALE)
        t0 = time.perf_counter()
        co = oracle_from_snapshot(g, str(d / "snap"), mesh=mesh, device="cuda")
        rec["cold_start_seconds"] = time.perf_counter() - t0
        # ---- serve once the script runs nothing beside us (release_mesh_ranks)
        t0 = time.perf_counter()
        while not (d / "serve").exists():
            check(time.perf_counter() - t0 < MESH_SERVE_WAIT_S, "the script never let us serve")
            time.sleep(0.05)
        rec["waited_to_serve_seconds"] = time.perf_counter() - t0
        for be in MESH_BACKENDS:
            got, lat, served_launches, _ = _serve_sharded(co, queries, be)
            check(np.array_equal(got, verdicts),
                  f"[{be}] rank {rank} differs from phase 4 on "
                  f"{int((got != verdicts).sum())} queries")
            rec[be] = {"n_queries": int(queries.shape[0]), "batches": len(lat),
                       "batch_ms": _latency_ms(lat), "launches": served_launches,
                       "verdicts_equal_phase_4": True}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(rec))


def start_mesh_ranks(started) -> None:
    """Start phase 4i (b)'s ranks (spawned processes, their output to files
    in the directory of ``share_main_path``'s handle ``started``, which
    holds phase 4's snapshot); ``finish_mesh_ranks`` waits for them."""
    import multiprocessing

    ranks, tmp = started
    ctx = multiprocessing.get_context("spawn")
    ranks += [ctx.Process(target=_mesh_rank, args=(r, tmp, _T0), daemon=True)
              for r in range(MESH_SHAPE[0] * MESH_SHAPE[1])]
    for p in ranks:
        p.start()


def release_mesh_ranks(started) -> None:
    """Let phase 4i (b)'s ranks serve their batches: the script runs
    nothing beside them from here until ``finish_mesh_ranks`` returns."""
    (pathlib.Path(started[1]) / "serve").touch()


def finish_mesh_ranks(started, timeout: float = 300.0) -> dict:
    """Wait for phase 4i (b)'s ranks, relay their records, fail if any
    failed; returns the launches their paths made, summed over the ranks."""
    ranks, tmp = started
    t_end = time.perf_counter() + timeout
    for p in ranks:
        p.join(max(t_end - time.perf_counter(), 0.0))
    d = pathlib.Path(tmp)
    recs = []
    for r, p in enumerate(ranks):
        out = d / f"rank{r}.json"
        if p.exitcode != 0 or not out.exists():
            log((d / f"rank{r}.log").read_text() if (d / f"rank{r}.log").exists() else "")
        check(p.exitcode == 0 and out.exists(),
              f"phase 4i rank {r} failed, exit {p.exitcode}")
        recs.append(json.loads(out.read_text()))
    rec = {"phase": "multi_device_ranks", "mesh": list(MESH_SHAPE), "process_group": "gloo",
           "ranks": recs}
    record(rec)
    r0 = recs[0]
    for be in MESH_BACKENDS:
        log(f"4i {MESH_SHAPE} gloo ranks [{be}]: {r0[be]['n_queries']} queries equal phase "
            f"4's on every rank, rank 0 batch p50 {r0[be]['batch_ms']['p50']:.4f} ms p99 "
            f"{r0[be]['batch_ms']['p99']:.4f} ms")
    log(f"4i mesh= build citeseer@{MESH_BUILD_SCALE}: {r0['build']['seconds']:.3f} s, "
        f"{r0['build']['levels']} levels, frontier_or {r0['build']['launches']['frontier_or']} "
        f"launches on rank 0, labels equal DL_SHA256")
    return {"label_intersect": sum(r[be]["launches"]["label_intersect"]
                                   for r in recs for be in MESH_BACKENDS),
            "frontier_or": sum(r["build"]["launches"]["frontier_or"] for r in recs)}


def stop_mesh_ranks(started) -> None:
    import shutil

    ranks, tmp = started
    for p in ranks:
        if p.is_alive():
            p.kill()
        p.join()
    shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ phase 4e


def phase_hierarchical(device, g, queries: np.ndarray, verdicts: np.ndarray) -> dict:
    """Hierarchical-Labeling of phase 4's graph at full width through
    ``build_oracle(method="hierarchical")`` on the card: the JAX package's
    level sizes, label matrices and their sha256, then phase 4's traffic
    served with ``backend="auto"`` (K1's batch form, one launch a batch)
    with phase 4's DL verdicts, both being exact.  Returns the launches."""
    import hashlib

    import torch

    from repro_torch.core.api import build_oracle
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    co = build_oracle(g, method="hierarchical", device=device)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    o, eng, st = co.oracle, co.engine, co.oracle.build_stats
    check(st["level_sizes"] == HL_LEVEL_SIZES,
          f"HL levels {st['level_sizes']}, not {HL_LEVEL_SIZES}")
    check(o.L_out.shape == HL_SHAPE and o.L_in.shape == HL_SHAPE,
          f"HL labels {o.L_out.shape} x {o.L_in.shape}, not {HL_SHAPE} x 2")
    check(o.total_label_size == HL_LABEL_INTS,
          f"HL has {o.total_label_size} label ints, not {HL_LABEL_INTS}")
    sha = hashlib.sha256(o.L_out.tobytes() + o.L_in.tobytes()).hexdigest()
    check(sha == HL_SHA256, f"HL labels' sha256 {sha} differs from the JAX package's")
    check(o.hop_rank is None, "HL labels must live in vertex-id space")
    check(eng.backend == "kernel", f"backend auto resolved to {eng.backend!r}, not kernel")
    co.serve(queries[:BATCH])                     # warm-up, outside the count
    torch.cuda.synchronize()
    eng.reset_stats()
    # ---- the counted run: HL served, backend auto
    latencies = []
    ops.reset_launches()
    out, t_serve = serve_all(co, queries, None, latencies)
    launches = dict(ops.LAUNCHES)
    degradation = dict(eng.degradation)
    # ----
    n_batches = len(latencies)
    check(eng.last_stats["backend"] == "kernel", f"HL served on {eng.last_stats['backend']!r}")
    check(launches["serve_batch"] == n_batches and launches["label_intersect"] == 0,
          f"HL serving launched {launches} for {n_batches} batches")
    check(not any(degradation.values()), f"HL degradation counters moved: {degradation}")
    check(np.array_equal(out, verdicts),
          f"HL differs from phase 4's DL verdicts on {int((out != verdicts).sum())} queries")
    rec = {"phase": "hierarchical", "dataset": MAIN_DATASET, "scale": MAIN_SCALE,
           "build_seconds": t_build, "stage_seconds": st["stages"],
           "level_sizes": st["level_sizes"], "L_out": list(o.L_out.shape),
           "L_in": list(o.L_in.shape), "label_ints": o.total_label_size, "sha256": sha,
           "label_bytes": int(o.L_out.nbytes + o.L_in.nbytes), "tier_widths": eng.widths,
           "n_queries": int(queries.shape[0]), "batches": n_batches,
           "kernel_qps": queries.shape[0] / t_serve,
           "batch_ms": {"p50": float(np.percentile(latencies, 50)) * 1e3,
                        "p99": float(np.percentile(latencies, 99)) * 1e3,
                        "max": max(latencies) * 1e3},
           "launches": launches, "degradation": degradation, "verdicts_equal_dl": True}
    record(rec)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in st["stages"].items())
    log(f"HL: build {t_build:.3f} s ({stages}), levels {st['level_sizes']}, "
        f"{o.total_label_size} label ints, sha256 equal; {queries.shape[0] / t_serve:.1f} "
        f"queries/s, batch p50 {rec['batch_ms']['p50']:.4f} ms p99 "
        f"{rec['batch_ms']['p99']:.4f} ms, resident {rec['label_bytes']} bytes, "
        f"verdicts equal DL's")
    return launches


# ------------------------------------------------------------------ phase 4f


QUICKSTART_QUERIES = 2000


def phase_quickstart(device) -> dict:
    """The ported quickstart at amaze: the five §6 baselines, ``OnlineBFS``,
    DL and HL (both served on the card) agree on every query, and
    ``examples/quickstart_torch.py`` runs.  Returns the launches."""
    import importlib.util

    from repro_torch.core import baselines
    from repro_torch.core.api import build_oracle
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    g = paper_dataset_analogue("amaze")
    q = np.random.default_rng(0).integers(0, g.n, size=(QUICKSTART_QUERIES, 2)).astype(np.int32)
    sizes, build_s = {}, {}
    answers = {}
    ops.reset_launches()
    for method in ("distribution", "hierarchical"):
        t0 = time.perf_counter()
        co = build_oracle(g, method=method, device=device,
                          **({"core_max": 512} if method == "hierarchical" else {}))
        build_s[method] = time.perf_counter() - t0
        answers[method] = co.serve(q)
        check(co.engine.last_stats["backend"] == "kernel", f"{method} left the kernel")
        sizes[method] = co.total_label_size
    launches = dict(ops.LAUNCHES)
    check(launches["serve_batch"] == 2, f"quickstart serving launched {launches}")
    for name in ("OnlineBFS", "Grail", "IntervalTC", "PWAHBitvector", "KReach", "TwoHopSetCover"):
        t0 = time.perf_counter()
        idx = getattr(baselines, name)(g)
        build_s[name] = time.perf_counter() - t0
        sizes[name] = idx.index_size_ints
        answers[name] = np.array([idx.query(int(u), int(v)) for u, v in q])
    for name, a in answers.items():
        check(np.array_equal(a, answers["OnlineBFS"]),
              f"{name} disagrees with OnlineBFS on {int((a != answers['OnlineBFS']).sum())} "
              f"of {QUICKSTART_QUERIES} queries")
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    demo.main(["--device", str(device)])
    rec = {"phase": "quickstart", "dataset": "amaze", "n": g.n, "m": g.m,
           "queries": QUICKSTART_QUERIES, "positives": int(answers["OnlineBFS"].sum()),
           "index_size_ints": sizes, "build_seconds": build_s, "all_agree": True,
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    record(rec)
    log(f"quickstart amaze: {len(answers)} indexes agree on {QUICKSTART_QUERIES} queries; "
        f"index ints {sizes}; phase {rec['seconds']:.3f} s")
    return launches


# ------------------------------------------------------------------ phase 4g


class _DispatchBook:
    """The daemon's target: phase 4's oracle, with a book of every dispatch
    (its queries and answers, and the ``serve_batch`` launches it made)."""

    def __init__(self, co):
        from repro_torch.kernels import ops

        self.co, self.engine, self.launches = co, co.engine, ops.LAUNCHES
        self.calls = []

    def serve(self, q, backend=None, deadline=None):
        before = self.launches["serve_batch"]
        ans = self.co.serve(q, backend=backend, deadline=deadline)
        self.calls.append((np.array(q, copy=True), ans.copy(),
                           self.launches["serve_batch"] - before))
        return ans


DAEMON_RUNS = (
    # (name, rate, duration, fault flags of launch/serve.py, pressure watermark)
    ("clean", 400.0, 3.0, None, None),
    ("faulted", 400.0, 3.0, ("2-6:60", "8-10"), None),
    ("pressure", 100.0, 2.0, None, 0.75),
)


def phase_daemon(g, co) -> dict:
    """The serving daemon over phase 4's oracle through ``run_open_loop`` at
    the JAX driver's defaults (64 queries an arrival, deadline 150 ms,
    ``max_batch`` 4,096, a 2 ms window), three runs: clean; with the
    driver's ``--inject-device-latency 2-6:60 --inject-device-failure 8-10``
    (the breaker trips); under a ``BudgetController`` whose pressure
    watermark is 0.75 of the full label bytes (it steps down).  In each
    run every dispatched answer equals phase 4's oracle's host merge, the
    registry's counters equal the daemon's books, and ``serve_batch``
    launched once for each warm-up rung and each dispatch that reached the
    kernel.  Returns the launches of the three runs."""
    import argparse

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fault_plan_from_args
    from repro_torch.obs import metrics
    from repro_torch.serve.budget import BudgetController, PressureConfig
    from repro_torch.serve.daemon import DaemonConfig
    from repro_torch.serve.openloop import run_open_loop

    total = {}
    runs = {}
    rungs = (DaemonConfig().max_batch // 64).bit_length()   # 64, 128, ..., 4096
    for name, rate, duration, faults, watermark in DAEMON_RUNS:
        book = _DispatchBook(co)
        plan = None if faults is None else fault_plan_from_args(argparse.Namespace(
            inject_device_latency=faults[0], inject_device_failure=faults[1]))
        ctl = None if watermark is None else BudgetController(
            co.engine, pressure=PressureConfig(watermark_bytes=int(watermark * FULL_LABEL_BYTES)))
        metrics.REGISTRY.reset()
        co.engine.reset_stats()
        # ---- the counted run
        ops.reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the injected failures' ladder warnings
            rep = run_open_loop(book, g, rate_arrivals_per_s=rate, arrival_batch=64,
                                duration_s=duration, deadline_ms=150.0,
                                config=DaemonConfig(deadline_ms=150.0), fault_plan=plan,
                                seed=0, budget_ctl=ctl)
        launches = dict(ops.LAUNCHES)
        # ----
        budget = None if ctl is None else ctl.snapshot()
        if ctl is not None:
            ctl.apply(None)
        per_call = [k for _, _, k in book.calls]
        reached = sum(per_call)
        check(launches["serve_batch"] == rungs + reached and launches["label_intersect"] == 0
              and set(per_call) <= {0, 1} and reached <= rep["device_batches"],
              f"daemon {name}: launches {launches}, {rungs} warm-up rungs, {reached} "
              f"dispatches that launched the kernel ({rep['device_batches']} device "
              f"batches), per dispatch {sorted(set(per_call))}")
        check(rep["sample_errors"] == 0, f"daemon {name}: {rep['sample_errors']} sampled errors")
        q = np.concatenate([c[0] for c in book.calls])
        got = np.concatenate([c[1] for c in book.calls])
        want = co.serve(q, backend="host")
        check(np.array_equal(got, want),
              f"daemon {name}: {int((got != want).sum())} of {q.shape[0]} dispatched answers "
              f"differ from phase 4's oracle")
        reg = metrics.REGISTRY
        books = {
            "answered": (reg.counter_value("daemon_requests_total", event="answered"),
                         rep["answered"]),
            "submitted": (reg.counter_value("daemon_requests_total", event="submitted"),
                          rep["submitted"]),
            "shed": (sum(reg.counter_value("daemon_shed_total", reason=r) for r in
                         ("queue_full", "deadline", "draining", "expired", "killed")),
                     sum(rep["shed"].values())),
            "batches": (reg.counter_value("daemon_batches_total", rung="all"), rep["batches"]),
            "device_batches": (reg.counter_value("daemon_batches_total", rung="device"),
                               rep["device_batches"]),
            "breaker_host_batches": (reg.counter_value("daemon_batches_total",
                                                       rung="breaker_host"),
                                     rep["breaker_host_batches"]),
            "breaker_trips": (reg.counter_value("daemon_breaker_trips_total"),
                              rep["breaker"]["trips"]),
        }
        if budget is not None:
            books["budget_steps_down"] = (
                reg.counter_value("daemon_budget_steps_total", direction="down"),
                budget["steps_down"])
        for k, (a, b) in books.items():
            check(a == b, f"daemon {name}: registry {k} {a} != the daemon's books {b}")
        check(rep["answered"] > 0, f"daemon {name} answered nothing")
        if name == "faulted":
            check(rep["breaker"]["trips"] >= 1 and rep["breaker_host_batches"] > 0,
                  f"the faulted run did not trip the breaker: {rep['breaker']}, "
                  f"{rep['breaker_host_batches']} host batches")
            check(rep["degradation"]["device_to_host"] > 0, "no device -> host rung taken")
            check(not any(v for k, v in rep["degradation"].items()
                          if k not in ("device_to_host", "deadline_to_host")),
                  f"daemon {name}: degradation {rep['degradation']}")
        elif name == "pressure":
            check(budget["steps_down"] >= 1, f"the pressure run took no step down: {budget}")
            check(not any(v for k, v in rep["degradation"].items()
                          if k not in ("uncertain", "searched", "deadline_to_host")),
                  f"daemon {name}: degradation {rep['degradation']}")
        else:
            check(not any(v for k, v in rep["degradation"].items() if k != "deadline_to_host"),
                  f"daemon {name}: degradation {rep['degradation']}")
        runs[name] = {k: rep[k] for k in (
            "offered_qps", "sustained_qps", "n_arrivals", "submitted", "answered", "shed",
            "shed_rate", "p50_ms", "p99_ms", "p99_within_deadline", "breaker", "batches",
            "device_batches", "breaker_host_batches", "degradation", "faults")}
        runs[name].update({"dispatches": len(book.calls), "kernel_dispatches": reached,
                           "dispatched_queries": int(q.shape[0]), "launches": launches,
                           "budget": budget, "answers_equal_phase_4": True,
                           "registry_equals_books": True})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"daemon {name}: {rep['answered']} of {rep['submitted']} answered, "
            f"{rep['sustained_qps']} queries/s sustained of {rep['offered_qps']} offered, "
            f"shed {rep['shed']}, p50 {rep['p50_ms']} ms p99 {rep['p99_ms']} ms, "
            f"{rep['device_batches']} device and {rep['breaker_host_batches']} breaker-host "
            f"batches, trips {rep['breaker']['trips']}, serve_batch {launches['serve_batch']}"
            + ("" if budget is None else f", budget steps down {budget['steps_down']}, "
               f"resident {budget['resident_bytes']}"))
    co.engine.reset_stats()
    record({"phase": "daemon", "dataset": MAIN_DATASET, "scale": MAIN_SCALE,
            "warmup_rungs": rungs, "runs": runs, "launches": total})
    return total


# ------------------------------------------------------------------ phase 4h

# benchmarks/dynamic_sweep.py's defaults (100 DAG-preserving updates a round
# at an insert share of 0.6), over 4 of its 10 rounds: about 1.6 s a round,
# four keep the script within its target beside phase 4l
DYN_ROUNDS = 1   # 4 before phase 4l's (d) and (e) (see SUBSTRATE_LAYERS' comment)
DYN_UPDATES = 100
DYN_INSERT_FRAC = 0.6
DYN_SEED = 0
DYN_QUERIES = 4096   # a round's queries, on the current and on the pinned epoch
DYN_TRUTH = 1024     # of them held against BFS truth of the mutated graph
# the daemon over the recovered oracle: 400 arrivals/s of 64 queries for
# 2 s, one publish 1 s in (``--publish-stall S`` stalls it S seconds more at
# its fault site ``dynamic.publish``, as the daemon tests do; 0 by default)
DYN_DAEMON_RATE, DYN_DAEMON_SECONDS, DYN_PUBLISH_AT = 400.0, 2.0, 1.0
DYN_LAG_TICK = 0.002   # the event loop's heartbeat in the daemon run


@contextlib.contextmanager
def _gc_paused_then_frozen():
    """The cyclic collector paused while a dynamic oracle is built or
    recovered (hundreds of thousands of int sets and lists, where the
    collector's passes over the growing heap cost more than the
    allocations), and the heap moved to its permanent generation after
    (``gc.freeze``), so a later collection, in whatever thread runs it (the
    daemon's publish), scans only what is new.  ``gc.unfreeze`` gives the
    heap back to the collector."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        gc.freeze()
        if was_enabled:
            gc.enable()


def _bfs_truth(adj, q: np.ndarray) -> np.ndarray:
    """BFS truth over adjacency sets (the dynamic oracle's live edge log),
    stopping at the target."""
    out = np.empty(q.shape[0], dtype=bool)
    for i, (u, v) in enumerate(q.tolist()):
        seen, stack = {u}, [u]
        while stack and v not in seen:
            for w in adj[stack.pop()]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        out[i] = v in seen
    return out


def _timed(obj, name: str, into: dict) -> None:
    """Wrap ``obj.name`` (an instance attribute from here on) so each call
    adds its seconds to ``into[name]``."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, wrapper)


def _last_span_s(name: str) -> float:
    from repro_torch.obs import trace

    for ev in reversed(trace.TRACER.events):
        if ev.get("name") == name and ev.get("ph") == "X":
            return ev["dur"] / 1e6
    raise AssertionError(f"no {name} span in the trace ring")


class _EpochBook:
    """The daemon's target in phase 4h: the durable oracle, with a book of
    every dispatch (the epoch that served it, the rung, its queries and
    answers, and the K1 launches it made).  An engine dispatch holds the
    daemon's engine lock, which a publish holds too, so the engine's epoch
    cannot change under it; a pinned dispatch serves its snapshot's epoch."""

    def __init__(self, dyn):
        from repro_torch.kernels import ops

        self.dyn, self.engine, self.launches = dyn, dyn.engine, ops.LAUNCHES
        self.calls = []
        self.publish_window = None   # (start, end) on the perf_counter clock

    @property
    def epoch(self) -> int:
        return self.dyn.epoch

    def _book(self, epoch: int, rung: str, q, fn):
        before = dict(self.launches)
        t0 = time.perf_counter()
        ans = fn()
        self.calls.append((epoch, rung, np.array(q, copy=True), ans.copy(),
                           {k: self.launches[k] - before[k]
                            for k in ("serve_batch", "label_intersect")},
                           t0, time.perf_counter()))
        return ans

    def serve(self, q, backend=None, deadline=None):
        return self._book(self.dyn.engine.epoch, "engine", q,
                          lambda: self.dyn.serve(q, backend=backend, deadline=deadline))

    def snapshot(self, epoch=None):
        book, snap = self, self.dyn.snapshot(epoch)

        class _Pin:
            def query_batch(self, q, device=True):
                return book._book(snap.epoch, "pinned" if device else "pinned_host", q,
                                  lambda: snap.query_batch(q, device=device))

        return _Pin()

    def apply(self, batch):
        self._t_apply = time.perf_counter()
        return self.dyn.apply(batch)

    def publish(self) -> int:
        t0 = getattr(self, "_t_apply", time.perf_counter())
        try:
            return self.dyn.publish()
        finally:
            self.publish_window = (t0, time.perf_counter())


def phase_dynamic(device, g, queries: np.ndarray, verdicts: np.ndarray,
                  publish_stall: float = 0.0) -> dict:
    """The dynamic oracle at citeseer@1.0 on the card: a
    ``DurableDynamicOracle`` built on phase 4's graph (epoch 0 gives phase
    4's verdict on all of phase 4's traffic), ``DYN_ROUNDS`` rounds of
    ``DYN_UPDATES`` DAG-preserving updates, each applied and published (a
    repair publish, a snapshot and a WAL marker), then ``DYN_QUERIES`` of
    phase 4's queries on the current epoch through ``serve_batch`` and on the
    epoch before it, pinned, through K1's tier form ``label_intersect``
    (equal to that epoch's host merge), ``DYN_TRUTH`` of them against BFS
    truth of the mutated graph; one more batch applied and never published,
    a crash, ``recover`` on the card with the never-crashed oracle's
    verdicts; the daemon over the recovered oracle through ``run_open_loop``
    with one publish mid-run (stalled ``publish_stall`` seconds at its fault
    site if that is not 0), every answer equal to the host merge of the
    epoch that served it, the registry equal to the daemon's books, and
    what the event loop and the collector did during the publish.
    Returns the K1 launches of the phase and the pinned batches' residue
    sizes."""
    import asyncio
    import tempfile

    import torch

    import repro_torch.serve.openloop as openloop
    from repro_torch.dynamic import DurableDynamicOracle, DynamicOracle, generate_trace
    from repro_torch.ft import inject
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics
    from repro_torch.serve.daemon import DaemonConfig, ServeDaemon
    from repro_torch.serve.prefilter import apply_prefilters

    t_phase = time.perf_counter()
    rec = {"phase": "dynamic", "dataset": MAIN_DATASET, "scale": MAIN_SCALE, "n": g.n,
           "m": g.m, "rounds": DYN_ROUNDS, "updates_per_round": DYN_UPDATES,
           "insert_frac": DYN_INSERT_FRAC, "queries_per_round": DYN_QUERIES}
    k1 = {"serve_batch": 0, "label_intersect": 0}

    def add(launches):
        for k in k1:
            k1[k] += launches[k]

    t0 = time.perf_counter()
    # the rounds' batches, the crash tail and the daemon's publish
    trace_ops = generate_trace(g, rounds=DYN_ROUNDS + 2, updates_per_round=DYN_UPDATES,
                               queries_per_round=1, insert_frac=DYN_INSERT_FRAC,
                               dag_preserving=True, seed=DYN_SEED)
    batches = [op.batch for op in trace_ops if op.kind == "update"]
    rec["trace_seconds"] = time.perf_counter() - t0
    check(queries.shape[0] >= (DYN_ROUNDS + 1) * DYN_QUERIES, "too little traffic for 4h")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_state_") as tmp:
        # ---- 1. start: epoch 0 = phase 4's oracle on phase 4's traffic
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        with _gc_paused_then_frozen():
            dur = DurableDynamicOracle(g, state_dir=tmp, device=device)
        torch.cuda.synchronize()
        rec["construct_seconds"] = time.perf_counter() - t0
        eng = dur.engine
        check(eng.backend == "kernel" and dur.snapshot().device.type == "cuda",
              f"the dynamic oracle serves on {eng.backend!r} / {dur.snapshot().device}")
        # ---- the counted run: epoch 0 on phase 4's traffic
        ops.reset_launches()
        out0, t_serve0 = serve_all(dur, queries, None)
        launches = dict(ops.LAUNCHES)
        # ----
        add(launches)
        n_batches = -(-queries.shape[0] // BATCH)
        check(launches["serve_batch"] == n_batches and launches["label_intersect"] == 0,
              f"epoch 0: launches {launches} for {n_batches} batches")
        check(np.array_equal(out0, verdicts),
              f"epoch 0 differs from phase 4's verdicts on {int((out0 != verdicts).sum())} "
              f"of {queries.shape[0]} queries")
        rec["epoch0"] = {"queries": int(queries.shape[0]), "serve_seconds": t_serve0,
                         "launches": launches, "verdicts_equal_phase_4": True,
                         "label_ints": dur.total_label_size,
                         "memory_allocated": torch.cuda.memory_allocated(device),
                         "memory_before": mem0}
        log(f"dynamic: DurableDynamicOracle built in {rec['construct_seconds']:.3f} s, "
            f"epoch 0 = phase 4 on {queries.shape[0]} queries")

        # ---- 2. rounds: apply, publish, current and pinned epochs, BFS truth
        timings = {}
        _timed(eng, "refresh", timings)
        _timed(dur, "_snapshot_state", timings)
        rounds, residues = [], []
        rng = np.random.default_rng(DYN_SEED)
        for r in range(DYN_ROUNDS):
            q = queries[r * DYN_QUERIES:(r + 1) * DYN_QUERIES]
            timings.clear()
            t0 = time.perf_counter()
            st = dur.apply(batches[r])
            t_apply = time.perf_counter() - t0
            t0 = time.perf_counter()
            e = dur.publish()
            t_publish = time.perf_counter() - t0
            stage, commit = _last_span_s("publish.stage"), _last_span_s("publish.commit")
            torch.cuda.synchronize()
            mem = torch.cuda.memory_allocated(device)
            t0 = time.perf_counter()
            eng._serve_batch_op()        # the first kernel batch's rebuild, timed alone
            t_rebuild = time.perf_counter() - t0
            check(not st.rebuild_pending and st.structural == 0,
                  f"round {r}: the DAG-preserving batch asked for a rebuild: {st}")
            # ---- the counted run: the current epoch, then the pinned one
            ops.reset_launches()
            cur = dur.serve(q)
            cur_launches = dict(ops.LAUNCHES)
            ops.reset_launches()
            old = dur.serve(q, epoch=e - 1)
            pin_launches = dict(ops.LAUNCHES)
            # ----
            add(cur_launches)
            add(pin_launches)
            snap = dur.snapshot(e - 1)
            cq = snap.comp[q]
            rest = int((~apply_prefilters(cq, snap.oracle.out_len, snap.oracle.in_len,
                                          snap.level).decided).sum())
            residues.append(rest)
            check(cur_launches["serve_batch"] == 1 and cur_launches["label_intersect"] == 0,
                  f"round {r}: the current epoch launched {cur_launches}")
            check(pin_launches["label_intersect"] == int(rest > 0)
                  and pin_launches["serve_batch"] == 0,
                  f"round {r}: the pinned epoch launched {pin_launches} for {rest} queries "
                  "past the prefilters")
            host_old = snap.query_batch(q, device=False)
            check(np.array_equal(old, host_old),
                  f"round {r}: the pinned epoch {e - 1} differs from its host merge on "
                  f"{int((old != host_old).sum())} queries")
            pick = rng.choice(DYN_QUERIES, DYN_TRUTH, replace=False)
            t0 = time.perf_counter()
            truth = _bfs_truth(dur.delta.out_adj, q[pick])
            t_truth = time.perf_counter() - t0
            check(np.array_equal(cur[pick], truth),
                  f"round {r}: epoch {e} differs from BFS truth on "
                  f"{int((cur[pick] != truth).sum())} of {DYN_TRUTH} queries")
            check(not any(eng.degradation.values()), f"degradation {eng.degradation}")
            gl = dur.growth_log[-1]
            rounds.append({
                "epoch": e, "apply_seconds": t_apply, "publish_seconds": t_publish,
                "stage_seconds": stage, "commit_seconds": commit,
                "refresh_seconds": timings["refresh"],
                "snapshot_seconds": timings["_snapshot_state"],
                "serve_batch_rebuild_seconds": t_rebuild, "truth_seconds": t_truth,
                "repaired_inserts": st.repaired_inserts, "repaired_deletes": st.repaired_deletes,
                "noop": st.noop, "label_ints": gl["label_ints"], "appends": gl["appends"],
                "drops": gl["drops"], "growth_rate": gl["growth_rate"],
                "memory_allocated": mem, "pinned_residue": rest,
                "positives": int(cur.sum())})
        del eng.refresh, dur._snapshot_state
        rec["round"] = rounds
        check(max(r["memory_allocated"] for r in rounds)
              <= rec["epoch0"]["memory_allocated"] + (dur.keep_epochs + 1) * FULL_LABEL_BYTES,
              "device memory grew past the epoch window's copies: "
              f"{[r['memory_allocated'] for r in rounds]}")
        log(f"dynamic: {DYN_ROUNDS} rounds, publish "
            f"{np.mean([r['publish_seconds'] for r in rounds]):.3f} s mean (stage "
            f"{np.mean([r['stage_seconds'] for r in rounds]):.3f}, snapshot "
            f"{np.mean([r['snapshot_seconds'] for r in rounds]):.3f}), pinned residues "
            f"{residues}, memory {rounds[-1]['memory_allocated']}")

        # ---- 3. crash and recover: the tail acknowledged in the WAL only
        qc = queries[DYN_ROUNDS * DYN_QUERIES:(DYN_ROUNDS + 1) * DYN_QUERIES]
        dur.apply(batches[DYN_ROUNDS])
        # the never-crashed oracle publishes the tail in memory (the crash
        # window between a publish and its snapshot); then the crash
        DynamicOracle.publish(dur)
        # ---- the counted run: the never-crashed oracle's verdicts
        ops.reset_launches()
        want = dur.serve(qc)
        want_launches = dict(ops.LAUNCHES)
        # ----
        add(want_launches)
        check(want_launches["serve_batch"] == 1 and want_launches["label_intersect"] == 0,
              f"the never-crashed oracle launched {want_launches}")
        del dur, eng, snap
        # the crashed oracle is cyclic garbage (its engine holds its comp
        # source): give the heap back to the collector and collect it here,
        # so the recovery's time is the recovery's
        t0 = time.perf_counter()
        gc.unfreeze()
        gc.collect()
        rec["crash_collect_seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _gc_paused_then_frozen():
            rec_dyn = DurableDynamicOracle.recover(tmp, device=device)
        torch.cuda.synchronize()
        t_recover = time.perf_counter() - t0
        ops.reset_launches()
        got = rec_dyn.serve(qc)
        launches = dict(ops.LAUNCHES)
        add(launches)
        check(rec_dyn.recovered_records >= DYN_UPDATES // 2,
              f"recovery replayed {rec_dyn.recovered_records} WAL records")
        check(np.array_equal(got, want),
              f"the recovered oracle differs from the never-crashed one on "
              f"{int((got != want).sum())} of {qc.shape[0]} queries")
        rec["recovery"] = {"seconds": t_recover, "wal_records": rec_dyn.recovered_records,
                           "epoch": rec_dyn.epoch, "launches": launches,
                           "never_crashed_launches": want_launches,
                           "verdicts_equal_never_crashed": True}
        log(f"dynamic: recovered epoch {rec_dyn.epoch} in {t_recover:.3f} s, "
            f"{rec_dyn.recovered_records} WAL records replayed")

        # ---- 4. the daemon over the recovered oracle, one publish mid-run
        book = _EpochBook(rec_dyn)
        pub_batch = batches[DYN_ROUNDS + 1]

        held = {"lag": []}

        class _PublishingDaemon(ServeDaemon):
            """run_open_loop's daemon, publishing ``pub_batch`` once,
            ``DYN_PUBLISH_AT`` seconds after it starts, with a heartbeat
            that books how late the event loop wakes; its drain awaits the
            publish first."""

            async def start(self):
                await super().start()
                held["daemon"] = self

                async def later():
                    await asyncio.sleep(DYN_PUBLISH_AT)
                    return await self.publish(pub_batch)

                async def heartbeat():
                    while True:
                        t = time.perf_counter()
                        await asyncio.sleep(DYN_LAG_TICK)
                        held["lag"].append((t, time.perf_counter() - t - DYN_LAG_TICK))

                self._pub = asyncio.ensure_future(later())
                self._beat = asyncio.ensure_future(heartbeat())

            async def drain(self):
                await self._pub
                self._beat.cancel()
                return await super().drain()

        collections = []

        def on_gc(phase, info):
            collections.append((phase, info["generation"], time.perf_counter()))

        metrics.REGISTRY.reset()
        rec_dyn.engine.reset_stats()
        epoch_before = rec_dyn.epoch
        openloop.ServeDaemon = _PublishingDaemon
        gc.callbacks.append(on_gc)
        # ---- the counted run
        ops.reset_launches()
        try:
            rep = openloop.run_open_loop(
                book, g, rate_arrivals_per_s=DYN_DAEMON_RATE, arrival_batch=64,
                duration_s=DYN_DAEMON_SECONDS, deadline_ms=150.0,
                config=DaemonConfig(deadline_ms=150.0), seed=1, n_truth=0,
                fault_plan=None if not publish_stall else inject.Injector(
                    latency={"dynamic.publish": ([0], publish_stall)}))
        finally:
            openloop.ServeDaemon = ServeDaemon
            gc.callbacks.remove(on_gc)
        launches = dict(ops.LAUNCHES)
        # ----
        add(launches)
        rungs = (DaemonConfig().max_batch // 64).bit_length()
        check(rec_dyn.epoch == epoch_before + 1, "the daemon's publish did not land")
        check(not publish_stall or rep["faults"]["stalled"] == ["dynamic.publish[0]"],
              f"the publish stall did not fire as planned: {rep['faults']}")
        by_rung = {}
        for epoch, rung, q, ans, lc, _, _ in book.calls:
            want = rec_dyn.snapshot(epoch).query_batch(q, device=False)
            check(np.array_equal(ans, want),
                  f"daemon: a {rung} dispatch on epoch {epoch} differs from that epoch's "
                  f"host merge on {int((ans != want).sum())} queries")
            b = by_rung.setdefault(rung, {"dispatches": 0, "serve_batch": 0,
                                          "label_intersect": 0, "epochs": set()})
            b["dispatches"] += 1
            b["epochs"].add(epoch)
            for k in lc:
                b[k] += lc[k]
        pinned = by_rung.get("pinned", {"dispatches": 0, "label_intersect": 0})
        engine_sb = by_rung.get("engine", {}).get("serve_batch", 0)
        counters = held["daemon"].counters
        reg = metrics.REGISTRY
        books = {
            "answered": (reg.counter_value("daemon_requests_total", event="answered"),
                         rep["answered"]),
            "submitted": (reg.counter_value("daemon_requests_total", event="submitted"),
                          rep["submitted"]),
            "batches": (reg.counter_value("daemon_batches_total", rung="all"), rep["batches"]),
            "device_batches": (reg.counter_value("daemon_batches_total", rung="device"),
                               rep["device_batches"]),
            "pinned_epoch_batches": (reg.counter_value("daemon_batches_total",
                                                       rung="pinned_epoch"),
                                     counters["pinned_epoch_batches"]),
            "publishes": (reg.counter_value("daemon_publishes_total"), counters["publishes"]),
        }
        for k, (a, b) in books.items():
            check(a == b, f"daemon: registry {k} {a} != the daemon's books {b}")
        check(counters["publishes"] == 1, f"{counters['publishes']} publishes")
        check(pinned["dispatches"] == counters["pinned_epoch_batches"] > 0,
              f"{pinned['dispatches']} pinned dispatches booked, the daemon counted "
              f"{counters['pinned_epoch_batches']}")
        check("pinned_host" not in by_rung, "a pinned batch took the host rung")
        check(pinned["label_intersect"] > 0 and pinned["label_intersect"] <= pinned["dispatches"],
              f"pinned dispatches launched label_intersect {pinned['label_intersect']} times "
              f"for {pinned['dispatches']} dispatches")
        check(launches["serve_batch"] == rungs + engine_sb
              and launches["label_intersect"] == pinned["label_intersect"],
              f"daemon launches {launches}: {rungs} warm-up rungs, {engine_sb} engine and "
              f"{pinned['label_intersect']} pinned launches booked")
        check(not any(v for k, v in rep["degradation"].items() if k != "deadline_to_host"),
              f"daemon degradation {rep['degradation']}")
        # what served and what held the event loop during the publish: each
        # rung's dispatches that ended inside it, the longest dispatch, the
        # loop's wake-up lag, the collector's passes
        p0, p1 = book.publish_window
        inside = [c for c in book.calls if p0 <= c[6] <= p1]
        lag_in = [dt for t, dt in held["lag"] if p0 <= t <= p1]
        lag_out = [dt for t, dt in held["lag"] if not p0 <= t <= p1]
        starts = {}
        gc_runs = []
        for ph, gen, t in collections:
            if ph == "start":
                starts[gen] = t
            elif gen in starts:
                gc_runs.append((gen, starts.pop(gen), t))
        during_publish = {
            "seconds": p1 - p0,
            "dispatches": {r: sum(1 for c in inside if c[1] == r)
                           for r in sorted({c[1] for c in inside})},
            "longest_dispatch_ms": 1e3 * max((c[6] - c[5] for c in inside), default=0.0),
            "loop_lag_max_ms": 1e3 * max(lag_in, default=0.0),
            "loop_lag_p50_ms": 1e3 * float(np.median(lag_in)) if lag_in else None,
            "loop_lag_max_ms_outside": 1e3 * max(lag_out, default=0.0),
            "gc_passes": {f"gen{k}": sum(1 for gn, a, b in gc_runs if gn == k and p0 <= a <= p1)
                          for k in range(3)},
            "gc_ms": 1e3 * sum(b - a for gn, a, b in gc_runs if p0 <= a <= p1),
        }
        rec["daemon"] = {k: rep[k] for k in (
            "offered_qps", "sustained_qps", "n_arrivals", "submitted", "answered", "shed",
            "shed_rate", "p50_ms", "p99_ms", "p99_within_deadline", "batches",
            "device_batches", "degradation")}
        rec["daemon"].update({
            "publish_at_s": DYN_PUBLISH_AT, "publish_stall_s": publish_stall,
            "during_publish": during_publish,
            "epochs": [epoch_before, rec_dyn.epoch],
            "pinned_epoch_batches": pinned["dispatches"],
            "by_rung": {k: {**v, "epochs": sorted(v["epochs"])} for k, v in by_rung.items()},
            "launches": launches, "answers_equal_their_epoch": True,
            "registry_equals_books": True})
        log(f"dynamic daemon: {rep['answered']} of {rep['submitted']} answered, p50 "
            f"{rep['p50_ms']} ms p99 {rep['p99_ms']} ms, {pinned['dispatches']} pinned "
            f"batches ({pinned['label_intersect']} label_intersect launches), shed "
            f"{rep['shed']}; during the {during_publish['seconds']:.3f} s publish (stall "
            f"{publish_stall} s): dispatches {during_publish['dispatches']}, loop lag max "
            f"{during_publish['loop_lag_max_ms']:.1f} ms, collector "
            f"{during_publish['gc_passes']} {during_publish['gc_ms']:.1f} ms")
        del rec_dyn, book, held
        gc.unfreeze()
    rec["launches"] = k1
    rec["seconds"] = time.perf_counter() - t_phase
    record(rec)
    return {"launches": k1, "residues": residues}


# ------------------------------------------------------------------ phase 4j

# The substrate's serving paths at full_config() widths (src/repro/configs/),
# weights from the port's init_params and a seeded torch.Generator.  Each LM:
# prefill at batch 1 (granite at train_4k's length and at prefill_32k's, its
# batch cut from 32; danube at 8,192, where its window of 4,096 cuts; the
# others at 4,096), then decode at batch 8 (decode_32k's batch cut from 128):
# granite feeds 8 prompts of 256 tokens through decode_step and then 64
# greedy tokens (a cache of 320), the others take 16 steps over a cache
# filled with random keys and values to 4,160 positions (past danube's
# window).  Then the check step: one step of that decode once more (granite's
# at kv_len 300 of its 320, the others' first, 4,161 of 4,176).  The last
# layer's K4 call of each prefill and of the check step is kept for K4's
# records.  granite and the MoE once more in float32 (fresh weights, the
# check step over the same cache; granite's prefill at 4,096 and decode
# against forward over 2 x 64 tokens).  deepseek-v2-lite (MLA): prefill 1 x
# 4,096 through K4 at a query/key width of 192 and a value width of 128, 16
# decode steps over a compressed cache filled with random latents to 4,160
# (its decode is float32 einsums, no K4: there is no check step against K4's
# plain version); float32 at 2 of its layers: prefill, its logits against
# the plain version, decode against forward.  xDeepFM: serve_p99 (200 batches of
# 512), serve_bulk (262,144 rows in slabs of 16,384: a slab's CIN
# intermediate is 5.1 GB, the whole batch's 82 GB) and retrieval_cand (1 user
# x 1,000,000 candidates in the JAX package's chunks of 25,000).
SUBSTRATE_LMS = {
    # arch: prefill lengths, how the decode cache is filled, the bfloat16
    # logits of a prefill against K4's plain version, a float32 re-check
    "granite-3-2b": {"prefill": (4096, 32768), "fill": "prompt",
                     "logits_vs_plain": True, "float32": True},
    "h2o-danube-1.8b": {"prefill": (8192,), "fill": "random",
                        "logits_vs_plain": False, "float32": False},
    "deepseek-7b": {"prefill": (4096,), "fill": "random",
                    "logits_vs_plain": False, "float32": False},
    "granite-moe-1b-a400m": {"prefill": (4096,), "fill": "random",
                             "logits_vs_plain": False, "float32": True},
    "deepseek-v2-lite-16b": {"prefill": (4096,), "fill": "random",
                             "logits_vs_plain": False, "float32": True},
}
# 4j's LM depth: each LM keeps at most SUBSTRATE_LAYERS of its layers
# (granite-3-2b's 320 decode steps took 16 of 4j's 50 s at all 40), widths,
# vocabulary, prompt and cache lengths as they are; the float32 re-checks
# run the same depth (deepseek-v2-lite's MLA_F32_LAYERS, fewer)
# (10 until phase 4l gained (d) and (e), 6 since, as phase 4h's DYN_ROUNDS
# 1, phase 4k's 3 granite steps, phase 4l (a)'s one bfloat16 step and (b)'s
# 4 microbatches, for their time)
SUBSTRATE_LAYERS = 6
# deepseek-v2-lite's float32 re-check keeps 2 of its 27 layers (27 would be
# 64 GB of float32 weights) and a capacity factor of E / k, so that no token
# is dropped: decode against forward holds only where both route alike
MLA_F32_LAYERS = 2
LM_DECODE_BATCH = 8
GRANITE_PROMPT, GRANITE_GREEDY, GRANITE_CHECK_KV_LEN = 256, 64, 300
CACHE_FILLED, FILLED_STEPS = 4160, 16
F32_DECODE_TOKENS = (2, 64)
# a prefill's K4 call past 8,192 query rows is held to its plain version on
# its last rows only (the plain version of a 32k call would hold 137 GB of
# logits)
K4_RECORD_ROWS = 1024
XDEEPFM_P99 = (200, 512)
XDEEPFM_BULK = (262_144, 16_384)
XDEEPFM_CANDIDATES, XDEEPFM_CHUNK = 1_000_000, 25_000
# the checks' bounds: float32 logits through K4 against the same weights and
# tokens through K4's plain version, and decode against forward (each
# attention agrees to 2e-5; 40 layers of residual adds keep the logits, rms
# ~1, within 1e-3).  bfloat16 logits against the plain version: each
# attention output is within one bfloat16 step of the plain one, and 24-40
# layers of random weights in bfloat16 carry such a step on, so the bound is
# relative to the logits' rms (max abs; deepseek-7b's first decode step
# measured 0.20 of it on an H100), with, over the 4,096 positions of a prefill, the
# share whose top-1 token agrees (a wrong mask or a wrong key would leave
# next to none).  The check step holds the bound against wrong attentions
# too (WRONG_ATTENTION): it must reject the one that drops chunks of keys.
# K4 itself is held at ATTENTION_TOL at every captured call.
SUBSTRATE_F32_ATOL = 1e-3
SUBSTRATE_BF16 = {"max_abs_over_rms": 0.5, "top1": 0.8}
WRONG_ATTENTION = ("dropped_chunks", "kv_len_minus_1")
XDEEPFM_ATOL = 1e-5
# The GNN family at full_config() widths (src/repro/configs/gcn_cora.py,
# gatedgcn_cfg.py, schnet_cfg.py, graphcast_cfg.py): GCN on K5 at
# full_graph_sm (a random DAG of Cora's n and m, edges padded by _pad_to,
# d_in 1,433) and at ogb_products (the shape's n and m padded by _pad_to,
# edges and features d 100 drawn on the card, 61,859,140 of the padded edges
# valid), each forward read for its n_layers = 2 K5 launches and held against
# the same forward through K5's plain version; gatedgcn at full_graph_sm and
# schnet at molecule (128 molecules of 30 atoms and 64 edges), float32, each
# held against the same forward on the CPU; graphcast in bfloat16 at
# full_graph_sm's mesh_dims held against its float32 re-run on the card.
GCN_PLAIN_TOL = 1e-5        # rtol and atol: K5 and its plain version sum in other orders
GNN_CPU_TOL = 1e-4          # rtol and atol: the card's index_add_ sums as its atomics land
# graphcast's decoded delta in bfloat16 against the float32 re-run, relative
# to the float32 delta's rms: the largest difference and the rms of the
# difference (random weights grow the residual stream ~16x a layer; bfloat16
# keeps about 3 digits a product)
GRAPHCAST_BF16 = {"max_abs_over_rms": 0.5, "rms_over_rms": 0.05}
# phase 4l (d): graphcast's per-rank loss in its own bfloat16 on 4 ranks
# against loss_fn on one, ||mine - ref|| / ||ref|| for the loss and each
# gradient leaf.  The partials are summed in float32 and rounded once as on
# one rank, but each rank's products see a quarter of the edges and the
# card's atomics land in another order: bfloat16 roundings (a step 2^-8)
# that differ and grow through 16 layers, as granite's bf16 training check
# (TRAIN_BF16_REL) allows
DIST_GRAPHCAST_BF16_REL = 0.05
MOLECULES, MOLECULE_ATOMS, MOLECULE_EDGES, ATOM_TYPES = 128, 30, 64, 10


def _plain(name: str):
    """Patch ``ops.<name>`` with its plain version for the block: the same
    model over the same weights with K4, K5 or K6 replaced, the yardstick."""
    from unittest import mock

    from repro_torch.kernels import ops, ref

    plain = {"flash_attention": ref.flash_attention_ref,
             # GCN passes the transposed rows too, for its backward
             "ell_spmm": lambda nbr, wgt, x, *transposed: ref.ell_spmm_ref(nbr, wgt, x),
             "embedding_bag": ref.embedding_bag_ref}[name]
    return mock.patch.object(ops, name, plain)


def _wrong_attention(kind: str):
    """Patch ``ops.flash_attention`` for the block with a wrong attention, a
    control for the model-level bound: the plain version without every
    fourth 32-key chunk of the prefix from the second on ("dropped_chunks")
    or without the newest key ("kv_len_minus_1")."""
    from unittest import mock

    import torch

    from repro_torch.kernels import ops, ref

    def attend(q, k, v, causal=True, window=None, kv_len=None):
        n = k.shape[2] if kv_len is None else kv_len
        if kind == "kv_len_minus_1":
            return ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_len=n - 1)
        keep = (torch.arange(n, device=k.device) // 32) % 4 != 1
        return ref.flash_attention_ref(q, k[:, :, :n][:, :, keep], v[:, :, :n][:, :, keep],
                                       causal=causal, window=window)

    return mock.patch.object(ops, "flash_attention", attend)


class _Calls:
    """``ops.<name>`` for the block, keeping the arguments and output of
    every call."""

    def __init__(self, name: str):
        self.name, self.calls = name, []

    def keep(self, args, kw, out) -> None:
        self.calls.append((args, out))

    def __enter__(self):
        from unittest import mock

        from repro_torch.kernels import ops

        kernel = getattr(ops, self.name)

        def call(*args, **kw):
            out = kernel(*args, **kw)
            self.keep(args, kw, out)
            return out

        self._patch = mock.patch.object(ops, self.name, call)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class _Capture(_Calls):
    """``ops.flash_attention`` for the block, keeping the inputs and output
    of its last call (a model's last layer); a cache's keys and values are
    cloned, since the steps after it write them."""

    def __init__(self):
        super().__init__("flash_attention")

    def keep(self, args, kw, out) -> None:
        q, k, v = args
        if kw.get("kv_len") is not None:
            k, v = k.clone(), v.clone()
        self.last = (q, k, v, kw, out)

    def k4_call(self, label: str, rows=None) -> tuple:
        """(label, configuration, q, k, v, out) of the last call, for
        ``_attention_record``; with ``rows``, q and out are cut to their last
        ``rows`` query rows (the queries stay right-aligned to the keys)."""
        q, k, v, kw, out = self.last
        if rows is not None and q.shape[2] > rows:
            q, out = q[:, :, -rows:], out[:, :, -rows:]
            label += f", its last {rows} query rows"
        q, out = q.contiguous(), out.contiguous()
        B, Hq, S, D = q.shape
        c = dict(B=B, Hq=Hq, Hkv=k.shape[1], S=S, T=k.shape[2], D=D, Dv=v.shape[3],
                 causal=kw["causal"], window=kw.get("window"),
                 dtype=str(q.dtype).removeprefix("torch."))
        if kw.get("kv_len") is not None:
            c["kv_len"] = kw["kv_len"]
        return f"{label} (phase 4j)", c, q, k, v, out


class _Counted:
    """Launch counts read around exactly each counted call, summed."""

    def __init__(self):
        self.total: dict = {}

    def __call__(self, fn, want: dict, what: str):
        import torch

        from repro_torch.kernels import ops

        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(got == want, f"{what}: launches {got}, not {want}")
        for k, v in got.items():
            self.total[k] = self.total.get(k, 0) + v
        return out


def _host_ms(fn, reps: int) -> list:
    """Host-clock ms of ``reps`` calls, each ended by a synchronise."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _agreement(got, exp) -> dict:
    """max |got - exp| and the share of rows whose argmax agrees."""
    return {"max_abs": float((got - exp).abs().max()),
            "exp_rms": float(exp.pow(2).mean().sqrt()),
            "top1": float((got.argmax(-1) == exp.argmax(-1)).float().mean())}


def _within(agree: dict, top1: bool) -> bool:
    """``_agreement`` within SUBSTRATE_BF16: max abs, and with ``top1`` the
    top-1 share too."""
    return (agree["max_abs"] <= SUBSTRATE_BF16["max_abs_over_rms"] * agree["exp_rms"]
            and (not top1 or agree["top1"] >= SUBSTRATE_BF16["top1"]))


def _lm_prefill(count, cfg, params, gen, device, S: int, vocab: int) -> dict:
    """Prefill at batch 1 x S: launches read around the first call, then two
    timed calls (one past 8,192 tokens); ms and tokens/s."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    toks = torch.randint(0, vocab, (1, S), generator=gen, device=device, dtype=torch.int32)
    out = count(lambda: tf.prefill(cfg, params, toks),
                {ops.attention_kernel(cfg.dtype): cfg.n_layers}, f"{cfg.name} prefill 1 x {S}")
    check(out.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(out).all()),
          f"{cfg.name} prefill 1 x {S}: logits {tuple(out.shape)} not finite")
    runs = _host_ms(lambda: tf.prefill(cfg, params, toks), 2 if S <= 8192 else 1)
    return {"S": S, "ms": min(runs), "ms_runs": runs, "tokens_per_s": S / min(runs) * 1e3}


def _logits_vs_plain(cfg, params, gen, device, vocab: int, S: int) -> dict:
    """forward's logits over 1 x S random tokens against the same model
    through K4's plain version: within SUBSTRATE_F32_ATOL in float32, within
    SUBSTRATE_BF16 (max abs and top-1) in bfloat16."""
    import torch

    from repro_torch.models import transformer as tf

    toks = torch.randint(0, vocab, (1, S), generator=gen, device=device, dtype=torch.int32)
    got = tf.forward(cfg, params, toks)[0][0]
    with _plain("flash_attention"):
        exp = tf.forward(cfg, params, toks)[0][0]
    agree = _agreement(got, exp)
    if cfg.dtype == torch.float32:
        check(agree["max_abs"] <= SUBSTRATE_F32_ATOL, f"{cfg.name} float32 logits against "
              f"K4's plain version: {agree}, atol {SUBSTRATE_F32_ATOL}")
        return {**agree, "tokens": S, "atol": SUBSTRATE_F32_ATOL}
    check(_within(agree, top1=True), f"{cfg.name} bfloat16 logits against K4's plain "
          f"version: {agree}, bound {SUBSTRATE_BF16}")
    return {**agree, "tokens": S, "bound": SUBSTRATE_BF16}


def _lm_decode(count, cfg, params, gen, device, vocab: int, fill: str) -> tuple:
    """The request batch through decode_step, each step on the host clock.
    ``fill`` "prompt": GRANITE_PROMPT prompt tokens into an empty cache, then
    GRANITE_GREEDY greedy ones; "random": FILLED_STEPS random tokens into a
    cache filled with random keys and values to CACHE_FILLED.  Returns the
    cache, the tokens fed [B, steps] (the first at the record's ``start``)
    and the record."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    B = LM_DECODE_BATCH
    start, n_feed, greedy = ((0, GRANITE_PROMPT, GRANITE_GREEDY) if fill == "prompt"
                             else (CACHE_FILLED, FILLED_STEPS, 0))
    feed = torch.randint(0, vocab, (B, n_feed), generator=gen, device=device, dtype=torch.int32)
    n = n_feed + greedy
    cache = tf.init_cache(cfg, B, start + n, device)
    for name in ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v"):
        # positions are axis 2 of MLA's [L, B, T, w], axis 3 of [L, B, Hkv, T, Dh]
        cache[name].narrow(2 if cfg.mla is not None else 3, 0, start).normal_(generator=gen)
    cache["pos"] = start
    fed, step_ms = [], []

    def drive():
        tok = None
        for t in range(n):
            inp = feed[:, t:t + 1] if t < n_feed else tok
            fed.append(inp)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, _ = tf.decode_step(cfg, params, cache, inp)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        return logits

    last = count(drive, _decode_launches(cfg, n), f"{cfg.name} decode {n} steps at batch {B}")
    fed = torch.cat(fed, dim=1)
    check(cache["pos"] == start + n and bool(torch.isfinite(last).all())
          and bool(((fed >= 0) & (fed < cfg.vocab)).all()),
          f"{cfg.name} decode: pos {cache['pos']}, logits not finite or tokens out of range")
    rec = {"batch": B, "fill": fill, "start": start, "fed": n_feed, "greedy": greedy,
           "cache": start + n, "window_cuts": cfg.window is not None and cfg.window < start + n,
           "step_ms_p50": float(np.median(step_ms)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "tokens_per_s": B / float(np.median(step_ms)) * 1e3}
    if greedy:
        rec.update(step_ms_p50_fed=float(np.median(step_ms[:n_feed])),
                   step_ms_p50_greedy=float(np.median(step_ms[n_feed:])),
                   distinct_greedy_tokens=int(torch.unique(fed[:, n_feed:]).numel()))
    else:
        rec["step_ms_runs"] = step_ms
    return cache, fed, rec


def _decode_launches(cfg, steps: int) -> dict:
    """K4's launches over ``steps`` decode steps: n_layers a step, MLA's none
    (its decode is float32 einsums over the compressed cache)."""
    from repro_torch.kernels import ops

    return {} if cfg.mla is not None else {ops.attention_kernel(cfg.dtype): steps * cfg.n_layers}


def _decode_profile(name: str, step, kernel: str) -> dict:
    """One decode step under torch.profiler: K4's share of the device time
    and the device's busy share of the step."""
    wall_ms, events = _device_events(step)
    pattern = re.compile("|".join(rf"(?<!\w){s}[<(]" for s in ATTENTION_SYMBOLS[kernel]))
    busy = sum(us for cat, _, us in events if cat == "kernel")
    k4 = sum(us for cat, name_, us in events if cat == "kernel" and pattern.search(name_))
    check(k4 > 0, f"{name}: the profiled decode step shows no {kernel}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3, "k4_device_ms": k4 / 1e3,
            "k4_share_of_device": k4 / busy, "device_busy_share": busy / 1e3 / wall_ms,
            "kernels": sum(1 for cat, _, _ in events if cat == "kernel")}


def _lm_check_step(count, cfg, params, cache, tok, kv_len: int) -> tuple:
    """The decode step at ``kv_len`` once more over the cache the request
    batch wrote (its token ``tok``, so the same keys and values at its
    position): read for launches, its last layer's K4 call captured, its
    logits against the same step through K4's plain version.  A dense LM's
    are held to SUBSTRATE_BF16's max abs, which must reject the step through
    the attention that drops chunks of keys (WRONG_ATTENTION, both
    reported); a MoE's difference is reported (routing is discrete: a
    bfloat16 step of difference moves tokens between experts and past the
    capacity) and its float32 re-check holds the bound.  Then the step under
    torch.profiler.  Returns the record and the captured call."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    kernel = ops.attention_kernel(cfg.dtype)
    end = cache["pos"]

    def step():
        cache["pos"] = kv_len - 1
        return tf.decode_step(cfg, params, cache, tok)[0][:, 0]

    with _plain("flash_attention"):
        exp = step()
    with _Capture() as cap:
        got = count(step, {kernel: cfg.n_layers}, f"{cfg.name} decode step at kv_len {kv_len}")
    rec = {"kv_len": kv_len, "vs_plain": _agreement(got, exp)}
    if cfg.moe is None:
        controls = {}
        for kind in WRONG_ATTENTION:
            with _wrong_attention(kind):
                controls[kind] = _agreement(step(), exp)
            controls[kind]["rejected"] = not _within(controls[kind], top1=False)
        check(_within(rec["vs_plain"], top1=False), f"{cfg.name} decode step against K4's "
              f"plain version: {rec['vs_plain']}, bound {SUBSTRATE_BF16}")
        check(controls["dropped_chunks"]["rejected"], f"{cfg.name}: the decode step's bound "
              f"passes an attention that drops chunks of keys: {controls}")
        rec.update(bound=SUBSTRATE_BF16, controls=controls)
    rec["profiled_step"] = _decode_profile(cfg.name, step, kernel)
    cache["pos"] = end
    window = f", window {cfg.window}" if cfg.window is not None else ""
    return rec, cap.k4_call(f"{cfg.name} decode step at batch {tok.shape[0]}, kv_len {kv_len} "
                            f"of a {cache['k'].shape[3]} cache{window}")


def _lm_float32(count, mod, gen, device, cache, tok, kv_len: int) -> tuple:
    """The LM once more in float32 at the same width, on K4's CUDA-core
    kernel, with fresh weights: the check step over the bfloat16 run's cache
    against the same step through K4's plain version, within
    SUBSTRATE_F32_ATOL; a dense LM and MLA (at MLA_F32_LAYERS of its layers,
    no token dropped) also prefill at 4,096 (its last layer's K4 call
    captured), its logits against the plain version, and decode against
    forward over F32_DECODE_TOKENS.  Returns the record and the captured
    calls."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(_substrate_config(mod), dtype=torch.float32)
    rec = {}
    if cfg.mla is not None:
        mo = cfg.moe
        cfg = dataclasses.replace(cfg, n_layers=MLA_F32_LAYERS, moe=dataclasses.replace(
            mo, capacity_factor=mo.n_experts / mo.top_k))
        rec["cut"] = {"n_layers": MLA_F32_LAYERS, "capacity_factor": cfg.moe.capacity_factor}
    V = getattr(mod, "VOCAB_REAL", cfg.vocab)
    params = tf.init_params(cfg, gen, device)
    if cfg.mla is None:   # MLA's decode step calls no K4: its check is decode vs forward
        cache32 = {"k": cache["k"].float(), "v": cache["v"].float()}

        def step():
            cache32["pos"] = kv_len - 1
            return tf.decode_step(cfg, params, cache32, tok)[0][:, 0]

        with _plain("flash_attention"):
            exp = step()
        agree = _agreement(count(step, {"flash_attention": cfg.n_layers},
                                 f"{cfg.name} float32 decode step at kv_len {kv_len}"), exp)
        check(agree["max_abs"] <= SUBSTRATE_F32_ATOL, f"{cfg.name} float32 decode step "
              f"against K4's plain version: {agree}, atol {SUBSTRATE_F32_ATOL}")
        rec["check_step"] = {**agree, "kv_len": kv_len, "atol": SUBSTRATE_F32_ATOL}
        del cache32, exp
    calls = []
    if cfg.moe is None or cfg.mla is not None:
        with _Capture() as cap:
            rec["prefill"] = _lm_prefill(count, cfg, params, gen, device, 4096, V)
        calls.append(cap.k4_call(f"{cfg.name} float32 prefill 1 x 4096, the last layer's call"))
        rec["vs_plain_4096"] = _logits_vs_plain(cfg, params, gen, device, V, 4096)
        b, n = F32_DECODE_TOKENS
        toks = torch.randint(0, V, (b, n), generator=gen, device=device, dtype=torch.int32)
        fwd = tf.forward(cfg, params, toks)[0]
        dec_cache = tf.init_cache(cfg, b, n, device)
        torch.cuda.synchronize()
        t_dec = time.perf_counter()
        dec = count(lambda: torch.cat([tf.decode_step(cfg, params, dec_cache, toks[:, t:t + 1])[0]
                                       for t in range(n)], dim=1),
                    _decode_launches(cfg, n), f"{cfg.name} float32 decode")
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t_dec) * 1e3 / n
        agree = _agreement(dec, fwd)
        check(agree["max_abs"] <= SUBSTRATE_F32_ATOL, f"{cfg.name} float32 decode against "
              f"forward: {agree}, atol {SUBSTRATE_F32_ATOL}")
        rec["decode_vs_forward"] = {**agree, "tokens": [b, n], "atol": SUBSTRATE_F32_ATOL,
                                    "ms_a_step_mean": dec_ms}
        del fwd, dec, dec_cache
    del params
    torch.cuda.empty_cache()
    return rec, calls


def _substrate_config(mod):
    """``mod.full_config()`` at 4j's depth (SUBSTRATE_LAYERS)."""
    import dataclasses

    cfg = mod.full_config()
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, SUBSTRATE_LAYERS))


def _lm(count, device, gen, mod) -> tuple:
    """An LM at full_config() in bfloat16, as SUBSTRATE_LMS says: prefill at
    each length (its last layer's K4 call captured), the logits of a prefill
    against K4's plain version, the request batch through decode_step, the
    check step, and the float32 re-check.  Returns the record and the
    captured K4 calls."""
    import torch

    from repro_torch.models import transformer as tf

    run = SUBSTRATE_LMS[mod.ARCH_ID]
    cfg = _substrate_config(mod)
    V = getattr(mod, "VOCAB_REAL", cfg.vocab)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, gen, device)
    torch.cuda.synchronize()
    rec = {"arch": cfg.name, "dtype": "bfloat16", "n_layers": cfg.n_layers,
           "init_seconds": time.perf_counter() - t0,
           "param_count": cfg.param_count(), "active_param_count": cfg.active_param_count(),
           "prefill": []}
    calls = []
    for S in run["prefill"]:
        with _Capture() as cap:
            rec["prefill"].append(_lm_prefill(count, cfg, params, gen, device, S, V))
        calls.append(cap.k4_call(f"{cfg.name} prefill 1 x {S}, the last layer's call",
                                 K4_RECORD_ROWS if S > 8192 else None))
    if run["logits_vs_plain"]:
        rec["vs_plain_4096"] = _logits_vs_plain(cfg, params, gen, device, V, 4096)
    cache, fed, rec["decode"] = _lm_decode(count, cfg, params, gen, device, V, run["fill"])
    kv_len = GRANITE_CHECK_KV_LEN if run["fill"] == "prompt" else CACHE_FILLED + 1
    at = kv_len - 1 - rec["decode"]["start"]
    tok = fed[:, at:at + 1]
    if cfg.mla is None:   # MLA's decode step calls no K4: nothing to hold it against here
        rec["decode"]["check_step"], call = _lm_check_step(count, cfg, params, cache, tok,
                                                           kv_len)
        calls.append(call)
    del params
    torch.cuda.empty_cache()
    if run["float32"]:
        rec["float32"], mine = _lm_float32(count, mod, gen, device, cache, tok, kv_len)
        calls += mine
    del cache
    torch.cuda.empty_cache()
    record({"phase": "substrate_model", **rec})
    return rec, calls


def _xdeepfm(count, device, gen) -> tuple:
    """xDeepFM at full_config(): serve_p99, serve_bulk in slabs and
    retrieval_cand in chunks, each read for launches (2 a forward); a
    batch's logits against the plain gathers; retrieval against forward on
    the broadcast ids for its first chunk.  Returns the record and the two
    gathers of a serve_bulk slab (label, table, ids), for K6's kernel record."""
    import torch

    from repro_torch.configs import xdeepfm_cfg
    from repro_torch.models.recsys import xdeepfm

    cfg = xdeepfm_cfg.full_config()
    t0 = time.perf_counter()
    params = xdeepfm.init_params(cfg, gen, device)
    torch.cuda.synchronize()
    rec = {"arch": cfg.name, "init_seconds": time.perf_counter() - t0,
           "table_bytes": params["table"].numel() * 4}

    def ids(B):
        return torch.randint(0, cfg.vocab_per_field, (B, cfg.n_fields), generator=gen,
                             device=device, dtype=torch.int32)

    def fwd(x):
        return xdeepfm.forward(cfg, params, x)

    # serve_p99: batches of 512, a host clock around each (ended by a synchronise)
    nb, B = XDEEPFM_P99
    batches = [ids(B) for _ in range(nb)]
    fwd(batches[0])
    lat = []

    def serve():
        for x in batches:
            lat.extend(_host_ms(lambda: fwd(x), 1))

    count(serve, {"embedding_bag": 2 * nb}, f"xDeepFM serve_p99 {nb} x {B}")
    got = fwd(batches[0])
    with _plain("embedding_bag"):
        exp = fwd(batches[0])
    err = float((got - exp).abs().max())
    check(got.shape == (B,) and bool(torch.isfinite(got).all()) and err <= XDEEPFM_ATOL,
          f"xDeepFM logits against the plain gathers: {err}, atol {XDEEPFM_ATOL}")
    rec["serve_p99"] = {"batches": nb, "batch": B, "p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99)), "max_ms": max(lat),
                        "vs_plain_max_abs": err, "atol": XDEEPFM_ATOL}

    # serve_bulk: 262,144 rows in slabs
    n, slab = XDEEPFM_BULK
    bulk = ids(n)
    fwd(bulk[:slab])
    outs = []
    secs = _host_ms(lambda: outs.append(count(
        lambda: torch.cat([fwd(bulk[i:i + slab]) for i in range(0, n, slab)]),
        {"embedding_bag": 2 * (n // slab)}, f"xDeepFM serve_bulk {n} in slabs of {slab}")), 1)
    check(outs[0].shape == (n,) and bool(torch.isfinite(outs[0]).all()),
          "xDeepFM serve_bulk: logits not finite")
    rec["serve_bulk"] = {"rows": n, "slab": slab, "seconds": secs[0] / 1e3,
                         "rows_per_s": n / secs[0] * 1e3}
    rows = xdeepfm._field_ids(cfg, bulk[:slab]).contiguous()
    bags = [("xDeepFM serve_bulk slab: the embedding rows, bags of one id (phase 4j)",
             params["table"], rows.view(-1, 1)),
            ("xDeepFM serve_bulk slab: the linear term, one bag of 39 ids (phase 4j)",
             params["linear"].view(-1, 1), rows)]
    del outs, bulk

    # retrieval_cand: one user against 1,000,000 candidates in chunks of 25,000
    user = ids(1)
    cands = torch.randint(0, cfg.vocab_per_field, (XDEEPFM_CANDIDATES,), generator=gen,
                          device=device, dtype=torch.int32)
    chunk = XDEEPFM_CHUNK
    out = []
    secs = _host_ms(lambda: out.append(count(
        lambda: xdeepfm.retrieval_score(cfg, params, user, cands, chunk=chunk),
        {"embedding_bag": 2 * -(-XDEEPFM_CANDIDATES // chunk)},
        f"xDeepFM retrieval_cand 1 x {XDEEPFM_CANDIDATES}")), 1)
    scores = out[0]
    m = min(chunk, XDEEPFM_CANDIDATES)
    first = user.expand(m, cfg.n_fields).clone()
    first[:, 0] = cands[:m]
    err = float((fwd(first) - scores[:m]).abs().max())
    check(scores.shape == (XDEEPFM_CANDIDATES,) and bool(torch.isfinite(scores).all())
          and err <= 1e-6, f"xDeepFM retrieval against forward on its first chunk: {err}")
    rec["retrieval_cand"] = {"candidates": XDEEPFM_CANDIDATES, "chunk": chunk,
                             "seconds": secs[0] / 1e3, "vs_forward_first_chunk": err}
    record({"phase": "substrate_model", **rec})
    return rec, bags


def _tree_map(fn, tree):
    """``fn`` over the tensors of a params tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _graph_rates(name: str, fn, n: int, m: int, smi: str) -> dict:
    """Two host-clock runs of a forward (each ended by a synchronise): ms,
    nodes/s and edges/s of the faster, the card beside them."""
    runs = _host_ms(fn, 2)
    ms = min(runs)
    log(f"4j {name}: {ms:.3f} ms a forward, {n / ms * 1e3:.4g} nodes/s, "
        f"{m / ms * 1e3:.4g} edges/s [{smi}]")
    return {"ms": ms, "ms_runs": runs, "nodes": n, "edges": m,
            "nodes_per_s": n / ms * 1e3, "edges_per_s": m / ms * 1e3}


def _gcn(count, device, gen, shape: str, smi: str) -> tuple:
    """GCN at full_config() on one shape: its ELL built, the forward read for
    its two K5 launches and held against the forward through K5's plain
    version within GCN_PLAIN_TOL, timed.  Returns the record and the two K5
    calls (label, nbr, wgt, h, out)."""
    import torch

    from repro_torch.configs import gcn_cora
    from repro_torch.configs.gnn_cells import GNN_SHAPES, shape_dims
    from repro_torch.data.synth import graph_batch_from_csr
    from repro_torch.graph.generators import random_dag
    from repro_torch.models.gnn import gcn
    from repro_torch.models.gnn.layers import GraphBatch

    info = GNN_SHAPES[shape]
    n_pad, m_pad, d_feat = shape_dims(shape)
    if shape == "full_graph_sm":
        g = graph_batch_from_csr(random_dag(info["n"], info["m"], seed=0), d_feat,
                                 n_classes=7, pad_edges_to=m_pad, device=device)
    else:   # drawn on the card: the shape is too large for a host graph
        n, m = info["n"], info["m"]
        ids = lambda: torch.randint(0, n, (m_pad,), generator=gen, device=device,  # noqa: E731
                                    dtype=torch.int32)
        g = GraphBatch(
            x=torch.randn((n_pad, d_feat), generator=gen, device=device),
            edge_src=ids(), edge_dst=ids(),
            edge_mask=torch.arange(m_pad, device=device) < m,
            node_mask=torch.arange(n_pad, device=device) < n,
            y=torch.randint(0, 7, (n_pad,), generator=gen, device=device, dtype=torch.int32))
    cfg = gcn_cora.full_config(d_in=d_feat)
    params = gcn.init_params(cfg, gen, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ell = gcn.graph_ell(g)
    torch.cuda.synchronize()
    ell_s = time.perf_counter() - t0
    with _Calls("ell_spmm") as cap:
        got = count(lambda: gcn.forward(cfg, params, g, ell), {"ell_spmm": cfg.n_layers},
                    f"GCN forward at {shape}")
    with _plain("ell_spmm"):
        exp = gcn.forward(cfg, params, g, ell)
    err = float((got - exp).abs().max())
    n, m = g.x.shape[0], int(g.edge_mask.sum())
    check(got.shape == (n, cfg.n_classes) and bool(torch.isfinite(got).all())
          and torch.allclose(got, exp, rtol=GCN_PLAIN_TOL, atol=GCN_PLAIN_TOL),
          f"GCN at {shape} against its forward through K5's plain version: {err}")
    rec = {"arch": cfg.name, "shape": shape, "n": n, "edges": m, "edges_padded": g.edge_src.numel(),
           "d_in": d_feat, "ell_width": ell.nbr.shape[1],
           "ell_width_transposed": ell.nbr_t.shape[1], "ell_seconds": ell_s,
           "vs_plain_max_abs": err, "tol": GCN_PLAIN_TOL,
           **_graph_rates(f"GCN {shape}", lambda: gcn.forward(cfg, params, g, ell), n, m, smi)}
    calls = [(f"GCN {shape} layer {i + 1}, F = {args[2].shape[1]} (phase 4j)", *args[:3], out)
             for i, (args, out) in enumerate(cap.calls)]
    return rec, calls


def _vs_cpu(name: str, mod, cfg, params, batch, *extra) -> dict:
    """A GNN forward on the card against the same forward on the CPU, within
    GNN_CPU_TOL."""
    import torch

    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    got = mod.forward(cfg, params, batch, *extra)
    exp = mod.forward(cfg, _tree_map(cpu, params), type(batch)(*(cpu(a) for a in batch)),
                      *extra)
    err = float((got.cpu() - exp).abs().max())
    check(bool(torch.isfinite(got).all())
          and torch.allclose(got.cpu(), exp, rtol=GNN_CPU_TOL, atol=GNN_CPU_TOL),
          f"{name} on the card against the CPU: {err}, tol {GNN_CPU_TOL}")
    return {"vs_cpu_max_abs": err, "tol": GNN_CPU_TOL}


def _gnns(count, device, gen, smi: str) -> tuple:
    """The GNN family at full_config() (see GCN_PLAIN_TOL's comment): each
    forward read for its launches (GCN 2 of K5, the others none).  Returns
    the records and GCN's K5 calls at ogb_products."""
    import dataclasses

    import torch

    from repro_torch.configs import gatedgcn_cfg, graphcast_cfg, schnet_cfg
    from repro_torch.configs.gnn_cells import GNN_SHAPES, shape_dims
    from repro_torch.data.synth import graph_batch_from_csr
    from repro_torch.graph.generators import random_dag
    from repro_torch.models.gnn import gatedgcn, graphcast, schnet
    from repro_torch.models.gnn.layers import GraphBatch

    recs = []
    small, _ = _gcn(count, device, gen, "full_graph_sm", smi)
    big, calls = _gcn(count, device, gen, "ogb_products", smi)
    recs += [small, big]
    torch.cuda.empty_cache()

    # gatedgcn at full_graph_sm, float32
    info, (_, m_pad, d_feat) = GNN_SHAPES["full_graph_sm"], shape_dims("full_graph_sm")
    cfg = gatedgcn_cfg.full_config(d_in=d_feat)
    g = graph_batch_from_csr(random_dag(info["n"], info["m"], seed=0), d_feat,
                             n_classes=cfg.n_classes, d_edge=gatedgcn_cfg.D_EDGE,
                             pad_edges_to=m_pad, device=device)
    params = gatedgcn.init_params(cfg, gen, device)
    count(lambda: gatedgcn.forward(cfg, params, g), {}, "gatedgcn forward at full_graph_sm")
    rec = _vs_cpu("gatedgcn at full_graph_sm", gatedgcn, cfg, params, g)
    n, m = g.x.shape[0], int(g.edge_mask.sum())
    recs.append({"arch": cfg.name, "shape": "full_graph_sm", **rec,
                 **_graph_rates("gatedgcn full_graph_sm",
                                lambda: gatedgcn.forward(cfg, params, g), n, m, smi)})

    # schnet at molecule: 128 molecules of 30 atoms and 64 edges each, float32
    cfg = schnet_cfg.full_config()
    rng = np.random.default_rng(26)
    B, A, E = MOLECULES, MOLECULE_ATOMS, MOLECULE_EDGES
    base = np.repeat(np.arange(B) * A, E)
    src = (base + rng.integers(0, A, B * E)).astype(np.int32)
    dst = (base + rng.integers(0, A, B * E)).astype(np.int32)
    x = np.zeros((B * A, 16), np.float32)
    x[:, 0] = rng.integers(0, ATOM_TYPES, B * A)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    g = GraphBatch(x=t(x), edge_src=t(src), edge_dst=t(dst),
                   edge_mask=torch.ones(B * E, dtype=torch.bool, device=device),
                   node_mask=torch.ones(B * A, dtype=torch.bool, device=device),
                   pos=t(3.0 * rng.standard_normal((B * A, 3)).astype(np.float32)),
                   y=t(rng.standard_normal(B * A).astype(np.float32)))
    params = schnet.init_params(cfg, gen, device)
    count(lambda: schnet.forward(cfg, params, g), {}, "schnet forward at molecule")
    rec = _vs_cpu("schnet at molecule", schnet, cfg, params, g)
    recs.append({"arch": cfg.name, "shape": "molecule", **rec,
                 **_graph_rates("schnet molecule", lambda: schnet.forward(cfg, params, g),
                                B * A, B * E, smi)})

    # graphcast at full_graph_sm's mesh_dims in bfloat16, against float32
    cfg = graphcast_cfg.full_config()
    n_g, n_m, m_g2m, m_mesh, m_m2g = graphcast_cfg.mesh_dims("full_graph_sm")
    ri = lambda hi, m: torch.randint(0, hi, (m,), generator=gen, device=device,  # noqa: E731
                                     dtype=torch.int32)
    b = graphcast.MeshBatch(
        grid_x=torch.randn((n_g, cfg.n_vars), generator=gen, device=device),
        g2m_src=ri(n_g, m_g2m), g2m_dst=ri(n_m, m_g2m), mesh_src=ri(n_m, m_mesh),
        mesh_dst=ri(n_m, m_mesh), m2g_src=ri(n_m, m_m2g), m2g_dst=ri(n_g, m_m2g),
        target=torch.randn((n_g, cfg.n_vars), generator=gen, device=device))
    params = graphcast.init_params(cfg, gen, device)
    out = count(lambda: graphcast.forward(cfg, params, b, n_m), {},
                "graphcast forward at full_graph_sm's mesh")

    out32 = graphcast.forward(dataclasses.replace(cfg, dtype=torch.float32),
                              _tree_map(lambda t: t.float(), params), b, n_m)
    delta, delta32 = out - b.grid_x, out32 - b.grid_x
    rms = float(delta32.pow(2).mean().sqrt())
    agree = {"max_abs_over_rms": float((delta - delta32).abs().max()) / rms,
             "rms_over_rms": float((delta - delta32).pow(2).mean().sqrt()) / rms,
             "delta32_rms": rms}
    check(bool(torch.isfinite(out).all())
          and all(agree[k] <= v for k, v in GRAPHCAST_BF16.items()),
          f"graphcast bfloat16 against its float32 re-run: {agree}, bound {GRAPHCAST_BF16}")
    recs.append({"arch": cfg.name, "shape": "full_graph_sm mesh_dims", "dtype": "bfloat16",
                 "mesh_dims": [n_g, n_m, m_g2m, m_mesh, m_m2g], "vs_float32": agree,
                 "bound": GRAPHCAST_BF16,
                 **_graph_rates("graphcast full_graph_sm mesh",
                                lambda: graphcast.forward(cfg, params, b, n_m),
                                n_g + n_m, m_g2m + m_mesh * cfg.n_layers + m_m2g, smi)})
    del params, out, out32
    torch.cuda.empty_cache()
    for r in recs:
        record({"phase": "substrate_model", **r})
    return recs, calls


def phase_substrate(device, smi: str) -> dict:
    """Phase 4j: the LM family's prefill and KV-cache decode on K4 (MLA's
    prefill at D = 192, Dv = 128), the GNN family's forward (GCN on K5) and
    xDeepFM's online, bulk and retrieval scoring on K6, at full_config()
    widths on the card, each call's launch counts read around exactly it;
    ``smi`` is the card's name and power limit, printed beside every time.
    Returns {"launches": the counted calls' sums, "configs": {kernel: its
    records at the path's shapes}}."""
    import torch

    from repro_torch.configs import (deepseek_7b, deepseek_v2_lite_16b, granite_3_2b,
                                     granite_moe_1b_a400m, h2o_danube_1_8b)
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    count = _Counted()
    lm, calls = [], []
    for mod in (granite_3_2b, h2o_danube_1_8b, deepseek_7b, granite_moe_1b_a400m,
                deepseek_v2_lite_16b):
        rec, mine = _lm(count, device, gen, mod)
        lm.append(rec)
        calls += mine
    gnn, spmm = _gnns(count, device, gen, smi)
    xrec, bags = _xdeepfm(count, device, gen)
    launches = dict(count.total)
    torch.cuda.empty_cache()
    # K4 at every captured call of the path, K5 at GCN's two calls at
    # ogb_products, K6 at a serve_bulk slab's two gathers, each against its
    # plain version
    configs = {"flash_attention_sm90": [], "flash_attention": [], "ell_spmm": [],
               "embedding_bag": []}
    for label, c, q, k, v, out in calls:
        configs[ops.attention_kernel(q.dtype)].append(
            _attention_record(label, c, q, k, v, out, device))
    for label, nbr, wgt, h, out in spmm:
        configs["ell_spmm"].append(_spmm_record(label, nbr, wgt, h, out, device))
    for label, table, idx in bags:
        configs["embedding_bag"].append(_bag_record(label, table, idx,
                                                    ops.embedding_bag(table, idx)))
    del calls, spmm, bags
    torch.cuda.empty_cache()
    record({"phase": "substrate", "seconds": time.perf_counter() - t_start, "card": smi,
            "launches": launches,
            "models": [r["arch"] for r in lm] + [r["arch"] for r in gnn] + [xrec["arch"]]})
    for r in lm:
        pre = ", ".join(f"1 x {p['S']} {p['ms']:.1f} ms ({p['tokens_per_s']:.0f} tok/s)"
                        for p in r["prefill"])
        chk = r["decode"].get("check_step")
        tail = ""
        if chk is not None:
            against = ", ".join(f"{k} {v['max_abs'] / v['exp_rms']:.3f}"
                                for k, v in chk.get("controls", {}).items())
            tail = (f"; check step max abs / rms "
                    f"{chk['vs_plain']['max_abs'] / chk['vs_plain']['exp_rms']:.3f}"
                    + (f" (controls: {against})" if against else ""))
        log(f"4j {r['arch']}: prefill {pre}; decode p50 {r['decode']['step_ms_p50']:.2f} ms "
            f"a step at batch {r['decode']['batch']}{tail} [{smi}]")
    log(f"4j xdeepfm: serve_p99 p50 {xrec['serve_p99']['p50_ms']:.3f} ms, p99 "
        f"{xrec['serve_p99']['p99_ms']:.3f} ms; serve_bulk "
        f"{xrec['serve_bulk']['rows_per_s']:.0f} rows/s; retrieval "
        f"{xrec['retrieval_cand']['seconds']:.2f} s [{smi}]")
    return {"launches": launches, "configs": configs}


def merge_substrate(library: list, sub: dict) -> None:
    """K4's, K5's and K6's records of phase 3b take phase 4j as their main
    path: its launch counts (the kernel library's beside them) and its
    configurations; K5's head becomes GCN's first call at ogb_products (F =
    16) and K6's the serve_bulk slab's embedding gather, the main path's
    shapes (K4's head, granite prefill at 4,096, is already the path's)."""
    for rec in library:
        name = rec["name"]
        if name not in ("flash_attention_sm90", "flash_attention", "ell_spmm", "embedding_bag"):
            continue
        rec["launches_by_path"] = {"kernel_library": rec["launches"],
                                   "substrate": sub["launches"].get(name, 0)}
        rec["launches"] = sub["launches"].get(name, 0)
        mine = sub["configs"].get(name, [])
        rec["configs"] = rec["configs"] + mine
        rec["cases_checked"] += len(mine)
        if name in ("ell_spmm", "embedding_bag"):
            rec.update({k: mine[0][k] for k in HEAD_KEYS})


# ------------------------------------------------------------------ phase 4k

# Training at full_config() widths (src/repro/configs/granite_3_2b.py,
# xdeepfm_cfg.py, gcn_cora.py), through launch.train's setup and step, the
# weights from a seed.  granite-3-2b in bfloat16 at all 40 layers, 3 steps of
# 4 x 1,024 tokens through the entry point itself (launch.train.main), so
# K4's backward sees 16 key tiles under the causal mask; xDeepFM 3 steps at
# batch 4,096 over its whole 39M-row table; GCN 6 steps on random_dag(N, 3N)
# at d_in 1,433 (launch.train's graph; N cut to TRAIN_GCN_NODES, the host
# draws x), then the same 6 with --ckpt-dir --fail-at 3 restarting to the
# same losses.
TRAIN_LM = dict(batch=4, seq=1024, steps=3)   # 4 before phase 4l's (d) and (e)
TRAIN_XDEEPFM = dict(batch=4096, steps=3)
TRAIN_GCN_NODES, TRAIN_GCN_STEPS, TRAIN_GCN_FAIL_AT = 50_000, 6, 3
TRAIN_F32_LAYERS = 2
# One step's gradients through the kernels against the same step through the
# plain versions (K4, K5, K6 forward and backward in kernels/ref.py), each
# leaf's ||g - g_plain|| / ||g_plain||: float32 (granite at 2 layers, xDeepFM,
# GCN) within TRAIN_F32_REL, float32 sums in other orders (K4's forward
# agrees to 2e-5, its backward to 1e-4 of the largest gradient; K6's
# backward adds in atomic order: 3.1e-6, 9.4e-8 and 8.0e-8 measured on an
# H100); bfloat16 granite at 40 layers within TRAIN_BF16_REL, each backward
# kernel within one bfloat16 step of its plain version, carried through 40
# layers of random weights (0.022 measured).  The control: the float32 step
# with the dk of every call's last key tile zeroed (a kernel that drops a key
# tile) must exceed TRAIN_F32_REL on some leaf (0.023 measured); at bfloat16
# the same control moves the gradients by no more than bfloat16 does
# (0.025 against 0.022), so it is reported there, not held: there each of
# the step's 40 K4 backward calls is held to its plain version at
# ATTENTION_BWD_TOL as it happens (_EveryBwdCall), which rejects a dk
# without its last key tile on every call.
TRAIN_F32_REL = 1e-4
TRAIN_BF16_REL = 0.05


def _plain_training():
    """Patch ``ops.flash_attention``, ``ops.ell_spmm`` and
    ``ops.embedding_bag`` for the block with autograd Functions of their
    plain versions, forward and backward (``kernels/ref.py``; K4's carrying
    the forward's lse to its backward, as the port's Function does): the
    same training step with every kernel replaced, the yardstick of its
    gradients."""
    import contextlib
    from unittest import mock

    import torch

    from repro_torch.kernels import ops, ref

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.masks = (causal, window)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            causal, window = ctx.masks
            return (*ref.flash_attention_bwd_ref(q, k, v, o, do.contiguous(), causal=causal,
                                                 window=window, lse=lse), None, None)

    class Spmm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, nbr, wgt, x, nbr_t, wgt_t):
            ctx.transposed = (nbr_t, wgt_t)
            return ref.ell_spmm_ref(nbr, wgt, x)

        @staticmethod
        def backward(ctx, dout):
            return None, None, ref.ell_spmm_ref(*ctx.transposed, dout), None, None

    class Bag(torch.autograd.Function):
        @staticmethod
        def forward(ctx, table, idx):
            ctx.save_for_backward(idx)
            ctx.V = table.shape[0]
            return ref.embedding_bag_ref(table, idx)

        @staticmethod
        def backward(ctx, dout):
            (idx,) = ctx.saved_tensors
            return ref.embedding_bag_bwd_ref(idx, dout, ctx.V), None

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        ops, "flash_attention",
        lambda q, k, v, causal=True, window=None: Attention.apply(q, k, v, causal, window)))
    stack.enter_context(mock.patch.object(
        ops, "ell_spmm", lambda nbr, wgt, x, nbr_t=None, wgt_t=None: Spmm.apply(
            nbr, wgt, x, nbr_t, wgt_t)))
    stack.enter_context(mock.patch.object(ops, "embedding_bag", Bag.apply))
    return stack


def _no_plain():
    """Patch every plain version the training path could take, forward and
    backward, to raise for the block: what runs there is the kernels."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels import ref

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card's training path")

    stack = contextlib.ExitStack()
    for name in ("flash_attention_ref", "flash_attention_bwd_ref", "ell_spmm_ref",
                 "embedding_bag_ref", "embedding_bag_bwd_ref"):
        stack.enter_context(mock.patch.object(ref, name, refuse))
    return stack


def _dropped_key_tile():
    """Patch ``ops.flash_attention_bwd`` for the block with the kernel whose dk
    loses its last 64-key tile: the control the gradient bound must reject."""
    from unittest import mock

    from repro_torch.kernels import ops

    kernel = ops.flash_attention_bwd

    def cut(*a, **kw):
        dq, dk, dv = kernel(*a, **kw)
        dk[:, :, -64:] = 0
        return dq, dk, dv

    return mock.patch.object(ops, "flash_attention_bwd", cut)


class _LastCall(_Calls):
    """``ops.<name>`` for the block, keeping the arguments and output of its
    last call that ``when(args)`` accepts (one call's tensors, not every
    call's), detached: a tensor that kept its grad_fn would keep its step's
    graph, and the parameters the graph reaches, on the card."""

    def __init__(self, name: str, when=lambda args: True):
        super().__init__(name)
        self.when, self.last = when, None

    def keep(self, args, kw, out) -> None:
        import torch

        if self.when(args):
            det = lambda x: x.detach() if isinstance(x, torch.Tensor) else x  # noqa: E731
            self.last = (tuple(det(a) for a in args), {k: det(v) for k, v in kw.items()}, out)


class _EveryBwdCall(_Calls):
    """``ops.flash_attention_bwd`` for the block, each call held as it
    happens against the plain backward on its own inputs (recomputing the
    softmax: the forward's lse is checked with it) at ``ATTENTION_BWD_TOL``,
    and a dk without its last 64-key tile rejected on each call where that
    tile has a gradient: the largest excess and the smallest control excess
    over the calls."""

    def __init__(self):
        super().__init__("flash_attention_bwd")
        self.excess, self.control = [], []

    def keep(self, args, kw, out) -> None:
        from repro_torch.kernels import ref

        q, k, v, o, do = args
        exp = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=kw.get("causal", True),
                                          window=kw.get("window"), scale=kw.get("scale"))
        self.excess.append(max(_bwd_excess(g, e) for g, e in zip(out, exp)))
        if bool(exp[1][:, :, -64:].abs().max() > 0):
            cut = out[1].clone()
            cut[:, :, -64:] = 0
            self.control.append(_bwd_excess(cut, exp[1]))
        del exp

    def summary(self) -> dict:
        return {"calls": len(self.excess), "max_excess": max(self.excess, default=None),
                "excess_by_call": self.excess,
                "control_dropped_key_tile_min_excess": min(self.control, default=None)}


def _grads(loss_of, params) -> tuple:
    """(loss, gradients) of one step: every leaf of ``params``, as the
    training step takes them."""
    import torch

    from repro_torch.tree import tree_leaves

    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_of(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def _grad_agreement(got, exp) -> list:
    """Each leaf's ||got - exp|| / ||exp|| (float32 norms)."""
    out = []
    for g, e in zip(got, exp):
        e32 = e.float()
        out.append(float((g.float() - e32).norm() / e32.norm().clamp_min(1e-30)))
    return out


def _grad_check(name: str, loss_of, params, bound: float, control: bool = False,
                every_call=None) -> dict:
    """One step's gradients through the kernels (the launch counts read
    around it; ``every_call``, a context such as ``_EveryBwdCall``, around
    it too) against the same step through the plain versions: every leaf's
    relative error within ``bound``; with ``control``, the step with K4's dk
    missing its last key tile must exceed it."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    with every_call or contextlib.nullcontext():
        loss, got = _grads(loss_of, params)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    with _plain_training():
        ops.reset_launches()
        plain_loss, exp = _grads(loss_of, params)
        check(not any(ops.LAUNCHES.values()), f"{name}: the plain step launched {ops.LAUNCHES}")
    rel = _grad_agreement(got, exp)
    del got
    rec = {"loss": loss, "plain_loss": plain_loss, "launches": launches, "bound": bound,
           "max_rel": max(rel), "rel_by_leaf": rel}
    check(all(np.isfinite([loss, plain_loss])) and max(rel) <= bound,
          f"{name}: gradients through the kernels at {max(rel)} of the plain step's, "
          f"bound {bound} (loss {loss} against {plain_loss})")
    if control:
        with _dropped_key_tile():
            _, cut = _grads(loss_of, params)
        rec["control_dropped_key_tile_max_rel"] = max(_grad_agreement(cut, exp))
        del cut
    del exp
    torch.cuda.empty_cache()
    return rec


# the kernels a K4 backward call launches, by dtype
ATTENTION_BWD_SYMBOLS = {
    "bfloat16": ("attention_bwd_sm90_delta_kernel", "attention_bwd_sm90_kernel",
                 "attention_bwd_sm90_dq_kernel"),
    "float32": ("attention_bwd_f32_delta_kernel", "attention_bwd_f32_kernel")}


def _attention_bwd_record(label: str, args: tuple, kw: dict, out: tuple, device) -> dict:
    """K4's backward at one call (captured on the training path, or made
    beside it): against its plain version (``ATTENTION_BWD_TOL``, the plain
    version recomputing its softmax); the wrapper's time with the call's
    lse (three launches a call in bfloat16, two in float32), its device
    time (their sum), the plain version's and SDPA's backward through
    autograd on the same inputs in the same dtype; the bound."""
    import library_cases as lc
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    t_rec = time.perf_counter()
    q, k, v, o, do = (x.detach() for x in args)   # the backward's saved tensors
    out = tuple(g.detach() for g in out)
    causal, window, lse = kw.get("causal", True), kw.get("window"), kw.get("lse")
    B, Hq, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    kern = lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal,  # noqa: E731
                                           window=window, lse=lse)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,  # noqa: E731
                                                window=window)
    p1, exp = _timed_once(plain)
    excess = [_bwd_excess(g, e) for g, e in zip(out, exp)]
    err = max(float((g.float() - e.float()).abs().max()) for g, e in zip(out, exp))
    check(max(excess) <= 1, f"flash_attention_bwd differs from its plain version at {label}: "
                            f"{excess} x the tolerance")
    del exp
    k1, k2 = _event_ms(kern, 3, warmup=1), _event_ms(kern, 3, warmup=1)
    p2, _ = _timed_once(plain)
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    check(window is None, "SDPA's yardstick here takes a causal mask alone")
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)
    lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,  # noqa: E731
                                      retain_graph=True)
    lib_err = max(float((g.float() - e.float()).abs().max()) for g, e in zip(lib(), out))
    l1, l2 = _event_ms(lib, 3, warmup=1), _event_ms(lib, 3, warmup=1)
    dtype = str(q.dtype).removeprefix("torch.")
    # a float32 call takes milliseconds: ten make a trace as steady as fifty bf16 ones
    device_ms_by_kernel = _each_kernel_device_ms(kern, ATTENTION_BWD_SYMBOLS[dtype],
                                                 10 if dtype == "float32" else 50)
    device_ms = sum(device_ms_by_kernel.values())
    pairs = _attention_pairs(S, T, causal, window)
    # five products, a multiply and an add each: over D q k^T (recomputed),
    # ds k and ds^T q; over Dv do v^T and p^T do
    flops = 2 * pairs * (3 * D + 2 * Dv) * Hq * B
    nbytes = q.element_size() * 2 * (q.numel() + k.numel() + v.numel()) \
        + q.element_size() * (o.numel() + do.numel())
    bound = _bound(nbytes, flops, PEAK_BF16_FLOPS_PER_S if q.dtype == torch.bfloat16
                   else PEAK_F32_FLOPS_PER_S)
    log(f"K4 flash_attention_bwd {label}: {min(k1, k2):.3f} ms (device {device_ms:.3f} ms), "
        f"plain {min(p1, p2):.3f} ms, SDPA backward {min(l1, l2):.3f} ms, "
        f"bound {bound['bound_ms']:.4f} ms")
    return {
        "config": label, "kernel": ops.attention_bwd_kernel(q.dtype),
        "shape": dict(B=B, Hq=Hq, Hkv=Hkv, S=S, T=T, D=D, Dv=Dv, causal=causal, window=window,
                      dtype=dtype),
        "visible_pairs": pairs, "max_abs_err": err, "max_excess": max(excess),
        "tolerance": dict(zip(("rtol", "atol_of_largest"), lc.ATTENTION_BWD_TOL[dtype])),
        "ms": min(k1, k2), "ms_runs": [k1, k2], "device_ms": device_ms,
        "device_ms_by_kernel": device_ms_by_kernel,
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2], **bound,
        "tflop_per_s": flops / device_ms / 1e9, "bound_share": bound["bound_ms"] / device_ms,
        "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
        "library": "torch.autograd.grad through F.scaled_dot_product_attention(is_causal, "
                   "enable_gqa=True), its forward outside the timed window",
        "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err,
        "record_seconds": time.perf_counter() - t_rec}


def _bag_bwd_record(label: str, idx, dout, V: int, out) -> dict:
    """K6's backward at one captured call of the training path: against its
    plain version within 1e-5; the wrapper's time (the zeroing and one
    launch), its device time, the plain version's and ``F.embedding_bag``'s
    backward through autograd; the bound (the table written once)."""
    import library_cases as lc
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    B, bag = idx.shape
    D = dout.shape[1]
    valid = int((idx >= 0).sum())
    kern = lambda: ops.embedding_bag_bwd(idx, dout, V)  # noqa: E731
    plain = lambda: ref.embedding_bag_bwd_ref(idx, dout, V)  # noqa: E731
    p1, exp = _timed_once(plain)
    err = float((out - exp).abs().max())
    check(torch.allclose(out, exp, rtol=lc.SPMM_BAG_BWD_TOL, atol=lc.SPMM_BAG_BWD_TOL),
          f"embedding_bag_bwd differs from its plain version at {label}: {err}")
    del exp
    k1, k2 = _event_ms(kern, 5, warmup=1), _event_ms(kern, 5, warmup=1)
    p2, _ = _timed_once(plain)
    table = torch.zeros((V, D), device=idx.device, requires_grad=True)
    lib_out = F.embedding_bag(idx.clamp_min(0).long(), table, mode="sum",
                              per_sample_weights=(idx >= 0).float())
    lib = lambda: torch.autograd.grad(lib_out, table, dout, retain_graph=True)[0]  # noqa: E731
    lib_err = float((lib() - out).abs().max())
    l1, l2 = _event_ms(lib, 5, warmup=1), _event_ms(lib, 5, warmup=1)
    def call():   # each call's table freed at once: fifty kept would fill the card
        kern()

    device_ms = _kernel_device_ms(call, "embedding_bag_bwd_kernel", 50)
    log(f"K6 embedding_bag_bwd {label}: {min(k1, k2):.3f} ms (device {device_ms:.4f} ms "
        f"without the zeroing), plain {min(p1, p2):.3f} ms, F.embedding_bag backward "
        f"{min(l1, l2):.3f} ms")
    return {
        "config": label, "max_abs_err": err,
        "shape": {"V": V, "D": D, "B": B, "bag": bag, "valid_slots": valid},
        # the device time of the adds; the zeroing is a memset beside them
        "ms": min(k1, k2), "ms_runs": [k1, k2], "device_ms": device_ms,
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
        # ids and dout read once, the table written once; one add per valid value
        **_bound(B * bag * 4 + B * D * 4 + V * D * 4, valid * D, PEAK_F32_FLOPS_PER_S),
        "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
        "library": "torch.autograd.grad through F.embedding_bag(idx.clamp_min(0), table, "
                   "mode='sum', per_sample_weights=(idx >= 0)), its forward outside the "
                   "timed window",
        "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err}


def _train_main(argv: list, what: str, want: dict, capture: "_LastCall") -> tuple:
    """``launch.train.main(argv)``, the entry point itself, with every plain
    version refused and the launch counts read around exactly it (``want``);
    every loss finite.  Returns (its metrics log, the captured call)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launches()
    with _no_plain(), capture as cap:
        log_ = train.main(argv)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(launches == want, f"{what} training launches {launches}, not {want}")
    check(all(np.isfinite([m["loss"] for m in log_])), f"{what} losses {log_}")
    return log_, cap.last


def _lm_training(device, gen, smi: str) -> tuple:
    """granite-3-2b: the float32 check at TRAIN_F32_LAYERS layers (and its
    control), the bfloat16 check at 40, then launch.train.main for
    TRAIN_LM's steps; the step times and the peak memory; a profiled step.
    Returns the record, the last K4 backward call of the run (for its
    kernel record) and the float32 K4 backward's record at the float32
    check's last call."""
    import dataclasses

    import torch

    from repro_torch.configs import granite_3_2b
    from repro_torch.data.synth import lm_batch
    from repro_torch.models import transformer as tf

    rec = {"arch": "granite-3-2b", **TRAIN_LM}
    marks = [("start", time.perf_counter())]
    full = granite_3_2b.full_config()
    B, S, steps = TRAIN_LM["batch"], TRAIN_LM["seq"], TRAIN_LM["steps"]
    batch = lm_batch(0, 0, B, S, full.vocab, device=device)
    # float32 at 2 layers: a tight bound, and the control it must reject
    cfg = dataclasses.replace(full, n_layers=TRAIN_F32_LAYERS, dtype=torch.float32)
    params = tf.init_params(cfg, gen, device)
    f32_call = _LastCall("flash_attention_bwd")   # layer 0's backward, the last
    f32 = rec["float32_check"] = _grad_check(
        "granite-3-2b float32", lambda p: tf.lm_loss(cfg, p, batch), params, TRAIN_F32_REL,
        control=True, every_call=f32_call)
    check(f32["launches"] == {"flash_attention": 2 * cfg.n_layers,
                              "flash_attention_bwd": cfg.n_layers},
          f"granite float32 step launches {f32['launches']}")
    check(f32["control_dropped_key_tile_max_rel"] > TRAIN_F32_REL,
          f"the float32 gradient bound passes a dk without its last key tile: "
          f"{f32['control_dropped_key_tile_max_rel']}")
    # the float32 K4 backward's record at its layer-0 call, made here so that
    # nothing of the float32 step stays on the card through the rest of 4k
    args, kw, out = f32_call.last
    f32_call.last = None
    k4_f32 = _attention_bwd_record(
        f"granite-3-2b float32 training at {TRAIN_F32_LAYERS} layers, layer 0's backward, "
        f"4 x 1,024 (phase 4k)", args, kw, out, device)
    del params, args, kw, out
    torch.cuda.empty_cache()
    marks.append(("float32_control_step", time.perf_counter()))
    # bfloat16 at all 40 layers, every K4 backward call held to its plain version
    params = tf.init_params(full, gen, device)
    every = _EveryBwdCall()
    bf16 = rec["bfloat16_check"] = _grad_check(
        "granite-3-2b bfloat16", lambda p: tf.lm_loss(full, p, batch), params, TRAIN_BF16_REL,
        control=True, every_call=every)
    check(bf16["launches"] == {"flash_attention_sm90": 2 * full.n_layers,
                               "flash_attention_bwd": full.n_layers,
                               "flash_attention_bwd_sm90": full.n_layers},
          f"granite bfloat16 step launches {bf16['launches']}")
    calls = bf16["k4_bwd_every_call"] = every.summary()
    check(calls["calls"] == full.n_layers and calls["max_excess"] <= 1,
          f"granite bfloat16 step: K4's backward calls at {calls['excess_by_call']} x "
          f"ATTENTION_BWD_TOL")
    check(calls["control_dropped_key_tile_min_excess"] is not None
          and calls["control_dropped_key_tile_min_excess"] > 1,
          f"the per-call check passes a dk without its last key tile: "
          f"{calls['control_dropped_key_tile_min_excess']}")
    log(f"4k granite-3-2b bfloat16 step: {calls['calls']} K4 backward calls, the largest "
        f"{calls['max_excess']:.3f} x ATTENTION_BWD_TOL (a dropped key tile at least "
        f"{calls['control_dropped_key_tile_min_excess']:.1f} x); gradients {bf16['max_rel']:.4f} "
        f"of the plain step's (the dropped tile {bf16['control_dropped_key_tile_max_rel']:.4f})")
    del params, batch
    torch.cuda.empty_cache()
    marks.append(("bfloat16_check", time.perf_counter()))
    # python -m repro_torch.launch.train --arch granite-3-2b --steps 4 --batch 4 --seq 1024
    argv = ["--arch", "granite-3-2b", "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--device", str(device)]
    # K4 twice a layer (remat runs the forward again in the backward), its backward once
    want = {"flash_attention_sm90": 2 * full.n_layers * steps,
            "flash_attention_bwd": full.n_layers * steps,
            "flash_attention_bwd_sm90": full.n_layers * steps}
    torch.cuda.reset_peak_memory_stats()
    log_, call = _train_main(argv, "granite-3-2b", want, _LastCall("flash_attention_bwd"))
    secs = [m["sec"] for m in log_]
    rec.update(argv=" ".join(argv), launches=want,
               losses=[m["loss"] for m in log_], step_seconds=secs,
               grad_norms=[m["grad_norm"] for m in log_],
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               tokens_per_s=B * S / min(secs[1:]), card=smi)
    log(f"4k granite-3-2b: {steps} steps of {B} x {S} tokens, step {min(secs[1:]):.3f} s "
        f"({rec['tokens_per_s']:.0f} tokens/s; first {secs[0]:.3f} s), peak memory "
        f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB, losses {rec['losses']} [{smi}]")
    torch.cuda.empty_cache()
    marks.append(("train_main", time.perf_counter()))
    prof = rec["profiled_step"] = _train_step_profile(argv)
    log(f"4k granite-3-2b profiled step: {prof['wall_ms']:.1f} ms, the card "
        f"{prof['device_busy_share']:.1%} busy; device ms by kind "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["device_ms_by_kind"].items())
        + f" [{smi}]")
    torch.cuda.empty_cache()
    marks.append(("profiled_step", time.perf_counter()))
    rec["seconds_by_part"] = {b: t - a for (_, a), (b, t) in zip(marks, marks[1:])}
    return rec, call, k4_f32


# xDeepFM's and GCN's launches in ``steps`` steps: two gathers, two layers'
# aggregations, each forward and backward
_TRAIN_LAUNCHES = {
    "xdeepfm": lambda steps: {"embedding_bag": 2 * steps, "embedding_bag_bwd": 2 * steps},
    "gcn-cora": lambda steps: {"ell_spmm": 2 * steps, "ell_spmm_bwd": 2 * steps}}


# a training step's kernels by kind, by name (cuBLAS's products on an H100 run
# as sm90_xmma / nvjet / cutlass kernels)
STEP_KINDS = (("k4_backward", r"attention_bwd_\w*kernel"),
              ("k4_forward", r"flash_attention(_sm90|_tiled)?_kernel"),
              ("matmul", r"gemm|xmma|nvjet|cutlass"))


def _train_step_profile(argv: list) -> dict:
    """One training step of ``argv``'s arch (launch.train's setup and step,
    after one step outside the trace) under torch.profiler: the wall time,
    the device's busy time and share, and the device time by kind
    (``STEP_KINDS``, the rest "other": norms, rope, the loss, AdamW)."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init

    args = train.parse_args(argv)
    _, params, loss_of, batch_fn, wd = train.setup(args)
    state, step = (params, adamw_init(params)), train.make_step(loss_of, args, wd)
    del params
    with _no_plain():
        state, _ = step(state, batch_fn(0))
        box = [state]

        def one():
            box[0], m = step(box[0], batch_fn(1))
            float(m["loss"])

        wall_ms, events = _device_events(one)
    del state, box
    kernels = [(name, us) for cat, name, us in events if cat == "kernel"]
    busy = sum(us for _, us in kernels)
    by_kind = dict.fromkeys([k for k, _ in STEP_KINDS] + ["other"], 0.0)
    for name, us in kernels:
        kind = next((k for k, pat in STEP_KINDS if re.search(pat, name)), "other")
        by_kind[kind] += us
    check(by_kind["k4_backward"] > 0, "the profiled training step shows no K4 backward")
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3, "device_busy_share":
            busy / 1e3 / wall_ms, "kernels": len(kernels),
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "share_of_device_by_kind": {k: v / busy for k, v in by_kind.items()}}


def _xdeepfm_training(device, smi: str) -> tuple:
    """xDeepFM at full_config(): the float32 check, then launch.train.main
    for TRAIN_XDEEPFM's steps.  Returns the record and the last K6 backward
    call of the embedding rows (bags of one id, the larger of the two)."""
    from repro_torch.launch import train

    steps = TRAIN_XDEEPFM["steps"]
    argv = ["--arch", "xdeepfm", "--steps", str(steps), "--batch",
            str(TRAIN_XDEEPFM["batch"]), "--device", str(device)]
    _, params, loss_of, batch_fn, _ = train.setup(train.parse_args(argv))
    batch = batch_fn(0)
    rec = {"arch": "xdeepfm", **TRAIN_XDEEPFM, "argv": " ".join(argv)}
    rec["float32_check"] = _grad_check("xdeepfm", lambda p: loss_of(p, batch), params,
                                       TRAIN_F32_REL)
    check(rec["float32_check"]["launches"] == _TRAIN_LAUNCHES["xdeepfm"](1),
          f"xDeepFM step launches {rec['float32_check']['launches']}")
    del params, batch
    log_, call = _train_main(argv, "xDeepFM", _TRAIN_LAUNCHES["xdeepfm"](steps),
                             _LastCall("embedding_bag_bwd", lambda a: a[0].shape[1] == 1))
    secs = [m["sec"] for m in log_]
    rec.update(launches=_TRAIN_LAUNCHES["xdeepfm"](steps), losses=[m["loss"] for m in log_],
               step_seconds=secs, rows_per_s=TRAIN_XDEEPFM["batch"] / min(secs[1:]), card=smi)
    log(f"4k xdeepfm: {steps} steps at batch {TRAIN_XDEEPFM['batch']}, step "
        f"{min(secs[1:]) * 1e3:.1f} ms, losses {rec['losses']} [{smi}]")
    return rec, call


def _gcn_training(device, smi: str) -> tuple:
    """GCN at full_config() on launch.train's graph at TRAIN_GCN_NODES: the
    float32 check, launch.train.main for TRAIN_GCN_STEPS steps, then the
    same with --ckpt-dir --fail-at: each step's loss equal to the
    uninterrupted run's.  Returns the record and the last K5 backward call
    (the first layer's: the transposed launch)."""
    import tempfile

    from repro_torch.launch import train

    steps = TRAIN_GCN_STEPS
    argv = ["--arch", "gcn-cora", "--steps", str(steps), "--gnn-nodes", str(TRAIN_GCN_NODES),
            "--device", str(device)]
    t0 = time.perf_counter()
    cfg, params, loss_of, _, _ = train.setup(train.parse_args(argv))
    rec = {"arch": "gcn-cora", "nodes": TRAIN_GCN_NODES, "edges": 3 * TRAIN_GCN_NODES,
           "d_in": cfg.d_in, "argv": " ".join(argv), "setup_seconds": time.perf_counter() - t0}
    rec["float32_check"] = _grad_check("gcn-cora", lambda p: loss_of(p, None), params,
                                       TRAIN_F32_REL)
    check(rec["float32_check"]["launches"] == _TRAIN_LAUNCHES["gcn-cora"](1),
          f"GCN step launches {rec['float32_check']['launches']}")
    del params
    log_, call = _train_main(argv, "GCN", _TRAIN_LAUNCHES["gcn-cora"](steps),
                             _LastCall("_ell_spmm", lambda a: a[3:] == ("ell_spmm_bwd",)))
    losses = [m["loss"] for m in log_]
    with tempfile.TemporaryDirectory() as ck:
        ft = train.main(argv + ["--ckpt-dir", ck, "--ckpt-every", "2",
                                "--fail-at", str(TRAIN_GCN_FAIL_AT)])
    by_step = {m["step"]: m["loss"] for m in ft}   # the loop counts the steps done
    resumed = [by_step.get(s + 1) for s in range(steps)]
    check(resumed == losses, f"GCN --fail-at {TRAIN_GCN_FAIL_AT} resumed to {resumed}, "
                             f"not the uninterrupted {losses}")
    secs = [m["sec"] for m in log_]
    rec.update(launches=_TRAIN_LAUNCHES["gcn-cora"](steps), losses=losses, step_seconds=secs,
               resumed_losses=resumed, ell_width_transposed=int(call[0][0].shape[1]), card=smi)
    log(f"4k gcn-cora: {steps} steps on random_dag({TRAIN_GCN_NODES}, "
        f"{3 * TRAIN_GCN_NODES}), step {min(secs[1:]) * 1e3:.2f} ms, losses {losses}; "
        f"--fail-at {TRAIN_GCN_FAIL_AT} resumed to the same [{smi}]")
    return rec, call


def phase_training(device, smi: str) -> dict:
    """Phase 4k: training at full_config() widths on the card, each path's
    launch counts read around exactly it (see TRAIN_LM's comment), the
    gradient checks against the plain versions and their control (see
    TRAIN_F32_REL's comment), then the three backward kernels at the path's
    own calls against their plain versions, timed beside their bound, their
    plain versions and the PyTorch call.  Returns {"launches": the paths'
    sums, "records": the backward kernels' kernel records}."""
    import torch

    t_start = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    gen = torch.Generator(device=device)
    gen.manual_seed(27)
    lm, k4_call, k4_f32 = _lm_training(device, gen, smi)
    t_lm = time.perf_counter()
    xd, k6_call = _xdeepfm_training(device, smi)
    t_xd = time.perf_counter()
    gc, k5_call = _gcn_training(device, smi)
    t_gc = time.perf_counter()
    launches = {}
    for r in (lm, xd, gc):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # the backward kernels at the path's calls (the float32 K4 backward's at the
    # float32 check's, whose launches it counts as its path's)
    (q, k, v, o, do), kw, out = k4_call
    k4 = _attention_bwd_record("granite-3-2b training, layer 0's backward, 4 x 1,024 "
                               "(phase 4k)", (q, k, v, o, do), kw, out, device)
    del q, k, v, o, do, kw, out
    f32_check = _own_launches(lm["float32_check"]["launches"])
    (idx, dout, V), _, out6 = k6_call
    k6 = _bag_bwd_record("xDeepFM training, the embedding rows' backward, batch 4,096 "
                         "(phase 4k)", idx, dout, V, out6)
    (nbr_t, wgt_t, dx, _), _, out5 = k5_call
    k5 = _spmm_record(f"GCN training, the first layer's backward: K5 over the transposed "
                      f"rows of random_dag({TRAIN_GCN_NODES}, {3 * TRAIN_GCN_NODES}) "
                      f"(phase 4k)", nbr_t, wgt_t, dx, out5, device)
    k5["library"] = "torch.sparse.mm(the transpose as CSR, built outside the timed window, dout)"
    del k4_call, k6_call, k5_call
    torch.cuda.empty_cache()
    records = []
    own = _own_launches(launches)
    for name, source, of, rec, paths in (
            ("flash_attention_bwd_sm90", "flash_attention_bwd_sm90.cu",
             "src/repro/kernels/flash_attention.py:110", k4, {}),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:110", k4_f32,
             {"training_float32_check": f32_check["flash_attention_bwd"]}),
            ("embedding_bag_bwd", "embedding_bag_bwd.cu",
             "src/repro/kernels/embedding_bag.py:52", k6, {}),
            ("ell_spmm_bwd", "ell_spmm.cu", "src/repro/kernels/ell_spmm.py:61", k5, {})):
        by_path = {"training": own.get(name, 0), **paths}
        records.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            # the TPU kernel has no backward: the kernel it is the backward of
            "replaces": of, "backward_of": of, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "matches_plain": True, **{kk: rec.get(kk) for kk in HEAD_KEYS}, "configs": [rec]})
        check(records[-1]["launches"] > 0, f"phase 4k's paths launched no {name}")
    t_end = time.perf_counter()
    record({"phase": "training", "seconds": t_end - t_start, "card": smi,
            "seconds_by_part": {"granite": t_lm - t_start, "xdeepfm": t_xd - t_lm,
                                "gcn": t_gc - t_xd, "records": t_end - t_gc},
            "launches": launches, "granite": lm, "xdeepfm": xd, "gcn": gc})
    return {"launches": launches, "records": records}


def merge_training(library: list, train: dict, cases: dict) -> None:
    """The forward kernels' records count phase 4k's launches beside their
    other paths'; the backward kernels' records join the list with their
    phase 3 cases, K4's taking phase 3b's backward configurations after its
    own (phase 4k's call heads the record)."""
    names = {rec["name"] for rec in train["records"]}
    extra = {rec["name"]: rec["configs"] for rec in library if rec["name"] in names}
    library[:] = [rec for rec in library if rec["name"] not in names]
    own = _own_launches(train["launches"])
    for rec in library:
        n = own.get(rec["name"], 0)
        if n:
            rec.setdefault("launches_by_path", {"kernel_library": rec["launches"]})
            rec["launches_by_path"]["training"] = n
            rec["launches"] += n
    # phase 3's K4 backward cases, half of them in each dtype
    k4_bwd = cases.get("flash_attention_bwd", 0) // 2
    checked = {**cases, "flash_attention_bwd": k4_bwd, "flash_attention_bwd_sm90": k4_bwd}
    for rec in train["records"]:
        rec["configs"] += extra.get(rec["name"], [])
        rec["cases_checked"] = checked.get(rec["name"], 0) + len(rec["configs"])
        library.append(rec)


# ------------------------------------------------------------------ phase 4l

# Training across ranks: DIST_WORLD gloo ranks on the one card (NCCL puts no
# two ranks on one device), spawned once phase 4i (b)'s have ended (they load
# the kernels the script built, reach the card and warm up beside phase 4e)
# and let go once phase 4k has ended, so that nothing runs beside them.  Each rank:
#  (a) granite-3-2b at full_config() widths through lm_cells.make_train_step
#      over a (DIST_WORLD, 1) data mesh, n_accum DIST_LM["n_accum"], a batch
#      of DIST_LM["batch"] x DIST_LM["seq"] tokens (one row a rank a
#      microbatch), the optimizer state ZeRO-sharded; first in float32 at
#      TRAIN_F32_LAYERS layers, one step against a one-rank step over the
#      whole batch (mesh None): its loss, and each leaf's slice of master,
#      mu and nu, within TRAIN_F32_REL (||mine - ref|| / ||ref||), which the
#      step with the last rank's gradient dropped from the average must
#      exceed; then in bfloat16 at DIST_LM["layers"] layers for
#      DIST_LM["steps"] steps (223M parameters: the depth cut to what the
#      script's time allows, gloo moving the gradients through the host),
#      every rank's params equal byte for byte after every step (their sha256
#      gathered), and quantized_psum_grads over step 1's gradient tree: held
#      to a numpy model of its formula on DIST_QUANT_MODEL_LEAVES (all ranks'
#      gradients gathered) and its distance from the float32 average
#      recorded;
#  (b) dist.pipeline_apply over a (DIST_WORLD,) stage mesh: the
#      DIST_GPIPE["layers"] layers of granite-3-2b at full width spread
#      evenly over the stages, fn a stage's transformer._layer calls,
#      DIST_GPIPE["microbatches"] microbatches of 1 x DIST_GPIPE["seq"]
#      random hidden states, in float32
#      and in bfloat16: the output and the gradients of a fixed projection of
#      it against the sequential run in this process (each microbatch through
#      the same layers in turn) within DIST_GPIPE_REL, which the pipeline with
#      stages 0 and 1 swapped must exceed;
#  (c) gatedgcn.make_dstlocal_loss at full_config() (16 layers, d 70, d_in
#      1,433) on full_graph_sm's padded shape (a random DAG of Cora's n and m,
#      nodes padded by _pad_to and masked), the edges laid out by
#      graph.partition: its loss and gradients against loss_fn on this rank
#      alone within JAX's own bounds (DIST_GNN_TOL), which the loss with the
#      node stream gathered in the wrong rank order must exceed; one
#      make_gnn_train_step step, its params equal on every rank;
#  (d) the data-sharded GNN losses (make_sharded_loss: a rank's n/P node
#      rows and m/P edges with global ids, JAX's layout) over a
#      (DIST_WORLD,) data mesh at full_config() widths, the graphs from
#      DIST_GNN_SEED: schnet at molecule (3 interactions, d 64, 300 RBFs; 128
#      molecules of 30 atoms, padded to 4,096 nodes) and gatedgcn at
#      full_graph_sm's padded shape (16 layers, d 70, d_in 1,433) in
#      float32, graphcast at full_graph_sm's mesh_dims (16 layers, d 512,
#      n_vars 227) in float64: the loss and every gradient leaf against
#      loss_fn on this rank over the whole graph within TRAIN_F32_REL
#      (||mine - ref|| / ||ref||), which the partials reduce-scattered onto
#      the wrong owners (each rank handed the next rank's rows) must exceed.
#      graphcast's 16 random layers grow its residual stream ~16x a layer
#      (the loss ~1e25): in float32 the one-rank loss_fn's own gradient
#      moves by 1e-4 to 6e-4 between two runs on the card (the atomics'
#      order), so the float32 run is measured beside that spread, not gated,
#      and the gate is held in float64.  graphcast once more in its own
#      bfloat16 within DIST_GRAPHCAST_BF16_REL (the same control rejected);
#      one make_gnn_train_step step on schnet, gatedgcn and graphcast
#      bfloat16, the params equal on every rank (sha256);
#  (e) xDeepFM at full_config() over a (2, 2) ("data", "model") mesh, the
#      tables row-sharded over "model" (a rank's 19.5M rows of the 39M x 10
#      table, 780 MB, and of the linear term): serve_p99's 512 rows and a
#      retrieval_score chunk of DIST_XDEEPFM["candidates"] candidates (a
#      data rank's half of each) against the one-rank forward over the
#      whole table within XDEEPFM_MESH_TOL, which the forward without the
#      model all-reduce must exceed; one train step at batch 4,096, the
#      table scaled by DIST_XDEEPFM["clip_scale"] so that the gradient norm
#      passes the clip (summed over both model ranks' blocks), against the
#      one-rank step: the loss, the gradient norm, the params and each
#      rank's slice of master, mu and nu within TRAIN_F32_REL, the
#      replicated params equal on every rank.  The train step's table is cut
#      to DIST_XDEEPFM["train_vocab_per_field"] a field: at 1M its gradient's
#      reduce-scatter and the params' all-gather move 780 MB a rank through
#      the host under gloo, and each rank's one-rank reference holds the
#      whole table five times over.  K6 and its backward are timed once at
#      the path's shapes on rank 0, the other ranks waiting.
#  (f), run right after (a): Megatron tensor parallelism
#      (dist.tensor_parallel) over a (2, 2) ("data", "model") mesh, each
#      rank its param_pspecs blocks
#      (transformer.shard_params), ZeRO over the 2 data ranks: granite-3-2b
#      at full width in float32 at TRAIN_F32_LAYERS layers, one
#      make_train_step step from (a)'s float32 weights on (a)'s batch
#      against (a)'s one-rank step: the loss, the gradient norm and this
#      rank's ZeRO slice of master, mu and nu, gathered whole over the model
#      ranks (gather_params), against the same slice of the one-rank state
#      within TRAIN_F32_REL, which the step with wo's reduce_from_model left
#      out must exceed (its blocks against the one-rank state's); in bfloat16 at
#      DIST_LM["layers"] layers one timed step, the params equal byte for
#      byte over each data group (sha256); a bfloat16 prefill of 1 x
#      DIST_TP["prefill"] tokens, the last position's logits against the
#      one-rank prefill within SUBSTRATE_BF16's max abs (one position: no
#      top-1 share); granite-moe-1b-a400m at full width, 2 layers, float32,
#      its 32 experts 16 a model rank (expert parallelism): the same step
#      check against a one-rank step run here; deepseek-7b at full width, 2 layers, float32:
#      DIST_TP["decode_steps"] decode steps of DIST_TP["decode_batch"]
#      tokens over a cache split by kv heads (16 a model rank), each step's
#      logits against the one-rank decode within SUBSTRATE_F32_ATOL.
#  (g), run right after (f): decode over a cache split along head_dim or
#      kv_lora over the model ranks and along its sequence over the data
#      ranks (transformer.decode_step with dist.split_softmax), each case
#      one random cache drawn whole from SPLIT_DECODE["seed"] on every rank
#      and placed by transformer.shard_cache, every step's logits against
#      the one-rank decode_step on the whole cache: h2o-danube-1.8b at full
#      width (window 4,096), SPLIT_DECODE["danube_layers"] layers, batch 1,
#      a cache of SPLIT_DECODE["danube_cache"] positions over a (4, 1) mesh,
#      4,096 a rank, one step at each of SPLIT_DECODE["danube_positions"]
#      (the window inside rank 0's block, ranks 1-3 keeping no key; exactly
#      rank 1's block, the last position of a slice; across ranks 1 and 2;
#      rank 1 keeping one key, K4 over a window of 1; rank 3's block at the
#      last position), in bfloat16 through flash_attention_sm90 (within
#      SUBSTRATE_BF16's max abs) and in float32 through flash_attention
#      (within SUBSTRATE_F32_ATOL), both keeping their lse, each rank's
#      launches those of the steps where it keeps a key; deepseek-v2-lite-16b
#      at full width, 2 layers, float32 (MLA's decode runs no kernel) on
#      (1, 4) (kv_lora 512, 128 a rank; batch 4) and on (2, 2) with batch 1
#      (the sequence and kv_lora together), within SUBSTRATE_F32_ATOL; then
#      rank 0 holds K4's lse and output at danube's decode shapes against
#      ref.flash_attention_ref(..., return_lse=True) (both dtypes; a rank's
#      whole block, a window across it, a window of one key), and times
#      each call with and without its lse, the other ranks waiting.
#      granite-3-2b's case on 16 model ranks runs on SPLIT_WORLD ranks of its own,
#      forked once this world has ended from a server that imported what they
#      run beside it (``prepare_split_ranks``).
# K4 and its backward are counted on every rank around exactly the 4-rank
# steps and pipeline runs and (f)'s tensor-parallel calls (apart), (g)'s
# split decode steps (apart), K6 and its backward around the 4-rank forward,
# retrieval and step (never the references).
DIST_WORLD = 4
DIST_RANK_TIMEOUT_S = 300     # a rank left in a collective raises after this
DIST_WAIT_S = 900.0           # how long a rank waits for the script's go
DIST_LM = dict(batch=8, seq=1024, n_accum=2, steps=1, layers=2)
DIST_GPIPE = dict(microbatches=4, seq=1024, layers=4)   # 8 before (d) and (e)
# the pipeline runs the sequential run's calls on the same inputs; its
# gradients sum the microbatches' parts in another order (the bfloat16
# params' gradients in bfloat16, a step 2^-8), and K4's bfloat16 backward
# adds dq in atomic order
DIST_GPIPE_REL = {"float32": 1e-5, "bfloat16": 2e-2}
DIST_GNN_TOL = {"loss": 5e-3, "grads": 2e-2}   # tests/test_dist.py's, max abs
DIST_QUANT_MODEL_LEAVES = ("final_ln", "layers/ln1", "layers/ln2", "layers/wk", "layers/wv")
DIST_GNN_SEED = 41
DIST_XDEEPFM_SEED = 43
DIST_XDEEPFM = dict(serve_batch=512, candidates=25_000, train_batch=4096,
                    train_vocab_per_field=100_000, clip_scale=100.0)
XDEEPFM_MESH_TOL = 1e-5   # tests/test_torch_xdeepfm.py's, max abs
DIST_TP = dict(prefill=4096, decode_batch=4, decode_steps=16, seed=47)
SPLIT_DECODE = dict(danube_layers=2, danube_cache=16384,
                    danube_positions=(100, 8191, 10000, 12286, 16383),
                    mla_layers=2, mla_cache=2048, mla_batch=4, mla_positions=(1000, 2047),
                    mla_seq_positions=(500, 1023, 1500, 2047),
                    granite_layers=1, granite_cache=2048, granite_batch=4,
                    granite_positions=(1023, 2047), seed=53)
# granite-3-2b's decode over a cache split along head_dim as JAX's single
# mesh splits it: 16 model ranks, 4 of its 64 dims a rank
SPLIT_WORLD = 16


def _leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths ("layers/wk"), in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _params_sha256(params) -> str:
    import hashlib

    import torch

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for p in tree_leaves(params):
        x = p.detach()
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def _same_on_every_rank(digest: str, ag) -> bool:
    """Whether every rank of ``ag`` holds the same sha256 digest."""
    import torch

    from repro_torch.launch.mesh import gather_rows

    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8, device="cuda")
    every = gather_rows(mine.unsqueeze(0), ag)
    return bool((every == every[0]).all())


def _state_rel(state, ref_state, layout) -> float:
    """The largest ||mine - ref|| / ||ref|| over each leaf's slice of
    master, mu and nu, ``ref_state`` whole."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for part in ("master", "mu", "nu"):
        for i, (a, b) in enumerate(zip(tree_leaves(getattr(state, part)),
                                       tree_leaves(getattr(ref_state, part)))):
            b = layout.part(b, i)
            worst = max(worst, float((a - b).norm() / b.norm().clamp_min(1e-30)))
    return worst


def _numpy_quantized_mean(parts: list, block: int = 256) -> np.ndarray:
    """JAX's quantized_psum_grads formula in numpy over every rank's gradient
    of one leaf: each rank's int8 codes and block scales, the codes summed in
    int32, the mean scale, the division by the ranks."""
    qs, ss = [], []
    for a in parts:
        flat = np.pad(a.reshape(-1), (0, (-a.size) % block)).reshape(-1, block)
        s = np.abs(flat).max(1, keepdims=True) / np.float32(127.0)
        s = np.where(s == 0, np.float32(1.0), s).astype(np.float32)
        qs.append(np.clip(np.round(flat / s), -127, 127).astype(np.int32))
        ss.append(s)
    n = len(parts)
    deq = sum(qs).astype(np.float32) * (sum(ss) / np.float32(n))
    return deq.reshape(-1)[:parts[0].size].reshape(parts[0].shape) / np.float32(n)


def _dist_lm(rank: int, world: int, timeout) -> tuple:
    """Phase 4l (a) on this rank: see the comment above DIST_WORLD.  Returns
    the record, the launches of the 4-rank steps and the float32 one-rank
    step (its batch, state and metrics: (f) holds its step to it)."""
    import contextlib
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.configs import granite_3_2b, lm_cells
    from repro_torch.data.synth import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axis_group, form_mesh, gather_rows, sum_over
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.optim import quantized_psum_grads, zero_init
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    device = torch.device("cuda", 0)
    mesh = form_mesh((world, 1), ("data", "model"), device_type="cuda", timeout=timeout)
    ag = axis_group(mesh, ("data",))
    full = granite_3_2b.full_config()
    B, S, A, steps = DIST_LM["batch"], DIST_LM["seq"], DIST_LM["n_accum"], DIST_LM["steps"]
    rec = {"mesh": [world, 1], **DIST_LM}
    marks = [("start", time.perf_counter())]
    # the step's two exchanges timed apart (synchronised around), by step
    original, gather = lm_cells._mean_parts, adamw_mod.gather_rows
    coll, kept, label = {}, {}, [None]

    def timed(kind, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        book = coll.setdefault(label[0], {"grads_reduce_scatter": 0.0, "params_all_gather": 0.0})
        book[kind] += time.perf_counter() - t0
        return out

    def timed_mean(acc, lay, n_accum):
        first = label[0] == "bfloat16 step 0"
        if first:   # its gradient tree: this rank's estimate, then its slice of the mean
            kept["local"] = [a / n_accum for a in acc]
        parts = timed("grads_reduce_scatter", original, acc, lay, n_accum)
        if first:
            kept["mean"] = parts
        return parts

    def timed_gather(part, group):
        return timed("params_all_gather", gather, part, group)

    def fresh(cfg):
        gen = torch.Generator(device=device)
        gen.manual_seed(29)
        return tf.init_params(cfg, gen, device)

    def run_step(cfg, step_mesh, batch, name):
        params = fresh(cfg)
        layout = lm_cells.opt_layout(cfg, params, step_mesh)
        state = zero_init(params, layout)
        label[0] = name
        params, state, metrics = lm_cells.make_train_step(cfg, A, step_mesh)(params, state,
                                                                             batch)
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))
        return params, state, metrics, layout

    patches = contextlib.ExitStack()
    patches.enter_context(mock.patch.object(lm_cells, "_mean_parts", timed_mean))
    patches.enter_context(mock.patch.object(adamw_mod, "gather_rows", timed_gather))
    with patches:
        # ---- float32 at TRAIN_F32_LAYERS: 4 ranks against one, and the control
        cfg = dataclasses.replace(full, n_layers=TRAIN_F32_LAYERS, dtype=torch.float32)
        batch = lm_batch(0, 0, B, S, full.vocab, device=device)
        ops.reset_launches()
        _, state, metrics, layout = run_step(cfg, mesh, batch, "float32 step")
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        want = {"flash_attention": 2 * cfg.n_layers * A, "flash_attention_bwd": cfg.n_layers * A}
        check(launches == want, f"rank {rank} float32 step launches {launches}, not {want}")
        _, ref_state, ref_metrics, _ = run_step(cfg, None, batch, "float32 one-rank step")
        loss_rel = abs(float(metrics["loss"]) - float(ref_metrics["loss"])) / abs(
            float(ref_metrics["loss"]))
        state_rel = _state_rel(state, ref_state, layout)
        del state

        def dropped(acc, lay, n_accum):   # the last rank's gradient left out of the sum
            if lay.group.index == lay.group.size - 1:
                for a in acc:
                    a.zero_()
            return timed_mean(acc, lay, n_accum)

        with mock.patch.object(lm_cells, "_mean_parts", dropped):
            _, state, _, _ = run_step(cfg, mesh, batch, "float32 control step")
        control_rel = _state_rel(state, ref_state, layout)
        # (f)'s float32 check holds its tensor-parallel step to this one-rank
        # step: the same weights (seed 29) and batch
        one_rank = {"batch": batch, "state": ref_state, "metrics": ref_metrics}
        del state, ref_state
        torch.cuda.empty_cache()
        check(loss_rel <= TRAIN_F32_REL and state_rel <= TRAIN_F32_REL,
              f"rank {rank}: the float32 4-rank step against one rank: loss {loss_rel}, state "
              f"{state_rel}, bound {TRAIN_F32_REL}")
        check(control_rel > TRAIN_F32_REL, f"rank {rank}: the bound passes a step without "
              f"the last rank's gradient: {control_rel}")
        rec["float32_check"] = {
            "n_layers": cfg.n_layers, "loss": float(metrics["loss"]),
            "loss_one_rank": float(ref_metrics["loss"]), "loss_rel": loss_rel,
            "state_max_rel": state_rel, "bound": TRAIN_F32_REL,
            "control_dropped_rank_max_rel": control_rel, "launches": launches}
        # ---- bfloat16 at DIST_LM["layers"], timed
        cfg = dataclasses.replace(full, n_layers=DIST_LM["layers"])
        params = fresh(cfg)
        layout = lm_cells.opt_layout(cfg, params, mesh)
        state = zero_init(params, layout)
        step = lm_cells.make_train_step(cfg, A, mesh)
        secs, losses, equal = [], [], []
        want = {"flash_attention_sm90": 2 * cfg.n_layers * A,
                "flash_attention_bwd": cfg.n_layers * A,
                "flash_attention_bwd_sm90": cfg.n_layers * A}
        torch.cuda.reset_peak_memory_stats()
        for s in range(steps):
            batch = lm_batch(0, s, B, S, full.vocab, device=device)
            label[0] = f"bfloat16 step {s}"
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            check(launches == want, f"rank {rank} bfloat16 step {s} launches {launches}")
            losses.append(float(metrics["loss"]))
            equal.append(_same_on_every_rank(_params_sha256(params), ag))
            check(equal[-1], f"rank {rank}: the params differ between ranks after step {s}")
        check(all(math.isfinite(x) for x in losses), f"rank {rank}: losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        marks.append(("bfloat16_steps", time.perf_counter()))
    # ---- the int8 all-reduce over step 0's gradient tree
    local, mean = kept.pop("local"), kept.pop("mean")
    names = _leaf_names(params)
    _, treedef = tree_flatten(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = tree_leaves(quantized_psum_grads(tree_unflatten(treedef, local), mesh))
    torch.cuda.synchronize()
    q_secs = time.perf_counter() - t0
    # its distance from the float32 average, whose slices this rank holds:
    # the sharded leaves' squares summed over the ranks, the whole ones' once
    sq = torch.zeros((2, 2), dtype=torch.float64, device=device)
    for i, (a, b) in enumerate(zip(q, mean)):
        sq[int(layout.dims[i] is None)] += torch.stack(
            [(layout.part(a, i) - b).double().square().sum(), b.double().square().sum()])
    sq = sum_over(sq[0], ag) + sq[1]
    diff, base = float(sq[0].sqrt()), float(sq[1].sqrt())
    model = {}
    for name in DIST_QUANT_MODEL_LEAVES:
        i = names.index(name)
        every = gather_rows(local[i].unsqueeze(0), ag).cpu().numpy()
        want_q = _numpy_quantized_mean(list(every))
        got_q = q[i].cpu().numpy()
        model[name] = {"elements": int(got_q.size),
                       "max_abs_vs_model": float(np.abs(got_q - want_q).max())}
        check(np.array_equal(got_q, want_q), f"rank {rank}: quantized_psum_grads on {name} "
              f"differs from the numpy model by {model[name]['max_abs_vs_model']}")
    del local, mean, q
    torch.cuda.empty_cache()
    marks.append(("quantized_psum_grads", time.perf_counter()))
    rec["seconds_by_part"] = {b: t - a for (_, a), (b, t) in zip(marks, marks[1:])}
    P = world
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_blocks = sum(-(-p.numel() // 256) for p in tree_leaves(params))
    n_sharded = sum(p.numel() for p, d in zip(tree_leaves(params), layout.dims)
                    if d is not None)
    n_whole = n_params - n_sharded
    rec["bfloat16"] = {
        "n_layers": cfg.n_layers, "param_count": n_params, "zero_sharded_params": n_sharded,
        "step_seconds": secs, "tokens_per_s": B * S / min(secs), "losses": losses,
        "grad_norm": float(metrics["grad_norm"]), "params_equal_every_step": equal,
        "peak_memory_bytes": peak, "launches_a_step": want,
        # the bytes this rank sends a step, as a ring algorithm sends them
        "wire_bytes_a_step": {
            "reduce_scatter float32 gradients (the ZeRO-sharded leaves)":
                (P - 1) * 4 * n_sharded // P,
            "all_reduce float32 gradients (the whole leaves)": 2 * (P - 1) * 4 * n_whole // P,
            "all_gather bfloat16 params (the ZeRO-sharded leaves)": (P - 1) * 2 * n_sharded // P,
            "all_reduce small (label counts, losses, the norm's squares)":
                2 * (P - 1) * (8 * A + 4 * A + 4) // P},
        "quantized_psum_grads": {
            "seconds": q_secs, "rel_distance_from_float32_average": diff / base,
            "wire_bytes": {"all_gather int8 codes": (P - 1) * 256 * n_blocks,
                           "all_gather float32 scales": (P - 1) * 4 * n_blocks},
            "numpy_model": model}}
    rec["collective_seconds"] = coll
    return rec, _add_counts({k: v * steps for k, v in want.items()},
                            rec["float32_check"]["launches"]), one_rank


def _add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


def _dist_gpipe(rank: int, world: int, timeout) -> tuple:
    """Phase 4l (b) on this rank: see the comment above DIST_WORLD."""
    import dataclasses

    import torch

    from repro_torch.configs import granite_3_2b
    from repro_torch.dist import pipeline_apply
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import form_mesh
    from repro_torch.models import transformer as tf

    device = torch.device("cuda", 0)
    mesh = form_mesh((world,), ("stage",), device_type="cuda", timeout=timeout)
    M, S = DIST_GPIPE["microbatches"], DIST_GPIPE["seq"]
    per = DIST_GPIPE["layers"] // world
    rec, total = {"mesh": [world], "layers_a_stage": per, **DIST_GPIPE}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        cfg = dataclasses.replace(granite_3_2b.full_config(), n_layers=DIST_GPIPE["layers"],
                                  dtype=dtype, remat=False)
        gen = torch.Generator(device=device)
        gen.manual_seed(31)
        layers = tf.init_params(cfg, gen, device)["layers"]
        x = torch.randn((M, 1, S, cfg.d_model), generator=gen, device=device).to(dtype)
        proj = torch.randn((M, 1, S, cfg.d_model), generator=gen, device=device)
        cos, sin = tf._angles(torch.arange(S, device=device), tf._rope_dim(cfg), cfg.rope_theta)

        def fn(p, mb):
            for l in range(per):
                mb = tf._layer(cfg, {k: v[l] for k, v in p.items()}, mb, cos, sin)[0]
            return mb

        def stage(s):
            return {k: v[s * per:(s + 1) * per][None].detach().clone().requires_grad_(True)
                    for k, v in layers.items()}

        mine = stage(rank)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = pipeline_apply(mine, x, fn, mesh)
        grads = torch.autograd.grad((out.float() * proj).sum(), list(mine.values()))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        calls = (M + world - 1) * per
        want = {ops.attention_kernel(dtype): calls, "flash_attention_bwd": calls}
        if dtype == torch.bfloat16:
            want["flash_attention_bwd_sm90"] = calls
        check(launches == want, f"rank {rank} GPipe {name} launches {launches}, not {want}")
        total = _add_counts(total, launches)
        # the sequential run in this process: each microbatch through the layers in turn
        whole = {k: v.detach().clone().requires_grad_(True) for k, v in layers.items()}
        ref = []
        for i in range(M):
            h = x[i]
            for l in range(DIST_GPIPE["layers"]):
                h = tf._layer(cfg, {k: v[l] for k, v in whole.items()}, h, cos, sin)[0]
            ref.append(h)
        ref = torch.stack(ref)
        ref_grads = torch.autograd.grad((ref.float() * proj).sum(), list(whole.values()))

        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

        out_rel = rel(out, ref)
        grad_rel = max(rel(g[0], r[rank * per:(rank + 1) * per])
                       for g, r in zip(grads, ref_grads))
        # the control: stages 0 and 1 swapped
        swap = {0: 1, 1: 0}.get(rank, rank)
        with torch.no_grad():
            control = pipeline_apply(stage(swap), x, fn, mesh)
        control_rel = rel(control, ref)
        bound = DIST_GPIPE_REL[name]
        check(out_rel <= bound and grad_rel <= bound,
              f"rank {rank} GPipe {name}: output {out_rel}, gradients {grad_rel}, bound {bound}")
        check(control_rel > bound, f"rank {rank} GPipe {name}: the bound passes two stages "
              f"swapped: {control_rel}")
        rec[name] = {"seconds": secs, "tokens_per_s": M * S / secs, "launches": launches,
                     "out_rel": out_rel, "grad_max_rel": grad_rel, "bound": bound,
                     "control_swapped_stages_rel": control_rel}
        del out, grads, ref, ref_grads, control, whole, mine, layers
        torch.cuda.empty_cache()
    return rec, total


def _dist_gatedgcn(rank: int, world: int, timeout) -> dict:
    """Phase 4l (c) on this rank: see the comment above DIST_WORLD."""
    from unittest import mock

    import torch

    from repro_torch.configs import gatedgcn_cfg
    from repro_torch.configs.gnn_cells import GNN_SHAPES, make_gnn_train_step, shape_dims
    from repro_torch.graph.generators import random_dag
    from repro_torch.graph.partition import partition_edges_by_dst
    from repro_torch.launch.mesh import axis_group, form_mesh
    from repro_torch.models.gnn import gatedgcn
    from repro_torch.models.gnn.layers import GraphBatch
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves

    device = torch.device("cuda", 0)
    mesh = form_mesh((world,), ("data",), device_type="cuda", timeout=timeout)
    cfg = gatedgcn_cfg.full_config()
    info = GNN_SHAPES["full_graph_sm"]
    n_pad = shape_dims("full_graph_sm")[0]
    g = random_dag(info["n"], info["m"], seed=7)
    src, dst, mask, width = partition_edges_by_dst(g, world, n_pad=n_pad)
    rng = np.random.default_rng(7)

    def t(a):
        return torch.from_numpy(a).to(device)

    batch = GraphBatch(
        x=t(rng.standard_normal((n_pad, cfg.d_in)).astype(np.float32)), edge_src=t(src),
        edge_dst=t(dst), edge_mask=t(mask), node_mask=t(np.arange(n_pad) < g.n),
        edge_attr=t(rng.standard_normal((src.shape[0], cfg.d_edge_in)).astype(np.float32)),
        y=t(rng.integers(0, cfg.n_classes, n_pad).astype(np.int32)))
    gen = torch.Generator(device=device)
    gen.manual_seed(33)
    params = gatedgcn.init_params(cfg, gen, device)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]

    def loss_and_grads(loss_fn):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        return float(loss), grads

    def err(got):   # each bound's share reached, the larger
        loss, grads = got
        return max(abs(loss - base[0]) / DIST_GNN_TOL["loss"],
                   max(float((a - b).abs().max()) for a, b in zip(grads, base[1]))
                   / DIST_GNN_TOL["grads"])

    base = loss_and_grads(lambda p, b: gatedgcn.loss_fn(cfg, p, b))
    dstlocal = gatedgcn.make_dstlocal_loss(cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = loss_and_grads(dstlocal)
    secs = time.perf_counter() - t0
    excess = err(got)
    gather = gatedgcn._gather_nodes
    with mock.patch.object(gatedgcn, "_gather_nodes",
                           lambda h, ag: gather(h, ag).roll(h.shape[0], 0)):
        control = err(loss_and_grads(dstlocal))
    check(excess <= 1, f"rank {rank} gatedgcn dst-local: {excess} x {DIST_GNN_TOL}")
    check(control > 1, f"rank {rank} gatedgcn dst-local: the bounds pass the node stream "
          f"in the wrong rank order ({control} x)")
    state = adamw_init(params)
    params, state, metrics = make_gnn_train_step(dstlocal, mesh)(params, state, batch)
    check(abs(float(metrics["loss"]) - got[0]) <= 1e-6, "the step's loss differs")
    equal = _same_on_every_rank(_params_sha256(params), axis_group(mesh, ("data",)))
    check(equal, f"rank {rank}: gatedgcn's params differ between ranks after a step")
    return {"mesh": [world], "n": g.n, "n_pad": n_pad, "m": g.m, "edges_a_rank": width,
            "loss": got[0], "loss_one_rank": base[0], "seconds_loss_and_grads": secs,
            "max_share_of_bounds": excess, "control_wrong_order_share": control,
            "bounds": DIST_GNN_TOL, "params_equal_after_step": equal}


def _rel(a, b) -> float:
    """||a - b|| / ||b||, in float64 (graphcast's gradients at 16 random
    layers pass 1e20, whose squares overflow float32); NaN where either
    holds a value that is not finite."""
    import torch

    a, b = a.double(), b.double()
    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.nan
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _dist_gnn_graphs(device) -> dict:
    """Phase 4l (d)'s whole graphs, the same on every rank (from
    DIST_GNN_SEED): SchNet's molecule batch (128 molecules of 30 atoms and
    64 edges, nodes padded to the cell's 4,096 and masked), GatedGCN's
    full_graph_sm (a random DAG of Cora's n and m, padded to the cell's
    3,072 nodes and 10,752 edges and masked, d_in 1,433, 8 edge features),
    GraphCast's full_graph_sm mesh_dims (3,072 grid rows, 512 mesh nodes,
    6,144 / 8,192 / 6,144 edges)."""
    import torch

    from repro_torch.configs import gatedgcn_cfg, graphcast_cfg
    from repro_torch.configs.gnn_cells import GNN_SHAPES, shape_dims
    from repro_torch.data.synth import graph_batch_from_csr
    from repro_torch.graph.generators import random_dag
    from repro_torch.models.gnn import graphcast
    from repro_torch.models.gnn.layers import GraphBatch

    rng = np.random.default_rng(DIST_GNN_SEED)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    B, A, E = MOLECULES, MOLECULE_ATOMS, MOLECULE_EDGES
    n_pad, m_pad, d_feat = shape_dims("molecule")
    base = np.repeat(np.arange(B) * A, E)
    x = np.zeros((n_pad, d_feat), np.float32)
    x[:B * A, 0] = rng.integers(0, ATOM_TYPES, B * A)
    y = np.zeros(n_pad, np.float32)
    y[:B * A] = rng.standard_normal(B * A)
    schnet_g = GraphBatch(
        x=t(x), edge_src=t((base + rng.integers(0, A, B * E)).astype(np.int32)),
        edge_dst=t((base + rng.integers(0, A, B * E)).astype(np.int32)),
        edge_mask=t(np.arange(m_pad) < B * E), node_mask=t(np.arange(n_pad) < B * A),
        pos=t(3.0 * rng.standard_normal((n_pad, 3)).astype(np.float32)), y=t(y))
    info, (n_pad, m_pad, d_feat) = GNN_SHAPES["full_graph_sm"], shape_dims("full_graph_sm")
    g = graph_batch_from_csr(random_dag(info["n"], info["m"], seed=DIST_GNN_SEED), d_feat,
                             seed=DIST_GNN_SEED, n_classes=gatedgcn_cfg.full_config().n_classes,
                             d_edge=gatedgcn_cfg.D_EDGE, pad_edges_to=m_pad, device=device)
    pad = n_pad - g.x.shape[0]
    gated_g = g._replace(
        x=torch.cat([g.x, torch.zeros((pad, d_feat), device=device)]),
        node_mask=torch.cat([g.node_mask, torch.zeros(pad, dtype=torch.bool, device=device)]),
        y=torch.cat([g.y, torch.zeros(pad, dtype=g.y.dtype, device=device)]))
    n_g, n_m, m_g2m, m_mesh, m_m2g = graphcast_cfg.mesh_dims("full_graph_sm")
    n_vars = graphcast_cfg.full_config().n_vars
    ri = lambda hi, m: t(rng.integers(0, hi, m).astype(np.int32))  # noqa: E731
    grid = rng.standard_normal((n_g, n_vars)).astype(np.float32)
    mesh_b = graphcast.MeshBatch(
        grid_x=t(grid), g2m_src=ri(n_g, m_g2m), g2m_dst=ri(n_m, m_g2m), mesh_src=ri(n_m, m_mesh),
        mesh_dst=ri(n_m, m_mesh), m2g_src=ri(n_m, m_m2g), m2g_dst=ri(n_g, m_m2g),
        target=t(grid + 0.1 * rng.standard_normal((n_g, n_vars)).astype(np.float32)))
    return {"schnet": schnet_g, "gatedgcn": gated_g, "graphcast": (mesh_b, n_m)}


def _rank_block(batch, index: int, parts: int):
    """This rank's block of a whole GraphBatch or MeshBatch (JAX's layout):
    each node array's n/P rows, each edge array's m/P edges."""
    def cut(a):
        if a is None:
            return None
        k = a.shape[0] // parts
        return a[index * k:(index + 1) * k]

    return type(batch)(*(cut(a) for a in batch))


def _dist_gnn_sharded(rank: int, world: int, timeout) -> dict:
    """Phase 4l (d) on this rank: see the comment above DIST_WORLD."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.configs import gatedgcn_cfg, gnn_cells, graphcast_cfg, schnet_cfg
    from repro_torch.dist import sharded
    from repro_torch.launch.mesh import axis_group, form_mesh
    from repro_torch.models.gnn import gatedgcn, graphcast, schnet
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves

    device = torch.device("cuda", 0)
    mesh = form_mesh((world,), ("data",), device_type="cuda", timeout=timeout)
    ag = axis_group(mesh, ("data",))
    graphs = _dist_gnn_graphs(device)
    mesh_b, n_m = graphs["graphcast"]
    wide = mesh_b._replace(grid_x=mesh_b.grid_x.double(), target=mesh_b.target.double())
    gc_full = graphcast_cfg.full_config()
    gc = (lambda c, p, b: graphcast.loss_fn(c, p, b, n_m),
          lambda c: graphcast.make_sharded_loss(c, mesh, n_m))
    # name, module, config, whole batch, one-rank loss, per-rank loss, bound,
    # gated, stepped (AdamW's float32 master takes no float64 params)
    cases = [
        ("schnet", schnet, schnet_cfg.full_config(), graphs["schnet"],
         lambda c, p, b: schnet.loss_fn(c, p, b),
         lambda c: schnet.make_sharded_loss(c, mesh), TRAIN_F32_REL, True, True),
        ("gatedgcn", gatedgcn, gatedgcn_cfg.full_config(), graphs["gatedgcn"],
         lambda c, p, b: gatedgcn.loss_fn(c, p, b),
         lambda c: gatedgcn.make_sharded_loss(c, mesh), TRAIN_F32_REL, True, True),
        ("graphcast float64", graphcast, dataclasses.replace(gc_full, dtype=torch.float64),
         wide, *gc, TRAIN_F32_REL, True, False),
        ("graphcast float32", graphcast, dataclasses.replace(gc_full, dtype=torch.float32),
         mesh_b, *gc, TRAIN_F32_REL, False, False),
        ("graphcast bfloat16", graphcast, gc_full, mesh_b, *gc, DIST_GRAPHCAST_BF16_REL, True,
         True)]
    scatter, update = sharded.scatter_sum, gnn_cells.adamw_update

    def wrong_owners(partial, ag_):   # each rank handed the next rank's rows
        return scatter(partial.roll(-(partial.shape[0] // ag_.size), 0), ag_)

    def kept_update(grads, *args, **kw):   # the step's gradients, kept for the check
        kept["grads"] = grads
        return update(grads, *args, **kw)

    rec = {"mesh": [world], "seed": DIST_GNN_SEED}
    for name, mod, cfg, whole, one_rank, per_rank, bound, gated, stepped in cases:
        gen = torch.Generator(device=device)
        gen.manual_seed(DIST_GNN_SEED)
        params = mod.init_params(cfg, gen, device)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        block = _rank_block(whole, ag.index, ag.size)
        loss_fn = per_rank(cfg)

        def loss_and_grads(fn, batch):
            loss = fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            torch.cuda.synchronize()
            return loss.detach(), grads

        def err(got):   # the loss's and the worst leaf's relative error; NaN beats all
            errs = [_rel(got[0], ref[0])] + [_rel(a, b) for a, b in zip(got[1], ref[1])]
            return math.nan if any(math.isnan(e) for e in errs) else max(errs)

        ref = loss_and_grads(lambda p, b: one_rank(cfg, p, b), whole)
        out = {"bound": bound, "nodes": whole[0].shape[0],
               "param_count": sum(p.numel() for p in leaves)}
        if gated:
            with mock.patch.object(sharded, "scatter_sum", wrong_owners), torch.no_grad():
                # the loss alone: the bound must reject it already
                out["control_wrong_owners_max_rel"] = _rel(loss_fn(params, block), ref[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if stepped:   # the step's own loss and gradients are the ones held to one rank
            kept = {}
            with mock.patch.object(gnn_cells, "adamw_update", kept_update):
                params, _, metrics = gnn_cells.make_gnn_train_step(loss_fn, mesh)(
                    params, adamw_init(params), block)
            torch.cuda.synchronize()
            got = (metrics["loss"], kept.pop("grads"))
            out["seconds_step"] = time.perf_counter() - t0
        else:
            got = loss_and_grads(loss_fn, block)
            out["seconds_loss_and_grads"] = time.perf_counter() - t0
        out.update(loss=float(got[0]), max_rel=err(got))
        if not gated:   # measured only: the one-rank program's own spread beside it
            out["one_rank_rerun_max_rel"] = err(loss_and_grads(
                lambda p, b: one_rank(cfg, p, b), whole))
        log(f"rank {rank} {name}: {out}")
        del ref, got
        if gated:
            check(out["max_rel"] <= bound,
                  f"rank {rank} {name} on {world} ranks: {out['max_rel']}, bound {bound}")
            check(out["control_wrong_owners_max_rel"] > bound, f"rank {rank} {name}: the "
                  f"bound passes the partials scattered onto the wrong owners")
        if stepped:
            out["params_equal_after_step"] = _same_on_every_rank(_params_sha256(params), ag)
            check(out["params_equal_after_step"],
                  f"rank {rank}: {name}'s params differ between ranks after a step")
        rec[name] = out
        del params, leaves, block
        torch.cuda.empty_cache()
    return rec


def _dist_xdeepfm(rank: int, world: int, timeout) -> tuple:
    """Phase 4l (e) on this rank: see the comment above DIST_WORLD.
    Returns the record, the K6 launches of the 4-rank calls and, on rank 0,
    K6's and its backward's records at the path's shapes."""
    import dataclasses
    from unittest import mock

    import torch
    import torch.distributed as dist

    from repro_torch.configs import xdeepfm_cfg
    from repro_torch.configs.cell import zero_pspecs
    from repro_torch.data.synth import recsys_batch
    from repro_torch.dist import sharded
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import AxisGroup, axis_group, form_mesh
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.optim import zero_init
    from repro_torch.optim.adamw import AdamWState, zero_layout
    from repro_torch.tree import tree_leaves, tree_map

    device = torch.device("cuda", 0)
    mesh = form_mesh((world // 2, 2), ("data", "model"), device_type="cuda", timeout=timeout)
    data, model = axis_group(mesh, ("data",)), xdeepfm.model_group(mesh)
    P, X = data.size, DIST_XDEEPFM
    launches = dict.fromkeys(("embedding_bag", "embedding_bag_bwd"), 0)

    def counted(fn):   # the K6 launches of a 4-rank call, every rank's own
        before = dict(ops.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += ops.LAUNCHES[k] - before[k]
        return out

    def rows_of(t):   # this data rank's rows
        k = t.shape[0] // P
        return t[data.index * k:(data.index + 1) * k]

    cfg = xdeepfm_cfg.full_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(DIST_XDEEPFM_SEED)
    whole = xdeepfm.init_params(cfg, gen, device)
    params = xdeepfm.shard_params(cfg, whole, mesh)
    ids = rows_of(torch.randint(0, cfg.vocab_per_field, (X["serve_batch"], cfg.n_fields),
                                generator=gen, device=device, dtype=torch.int32))
    user = torch.randint(0, cfg.vocab_per_field, (1, cfg.n_fields), generator=gen,
                         device=device, dtype=torch.int32)
    cands = rows_of(torch.randint(0, cfg.vocab_per_field, (X["candidates"],), generator=gen,
                                  device=device, dtype=torch.int32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve = counted(lambda: xdeepfm.forward(cfg, params, ids, mesh))
    serve_s = time.perf_counter() - t0
    serve_err = float((serve - xdeepfm.forward(cfg, whole, ids)).abs().max())
    with mock.patch.object(sharded, "sum_over_ranks", lambda x, ag: x):   # no model all-reduce
        control = float((xdeepfm.forward(cfg, params, ids, mesh)
                         - xdeepfm.forward(cfg, whole, ids)).abs().max())
    t0 = time.perf_counter()
    scores = counted(lambda: xdeepfm.retrieval_score(cfg, params, user, cands, mesh=mesh))
    retrieval_s = time.perf_counter() - t0
    retrieval_err = float((scores - xdeepfm.retrieval_score(cfg, whole, user, cands))
                          .abs().max())
    log(f"rank {rank} xDeepFM serve {serve_err}, retrieval {retrieval_err}, no model "
        f"all-reduce {control}")
    check(serve_err <= XDEEPFM_MESH_TOL and retrieval_err <= XDEEPFM_MESH_TOL,
          f"rank {rank} xDeepFM on a (2, 2) mesh: serve {serve_err}, retrieval "
          f"{retrieval_err}, bound {XDEEPFM_MESH_TOL}")
    check(control > XDEEPFM_MESH_TOL, f"rank {rank} xDeepFM: the bound passes the forward "
          f"without the model all-reduce ({control})")
    serve_rows = xdeepfm.local_rows(cfg, xdeepfm._field_ids(cfg, ids), params["table"].shape[0],
                                    model).reshape(-1, 1).contiguous()
    serve_table = params["table"]
    del whole, scores
    torch.cuda.empty_cache()
    # the train step, vocab_per_field cut (DIST_XDEEPFM's comment); the table
    # scaled so that the gradient's norm passes the clip
    tcfg = dataclasses.replace(cfg, vocab_per_field=X["train_vocab_per_field"])
    gen.manual_seed(DIST_XDEEPFM_SEED + 1)
    whole = xdeepfm.init_params(tcfg, gen, device)
    whole["table"].mul_(X["clip_scale"])
    batch = recsys_batch(DIST_XDEEPFM_SEED, 0, X["train_batch"], cfg.n_fields,
                         tcfg.vocab_per_field, device=device)
    opt_p = zero_pspecs(whole, xdeepfm.param_pspecs(tcfg), mesh)
    layout = zero_layout(opt_p, mesh)
    mine = tree_map(lambda t: t.clone(), xdeepfm.shard_params(tcfg, whole, mesh))
    state = zero_init(mine, layout)
    one = zero_pspecs(whole, xdeepfm.param_pspecs(tcfg), None)
    ref_params = tree_map(lambda t: t.clone(), whole)
    ref_params, ref_state, ref_metrics = xdeepfm_cfg.make_train_step(tcfg, None, one)(
        ref_params, zero_init(ref_params, zero_layout(one, None)), batch)
    rows = {k: rows_of(v) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mine, state, metrics = counted(
        lambda: xdeepfm_cfg.make_train_step(tcfg, mesh, opt_p)(mine, state, rows))
    step_s = time.perf_counter() - t0
    blocks = lambda tree: xdeepfm.shard_params(tcfg, tree, mesh)  # noqa: E731
    loss_rel = abs(float(metrics["loss"]) - float(ref_metrics["loss"])) / abs(
        float(ref_metrics["loss"]))
    params_rel = max(_rel(a, b) for a, b in zip(tree_leaves(mine), tree_leaves(blocks(ref_params))))
    state_rel = _state_rel(state, AdamWState(ref_state.step, blocks(ref_state.mu),
                                             blocks(ref_state.nu), blocks(ref_state.master)),
                           layout)
    norm_rel = abs(float(metrics["grad_norm"]) - float(ref_metrics["grad_norm"])) / float(
        ref_metrics["grad_norm"])
    log(f"rank {rank} xDeepFM step: loss {loss_rel}, params {params_rel}, state {state_rel}, "
        f"norm {norm_rel} ({float(ref_metrics['grad_norm'])}), {step_s:.3f} s")
    check(float(ref_metrics["grad_norm"]) > 1.0, f"the forced gradient norm "
          f"{float(ref_metrics['grad_norm'])} does not pass the clip")
    check(max(loss_rel, params_rel, state_rel, norm_rel) <= TRAIN_F32_REL,
          f"rank {rank} xDeepFM's step on (2, 2) against one rank: loss {loss_rel}, params "
          f"{params_rel}, state {state_rel}, norm {norm_rel}, bound {TRAIN_F32_REL}")
    equal = _same_on_every_rank(_params_sha256({k: v for k, v in mine.items()
                                                if k not in ("table", "linear")}),
                                AxisGroup(("data", "model"), None, world, rank))
    check(equal, f"rank {rank}: xDeepFM's replicated params differ between ranks")
    check(all(v > 0 for v in launches.values()), f"rank {rank} launched no K6: {launches}")
    rec = {"mesh": [P, model.size], "table_rows_a_rank": serve_table.shape[0],
           "serve": {"rows_a_rank": ids.shape[0], "max_abs_err": serve_err,
                     "control_no_model_all_reduce": control, "seconds": serve_s},
           "retrieval": {"candidates_a_rank": cands.shape[0], "max_abs_err": retrieval_err,
                         "seconds": retrieval_s},
           "bound": XDEEPFM_MESH_TOL,
           "train": {"batch": X["train_batch"], "vocab_per_field": tcfg.vocab_per_field,
                     "cut": "vocab_per_field for the train step alone (DIST_XDEEPFM)",
                     "table_scaled_by": X["clip_scale"],
                     "grad_norm": float(metrics["grad_norm"]),
                     "grad_norm_one_rank": float(ref_metrics["grad_norm"]),
                     "loss_rel": loss_rel, "params_max_rel": params_rel,
                     "state_max_rel": state_rel, "grad_norm_rel": norm_rel,
                     "bound": TRAIN_F32_REL, "seconds": step_s,
                     "replicated_params_equal": equal},
           "launches": dict(launches)}
    records = None
    dist.barrier()
    if rank == 0:   # K6 and its backward at the path's shapes, the other ranks waiting
        bag_out = ops.embedding_bag(serve_table, serve_rows)
        train_rows = xdeepfm.local_rows(tcfg, xdeepfm._field_ids(tcfg, rows["ids"]),
                                        mine["table"].shape[0], model).reshape(-1, 1)
        dout = torch.randn((train_rows.shape[0], tcfg.embed_dim), generator=gen, device=device)
        V = mine["table"].shape[0]
        records = {
            "embedding_bag": _bag_record(
                f"xDeepFM serve_p99 over a (2, 2) mesh: a rank's {serve_rows.shape[0]:,} "
                f"bags of one id over its {serve_table.shape[0]:,}-row block, ids outside "
                f"it -1 (phase 4l (e))", serve_table, serve_rows, bag_out),
            "embedding_bag_bwd": _bag_bwd_record(
                f"xDeepFM's train step over a (2, 2) mesh: a rank's {train_rows.shape[0]:,} "
                f"bags of one id into its {V:,}-row block (vocab_per_field "
                f"{tcfg.vocab_per_field:,}), ids outside it -1 (phase 4l (e))",
                train_rows, dout, V, ops.embedding_bag_bwd(train_rows, dout, V))}
    dist.barrier()
    del mine, state, ref_params, ref_state, whole, params, serve_table
    torch.cuda.empty_cache()
    return rec, dict(launches), records


def _dist_tp(rank: int, world: int, timeout, one_rank: dict) -> tuple:
    """Phase 4l (f) on this rank: see the comment above DIST_WORLD.
    ``one_rank`` is (a)'s float32 one-rank step (granite at
    TRAIN_F32_LAYERS, seed 29), which granite's float32 check is held to.
    Returns the record and the K4 launches of the tensor-parallel calls."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.configs import deepseek_7b, granite_3_2b, granite_moe_1b_a400m, lm_cells
    from repro_torch.data.synth import lm_batch
    from repro_torch.dist import tensor_parallel
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axis_group, form_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import zero_init
    from repro_torch.tree import tree_leaves

    device = torch.device("cuda", 0)
    mesh = form_mesh((world // 2, 2), ("data", "model"), device_type="cuda", timeout=timeout)
    data, model = axis_group(mesh, ("data",)), tensor_parallel.model_group(mesh)
    B, S, A = DIST_LM["batch"], DIST_LM["seq"], DIST_LM["n_accum"]
    launches: dict = {}

    def counted(fn):   # fn's K4 launches, added to the path's
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        diff = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
        for k, v in diff.items():
            launches[k] = launches.get(k, 0) + v
        return out, diff

    def fresh(cfg, seed=DIST_TP["seed"]):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return tf.init_params(cfg, gen, device)

    def tp_step(cfg, batch, seed=DIST_TP["seed"]):
        params = tf.shard_params(cfg, fresh(cfg, seed), mesh)
        layout = lm_cells.opt_layout(cfg, params, mesh)
        state = zero_init(params, layout)
        step = lm_cells.make_train_step(cfg, A, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        return params, state, metrics, layout, time.perf_counter() - t0

    def step_check(cfg, name, one, seed=DIST_TP["seed"]):
        """The float32 tensor-parallel step against the one-rank step
        (``one``: (a)'s, else run here), and with ``one`` given the same
        step without wo's reduce_from_model (the control)."""
        control = one is not None
        if one is None:
            batch = lm_batch(seed, 0, B, S, cfg.vocab, device=device)
            ref = fresh(cfg, seed)
            ref_layout = lm_cells.opt_layout(cfg, ref, None)
            _, ref_state, ref_m = lm_cells.make_train_step(cfg, A, None)(
                ref, zero_init(ref, ref_layout), batch)
            del ref
        else:
            batch, ref_state, ref_m = one["batch"], one["state"], one["metrics"]
        want = {"flash_attention": 2 * cfg.n_layers * A, "flash_attention_bwd": cfg.n_layers * A}

        def scalars_rel(metrics) -> dict:
            return {"loss_rel": abs(float(metrics["loss"]) - float(ref_m["loss"]))
                    / abs(float(ref_m["loss"])),
                    "grad_norm_rel": abs(float(metrics["grad_norm"]) - float(ref_m["grad_norm"]))
                    / float(ref_m["grad_norm"])}

        def rel_to_one_rank(state, metrics, layout) -> dict:
            """This rank's ZeRO slice of master, mu and nu, gathered whole
            over the model ranks (gather_params), against the same slice
            of the one-rank state (the data ranks' slices cover it)."""
            state_rel = 0.0
            for part in ("master", "mu", "nu"):
                whole = tf.gather_params(cfg, getattr(state, part), mesh)
                for i, (a, b) in enumerate(zip(tree_leaves(whole),
                                               tree_leaves(getattr(ref_state, part)))):
                    state_rel = max(state_rel, _rel(a, layout.part(b, i)))
                del whole
            return {**scalars_rel(metrics), "state_max_rel": state_rel}

        (_, state, metrics, layout, secs), diff = counted(lambda: tp_step(cfg, batch, seed))
        check(diff == want, f"rank {rank} {name} tensor-parallel step launches {diff}, not {want}")
        got = rel_to_one_rank(state, metrics, layout)
        del state
        worst = max(got.values())
        log(f"rank {rank} 4l (f) {name}: {got} of the one-rank step, {secs:.3f} s")
        check(worst <= TRAIN_F32_REL, f"rank {rank} 4l (f) {name} against one rank: {got}, "
              f"bound {TRAIN_F32_REL}")
        rec = {"n_layers": cfg.n_layers, "loss": float(metrics["loss"]),
               "loss_one_rank": float(ref_m["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "grad_norm_one_rank": float(ref_m["grad_norm"]), **got,
               "bound": TRAIN_F32_REL, "seconds": secs, "launches": diff}
        if control:
            real = tf.reduce_from_model

            def no_wo_reduce(x, ag):   # the attention's partial output left unsummed
                return x if sys._getframe(1).f_code.co_name == "_layer" else real(x, ag)

            with mock.patch.object(tf, "reduce_from_model", no_wo_reduce):
                _, cstate, cm, clayout, _ = tp_step(cfg, batch, seed)
            # the control's slices against the same slices of the one-rank
            # state (no gather: it only has to exceed the bound)
            ctrl = max(scalars_rel(cm).values())
            for part in ("master", "mu", "nu"):
                blocks = tf.shard_params(cfg, getattr(ref_state, part), mesh)
                for i, (a, b) in enumerate(zip(tree_leaves(getattr(cstate, part)),
                                               tree_leaves(blocks))):
                    ctrl = max(ctrl, _rel(a, clayout.part(b, i)))
                del blocks
            del cstate
            check(ctrl > TRAIN_F32_REL, f"rank {rank} 4l (f): the bound passes the step without "
                  f"wo's reduce_from_model ({ctrl})")
            rec["control_no_wo_reduce_max_rel"] = ctrl
        del ref_state
        torch.cuda.empty_cache()
        return rec

    full = granite_3_2b.full_config()
    rec = {"mesh": [data.size, model.size], "batch": B, "seq": S, "n_accum": A}
    marks = [("start", time.perf_counter())]
    # ---- granite float32: the step against one rank, and the control
    rec["granite_float32"] = step_check(
        dataclasses.replace(full, n_layers=TRAIN_F32_LAYERS, dtype=torch.float32),
        "granite float32 step", one_rank, seed=29)
    marks.append(("granite_float32", time.perf_counter()))
    # ---- granite bfloat16: a timed step, the params equal over each data group
    cfg = dataclasses.replace(full, n_layers=DIST_LM["layers"])
    batch = lm_batch(DIST_TP["seed"], 1, B, S, cfg.vocab, device=device)
    want = {"flash_attention_sm90": 2 * cfg.n_layers * A, "flash_attention_bwd": cfg.n_layers * A,
            "flash_attention_bwd_sm90": cfg.n_layers * A}
    torch.cuda.reset_peak_memory_stats()
    (params, _, metrics, _, secs), diff = counted(lambda: tp_step(cfg, batch))
    check(diff == want, f"rank {rank} 4l (f) bfloat16 step launches {diff}, not {want}")
    equal = _same_on_every_rank(_params_sha256(params), data)
    check(equal, f"rank {rank}: the params differ over the data group after the bf16 step")
    check(math.isfinite(float(metrics["loss"])), f"rank {rank}: loss {metrics['loss']}")
    rec["granite_bfloat16"] = {
        "n_layers": cfg.n_layers, "param_count_a_rank": sum(p.numel()
                                                            for p in tree_leaves(params)),
        "step_seconds": secs, "tokens_per_s": B * S / secs, "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]), "params_equal_over_data_group": equal,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": diff}
    del params
    torch.cuda.empty_cache()
    marks.append(("granite_bfloat16", time.perf_counter()))
    # ---- granite bfloat16 prefill of 1 x DIST_TP["prefill"], its last logits
    whole = fresh(cfg)
    local = tf.shard_params(cfg, whole, mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(DIST_TP["seed"])
    toks = torch.randint(0, cfg.vocab, (1, DIST_TP["prefill"]), generator=gen, device=device,
                         dtype=torch.int32)
    t0 = time.perf_counter()
    got, diff = counted(lambda: tf.prefill(cfg, local, toks, model))
    prefill_s = time.perf_counter() - t0
    check(diff == {"flash_attention_sm90": cfg.n_layers},
          f"rank {rank} 4l (f) prefill launches {diff}")
    agree = _agreement(got.float(), tf.prefill(cfg, whole, toks).float())
    check(got.shape == (1, 1, cfg.vocab) and _within(agree, top1=False),
          f"rank {rank} 4l (f) prefill against one rank: {agree}, bound {SUBSTRATE_BF16}")
    rec["granite_prefill_bfloat16"] = {"tokens": DIST_TP["prefill"], **agree,
                                       "bound": SUBSTRATE_BF16["max_abs_over_rms"],
                                       "seconds": prefill_s, "launches": diff}
    del whole, local, got
    torch.cuda.empty_cache()
    marks.append(("granite_prefill", time.perf_counter()))
    # ---- granite-moe float32: expert parallelism, 16 of 32 experts a rank
    rec["granite_moe_float32"] = step_check(
        dataclasses.replace(granite_moe_1b_a400m.full_config(), n_layers=2, dtype=torch.float32),
        "granite-moe float32 step", None)
    marks.append(("granite_moe_float32", time.perf_counter()))
    # ---- deepseek-7b float32: decode over a cache split by kv heads
    cfg = dataclasses.replace(deepseek_7b.full_config(), n_layers=2, dtype=torch.float32)
    whole = fresh(cfg)
    local = tf.shard_params(cfg, whole, mesh)
    Bd, T = DIST_TP["decode_batch"], DIST_TP["decode_steps"]
    toks = torch.randint(0, cfg.vocab, (Bd, T), generator=gen, device=device, dtype=torch.int32)
    cache = tf.init_cache(cfg, Bd, T, device, model)
    ref_cache = tf.init_cache(cfg, Bd, T, device)
    errs, ms = [], []
    for t in range(T):
        t0 = time.perf_counter()
        (got, _), diff = counted(lambda: tf.decode_step(cfg, local, cache, toks[:, t:t + 1],
                                                        model))
        ms.append((time.perf_counter() - t0) * 1e3)
        check(diff == {"flash_attention": cfg.n_layers}, f"rank {rank} decode launches {diff}")
        exp, _ = tf.decode_step(cfg, whole, ref_cache, toks[:, t:t + 1])
        errs.append(float((got - exp).abs().max()))
    check(max(errs) <= SUBSTRATE_F32_ATOL, f"rank {rank} 4l (f) deepseek-7b decode against one "
          f"rank: {max(errs)}, bound {SUBSTRATE_F32_ATOL}")
    rec["deepseek_decode_float32"] = {
        "n_layers": cfg.n_layers, "batch": Bd, "steps": T,
        "kv_heads_a_rank": cache["k"].shape[2], "max_abs_err": max(errs),
        "bound": SUBSTRATE_F32_ATOL, "ms_a_step_median": float(np.median(ms))}
    del whole, local, cache, ref_cache
    torch.cuda.empty_cache()
    marks.append(("deepseek_decode", time.perf_counter()))
    rec["seconds_by_part"] = {b: t - a for (_, a), (b, t) in zip(marks, marks[1:])}
    return rec, launches


def _split_case(cfg, mesh, batch: int, length: int, positions, seq_split: bool, counted,
                expect=None) -> dict:
    """One case of phase 4l (g) (see the comment above DIST_WORLD) on this
    rank: the whole weights and a random whole cache from
    SPLIT_DECODE["seed"] (the same on every rank), this rank's blocks of
    both, one decode step at each position of ``positions`` on the split
    cache and on the whole one; each step's logits against the one-rank
    step's, and its kernel launches (``counted``) against ``expect(pos)``
    where given (``mesh`` may be the model axis alone).  Returns the
    largest error, the launches and the steps' milliseconds."""
    import torch

    from repro_torch.dist.tensor_parallel import model_group
    from repro_torch.launch.mesh import ONE_RANK, axis_group
    from repro_torch.models import transformer as tf

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(SPLIT_DECODE["seed"])
    whole = tf.init_params(cfg, gen, device)
    ref = tf.init_cache(cfg, batch, length, device)
    for k in ref:
        if k != "pos":
            ref[k].copy_(torch.randn(ref[k].shape, generator=gen, device=device))
    mg = model_group(mesh)
    dg = axis_group(mesh, ("data",)) if seq_split else ONE_RANK
    local = tf.shard_params(cfg, whole, mesh)
    cache = tf.shard_cache(cfg, ref, mg, dg)
    toks = torch.randint(0, cfg.vocab, (batch, len(positions)), generator=gen, device=device,
                         dtype=torch.int32)
    steps, launches = [], {}
    for i, pos in enumerate(positions):
        cache["pos"] = ref["pos"] = pos
        t0 = time.perf_counter()
        (got, _), diff = counted(lambda: tf.decode_step(cfg, local, cache, toks[:, i:i + 1], mg,
                                                        dg))
        ms = (time.perf_counter() - t0) * 1e3
        if expect is not None:
            check(diff == expect(pos), f"split decode {cfg.name} at {pos}: launches {diff}, "
                                       f"not {expect(pos)}")
        for k, v in diff.items():
            launches[k] = launches.get(k, 0) + v
        exp, _ = tf.decode_step(cfg, whole, ref, toks[:, i:i + 1])
        steps.append({"pos": pos, "ms": ms, **_agreement(got.float(), exp.float())})
    del whole, local, ref, cache
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "batch": batch, "cache_positions": length,
            "mesh": list(mesh.mesh.shape), "seq_split": seq_split,
            "cache_split": tf.cache_split(cfg, mg.size),
            "max_abs_err": max(x["max_abs"] for x in steps), "steps": steps,
            "launches": launches, "ms_a_step_median": float(np.median([x["ms"] for x in steps]))}


def _lse_records(device) -> list:
    """Phase 4l (g)'s K4 records on rank 0: each kernel at danube's decode
    shapes over a rank's 4,096-key block (32 q heads over 8 kv heads of 80)
    with its lse, against ref.flash_attention_ref(..., return_lse=True):
    the whole block, a window across it, a window of one key.  Each record
    is ``_attention_record``'s (the call without lse: times, bound, SDPA)
    plus the lse's error and the call's time with it."""
    import torch

    import library_cases as lc
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(SPLIT_DECODE["seed"])
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        q = torch.randn((1, 32, 1, 80), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((1, 8, 4096, 80), generator=gen, device=device).to(dtype)
                for _ in range(2))
        # the window of one key over a prefix of 4,000: its key lies in a 32-key
        # chunk that _attention_record's dropped-chunks control removes
        for window, kv_len in ((None, 4096), (2287, 4096), (1, 4000)):
            c = dict(B=1, Hq=32, Hkv=8, S=1, T=4096, D=80, causal=True, window=window,
                     dtype=name, kv_len=kv_len)
            o, lse = ops.flash_attention(q, k, v, window=window, kv_len=kv_len,
                                         return_lse=True)
            rec = _attention_record(
                f"h2o-danube-1.8b decode over a rank's block of a cache split along its "
                f"sequence: {kv_len:,} filled keys, window {window} (phase 4l (g))", c, q, k, v,
                o, device)
            _, exp = ref.flash_attention_ref(q, k, v, window=window, kv_len=kv_len,
                                             return_lse=True)
            lse_err = float((lse - exp).abs().max())
            check(lse_err <= lc.ATTENTION_LSE_TOL, f"K4 {name} lse at window {window}: "
                  f"{lse_err}, bound {lc.ATTENTION_LSE_TOL}")
            with_lse = lambda: ops.flash_attention(q, k, v, window=window,  # noqa: E731
                                                   kv_len=kv_len, return_lse=True)
            w1, w2 = _event_ms(with_lse, 3, warmup=1), _event_ms(with_lse, 3, warmup=1)
            rec.update(lse_max_abs_err=lse_err, lse_tolerance=lc.ATTENTION_LSE_TOL,
                       ms_with_lse=min(w1, w2), ms_with_lse_runs=[w1, w2])
            log(f"K4 {rec['kernel']} lse at danube's decode, window {window}: {lse_err:.2e}, "
                f"{min(w1, w2):.4f} ms with lse, {rec['ms']:.4f} ms without")
            out.append(rec)
    return out


def _dist_split_decode(rank: int, world: int, timeout) -> tuple:
    """Phase 4l (g) on this rank: see the comment above DIST_WORLD.
    Returns the record, the K4 launches of the split steps and (rank 0)
    K4's lse records."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import deepseek_v2_lite_16b, h2o_danube_1_8b
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import form_mesh

    device = torch.device("cuda", 0)
    launches: dict = {}

    def counted(fn):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}

    t_start = time.perf_counter()
    rec = {}
    mesh = form_mesh((world, 1), ("data", "model"), device_type="cuda", timeout=timeout)
    block = SPLIT_DECODE["danube_cache"] // world
    full = h2o_danube_1_8b.full_config()

    def keeps_a_key(pos) -> bool:   # this rank's block meets the window [pos - w + 1, pos]
        lo, base = pos - full.window + 1, rank * block
        return base <= pos and lo < base + block

    for dtype, bound in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        cfg = dataclasses.replace(full, n_layers=SPLIT_DECODE["danube_layers"], dtype=dtype)
        kernel = ops.attention_kernel(dtype)
        case = _split_case(cfg, mesh, 1, SPLIT_DECODE["danube_cache"],
                           SPLIT_DECODE["danube_positions"], True, counted,
                           lambda pos: {kernel: cfg.n_layers} if keeps_a_key(pos) else {})
        if dtype == torch.bfloat16:
            ok = all(_within(x, top1=False) for x in case["steps"])
            case["bound"] = {"max_abs_over_rms": SUBSTRATE_BF16["max_abs_over_rms"]}
        else:
            ok = case["max_abs_err"] <= SUBSTRATE_F32_ATOL
            case["bound"] = SUBSTRATE_F32_ATOL
        check(ok, f"rank {rank} 4l (g) danube {bound} split decode against one rank: "
                  f"{case['steps']}, bound {case['bound']}")
        log(f"rank {rank} 4l (g) danube {bound}: {case['max_abs_err']:.2e} of one rank, "
            f"{case['ms_a_step_median']:.1f} ms a step, launches {case['launches']}")
        launches = _add_counts(launches, case["launches"])
        rec[f"danube_{bound}"] = case
    del mesh
    cfg = dataclasses.replace(deepseek_v2_lite_16b.full_config(),
                              n_layers=SPLIT_DECODE["mla_layers"], dtype=torch.float32)
    for key, shape, batch, positions, seq in (
            ("deepseek_v2_lite_kv_lora", (1, world), SPLIT_DECODE["mla_batch"],
             SPLIT_DECODE["mla_positions"], False),
            ("deepseek_v2_lite_seq_kv_lora", (2, world // 2), 1,
             SPLIT_DECODE["mla_seq_positions"], True)):
        mesh = form_mesh(shape, ("data", "model"), device_type="cuda", timeout=timeout)
        case = _split_case(cfg, mesh, batch, SPLIT_DECODE["mla_cache"], positions, seq, counted,
                           lambda pos: {})
        check(case["max_abs_err"] <= SUBSTRATE_F32_ATOL,
              f"rank {rank} 4l (g) {key} against one rank: {case['steps']}, "
              f"bound {SUBSTRATE_F32_ATOL}")
        case["bound"] = SUBSTRATE_F32_ATOL
        rec[key] = case
        log(f"rank {rank} 4l (g) {key} on {shape}: {case['max_abs_err']:.2e} of one rank, "
            f"{case['ms_a_step_median']:.1f} ms a step")
        del mesh
    torch.cuda.empty_cache()
    records = None
    dist.barrier()
    if rank == 0:   # K4's lse at the path's shapes, the other ranks waiting
        records = _lse_records(device)
    dist.barrier()
    rec["seconds"] = time.perf_counter() - t_start
    return rec, launches, records


def _dist_rank(rank: int, tmp: str, t0: float) -> None:
    """Phase 4l, one rank (spawned): waits for the script's go, then (a),
    (f), (b), (c), (d) and (e); exits non-zero on any failure."""
    global _T0
    _T0 = t0
    d = pathlib.Path(tmp)
    with open(d / f"rank{rank}.log", "w") as logf, contextlib.redirect_stdout(logf):
        try:
            _dist_rank_phases(rank, d)
        except BaseException:
            import traceback

            traceback.print_exc(file=logf)
            logf.flush()
            os._exit(1)


def _dist_warm_up(device) -> None:
    """This process's first use of what phase 4l's steps run (the kernels'
    modules, cuBLAS, K4 in both dtypes forward and backward, gloo's path for
    CUDA tensors), at toy size, before the wait: it cost the first measured
    step about 9 s otherwise."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import granite_3_2b
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(granite_3_2b.full_config(), n_layers=1, vocab=256, dtype=dtype)
        params = tf.init_params(cfg, gen, device)
        tok = torch.randint(0, cfg.vocab, (1, 128), generator=gen, device=device)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        torch.autograd.grad(tf.lm_loss(cfg, params, {"tokens": tok, "labels": tok}), leaves)
    x = torch.ones(4 * DIST_WORLD, device=device)
    dist.all_reduce(x)
    dist.all_gather_into_tensor(torch.empty(4 * DIST_WORLD ** 2, device=device), x)
    dist.reduce_scatter_tensor(torch.empty(4, device=device), x)
    torch.cuda.synchronize()


def _dist_rank_phases(rank: int, d: pathlib.Path) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.cuda.init()
    timeout = datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), DIST_WORLD),
                            rank=rank, world_size=DIST_WORLD, timeout=timeout)
    try:
        t0 = time.perf_counter()
        _dist_warm_up(torch.device("cuda", 0))
        warm_up = time.perf_counter() - t0
        while not (d / "go").exists():
            check(time.perf_counter() - t0 < DIST_WAIT_S, "the script never let us go")
            time.sleep(0.05)
        rec = {"rank": rank, "warm_up_seconds": warm_up,
               "waited_seconds": time.perf_counter() - t0 - warm_up}
        t0 = time.perf_counter()
        rec["lm"], lm_launches, one_rank = _dist_lm(rank, DIST_WORLD, timeout)
        t1 = time.perf_counter()
        # (f) right after (a): it holds its float32 step to (a)'s one-rank
        # step, whose state (2.7 GB a rank) is then dropped before (b)-(e)
        rec["tensor_parallel"], rec["launches_tensor_parallel"] = _dist_tp(rank, DIST_WORLD,
                                                                           timeout, one_rank)
        del one_rank
        torch.cuda.empty_cache()
        t_tp = time.perf_counter()
        rec["split_decode"], rec["launches_split_decode"], rec["k4_lse_records"] = \
            _dist_split_decode(rank, DIST_WORLD, timeout)
        t2 = time.perf_counter()
        rec["gpipe"], pipe_launches = _dist_gpipe(rank, DIST_WORLD, timeout)
        t3 = time.perf_counter()
        rec["gatedgcn"] = _dist_gatedgcn(rank, DIST_WORLD, timeout)
        t4 = time.perf_counter()
        rec["gnn_sharded"] = _dist_gnn_sharded(rank, DIST_WORLD, timeout)
        t5 = time.perf_counter()
        rec["xdeepfm"], bag_launches, rec["k6_records"] = _dist_xdeepfm(rank, DIST_WORLD,
                                                                        timeout)
        rec["seconds_by_part"] = {"lm": t1 - t0, "tensor_parallel": t_tp - t1,
                                  "split_decode": t2 - t_tp,
                                  "gpipe": t3 - t2, "gatedgcn": t4 - t3, "gnn_sharded": t5 - t4,
                                  "xdeepfm": time.perf_counter() - t5}
        rec["launches"] = _add_counts(_add_counts(lm_launches, pipe_launches), bag_launches)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(rec))


def start_dist_ranks() -> tuple:
    """Spawn phase 4l's ranks (their output to files in a temporary
    directory); they reach the card and wait for ``release_dist_ranks``."""
    import multiprocessing
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_4l_")
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=_dist_rank, args=(r, tmp, _T0), daemon=True)
             for r in range(DIST_WORLD)]
    for p in ranks:
        p.start()
    return ranks, tmp


def release_dist_ranks(started) -> None:
    """Let phase 4l's ranks run: the script runs nothing beside them from
    here until ``finish_dist_ranks`` returns."""
    (pathlib.Path(started[1]) / "go").touch()


def finish_dist_ranks(started, smi: str, timeout: float = 300.0) -> dict:
    """Wait for phase 4l's ranks, relay their records, fail if any failed;
    returns {"launches": the launches their paths made, summed over the
    ranks, "tensor_parallel" and "split_decode": (f)'s and (g)'s launches,
    "configs": {kernel: rank 0's records of K6 and its backward at (e)'s
    shapes and of K4's two kernels' lse at (g)'s}}."""
    ranks, tmp = started
    t_start = time.perf_counter()
    t_end = t_start + timeout
    for p in ranks:
        p.join(max(t_end - time.perf_counter(), 0.0))
    d = pathlib.Path(tmp)
    failed = [r for r, p in enumerate(ranks)
              if p.exitcode != 0 or not (d / f"rank{r}.json").exists()]
    for r in failed:   # every failed rank's log: the first fault may be any rank's
        log((d / f"rank{r}.log").read_text() if (d / f"rank{r}.log").exists() else "")
    check(not failed, f"phase 4l ranks {failed} failed, exits "
          f"{[ranks[r].exitcode for r in failed]}")
    recs = [json.loads((d / f"rank{r}.json").read_text()) for r in range(len(ranks))]
    launches, tp_launches, split_launches = {}, {}, {}
    for r in recs:
        launches = _add_counts(launches, r["launches"])
        tp_launches = _add_counts(tp_launches, r["launches_tensor_parallel"])
        split_launches = _add_counts(split_launches, r["launches_split_decode"])
    for name in ("flash_attention_sm90", "flash_attention_bwd", "embedding_bag",
                 "embedding_bag_bwd"):
        check(all(r["launches"].get(name, 0) > 0 for r in recs),
              f"phase 4l: a rank launched no {name}")
    for name in ("flash_attention", "flash_attention_sm90", "flash_attention_bwd",
                 "flash_attention_bwd_sm90"):
        check(all(r["launches_tensor_parallel"].get(name, 0) > 0 for r in recs),
              f"phase 4l (f): a tensor-parallel rank launched no {name}")
    for name in ("flash_attention", "flash_attention_sm90"):
        check(all(r["launches_split_decode"].get(name, 0) > 0 for r in recs),
              f"phase 4l (g): a split-decode rank launched no {name}")
    configs = {k: [v] for k, v in recs[0].pop("k6_records").items()}
    lse_records = recs[0].pop("k4_lse_records")
    for r in recs[1:]:
        r.pop("k6_records")
        r.pop("k4_lse_records")
    record({"phase": "distributed_training", "world": DIST_WORLD, "process_group": "gloo",
            "seconds": time.perf_counter() - t_start, "card": smi, "launches": launches,
            "launches_tensor_parallel": tp_launches, "launches_split_decode": split_launches,
            "ranks": recs})
    r0 = recs[0]
    lm, bf = r0["lm"], r0["lm"]["bfloat16"]
    last = f"bfloat16 step {DIST_LM['steps'] - 1}"
    log(f"4l granite-3-2b on {DIST_WORLD} gloo ranks, ZeRO AdamW: float32 at "
        f"{lm['float32_check']['n_layers']} layers {lm['float32_check']['state_max_rel']:.2e} of a "
        f"one-rank step (bound {TRAIN_F32_REL}, a dropped rank "
        f"{lm['float32_check']['control_dropped_rank_max_rel']:.3f}); bfloat16 at "
        f"{bf['n_layers']} layers, step {min(bf['step_seconds']):.3f} s "
        f"({bf['tokens_per_s']:.0f} tokens/s), gradient reduce-scatter "
        f"{lm['collective_seconds'][last]['grads_reduce_scatter']:.3f} s, params "
        f"all-gather {lm['collective_seconds'][last]['params_all_gather']:.3f} s, "
        f"peak {bf['peak_memory_bytes'] / 2**30:.2f} GiB a rank; int8 all-reduce "
        f"{bf['quantized_psum_grads']['rel_distance_from_float32_average']:.4f} from float32 "
        f"[{smi}]")
    gp, gc = r0["gpipe"], r0["gatedgcn"]
    log("4l GPipe over " + ", ".join(
        f"{k}: output {gp[k]['out_rel']:.2e}, gradients {gp[k]['grad_max_rel']:.2e} (swapped "
        f"stages {gp[k]['control_swapped_stages_rel']:.3f}), {gp[k]['seconds']:.3f} s"
        for k in ("float32", "bfloat16")) + f" [{smi}]")
    log(f"4l gatedgcn dst-local: {gc['max_share_of_bounds']:.3f} of the bounds (wrong rank "
        f"order {gc['control_wrong_order_share']:.1f} x), {gc['seconds_loss_and_grads']:.3f} s "
        f"[{smi}]")
    gs = r0["gnn_sharded"]
    log("4l data-sharded GNN losses on 4 ranks: " + ", ".join(
        f"{k} {v['max_rel']:.2e} of one rank ("
        + (f"bound {v['bound']}, wrong owners {v['control_wrong_owners_max_rel']:.3f}"
           if "control_wrong_owners_max_rel" in v
           else f"not gated: one rank against itself {v['one_rank_rerun_max_rel']:.2e}")
        + (f"), a step {v['seconds_step']:.3f} s" if "seconds_step" in v
           else f"), a loss and its gradients {v['seconds_loss_and_grads']:.3f} s")
        for k, v in gs.items() if isinstance(v, dict)) + f" [{smi}]")
    xd = r0["xdeepfm"]
    log(f"4l xDeepFM on (2, 2), {xd['table_rows_a_rank']:,} table rows a rank: serve "
        f"{xd['serve']['max_abs_err']:.2e} ({xd['serve']['seconds'] * 1e3:.1f} ms; no model "
        f"all-reduce {xd['serve']['control_no_model_all_reduce']:.3f}), retrieval "
        f"{xd['retrieval']['max_abs_err']:.2e} ({xd['retrieval']['seconds']:.3f} s), step at "
        f"vocab {xd['train']['vocab_per_field']:,}: gradient norm "
        f"{xd['train']['grad_norm']:.3f}, state {xd['train']['state_max_rel']:.2e} of one rank, "
        f"{xd['train']['seconds']:.3f} s; K6 launches {xd['launches']} a rank [{smi}]")
    tp = r0["tensor_parallel"]
    g32, gbf, gpf = tp["granite_float32"], tp["granite_bfloat16"], tp["granite_prefill_bfloat16"]
    moe, dec = tp["granite_moe_float32"], tp["deepseek_decode_float32"]
    log(f"4l (f) tensor parallelism on (2, 2): granite f32 step {g32['state_max_rel']:.2e} of "
        f"one rank (grad norm {g32['grad_norm_rel']:.2e}; no wo reduce "
        f"{g32['control_no_wo_reduce_max_rel']:.3f}), bf16 step {gbf['step_seconds']:.3f} s "
        f"({gbf['tokens_per_s']:.0f} tokens/s), prefill 1 x {gpf['tokens']:,} max abs "
        f"{gpf['max_abs']:.4f} (rms {gpf['exp_rms']:.3f}) {gpf['seconds']:.3f} s; granite-moe "
        f"EP step {moe['state_max_rel']:.2e}; deepseek-7b decode {dec['max_abs_err']:.2e}, "
        f"{dec['ms_a_step_median']:.1f} ms a step; K4 launches {tp_launches} [{smi}]")
    sd = r0["split_decode"]
    log("4l (g) split decode against one rank: " + ", ".join(
        f"{k} on {tuple(v['mesh'])} max abs {v['max_abs_err']:.2e}, "
        f"{v['ms_a_step_median']:.1f} ms a step" for k, v in sd.items() if isinstance(v, dict))
        + f"; {sd['seconds']:.1f} s; K4 launches {split_launches} [{smi}]")
    for rec in lse_records:
        configs.setdefault(rec["kernel"], []).append(rec)
    return {"launches": launches, "tensor_parallel": tp_launches,
            "split_decode": split_launches, "configs": configs}


def _split_rank(rank: int, tmp: str, t0: float) -> None:
    """Phase 4l (g)'s granite case, one of SPLIT_WORLD ranks (forked from
    ``prepare_split_ranks``' server, what it runs already imported): reaches
    the card, joins the world, forms its mesh and runs the case; exits
    non-zero on any failure."""
    global _T0
    _T0 = t0
    d = pathlib.Path(tmp)
    with open(d / f"rank{rank}.log", "w") as logf, contextlib.redirect_stdout(logf):
        try:
            _split_rank_phase(rank, d)
        except BaseException:
            import traceback

            traceback.print_exc(file=logf)
            logf.flush()
            os._exit(1)


def _split_rank_phase(rank: int, d: pathlib.Path) -> None:
    marks = {"started": time.perf_counter() - _T0}
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs import granite_3_2b
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import form_mesh

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    torch.cuda.init()
    torch.empty(1, device="cuda")
    marks["on_the_card"] = time.perf_counter() - _T0
    timeout = datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), SPLIT_WORLD),
                            rank=rank, world_size=SPLIT_WORLD, timeout=timeout)
    marks["process_group"] = time.perf_counter() - _T0
    try:
        # the model axis alone: JAX's single mesh's 16 model ranks, with no
        # data group of one rank each to make
        mesh = form_mesh((SPLIT_WORLD,), ("model",), device_type="cuda", timeout=timeout)
        marks["mesh"] = time.perf_counter() - _T0
        t0 = time.perf_counter()

        def counted(fn):
            torch.cuda.synchronize()
            before = dict(ops.LAUNCHES)
            out = fn()
            torch.cuda.synchronize()
            return out, {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}

        cfg = dataclasses.replace(granite_3_2b.full_config(),
                                  n_layers=SPLIT_DECODE["granite_layers"], dtype=torch.float32)
        case = _split_case(cfg, mesh, SPLIT_DECODE["granite_batch"],
                           SPLIT_DECODE["granite_cache"], SPLIT_DECODE["granite_positions"],
                           False, counted, lambda pos: {})
        check(case["cache_split"] == "head_dim" and case["max_abs_err"] <= SUBSTRATE_F32_ATOL,
              f"rank {rank} 4l (g) granite on {SPLIT_WORLD} model ranks against one rank: "
              f"{case['cache_split']} {case['steps']}, bound {SUBSTRATE_F32_ATOL}")
        case["bound"] = SUBSTRATE_F32_ATOL
        rec = {"rank": rank, "granite_head_dim": case, "seconds": time.perf_counter() - t0,
               "start_up_at_seconds": marks}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(rec))


# what phase 4l (g)'s 16 ranks run, imported once in the fork server they
# are forked from: 16 spawned processes importing torch took 21.5-25 s on
# the 8 host cores beside an NVIDIA H100 80GB HBM3 (700.00 W)
SPLIT_PRELOAD = ["__main__", "torch", "torch.distributed", "repro_torch.configs",
                 "repro_torch.models.transformer", "repro_torch.kernels.ops",
                 "repro_torch.launch.mesh"]


def prepare_split_ranks() -> float:
    """Start the fork server phase 4l (g)'s ranks are forked from, its
    imports (SPLIT_PRELOAD) running in the background from here on (one
    process; nothing there touches the card).  Returns the time it was
    asked for."""
    import multiprocessing
    from multiprocessing import forkserver

    multiprocessing.get_context("forkserver").set_forkserver_preload(SPLIT_PRELOAD)
    forkserver.ensure_running()
    return time.perf_counter()


def start_split_ranks() -> tuple:
    """Fork phase 4l (g)'s SPLIT_WORLD ranks from ``prepare_split_ranks``'
    server (waiting for its imports where they have not ended)."""
    import multiprocessing
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_4lg_")
    ctx = multiprocessing.get_context("forkserver")
    ranks = [ctx.Process(target=_split_rank, args=(r, tmp, _T0), daemon=True)
             for r in range(SPLIT_WORLD)]
    t0 = time.perf_counter()
    for p in ranks:
        p.start()
    return ranks, tmp, t0


def finish_split_ranks(started, smi: str, timeout: float = 240.0) -> dict:
    """Wait at most ``timeout`` s for the ranks of ``start_split_ranks``,
    relay their records; fail if any failed.  Their start-up is the last
    rank's mesh mark since their fork (the card, gloo and the mesh)."""
    ranks, tmp, t_fork = started
    d = pathlib.Path(tmp)
    for p in ranks:
        p.join(max(t_fork + timeout - time.perf_counter(), 0.0))
    failed = [r for r, p in enumerate(ranks)
              if p.exitcode != 0 or not (d / f"rank{r}.json").exists()]
    for r in failed:
        log((d / f"rank{r}.log").read_text() if (d / f"rank{r}.log").exists() else "")
    check(not failed, f"phase 4l (g) ranks {failed} failed, exits "
          f"{[ranks[r].exitcode for r in failed]}")
    recs = [json.loads((d / f"rank{r}.json").read_text()) for r in range(SPLIT_WORLD)]
    since = {k: max(r["start_up_at_seconds"][k] for r in recs) - (t_fork - _T0)
             for k in ("started", "on_the_card", "process_group", "mesh")}
    out = {"phase": "split_decode_16_ranks", "world": SPLIT_WORLD, "process_group": "gloo",
           "start_up_seconds": since, "seconds": time.perf_counter() - t_fork, "card": smi,
           "ranks": recs}
    record(out)
    g = recs[0]["granite_head_dim"]
    log(f"4l (g) granite-3-2b f32 on {SPLIT_WORLD} model ranks, split {g['cache_split']}: max abs "
        f"{max(r['granite_head_dim']['max_abs_err'] for r in recs):.2e} of one rank, "
        f"{g['ms_a_step_median']:.1f} ms a step; the last of {SPLIT_WORLD} ranks forked "
        f"{since['started']:.1f} s, on the card {since['on_the_card']:.1f}, in the process group "
        f"{since['process_group']:.1f}, its mesh {since['mesh']:.1f} s after the fork; "
        f"{out['seconds']:.1f} s in all [{smi}]")
    return out


def stop_dist_ranks(started) -> None:
    import shutil

    ranks, tmp = started
    for p in ranks:
        if p.is_alive():
            p.kill()
        p.join()
    shutil.rmtree(tmp, ignore_errors=True)


def merge_distributed(library: list, dist_out: dict) -> None:
    """The K4 and K6 records count phase 4l's launches (every rank's)
    beside their other paths', (f)'s tensor-parallel K4 and K4-backward
    launches and (g)'s split-decode K4 launches under their own keys; K6's
    and its backward's take (e)'s records at the path's shapes after their
    own, K4's two kernels (g)'s lse records."""
    for rec in library:
        for path, counts in (("distributed_training", dist_out["launches"]),
                             ("tensor_parallel", dist_out["tensor_parallel"]),
                             ("split_decode", dist_out["split_decode"])):
            n = _own_launches(counts).get(rec["name"], 0)
            if n:
                rec.setdefault("launches_by_path", {"kernel_library": rec["launches"]})
                rec["launches_by_path"][path] = n
                rec["launches"] += n
        mine = dist_out["configs"].get(rec["name"])
        if mine:
            rec["configs"] += mine
            rec["cases_checked"] += len(mine)


# ------------------------------------------------------------------ phase 4d

# the full store at citeseer@1.0 (L_out 16 wide, L_in 8) and the padded floor
# both sides reach at any budget below 2/3 of it: 8 + 8 int32 columns a row
FULL_LABEL_BYTES = 66_618_912
FLOOR_LABEL_BYTES = 44_412_608
QUARANTINE_QUERIES = 4096
BUDGET_SEARCH_SECONDS = 60.0   # the budgeted run serves a prefix past this
# ... or past the point where the whole script would end later than its
# target (330 s), with this much left for what follows the budgeted run
# (the rest of 4d and phases 5-7)
SCRIPT_TARGET_SECONDS = 330.0
AFTER_4D_SECONDS = 20.0


def phase_cold_start_and_budget(g, co, queries: np.ndarray, verdicts: np.ndarray) -> dict:
    """Phase 4's oracle saved and cold-started, a corrupt snapshot served in
    quarantine mode, then phase 4's engine under a memory budget, each
    against phase 4's verdicts (``verdicts`` of ``queries``).  Returns the
    budgeted ``ServeBatch`` op and the launches of its run, for phase 5."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.api import oracle_from_snapshot
    from repro_torch.ft import inject
    from repro_torch.kernels import ops, ref
    from repro_torch.persist import (CorruptSnapshotError, load_budgeted, load_oracle,
                                     save_budgeted, save_oracle)
    from repro_torch.serve.budget import BudgetController, label_bytes, truncate_store

    t_phase = time.perf_counter()
    eng, o = co.engine, co.oracle
    full = label_bytes(o)
    check(full == FULL_LABEL_BYTES, f"full store {full} bytes, not {FULL_LABEL_BYTES}")
    rec = {"phase": "cold_start_budget", "dataset": MAIN_DATASET, "scale": MAIN_SCALE,
           "full_label_bytes": full}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as tmp:
        d = pathlib.Path(tmp)
        # ---- 1. save, cold start, serve phase 4's traffic
        t0 = time.perf_counter()
        path = save_oracle(str(d / "oracle"), o)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_oracle(path)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        cold = oracle_from_snapshot(g, path, device=eng.device)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        check_labels(o, cold.oracle, "the cold-started oracle")
        check(cold.engine.backend == "kernel",
              f"auto resolved to {cold.engine.backend!r} after a cold start")
        cold.serve(queries[:BATCH])
        ops.reset_launches()
        # ---- the cold-started path
        cold_out, t_serve = serve_all(cold, queries, None)
        cold_launches = dict(ops.LAUNCHES)
        # ----
        n_batches = -(-queries.shape[0] // BATCH)
        check(np.array_equal(cold_out, verdicts),
              f"cold start != phase 4 on {int((cold_out != verdicts).sum())} queries")
        check(cold_launches["serve_batch"] == n_batches and
              cold_launches["label_intersect"] == 0, f"cold start launches {cold_launches}")
        check(not any(cold.engine.degradation.values()),
              f"degradation after a cold start: {cold.engine.degradation}")
        rec["cold_start"] = {"save_seconds": t_save, "bytes_on_disk": _dir_bytes(d / "oracle"),
                             "load_seconds": t_load, "cold_start_seconds": t_cold,
                             "serve_qps": queries.shape[0] / t_serve,
                             "launches": cold_launches, "labels_equal": True,
                             "verdicts_equal": True}
        del cold

        # ---- 2. a corrupt row block: strict refuses, quarantine serves it
        cq = co.comp[queries]
        per_block = np.bincount(cq[:, 0] // 4096)
        k = int(per_block.argmax())
        bad = shutil.copytree(path, d / "corrupt")
        inject.flip_bit(str(bad / f"L_out.{k:05d}.npy"), seed=5)
        try:
            oracle_from_snapshot(g, str(bad), device=eng.device)
        except CorruptSnapshotError:
            pass
        else:
            check(False, "a strict load of a corrupt snapshot did not raise")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            quar = oracle_from_snapshot(g, str(bad), mode="quarantine", device=eng.device)
        rows = quar.engine.stats()["n_quarantined"]
        check(rows == min(4096, o.n - 4096 * k), f"{rows} rows quarantined")
        touch = np.flatnonzero(cq[:, 0] // 4096 == k)[:QUARANTINE_QUERIES]
        check(touch.size == QUARANTINE_QUERIES, f"only {touch.size} queries touch block {k}")
        t0 = time.perf_counter()
        q_out = quar.serve(queries[touch])
        t_quar = time.perf_counter() - t0
        deg = quar.engine.stats()["degradation"]
        check(np.array_equal(q_out, verdicts[touch]), "quarantine mode differs from phase 4")
        check(deg["quarantined"] == deg["searched"] == QUARANTINE_QUERIES
              and deg["uncertain"] == 0 and deg["device_to_host"] == 0,
              f"quarantine counters {deg}")
        rec["quarantine"] = {"block": f"L_out.{k:05d}", "rows": rows,
                             "queries": int(touch.size), "seconds": t_quar,
                             "degradation": deg, "verdicts_equal": True}
        del quar

        # ---- 3. phase 4's engine under 0.75 x the full store
        budget = int(0.75 * full)
        ctl = BudgetController(eng)
        t0 = time.perf_counter()
        store = truncate_store(ctl.full_oracle(), budget_bytes=budget)
        t_cut = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng.set_budget(store)
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        mem_after = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ctl.apply(budget)          # the governor's own re-truncation (cut + upload)
        torch.cuda.synchronize()
        t_retrunc = time.perf_counter() - t0
        store = eng.budget_store
        # theta*: the largest threshold keeping every row within 8 entries,
        # the smallest rank value in a 9th column
        theta = min(int(m[lens > 8, 8].min()) for m, lens in
                    ((o.L_out, o.out_len), (o.L_in, o.in_len)) if (lens > 8).any())
        check(store.rank_cut == theta, f"rank_cut {store.rank_cut}, not theta* {theta}")
        check(store.resident_bytes == FLOOR_LABEL_BYTES,
              f"resident {store.resident_bytes} bytes, not {FLOOR_LABEL_BYTES}")
        bv = eng._budget_view
        co.serve(queries[:BATCH])   # warm-up, outside the count
        eng.reset_stats()
        latencies, outs = [], []
        ops.reset_launches()
        # ---- the budgeted path: batches of phase 4's traffic until its end,
        # BUDGET_SEARCH_SECONDS, or the script's target, whichever comes first
        t0 = time.perf_counter()
        left = SCRIPT_TARGET_SECONDS - AFTER_4D_SECONDS - (t0 - _T0)
        cap = min(BUDGET_SEARCH_SECONDS, left)
        for i in range(0, queries.shape[0], BATCH):
            t_batch = time.perf_counter()
            outs.append(co.serve(queries[i:i + BATCH]))
            latencies.append(time.perf_counter() - t_batch)
            if time.perf_counter() - t0 > cap:
                break
        t_budget = time.perf_counter() - t0
        budget_launches = dict(ops.LAUNCHES)
        degradation = dict(eng.degradation)
        # ----
        b_out = np.concatenate(outs)
        served = b_out.size
        check(eng.last_stats["backend"] == "kernel", "the budgeted run left the kernel")
        check(budget_launches["serve_batch"] == len(latencies)
              and budget_launches["label_intersect"] == 0,
              f"budgeted launches {budget_launches} for {len(latencies)} batches")
        check(np.array_equal(b_out, verdicts[:served]),
              f"budgeted verdicts differ from the full store's on "
              f"{int((b_out != verdicts[:served]).sum())} queries")
        # the kernel's marks against the plain version on the same batches
        sb = bv.serve_batch
        args = [sb.L_out, sb.L_in, sb.out_len, sb.in_len, sb.level, sb.widths]
        marked = 0
        for i in range(0, served, BATCH):
            qb = np.ascontiguousarray(cq[i:i + BATCH], dtype=np.int32)
            got = sb(qb)
            exp = ref.serve_batch_ref(*args, torch.from_numpy(qb).to(eng.device),
                                      sb.trunc_out, sb.trunc_in).cpu().numpy()
            check(np.array_equal(got, exp), f"budgeted serve_batch != plain at batch {i}")
            marked += int((got >> 7).sum())
        check(degradation["uncertain"] > 0, "no query was uncertain under the budget")
        check(degradation["uncertain"] == marked == degradation["searched"],
              f"uncertain {degradation['uncertain']}, marked {marked}, "
              f"searched {degradation['searched']}")
        check(not any(v for k, v in degradation.items() if k not in ("uncertain", "searched")),
              f"degradation {degradation}")
        rec["budget_0_75"] = {
            "budget_bytes": budget, "rank_cut": store.rank_cut, "theta_star": theta,
            "resident_bytes": store.resident_bytes, "dropped_ints": store.dropped_ints,
            "truncated_rows": {"out": int(store.truncated_out.sum()),
                               "in": int(store.truncated_in.sum())},
            "cut_seconds": t_cut, "upload_seconds": t_upload, "retruncate_seconds": t_retrunc,
            "memory_allocated": {"before_set_budget": mem_before,
                                 "after_set_budget": mem_after,
                                 "added": mem_after - mem_before},
            "served": int(served), "of": int(queries.shape[0]),
            "prefix_why": None if served == queries.shape[0] else
            f"searching the uncertain queries passed {BUDGET_SEARCH_SECONDS} s"
            if cap == BUDGET_SEARCH_SECONDS else
            f"the script had {left:.1f} s left before its {SCRIPT_TARGET_SECONDS} s target",
            "kernel_qps": served / t_budget,
            "batch_ms": {"p50": float(np.percentile(latencies, 50)) * 1e3,
                         "p99": float(np.percentile(latencies, 99)) * 1e3,
                         "max": max(latencies) * 1e3},
            "launches": budget_launches, "degradation": degradation,
            "uncertain_marked_by_kernel": marked, "verdicts_equal_full": True}
        budgeted = {"op": sb, "launches": budget_launches["serve_batch"]}

        # ---- 4. 0.5 x full: the padded floor, one batch
        ctl.apply(int(0.5 * full))
        st = eng.budget_store
        check(st.rank_cut == 0 and st.resident_bytes == FLOOR_LABEL_BYTES > int(0.5 * full),
              f"at 0.5: rank_cut {st.rank_cut}, resident {st.resident_bytes}")
        eng.reset_stats()
        t0 = time.perf_counter()
        half = co.serve(queries[:BATCH])
        t_half = time.perf_counter() - t0
        check(np.array_equal(half, verdicts[:BATCH]), "verdicts at the floor differ")
        rec["budget_0_5"] = {"budget_bytes": int(0.5 * full), "rank_cut": st.rank_cut,
                             "resident_bytes": st.resident_bytes, "queries": BATCH,
                             "seconds": t_half, "degradation": dict(eng.degradation),
                             "verdicts_equal_full": True}

        # ---- 5. the 0.75 store saved and loaded, byte for byte
        t0 = time.perf_counter()
        bpath = save_budgeted(str(d / "budgeted"), store)
        back = load_budgeted(bpath)
        t_bsnap = time.perf_counter() - t0
        for a, b in zip(store.packed_masks(), back.packed_masks()):
            check(a.tobytes() == b.tobytes(), "budgeted masks differ after a reload")
        check_labels(store.oracle, back.oracle, "the reloaded budgeted store")
        check((back.rank_cut, back.resident_bytes, back.dropped_ints)
              == (store.rank_cut, store.resident_bytes, store.dropped_ints),
              "budgeted store meta differs after a reload")
        rec["budgeted_snapshot"] = {"seconds": t_bsnap, "bytes_on_disk": _dir_bytes(d / "budgeted"),
                                    "equal": True}

    # ---- 6. the full store again: apply(None), then refresh
    ctl.apply(None)
    check(eng.budget_store is None, "apply(None) left a budget")
    epoch = eng.epoch
    eng.refresh(o)
    check(eng.epoch == epoch + 1 and eng._serve_batch is None, "refresh kept the old binding")
    eng.reset_stats()
    ops.reset_launches()
    again, _ = serve_all(co, queries, None)
    again_launches = dict(ops.LAUNCHES)
    check(np.array_equal(again, verdicts), "after refresh the verdicts differ from phase 4's")
    check(again_launches["serve_batch"] == n_batches and not any(eng.degradation.values()),
          f"after refresh: launches {again_launches}, degradation {eng.degradation}")
    rec["refreshed"] = {"epoch": eng.epoch, "launches": again_launches,
                        "degradation": dict(eng.degradation), "verdicts_equal": True}
    rec["seconds"] = time.perf_counter() - t_phase
    record(rec)
    b = rec["budget_0_75"]
    log(f"cold start: save {t_save:.3f} s ({rec['cold_start']['bytes_on_disk']} bytes), load "
        f"{t_load:.3f} s, cold start {t_cold:.3f} s, labels and verdicts equal; quarantine "
        f"{QUARANTINE_QUERIES} queries in {t_quar:.3f} s; budget 0.75: rank_cut "
        f"{b['rank_cut']}, resident {b['resident_bytes']}, {b['served']} queries at "
        f"{b['kernel_qps']:.1f} queries/s, uncertain {degradation['uncertain']}, batch p50 "
        f"{b['batch_ms']['p50']:.4f} ms p99 {b['batch_ms']['p99']:.4f} ms, memory +"
        f"{mem_after - mem_before} bytes; phase {rec['seconds']:.3f} s")
    return budgeted


# ------------------------------------------------------------------ phase 5


def _event_ms(fn, reps: int, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn, runtime: bool = False) -> tuple:
    """Run ``fn`` once under torch.profiler; returns (wall ms, [(category,
    name, device us)] of every kernel, copy and memset the card ran), and
    with ``runtime`` the host's CUDA runtime and driver calls as well (their
    host us)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    cats = ("kernel", "gpu_memcpy", "gpu_memset") + (
        ("cuda_runtime", "cuda_driver") if runtime else ())
    return wall_ms, [(ev["cat"], ev.get("name", ""), float(ev.get("dur", 0.0)))
                     for ev in events if ev.get("ph") == "X" and ev.get("cat") in cats]


def _serve_batch_work(args: list, q: np.ndarray, codes: np.ndarray,
                      masks: bool = False) -> dict:
    """What one ``serve_batch`` call on queries ``q`` with result ``codes``
    needs, each input byte read once and each output byte written once: the
    ids, the four scalars of every query (two without levels), under a
    budget its two truncation-mask bits, the label rows of the queries that
    reach intersection cut to min(length, tier width), a code byte a query;
    the int32 compares of a row-major all-pairs scan that
    stops at the first shared value; and the distinct 32-byte sectors the
    kernel's loads touch (ids, scalars, each query's first row vectors, which
    it loads before the prefilters decide, and the rest of the intersected
    rows' vectors) and its stores."""
    import torch

    L_out, L_in, out_len, in_len, level, widths = args
    dev = L_out.device
    (n, Lo), Li = L_out.shape, L_in.shape[1]
    qt = torch.from_numpy(q).to(dev).long()
    qt = torch.where(qt < 0, qt + n, qt)
    fate = (torch.from_numpy(codes).to(dev).long() & 0x7F) >> 1
    sel = fate > 0
    u, v = qt[sel, 0], qt[sel, 1]
    w = torch.tensor(widths, device=dev)[fate[sel] - 1]
    la, lb = torch.minimum(out_len[u].long(), w), torch.minimum(in_len[v].long(), w)
    B = q.shape[0]
    scalars = 2 if level is None else 4
    compares = 0
    for i in range(0, u.numel(), 1 << 16):
        a, b = L_out[u[i:i + (1 << 16)]], L_in[v[i:i + (1 << 16)]]
        ca, cb = la[i:i + (1 << 16)], lb[i:i + (1 << 16)]
        av = (torch.arange(Lo, device=dev)[None, :] < ca[:, None]) & (a != -1)
        bv = torch.arange(Li, device=dev)[None, :] < cb[:, None]
        eq = ((a[:, :, None] == b[:, None, :]) & av[:, :, None] & bv[:, None, :]).flatten(1)
        first = eq.int().argmax(1)
        compares += int(torch.where(eq.any(1), (first // Li) * cb + first % Li + 1,
                                    ca * cb).sum())

    def row_sectors(base_elems, ncols, row_elems):
        """Distinct sectors of rows starting at ``base_elems`` (int32 offsets)
        read over their first ``ncols`` columns (int64 per row)."""
        start = base_elems * 4 // 32
        end = (base_elems * 4 + torch.clamp(ncols, min=1) * 4 - 1) // 32
        span = int((end - start).max()) + 1 if start.numel() else 0
        ids = start[:, None] + torch.arange(span, device=dev)[None, :]
        return int(torch.unique(ids[(ids <= end[:, None]) & (ncols[:, None] > 0)]).numel())

    round4 = lambda x: (x + 3) // 4 * 4  # noqa: E731
    # first vectors: columns [0, min(width, 16)) of every query's rows; the
    # intersected rows' later vectors run to their cut length, rounded up
    first_o = torch.full((B,), min(Lo, 16), device=dev, dtype=torch.long)
    first_i = torch.full((B,), min(Li, 16), device=dev, dtype=torch.long)
    first_o[sel] = torch.maximum(first_o[sel], round4(la))
    first_i[sel] = torch.maximum(first_i[sel], round4(lb))
    both = torch.cat([qt[:, 0], qt[:, 1]])
    sectors = {
        "ids": -(-B * 8 // 32),
        "scalars": (int(torch.unique(qt[:, 0] * 4 // 32).numel())
                    + int(torch.unique(qt[:, 1] * 4 // 32).numel())
                    + (0 if level is None else int(torch.unique(both * 4 // 32).numel()))),
        "label_rows": row_sectors(qt[:, 0] * Lo, first_o, Lo) + row_sectors(qt[:, 1] * Li,
                                                                              first_i, Li),
        "codes": -(-B // 32) + 1}
    if masks:   # one byte of each mask a query, read with the scalars
        sectors["masks"] = (int(torch.unique(qt[:, 0] // 256).numel())
                            + int(torch.unique(qt[:, 1] // 256).numel()))
    return {"bytes": B * 8 + B * scalars * 4 + (-(-2 * B // 8) if masks else 0)
            + int((la + lb).sum()) * 4 + B,
            "compares": compares, "intersected": int(sel.sum()), "sectors": sectors,
            "sector_bytes": 32 * sum(sectors.values())}


def timing_serve_batch(co, cq: np.ndarray, launches: dict, cases: int, budgeted) -> dict:
    """K1's batch form and its plain version at the main path's binding (the
    engine's resident citeseer@1.0 labels, lengths, levels and widths): on
    the first batch of the traffic (B = 4096, condensation ids) and on the
    whole traffic in one call (B = 1,048,576); then the same two under phase
    4d's budget (``budgeted``: its ``ServeBatch`` op, bound to the cut store
    and its truncation masks, and the launches of phase 4d's budgeted run).  The call (copy in, launch, copy out, one
    synchronise) by CUDA events, the kernel's device time by torch.profiler,
    the bound from the work these queries need."""
    import torch

    from repro_torch.kernels import ref

    configs = []
    full = co.engine._serve_batch_op()
    for sb, B, reps, n_launch in ((full, BATCH, 200, launches["main_path"]),
                                  (full, cq.shape[0], 10, launches["main_path"]),
                                  (budgeted["op"], BATCH, 200, budgeted["launches"]),
                                  (budgeted["op"], cq.shape[0], 10, budgeted["launches"])):
        args = [sb.L_out, sb.L_in, sb.out_len, sb.in_len, sb.level, sb.widths]
        masks = (sb.trunc_out, sb.trunc_in)
        dev = sb.L_out.device
        q = np.ascontiguousarray(cq[:B], dtype=np.int32)
        qd = torch.from_numpy(q).to(dev)
        got = sb(q)
        exp = ref.serve_batch_ref(*args, qd, *masks).cpu().numpy()
        check(np.array_equal(got, exp), f"serve_batch differs from its plain version at "
                                        f"B={B} on {int((got != exp).sum())} queries")
        kern = lambda: sb(q)  # noqa: E731
        plain = lambda: ref.serve_batch_ref(*args, qd, *masks)  # noqa: E731
        # plain, kernel, kernel, plain: both sides see the same card state
        p1, k1, k2, p2 = (_event_ms(plain, max(reps // 4, 3), warmup=2), _event_ms(kern, reps),
                          _event_ms(kern, reps), _event_ms(plain, max(reps // 4, 3), warmup=2))
        device_ms = _kernel_device_ms(kern, "serve_batch_kernel", min(reps, 50))
        budget = sb.trunc_out is not None
        work = _serve_batch_work(args, q, got, masks=budget)
        bound = _bound(work["bytes"], work["compares"], PEAK_INT32_OPS_PER_S)
        fates = np.bincount((got & 0x7F) >> 1, minlength=1 + len(sb.widths))
        configs.append({
            "B": B, "budgeted": budget,
            "uncertain": int((got >> 7).sum()),
            "shape": {"B": B, "L_out": list(sb.L_out.shape), "L_in": list(sb.L_in.shape),
                      "widths": sb.widths, "level": sb.level is not None,
                      "prefiltered": int(fates[0]), "tiers": fates[1:].tolist()},
            "ms": min(k1, k2), "ms_runs": [k1, k2], "device_ms": device_ms,
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2], "launches": n_launch,
            **bound, **work, "bound_share_device": bound["bound_ms"] / device_ms,
            # no PyTorch call computes prefilters, tiers and intersection in one
            "library_ms": None})
        log(f"serve_batch B={B}{' budgeted' if budget else ''}: {min(k1, k2):.6f} ms a call "
            f"(device {device_ms:.6f} ms), plain {min(p1, p2):.6f} ms, bound "
            f"{configs[-1]['bound_ms']:.6f} ms ({configs[-1]['bound_by']}), "
            f"{work['sector_bytes']} sector bytes")
    head = configs[0]
    return {
        "name": "serve_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/serve_batch.cu",
        "replaces": "src/repro/kernels/label_intersect.py:48",
        # every path of the script that serves through it, each read around
        # its own run: phase 4, HL (4e), the quickstart (4f), the daemon (4g)
        "launches": sum(launches.values()), "launches_by_path": launches,
        "matches_plain": True, "cases_checked": cases + len(configs),
        "max_abs_err": 0,
        **{k: head[k] for k in ("shape", "ms", "ms_runs", "device_ms", "plain_ms",
                                "plain_ms_runs", "bound_ms", "bound_by", "bytes",
                                "operations", "library_ms")},
        "budgeted_ms": configs[2]["ms"], "budgeted_device_ms": configs[2]["device_ms"],
        "budgeted_bound_ms": configs[2]["bound_ms"], "budgeted_launches": budgeted["launches"],
        "configs": configs}


TIER_BIG_B = 1 << 20   # the tier form's large batch: where its byte bound binds


def phase_timing(co, rest: np.ndarray, launches: dict, cases: dict, pinned_b: int) -> list:
    """K1's tier form and its plain version on the main path's label
    matrices at width 16 (``serve_step``'s full width on them): at the
    pinned batch size of phase 4h, ``pinned_b`` queries of the main path's
    intersection residue ``rest`` (condensation ids), at B = 4096 and at
    ``TIER_BIG_B``, the residue repeated (the plain version there timed over
    a few calls only).  ``launches``: its launches by path (phase 4 and
    phase 4h)."""
    import torch

    from repro_torch.kernels import ops, ref

    o, eng = co.oracle, co.engine
    check(rest.shape[0] >= BATCH, "too few intersection queries to time")
    width = 16
    L_out, L_in = o.device_labels(eng.device)
    wa, wb = min(width, L_out.shape[1]), min(width, L_in.shape[1])
    flush = _l2_flush(eng.device)
    configs = []
    for B in (pinned_b, BATCH, TIER_BIG_B):
        q = torch.from_numpy(np.resize(rest, (B, 2))).to(eng.device)
        got = ops.tier_intersect(L_out, L_in, q, width)
        exp = ref.tier_intersect_ref(L_out, L_in, q, width)
        torch.cuda.synchronize()
        max_abs_err = int((got.to(torch.int32) - exp.to(torch.int32)).abs().max())
        check(max_abs_err == 0, f"kernel disagrees with its plain version at B={B}")
        kern = lambda: ops.tier_intersect(L_out, L_in, q, width)  # noqa: E731
        plain = lambda: ref.tier_intersect_ref(L_out, L_in, q, width)  # noqa: E731
        # plain, kernel, kernel, plain: both sides see the same card state
        plain_reps, plain_warmup = (200, 10) if B <= BATCH else (5, 1)
        p1, k1, k2, p2 = (_event_ms(plain, plain_reps, plain_warmup), _event_ms(kern, 200),
                          _event_ms(kern, 200), _event_ms(plain, plain_reps, plain_warmup))
        kern()
        c = {"B": B, "max_abs_err": max_abs_err,
             "ms": min(k1, k2), "ms_runs": [k1, k2],
             # back to back (the rows of the call before in L2), and after
             # an L2 flush, the time the shares hold against the DRAM rate
             "device_ms": _kernel_device_ms(kern, "label_intersect_kernel", 50),
             "device_ms_l2_flushed": _cold_device_ms(kern, "label_intersect_kernel", 50, flush),
             "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
             **tier_intersect_bound(L_out, L_in, q, width),
             "library_ms": None}
        c["bound_share"] = c["bound_ms"] / c["device_ms_l2_flushed"]
        c["bound_share_l2_warm"] = c["bound_ms"] / c["device_ms"]
        c["gather_floor_share"] = c["gather_floor_ms"] / c["device_ms_l2_flushed"]
        configs.append(c)
        log(f"label_intersect B={B}: {c['ms']:.6f} ms a call (device {c['device_ms']:.6f} ms, "
            f"{c['device_ms_l2_flushed']:.6f} after an L2 flush; bound {c['bound_ms']:.6f} ms, "
            f"{c['bound_share']:.1%} of it, gather floor {c['gather_floor_ms']:.6f} ms, "
            f"{c['gather_floor_share']:.1%}), plain {c['plain_ms']:.6f} ms")
    head = configs[0]
    return [{
        "name": "label_intersect",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/label_intersect.cu",
        "replaces": "src/repro/kernels/label_intersect.py:48",
        # phase 4 (none: its kernel backend runs the batch form) and the
        # pinned epochs of phase 4h, each read around its own run
        "launches": sum(launches.values()), "launches_by_path": launches,
        "matches_plain": True,
        "cases_checked": cases["label_intersect"] + len(configs),
        "max_abs_err": max(c["max_abs_err"] for c in configs),
        "shape": {"B": head["B"], "width": width, "wa": wa, "wb": wb,
                  "L_out": list(L_out.shape), "L_in": list(L_in.shape),
                  "at": "the pinned batch size of phase 4h"},
        **{k: head[k] for k in ("ms", "ms_runs", "device_ms", "device_ms_l2_flushed",
                                "plain_ms", "plain_ms_runs", "bound_ms", "bound_by", "bytes",
                                "operations", "bound_share", "gather_floor_bytes",
                                "gather_floor_ms", "gather_floor_share", "library_ms")},
        "configs": configs,
    }]


def timing_frontier_or(real, launches: dict, cases: int) -> dict:
    """K2's slab form and its plain version, fused, at a real out-slab and
    frontier (phase 4b's): out[perm[i]] |= OR of the frontier words of row
    i's neighbors.  ``launches``: its launches by path (the device build,
    none since the frontier form; phase 4i's mesh= build).  Its bound
    counts the whole slab."""
    import torch

    from repro_torch.kernels import ops, ref

    slab, f, perm_r = real
    out = f.clone()
    flags = torch.zeros(2, dtype=torch.int32, device=f.device)
    exp_out, exp_flags = out.clone(), flags.clone()
    ops.frontier_or(slab, f, out=out, perm=perm_r, flags=flags)
    ref.frontier_or_ref(slab, f, out=exp_out, perm=perm_r, flags=exp_flags)
    torch.cuda.synchronize()
    max_abs_err = int((out.long() - exp_out.long()).abs().max())
    check(max_abs_err == 0 and torch.equal(flags, exp_flags),
          "frontier_or disagrees with its plain version at the timed shape")
    kern = lambda: ops.frontier_or(slab, f, out=out, perm=perm_r, flags=flags)  # noqa: E731
    plain = lambda: ref.frontier_or_ref(slab, f, out=exp_out, perm=perm_r,  # noqa: E731
                                        flags=exp_flags)
    p1, k1, k2, p2 = (_event_ms(plain, 50), _event_ms(kern, 200),
                      _event_ms(kern, 200), _event_ms(plain, 50))
    device_ms = _kernel_device_ms(kern, "frontier_or_kernel", 50)
    cold_ms = _cold_device_ms(kern, "frontier_or_kernel", 50, _l2_flush(f.device))
    r, d = slab.shape
    wm = f.shape[1]
    valid = int(slab.ne(-1).sum())
    bound = frontier_or_bound(slab, wm)
    return {
        "name": "frontier_or",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frontier_or.cu",
        "replaces": "src/repro/kernels/frontier_ell.py:61",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "matches_plain": True,
        "cases_checked": cases,
        "max_abs_err": max_abs_err,
        "shape": {"r": r, "d": d, "n_src": int(f.shape[0]), "wm": wm,
                  "valid_slots": valid, "form": "fused"},
        "ms": min(k1, k2),
        "ms_runs": [k1, k2],
        # back to back (slab, f and out in L2 at 0.5), and after an L2
        # flush, the time the share holds against the DRAM rate
        "device_ms": device_ms,
        "device_ms_l2_flushed": cold_ms,
        "plain_ms": min(p1, p2),
        "plain_ms_runs": [p1, p2],
        **bound, "bound_share": bound["bound_ms"] / cold_ms,
        "bound_share_l2_warm": bound["bound_ms"] / device_ms,
        # no single PyTorch call computes an OR-reduction gather
        "library_ms": None,
    }


def timing_frontier_expand(level: list, launches: int, cases: int) -> dict:
    """K2's frontier form and its plain version at a real level of phase
    4b's build (a sweep in the middle of the schedule): checked against the
    plain version, then each call timed alone with CUDA events after the
    level's state is restored (a level runs once, and the build reads the
    host after every level, so calls do not overlap)."""
    import frontier_cases as fc
    import torch

    from repro_torch.kernels import ops, ref

    base = dict(zip(fc.ORDER, level))
    case = {k: (base[k].cpu().numpy() if k in fc.ARRAYS else base[k]) for k in fc.ORDER}
    out = _check_frontier_expand(case, base["v"].device, "a real level of the build")
    state = {k: base[k].clone() for k in ("frontier", "v", "pruned", "delta_cur", "delta_next",
                                          "stamps", "cone", "counts")}
    args = [state.get(k, base[k]) for k in fc.ORDER]

    def restore():
        for k, t in state.items():
            t.copy_(base[k])

    def per_call_ms(fn, reps: int) -> list:
        times = []
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    p1, k1 = per_call_ms(ref.frontier_expand_ref, 20), per_call_ms(ops.frontier_expand, 200)
    k2, p2 = per_call_ms(ops.frontier_expand, 200), per_call_ms(ref.frontier_expand_ref, 20)
    device_ms = _kernel_device_ms(lambda: (restore(), ops.frontier_expand(*args)),
                                  "frontier_expand_kernel", 50)

    # the work this level needs (each input read once, each output written
    # once): the frontier rows' ids, CSR offsets, verdict stamps, pushed and
    # cleared words and verdicts; the label rows and the distinct hop-mask
    # rows of the rows that compute a verdict; each edge's neighbor id; the
    # distinct targets' visited words (read, and written where they gained),
    # the gained rows' delta words and stamps, the claims' ring and cone
    # entries; one OR per edge word and per hop word
    lo, hi, cap = case["lo"], case["hi"], case["frontier"].shape[0]
    rows = case["frontier"][np.arange(lo, hi) % cap].astype(np.int64)
    k = rows.size
    n, wm = case["v"].shape
    l_max = case["L_tgt"].shape[1]
    fresh = rows[case["stamps"][1, rows] != case["sweep"]]
    hops = case["L_tgt"][fresh].ravel()
    n_hop = np.unique(hops[hops >= 0]).size
    e0, e1 = case["indptr"][rows], case["indptr"][rows + 1]
    edges = np.concatenate([np.arange(a, b) for a, b in zip(e0, e1)]) if k else np.zeros(0, int)
    targets = np.unique(case["indices"][edges])
    gained = int((out["v"] != case["v"]).any(1).sum())
    claims = int(out["counts"][0] - case["counts"][0])
    joined = int(out["counts"][1] - case["counts"][1])
    nbytes = (k * (4 + 16 + 4 + 3 * wm * 4) + fresh.size * (l_max * 4 + wm * 4 + 4)
              + n_hop * wm * 4 + edges.size * 4 + targets.size * wm * 4
              + gained * (3 * wm * 4 + 4) + claims * 8 + joined * 8 + 24)
    ops_needed = (edges.size + fresh.size * l_max) * wm
    return {
        "name": "frontier_expand",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frontier_expand.cu",
        "replaces": "src/repro/kernels/frontier_ell.py:61",
        "launches": launches,
        "matches_plain": True,
        "cases_checked": cases,
        "max_abs_err": 0,
        "shape": {"n": n, "wm": wm, "l_max": l_max, "frontier_rows": k,
                  "verdict_rows": int(fresh.size), "hop_rows": n_hop,
                  "edges": int(edges.size), "targets": int(targets.size),
                  "gained_rows": gained, "claims": claims, "cone_joins": joined},
        "ms": float(np.median(k1 + k2)), "ms_min": min(k1 + k2),
        "ms_runs": [float(np.median(k1)), float(np.median(k2))],
        "device_ms": device_ms,
        "plain_ms": float(np.median(p1 + p2)), "plain_ms_runs": [float(np.median(p1)),
                                                                  float(np.median(p2))],
        **_bound(nbytes, ops_needed, PEAK_INT32_OPS_PER_S),
        # no PyTorch call pushes packed words over a CSR with claims
        "library_ms": None,
    }


# ------------------------------------------------------------------ phase 6


def phase_serving_profile(co, queries: np.ndarray, n_batches: int = 64) -> None:
    """Where a serving batch spends its time: the device's busy share over a
    window of the main path (torch.profiler), and the engine's own spans
    (obs tracer): ``engine.batch`` wall time, and the part of it inside
    ``device_call`` (host-to-device copy, launch, device work, copy back)."""
    from repro_torch.obs import trace

    window = queries[:n_batches * BATCH]
    serve_all(co, window[:BATCH], None)
    wall_ms, events = _device_events(lambda: serve_all(co, window, None), runtime=True)
    device_us, runtime = {}, {}
    for cat, name, us in events:
        if cat in ("cuda_runtime", "cuda_driver"):
            ms, count = runtime.get(name, (0.0, 0))
            runtime[name] = (ms + us / 1e3, count + 1)
        else:
            device_us[cat] = device_us.get(cat, 0.0) + us
    # the engine's spans, from an unprofiled run of the same window
    trace.TRACER.clear()
    t0 = time.perf_counter()
    serve_all(co, window, None)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {}
    for ev in trace.TRACER.events:
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    trace.TRACER.clear()
    busy_ms = sum(device_us.values()) / 1e3
    check(device_us.get("kernel", 0.0) > 0, "the profiled serving window ran no kernel")
    record({"phase": "serving_profile", "batches": n_batches, "batch": BATCH,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_ms_by_kind": {k: v / 1e3 for k, v in device_us.items()},
            "wall_ms": plain_wall_ms, "span_ms": spans,
            "device_call_share_of_batch": (spans.get("device_call", 0.0)
                                           / spans["engine.batch"]),
            # the host's CUDA calls a batch (launches, copies, synchronisations)
            "runtime_calls_per_batch": {k: {"count": c / n_batches, "ms": ms / n_batches}
                                        for k, (ms, c) in sorted(runtime.items(),
                                                                 key=lambda x: -x[1][0])}})


# ------------------------------------------------------------------ phase 7


# ----------------------------------------------------------------- phase 4m
#
# The paper's own production cells (configs/reachability.py), each cell's
# own ``fn`` run once at its global shapes on the card: the cell on one rank
# (``mesh`` None), whose program is the single-device one.  Data from
# ``PRODUCTION_SEED`` on the card.

PRODUCTION_SEED = 0
PRODUCTION_CELLS = ("serve_1m", "serve_xl", "build_sweep", "build_sweep_xl")
# the full script runs all four (8.1 s of it on an H100)
FULL_RUN_PRODUCTION = PRODUCTION_CELLS
# a label row's hops: its length's i.i.d. draws u^PRODUCTION_SKEW x H (u
# uniform), skewed to the first ranks, sorted, a repeat dropped; H sets the
# share of true verdicts, which the gate holds in PRODUCTION_TRUE_SHARE
# (32.0% at serve_1m with 3,000, 26.5% at serve_xl with 1,000 on an H100).
# Not the smallest of L sorted draws: full rows alone would then hold high
# ranks, and the width L - 1 control would almost never differ
PRODUCTION_SKEW = 1.5
PRODUCTION_HOPS = {"serve_1m": 3_000, "serve_xl": 1_000}
PRODUCTION_TRUE_SHARE = (0.2, 0.8)
PRODUCTION_CHUNK = 1 << 16     # queries a chunk of the plain version


def production_labels(gen, n: int, L: int, H: int, device):
    """int32[n, L] label rows: a length uniform in [1, L], that many hops
    drawn i.i.d. (``PRODUCTION_HOPS``' comment), sorted, a repeat dropped,
    INVALID (-1) after the row's entries."""
    import torch

    big = torch.iinfo(torch.int32).max
    lens = torch.randint(1, L + 1, (n, 1), generator=gen, device=device, dtype=torch.int32)
    x = torch.rand((n, L), generator=gen, device=device).pow_(PRODUCTION_SKEW).mul_(H)
    x = x.to(torch.int32)
    cols = torch.arange(L, device=device, dtype=torch.int32)[None, :]
    x = torch.sort(x.masked_fill_(cols >= lens, big), dim=1).values
    x[:, 1:].masked_fill_(x[:, 1:] == x[:, :-1], big)
    x = torch.sort(x, dim=1).values
    return x.masked_fill_(x == big, -1)


def _dry_trace_one_rank(shape: str) -> dict:
    """The dry run of ``shape``'s cell on a one-rank fake mesh
    (``launch.dryrun``): its trace's argument bytes and bytes accessed."""
    import torch.distributed as dist

    from repro_torch.configs import reachability
    from repro_torch.launch.dryrun import fake_mesh, trace_cell

    mesh = fake_mesh((1, 1), ("data", "model"))
    try:
        traced = trace_cell(reachability.cells(shape, mesh), mesh)
    finally:
        dist.destroy_process_group()
    traced.pop("top")
    return traced


def _past_2_31(ids, width: int):
    """bool[B]: the row ``ids`` of an int32[n, width] matrix ends past byte 2^31."""
    return (ids.long() + 1) * width * 4 > 2 ** 31


def _serve_cell(shape: str, device) -> tuple:
    """``shape``'s serve cell: labels and 1,000,000 queries made on the card,
    the cell's ``fn`` once (one K1 tier-form launch at the full width), its
    verdicts against ``ref.tier_intersect_ref`` on every query, in chunks;
    a control at width L - 1 that must differ; the dry run beside it."""
    import torch

    from repro_torch.configs import reachability
    from repro_torch.kernels import ops, ref

    info = reachability.ORACLE_SHAPES[shape]
    n, L, B = info["n"], info["l_max"], info["queries"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(PRODUCTION_SEED)
    L_out = production_labels(gen, n, L, PRODUCTION_HOPS[shape], device)
    L_in = production_labels(gen, n, L, PRODUCTION_HOPS[shape], device)
    q = torch.randint(0, n, (B, 2), generator=gen, device=device, dtype=torch.int32)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    cell = reachability.cells(shape, None)
    ops.reset_launches()
    fn_ms, got = _timed_once(lambda: cell.fn(L_out, L_in, q))
    launches = dict(ops.LAUNCHES)
    check(launches["label_intersect"] == 1 and sum(launches.values()) == 1,
          f"[{shape}] the cell's fn launched {launches}, not one label_intersect")
    plain = lambda w: _rows_chunked(  # noqa: E731
        lambda s: ref.tier_intersect_ref(L_out, L_in, q[s], w), B, PRODUCTION_CHUNK)
    plain_ms, exp = _timed_once(lambda: plain(L))
    wrong = int((got != exp).sum())
    check(wrong == 0, f"[{shape}] {wrong} of {B} verdicts differ from the plain version")
    past = _past_2_31(q[:, 0], L) | _past_2_31(q[:, 1], L)
    n_past = int(past.sum())
    check(n_past > 0, f"[{shape}] no query reads a row past byte 2^31")
    share = float(got.float().mean())
    check(PRODUCTION_TRUE_SHARE[0] <= share <= PRODUCTION_TRUE_SHARE[1],
          f"[{shape}] {share:.1%} of the verdicts are true, outside {PRODUCTION_TRUE_SHARE}")
    control = int((plain(L - 1) != exp).sum())
    check(control > 0, f"[{shape}] the plain version at width {L - 1} matched at width {L}: "
                       "the gate cannot tell a row's last entry")
    kern = lambda: ops.tier_intersect(L_out, L_in, q, L)  # noqa: E731
    k1, k2 = _event_ms(kern, 20, 3), _event_ms(kern, 20, 3)
    device_ms = _kernel_device_ms(kern, "label_intersect_kernel", 10)
    bound = tier_intersect_bound(L_out, L_in, q, L)
    dry = _dry_trace_one_rank(shape)
    held = L_out.nbytes + L_in.nbytes + q.nbytes
    check(dry["memory"]["argument_size_in_bytes"] == held,
          f"[{shape}] the dry run's argument bytes {dry['memory']['argument_size_in_bytes']} "
          f"are not the card's {held}")
    dry_ms = dry["cost"]["bytes_accessed"] / PEAK_BYTES_PER_S * 1e3
    rec = {"name": "label_intersect", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/label_intersect.cu",
           "replaces": "src/repro/kernels/label_intersect.py:48",
           "config": f"{shape} (configs/reachability.py)",
           "launches": launches["label_intersect"],
           "launches_by_path": {f"production_{shape}": launches["label_intersect"]},
           "matches_plain": True, "max_abs_err": 0,
           "shape": {"B": B, "width": L, "L_out": [n, L], "L_in": [n, L]},
           "ms": min(k1, k2), "ms_runs": [k1, k2], "fn_ms": fn_ms, "device_ms": device_ms,
           "plain_ms": plain_ms, **bound, "library_ms": None,
           "bound_share": bound["bound_ms"] / device_ms,
           "rows_read_once_bytes": B * 2 * L * 4,
           "queries_past_2_31": n_past, "true_share": share,
           "control_width_minus_1_differs": control}
    log(f"4m {shape}: n = {n:,}, L {L}, {B:,} queries ({share:.1%} true, {n_past:,} read a "
        f"row past byte 2^31): {wrong} wrong; width {L - 1} differs on {control:,}; K1 "
        f"{rec['ms']:.6f} ms (device {device_ms:.6f}, bound {bound['bound_ms']:.6f} by "
        f"{bound['bound_by']}), plain {plain_ms:.3f} ms; dry run {dry_ms:.6f} ms of bytes, "
        f"{dry_ms / rec['ms']:.1%} of the call")
    cell_rec = {"shape": shape, "kind": "serve", "made_s": made_s, "fn_ms": fn_ms,
                "wrong": wrong, "true_share": share, "queries_past_2_31": n_past,
                "control_differs": control, "held_bytes": held,
                "dry_run": {k: dry[k] for k in ("memory", "cost", "collectives", "kernels")},
                "dry_bytes_ms": dry_ms, "dry_bytes_share": dry_ms / rec["ms"],
                "seconds": time.perf_counter() - t0}
    del L_out, L_in, q, got, exp
    return cell_rec, rec


def production_dag(gen, n: int, m: int, device) -> tuple:
    """int32 edges of a random DAG with ``n`` vertices and ``m`` edges, made
    on the card: a uniform in [0, n), a span s log-uniform in [1, n), the
    edge joining a and (a + s) mod n from the lower id to the higher (every
    edge goes up in id; duplicates kept, as an edge list may hold them)."""
    import torch

    a = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int64)
    span = torch.exp(torch.rand(m, generator=gen, device=device, dtype=torch.float64)
                     * math.log(n)).long().clamp(1, n - 1)
    b = (a + span) % n
    return torch.minimum(a, b).to(torch.int32), torch.maximum(a, b).to(torch.int32)


def _csr_host(src, dst, n: int) -> tuple:
    """(indptr int64[n + 1], indices int32[m]) on the host of the edges by
    ``src``, sorted on the card."""
    import torch

    order = torch.argsort(src, stable=True)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return indptr.cpu().numpy(), dst[order].cpu().numpy()


def _np_reach(source: int, pruned: np.ndarray, indptr: np.ndarray, indices: np.ndarray,
              max_steps: int) -> np.ndarray:
    """The masked BFS of ``distribute_one`` on the host, level by level over
    a CSR: the visited set, where pruned vertices are visited but do not
    expand."""
    visited = np.zeros(pruned.shape[0], dtype=bool)
    visited[source] = True
    fresh = np.zeros_like(visited)
    frontier = np.array([] if pruned[source] else [source], dtype=np.int64)
    for _ in range(max_steps):
        if frontier.size == 0:
            break
        starts, counts = indptr[frontier], indptr[frontier + 1] - indptr[frontier]
        idx = np.repeat(starts - np.cumsum(counts) + counts, counts) + np.arange(counts.sum())
        nb = indices[idx]
        nb = nb[~visited[nb]]
        fresh[:] = False
        fresh[nb] = True
        visited |= fresh
        frontier = np.flatnonzero(fresh & ~pruned)
    return visited


def _np_pass(L: np.ndarray, lens: np.ndarray, row: np.ndarray, vi: int, csr: tuple,
             max_steps: int) -> tuple:
    """One pass of ``distribute_one`` on the host: (L, lens, pruned count)."""
    n = L.shape[0]
    lut = np.zeros(n + 1, dtype=bool)
    lut[np.where(row == -1, n, row)] = True
    lut[n] = False
    pruned = lut[np.where(L == -1, n, L)].any(1)
    labeled = _np_reach(vi, pruned, *csr, max_steps) & ~pruned
    L = L.copy()
    rows = np.flatnonzero(labeled)
    L[rows, np.minimum(lens[rows], L.shape[1] - 1)] = vi
    return L, lens + labeled.astype(np.int32), int(pruned.sum())


def _state_cols(state, k: int) -> tuple:
    """The first ``k`` columns of a label state on the host, after checking
    on the card that every later column is INVALID."""
    for name in ("L_out", "L_in"):
        check(bool((getattr(state, name)[:, k:] == -1).all()),
              f"{name} holds an entry past column {k}")
    return (state.L_out[:, :k].cpu().numpy(), state.L_in[:, :k].cpu().numpy(),
            state.out_len.cpu().numpy(), state.in_len.cpu().numpy())


def _build_cell(shape: str, device, second: bool) -> dict:
    """``shape``'s build cell: a random DAG made on the card, the cell's
    ``fn`` (``distribute_one`` over the one-rank state) from the top vertex
    of the §5.2 order on a fresh state, held to a 64-level BFS both ways
    (``graph.bfs.bfs_levels_device``), with the truth less its last level
    as a control that must be rejected; with ``second``, an iteration from
    the next vertex of the order held to a numpy transcription of the step.
    The dry run beside it."""
    import torch

    from repro_torch.configs import reachability
    from repro_torch.core.distribution_device import init_state
    from repro_torch.graph.bfs import bfs_levels_device
    from repro_torch.kernels import ops

    info = reachability.ORACLE_SHAPES[shape]
    n, m, L = info["n"], info["m"], info["l_max"]
    steps = reachability.MAX_STEPS
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(PRODUCTION_SEED)
    src, dst = production_dag(gen, n, m, device)
    score = ((torch.bincount(src, minlength=n) + 1) * (torch.bincount(dst, minlength=n) + 1))
    order = torch.argsort(-score, stable=True)[:2].tolist()
    state = init_state(n, L, device)
    vi = torch.tensor(order[0], dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    cell = reachability.cells(shape, None)
    held = sum(t.nbytes for t in state) + vi.nbytes + 4 * src.nbytes
    ops.reset_launches()
    t1 = time.perf_counter()
    state = cell.fn(state, vi, src, dst, dst, src)
    torch.cuda.synchronize()
    fn_s = time.perf_counter() - t1
    check(not any(ops.LAUNCHES.values()), f"[{shape}] distribute_one launched {ops.LAUNCHES}")
    check(not bool(state.overflow), f"[{shape}] overflow")
    rec = {"shape": shape, "kind": "build", "n": n, "m": m, "l_max": L, "vi": order[0],
           "made_s": made_s, "fn_s": fn_s}
    for name, lens, col, a, b in (("L_out", state.out_len, state.L_out, dst, src),
                                  ("L_in", state.in_len, state.L_in, src, dst)):
        level = bfs_levels_device(order[0], a, b, n, steps)
        truth = level >= 0
        deepest = int(level.max())
        want = torch.where(truth, vi, torch.tensor(-1, dtype=torch.int32, device=device))
        ok = (bool(torch.equal(lens, truth.to(torch.int32))) and bool(torch.equal(col[:, 0], want))
              and bool((col[:, 1:] == -1).all()))
        check(ok, f"[{shape}] {name} after distribute_one differs from the BFS truth")
        short = (level >= 0) & (level < deepest)
        check(not torch.equal(lens, short.to(torch.int32)),
              f"[{shape}] {name}: the truth without its last level ({deepest}) passed too")
        # the steps the pass ran: a level each, and one that found nothing new
        rec[name] = {"labeled": int(truth.sum()), "levels": deepest,
                     "steps": min(deepest + 1, steps)}
    if second:
        check(max(int(state.out_len.max()), int(state.in_len.max())) == 1,
              f"[{shape}] a row holds more than one label after one iteration")
        host = _state_cols(state, 1)
        fwd, rev = _csr_host(src, dst, n), _csr_host(dst, src, n)
        wi = order[1]
        t2 = time.perf_counter()
        state = cell.fn(state, torch.tensor(wi, dtype=torch.int32, device=device),
                        src, dst, dst, src)
        torch.cuda.synchronize()
        rec["second_fn_s"] = time.perf_counter() - t2
        Lo, Li, olen, ilen = (np.concatenate([x, np.full((n, 1), -1, np.int32)], 1)
                              if x.ndim == 2 else x for x in host)
        t3 = time.perf_counter()
        Lo, olen, pruned_r = _np_pass(Lo, olen, Li[wi], wi, rev, steps)
        Li, ilen, pruned_f = _np_pass(Li, ilen, Lo[wi], wi, fwd, steps)
        rec["numpy_s"] = time.perf_counter() - t3
        got = _state_cols(state, 2)
        check(all(np.array_equal(x, y) for x, y in zip(got, (Lo, Li, olen, ilen))),
              f"[{shape}] the second iteration differs from its numpy transcription")
        check(pruned_r + pruned_f > 0, f"[{shape}] the second iteration pruned nothing")
        rec["second"] = {"vi": wi, "pruned": [pruned_r, pruned_f],
                         "labeled": [int(olen.sum() - host[2].sum()),
                                     int(ilen.sum() - host[3].sum())]}
    dry = _dry_trace_one_rank(shape)
    check(dry["memory"]["argument_size_in_bytes"] == held,
          f"[{shape}] the dry run's argument bytes {dry['memory']['argument_size_in_bytes']} "
          f"are not the card's {held}")
    dry_ms = dry["cost"]["bytes_accessed"] / PEAK_BYTES_PER_S * 1e3
    # the trace runs every pass its 64 steps (a meta tensor has no flag to
    # stop on); the card ran ``steps``: the bound scaled to them, the
    # bytes of a step dominating
    ran = (rec["L_out"]["steps"] + rec["L_in"]["steps"]) / (2 * steps)
    rec.update(held_bytes=held, dry_run={k: dry[k] for k in ("memory", "cost", "collectives")},
               dry_bytes_ms=dry_ms, dry_bytes_share=dry_ms / (fn_s * 1e3),
               dry_bytes_ms_at_card_steps=dry_ms * ran,
               dry_bytes_share_at_card_steps=dry_ms * ran / (fn_s * 1e3),
               seconds=time.perf_counter() - t0)
    log(f"4m {shape}: n = {n:,}, m = {m:,}, L {L}: distribute_one from {order[0]} "
        f"{fn_s:.3f} s, {rec['L_out']['labeled']:,} ancestors ({rec['L_out']['levels']} "
        f"levels), {rec['L_in']['labeled']:,} descendants ({rec['L_in']['levels']}) = BFS "
        + (f"; from {order[1]}: pruned {rec['second']['pruned']} = numpy "
           if second else "")
        + f"; dry run {dry_ms:.3f} ms of bytes (64 steps a pass; "
          f"{rec['dry_bytes_ms_at_card_steps']:.3f} at the card's steps, "
          f"{rec['dry_bytes_share_at_card_steps']:.1%} of the call)")
    del state, src, dst
    return rec


def phase_production_cells(device, shapes) -> tuple:
    """Phase 4m: each of ``shapes`` (configs/reachability.py's cells) run
    once on the card; (record, K1 records)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    cells, kernels = [], []
    for shape in shapes:
        if shape.startswith("serve"):
            cell, k1 = _serve_cell(shape, device)
            kernels.append(k1)
        else:
            cell = _build_cell(shape, device, second=shape == "build_sweep")
        cells.append(cell)
        gc.collect()
        torch.cuda.empty_cache()
    rec = {"phase": "production_cells", "seconds": time.perf_counter() - t0, "cells": cells,
           "peak_bytes": torch.cuda.max_memory_allocated(device)}
    record(rec)
    return rec, kernels


def phase_driver():
    """The serve driver's sweep on the card, a path of its own: the launch
    counts are read around exactly this run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    ops.reset_launches()
    rec = serve.main(["--dataset", "kegg", "--scale", "1.0", "--n-queries", "20000",
                      "--backend", "all", "--device", "cuda"])
    launches = dict(ops.LAUNCHES)
    check(launches["serve_batch"] > 0,
          "serve_batch never launched in the serve driver's sweep")
    check(set(rec["backends"]) == {"host", "dense", "kernel"},
          f"the sweep served {sorted(rec['backends'])}")
    for be, r in rec["backends"].items():
        check(not any(r["degradation"].values()),
              f"[{be}] degradation counters moved: {r['degradation']}")
        check(r["sample_errors"] == 0, f"[{be}] {r['sample_errors']} wrong sampled verdicts")
    record({"phase": "serve_driver", "seconds": time.perf_counter() - t0,
            "launches": launches, "device_name": rec["device_name"],
            "mqps": {be: r["mqps"] for be, r in rec["backends"].items()}})


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device-build-scale", type=float, default=None,
                    help="citeseer scale of the device build phase (4b); default "
                         f"{FULL_RUN_DEVICE_BUILD_SCALE} in the full script, "
                         f"{MAIN_SCALE} with --only-device-build")
    ap.add_argument("--only-device-build", action="store_true",
                    help="run phases 1-3 and 4b only")
    ap.add_argument("--only-kernels", action="store_true",
                    help="run phases 1-3 and 3b (the kernel library) only")
    ap.add_argument("--only-substrate", action="store_true",
                    help="run phases 1-3b and 4j (the LM family and xDeepFM) only")
    ap.add_argument("--only-training", action="store_true",
                    help="run phases 1-3 and 4k (training: the backward kernels) only")
    ap.add_argument("--only-dynamic", action="store_true",
                    help="run phases 1-3, 4 and 4h (the dynamic oracle) only")
    ap.add_argument("--only-multi-device", action="store_true",
                    help="run phases 1-4 and 4i (the multi-device modes) only")
    ap.add_argument("--only-distributed-training", action="store_true",
                    help="run phases 1-3 and 4l (training across ranks) only")
    ap.add_argument("--only-production-cells", action="store_true",
                    help="run phases 1-3 and 4m (the oracle's production cells, all four) only")
    ap.add_argument("--publish-stall", type=float, default=0.0, metavar="S",
                    help="stall phase 4h's daemon publish S seconds more at its fault "
                         "site dynamic.publish (default 0: the publish as it is)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # the port must be importable from this checkout before anything prints
    import repro_torch.core.api  # noqa: F401
    # the full script runs phase 4c's host engines in a child process beside
    # phases 1-4b (the kernel builds leave most cores idle); it stops it on
    # the way out, however the run ends
    child = None
    if not (args.only_device_build or args.only_kernels or args.only_dynamic
            or args.only_multi_device or args.only_substrate or args.only_training
            or args.only_distributed_training or args.only_production_cells):
        child = start_host_engines()
    children = {"host_engines": child, "mesh_ranks": None, "dist_ranks": None,
                "split_ranks": None}
    try:
        return run(args, children)
    finally:
        if child is not None:
            stop_host_engines(child)
        if children["mesh_ranks"] is not None:
            stop_mesh_ranks(children["mesh_ranks"])
        if children["dist_ranks"] is not None:
            stop_dist_ranks(children["dist_ranks"])
        if children["split_ranks"] is not None:
            stop_dist_ranks(children["split_ranks"][:2])


def _started(children: dict, key: str, start):
    """``start()``'s ranks, kept in ``children[key]`` so that ``main`` stops
    them however the run ends."""
    children[key] = start()
    return children[key]


def run(args, children: dict) -> int:
    """The phases of ``main``'s arguments; ``children`` holds phase 4c's
    child process (the full script) and phase 4i's and 4l's ranks, started
    here after 4i (a) (they load the kernels the script built)."""
    import torch

    t_start = time.perf_counter()
    name, smi_line = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    cases = phase_kernel_vs_plain(device)
    if args.only_device_build:
        built = phase_device_build(device, args.device_build_scale or MAIN_SCALE)
        kernels = [timing_frontier_expand(built["level"], built["launches"]["frontier_expand"],
                                          cases["frontier_expand"] + 1)]
    elif args.only_kernels:
        kernels = phase_kernel_library(device, cases)
    elif args.only_substrate:
        kernels = phase_kernel_library(device, cases)
        merge_substrate(kernels, phase_substrate(device, smi_line))
    elif args.only_training:
        kernels = []
        merge_training(kernels, phase_training(device, smi_line), cases)
    elif args.only_distributed_training:
        dist_ranks = children["dist_ranks"] = start_dist_ranks()
        release_dist_ranks(dist_ranks)
        prepare_split_ranks()
        finish_dist_ranks(dist_ranks, smi_line)
        finish_split_ranks(_started(children, "split_ranks", start_split_ranks), smi_line)
        kernels = None
    elif args.only_production_cells:
        _, kernels = phase_production_cells(device, PRODUCTION_CELLS)
    elif args.only_dynamic:
        g, co, queries, cq, rest, launches, verdicts = phase_main_path(device)
        dyn = phase_dynamic(device, g, queries, verdicts, args.publish_stall)
        kernels = phase_timing(co, cq[rest], {"main_path": launches["label_intersect"],
                                              "dynamic": dyn["launches"]["label_intersect"]},
                               cases, int(np.median(dyn["residues"])))
    elif args.only_multi_device:
        g, co, queries, cq, rest, launches, verdicts = phase_main_path(device)
        mesh_ranks = children["mesh_ranks"] = share_main_path(co, queries, verdicts)
        one = phase_multi_device_one_rank(device, g, co, queries, verdicts,
                                          str(pathlib.Path(mesh_ranks[1]) / "snap"))
        start_mesh_ranks(mesh_ranks)
        release_mesh_ranks(mesh_ranks)
        ranks = finish_mesh_ranks(mesh_ranks)
        kernels = phase_timing(co, cq[rest], {"main_path": launches["label_intersect"],
                                              "multi_device_one_rank": one["label_intersect"],
                                              "multi_device_ranks": ranks["label_intersect"]},
                               cases, one["residue_median"])
        kernels.append(timing_frontier_or(mesh_build_slab(device),
                                          {"mesh_build": ranks["frontier_or"]},
                                          cases["frontier_or"]))
    else:
        library = phase_kernel_library(device, cases)
        g, co, queries, cq, rest, launches, verdicts = phase_main_path(device)
        mesh_ranks = children["mesh_ranks"] = share_main_path(co, queries, verdicts)
        one = phase_multi_device_one_rank(device, g, co, queries, verdicts,
                                          str(pathlib.Path(mesh_ranks[1]) / "snap"))
        # 4i (b)'s ranks build and cold-start beside 4b alone, and serve
        # with nothing beside them: no measured window of another phase, nor
        # their own serving, shares the host or the card
        start_mesh_ranks(mesh_ranks)
        built = phase_device_build(device, args.device_build_scale
                                   or FULL_RUN_DEVICE_BUILD_SCALE)
        finish_host_engines(children["host_engines"])
        release_mesh_ranks(mesh_ranks)
        ranks = finish_mesh_ranks(mesh_ranks)
        # 4l's ranks reach the card and warm up beside 4e, and wait until 4k
        # has ended
        dist_ranks = children["dist_ranks"] = start_dist_ranks()
        # the paths of this slice, each with its own counts: HL, the
        # quickstart, the daemon, the dynamic oracle; before 4d, whose
        # budgeted run is cut to the script's target on the clock they leave
        k1_launches = {"main_path": launches["serve_batch"],
                       "hierarchical": phase_hierarchical(device, g, queries,
                                                          verdicts)["serve_batch"],
                       "quickstart": phase_quickstart(device)["serve_batch"],
                       "daemon": phase_daemon(g, co)["serve_batch"]}
        dyn = phase_dynamic(device, g, queries, verdicts, args.publish_stall)
        k1_launches["dynamic"] = dyn["launches"]["serve_batch"]
        merge_substrate(library, phase_substrate(device, smi_line))
        merge_training(library, phase_training(device, smi_line), cases)
        release_dist_ranks(dist_ranks)
        # 4l (g)'s 16 ranks: their fork server imports beside 4l, they are
        # forked once 4l's ranks have ended (16 contexts beside 4j-4l ran
        # the card out of memory)
        prepare_split_ranks()
        merge_distributed(library, finish_dist_ranks(dist_ranks, smi_line))
        finish_split_ranks(_started(children, "split_ranks", start_split_ranks), smi_line)
        _, production = phase_production_cells(device, FULL_RUN_PRODUCTION)
        budgeted = phase_cold_start_and_budget(g, co, queries, verdicts)
        cases["frontier_or"] += built["frontier_or_cases"]
        kernels = [timing_serve_batch(co, cq, k1_launches, cases["serve_batch"], budgeted)]
        kernels += phase_timing(co, cq[rest], {"main_path": launches["label_intersect"],
                                               "dynamic": dyn["launches"]["label_intersect"],
                                               "multi_device_one_rank": one["label_intersect"],
                                               "multi_device_ranks": ranks["label_intersect"]},
                                cases, int(np.median(dyn["residues"])))
        kernels.append(timing_frontier_expand(built["level"],
                                              built["launches"]["frontier_expand"],
                                              cases["frontier_expand"] + 1))
        kernels.append(timing_frontier_or(built["real_slab"],
                                          {"device_build": built["launches"]["frontier_or"],
                                           "mesh_build": ranks["frontier_or"]},
                                          cases["frontier_or"]))
        kernels += library + production
        phase_serving_profile(co, queries)
        phase_driver()
    record({"phase": "done", "seconds": time.perf_counter() - t_start,
            "card": smi_line})
    log(smi_line)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
