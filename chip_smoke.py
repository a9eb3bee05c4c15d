#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --label-sweep SRC   # stage-1 sweep of SRC's port
    python3 chip_smoke.py --lm | --lm-train   # the LM phases alone

Phases, one JSON line each (with its seconds):

1. device   — the card's name and power limit (``nvidia-smi``).
2. build    — compile the hand-written CUDA kernels from ``kernels/csrc``,
   then hold each against its plain PyTorch version (``torch.equal``)
   on small random inputs at ragged shapes; the label kernels both on
   gathered rows and reading rows in place by endpoint id (rows ending
   on and one past a 32-slot chunk, duplicate ids, the all-pad row,
   repeated endpoints, endpoint ids n, n+3, -1, -2 and -(n+5), int32
   and float32 distance planes).
3. main path, one real build per path, with the launch counters set to
   0 before each path and read after it; each path must launch exactly
   its own kernels:
   - ``ell_loop``: ``ISLabelIndex.build`` on ``er:1000000:2.2@1``
     (``l_cap=64``, ``label_chunk=8192``), then ``query`` on 1024 seeded
     random pairs (two calls, then ``QUERY_REPEATS`` timed ones); the
     first 16 sources are checked bitwise against Dijkstra;
   - ``fused``: the same on ``er:10000:2.2@1``;
   - ``dense``: the same on ``rmat:12:24@1`` (a small dense core);
   - ``compressed``: the same on ``rmat:15:8@1`` with
     ``label_dtype="compressed"`` (delta16 ids, int32 distances), whose
     stage 1 runs the packed kernel and stage 2 the ``ell_loop`` route.
   Builds and queries run under ``torch.cuda.set_sync_debug_mode
   ("error")``: any device sync outside ``host_read`` raises.
4. paths_<path> — the path lane (§8.1, ``path_batch_fn(256)``) on each
   main path's index and 1024 pairs, launch counters zeroed around it:
   it must launch exactly the route's stage-2 kernel, give the query's
   distances bitwise and its round count, and every path must pass
   ``check_path_batch`` against the generated edges; on ``fused`` and
   ``dense`` the host oracle ``shortest_path`` is checked on 8 pairs.
5. serving_<path> — the serving engine (``repro_torch.serve``) on each
   main path's index at ``launch/serve.py``'s defaults (buckets 64, 256,
   1024; 2 ms; cache 65,536): a ``hotspot`` and a ``uniform`` trace of
   4,096 requests (1,024 on ``ell_loop``) at 50,000 req/s on the trace
   clock, under sync debug mode "error". Every answer equal to
   ``idx.query`` bitwise (a Dijkstra sample of 256 on ``fused`` and
   ``dense``); each lane launching exactly its kernels (``mu``: the
   label kernel; ``full``: it and the route's stage-2 kernel); no
   first-use build after warmup and the shape counts unchanged; one
   counted sync a batch beyond the entry points' own exit-flag reads.
   Then a profiled replay (device idle share), ``classify`` and
   ``query_host`` on CUDA tensors, and on ``fused`` and ``dense`` a
   path-lane replay of 512 requests at hop caps 64 and 256 whose paths
   all pass the launcher's audit.
6. mutation — §8.3 on a hold-out build of ``er:10000:2.2@1``: insert
   the held-out vertex (its distances equal to Dijkstra's on the full
   graph, its paths checked), then delete it (answers restored, the
   conservative rule); insert and delete ms over three cycles.
7. versioned_<path> — versioned mutation under traffic (§8.3 live) on
   ``fused`` (``er:10000:2.2@1``), ``ell_loop`` (``er:1000000:2.2@1``)
   and ``compressed`` (``rmat:15:8@1``, delta16): each builds its own
   index over n_base + 16 spare ids and serves a ``readwrite`` trace
   (4,096 requests on ``fused``, 1,024 elsewhere; write ratio 0.05, 0.01
   on ``ell_loop``) through ``DistanceServer(versioned=True)`` at the
   launcher's defaults, under sync debug mode "error". Every read equal
   to its version's ``index.query``, every 8th version segment and the
   last to a from-scratch build (and 256 reads of ``fused`` to
   Dijkstra), the family's route ``repro``'s rule, each lane launching
   exactly its kernels, no new batch shape, no first-use build in
   ``serve_read`` (one layout build a swap in ``mutation``), one
   serving-layer sync a read batch, and nothing retired left after
   ``drain``. Swap ms and its stages, touched rows, ``qps_compute``,
   read latency, state bytes and peak device bytes.
8. directed — ``DiISLabelIndex`` (§8.2) on a random digraph (n =
   100,000, e = 400,000, ``tests/test_directed.py``'s generator): 1,024
   pairs in calls of 256, 16 sources against Dijkstra, ``reachable``,
   and 8 host-oracle paths checked edge by edge. No kernel runs there.
9. sharded_<path> — ``ShardedIndex.from_index(idx, 4, strategy="level")``
   on each main path's index, all four shards on this card (one
   relaxer shared): partition seconds, entries and block bytes per
   shard; 1,024 pairs (256 on ``ell_loop``) whose answers, every
   shard's rounds and the μ-only lane equal the unsharded index's,
   with exactly 4× the unsharded query's launches and one cross-shard
   reduction a call under sync debug mode "error", timed beside the
   unsharded query; a ``hotspot`` replay of 1,024 requests (256 on
   ``ell_loop``) through ``DistanceServer`` over the shards, answers
   equal to ``idx.query``, no first-use build. On ``fused`` also a
   path-lane replay of 256 requests (paths audited) and
   ``apply_mutations`` inserting the mutation phase's hold-out vertex,
   answering as ``insert_vertex`` on the unsharded hold-out index.
10. http — ``ServiceFrontend`` on localhost over a ``ReplicaSet`` of 2
   on the ``fused`` index: 2,048 ``uniform`` requests through
   ``replay_http`` (64 pairs a request) equal to ``idx.query`` with no
   SLO alert, then a ``straggler`` replay (1,024 requests, replica 0
   stalled 5 s a batch) that must evict replica 0 and fire the latency
   SLO; ``/metrics`` parsed; req/s and wire ms. Then
   ``python -m repro_torch.launch.serve --mode http --graph er --n 10000
   --l-cap 64 --replicas 2 --scenario straggler --audit index`` must
   exit 0.
11. vc_baseline — Table 8: on ``benchmarks/bench_baselines.py``'s four
   graphs (``rmat:17:8@1``, ``rmat:15:8@1``, ``er:65536:2.2@2``,
   ``grid:181@3``) at its ``IndexConfig(l_cap=1024, label_chunk=2048)``,
   IS-LABEL and the one-level VC index (``core/vc_baseline.py``, k = 2)
   built on the card and queried on 1,024 seeded pairs under sync debug
   mode "error": answers bitwise equal, the first 16 sources equal to
   Dijkstra, each index launching exactly the label kernel and its
   route's stage-2 kernel; k, core size, route, rounds, build s, query
   ms and the VC / IS-LABEL query ratio.
12. examples — the twins of ``examples/`` and ``scripts/``
   (``repro_torch.examples``, ``repro_torch.scripts``), each ``main``
   called in-process with the launch counters zeroed: ``smoke_core`` on
   each of its four graphs (200 queries against Dijkstra, 5 paths, "ALL
   OK"), ``quickstart`` (``rmat_graph(12)``, ``l_cap=512``),
   ``distance_serving`` at ``rmat:17`` with 65,536 requests in batches
   of 512 and its sharded lane on 4 shards of the card (build s, q/s,
   batch p50 / p99, peak device bytes), ``gnn_molecules`` (200 EGNN
   steps) and ``train_lm`` (100 of its 300 steps of the 12 x 768 LM at
   8 x 256 through the world-1 mesh step, the prefetch pipeline and the
   runner, a checkpoint at step 100); an index twin must launch exactly
   the label kernel and its route's stage-2 kernel, the training twins
   none. Beside ``train_lm``, ``python -m
   repro_torch.examples.quickstart`` as a user types it must exit 0.
13. train_<arch> — training on the card (no kernel of ``kernels/`` lies
   on its path: each phase must launch none) at the published configs:
   ``gcn-cora`` and ``graphsage-reddit`` on ``full_graph_sm`` (2,708
   nodes, 1,433 features, 7 classes; 3,072 rows, 21,504 edges),
   ``egnn`` and ``dimenet`` (6 blocks, d_hidden 128; 65,536 triplet
   slots) on ``molecule`` (128 graphs of 30 atoms; 4,096 rows, 16,384
   edges), through ``launch/train.py``'s ``init_state`` and
   ``make_batch_fn`` and ``FaultTolerantRunner`` with checkpoints every
   10 steps: 50 timed steps under sync debug mode "error" (first-step
   and median step ms, steps/s, syncs a step, the loss read's and the
   checkpoint saves' shares, peak device bytes, loss at steps 1 and 50;
   ``repro``'s launcher check ``loss[50] < 1.5 loss[1]``), the card
   against the CPU over 5 steps from one state and batch (rtol 1e-4,
   atol 1e-5: atomics reorder float sums), a fresh runner restoring
   step 50 bitwise onto the card, a resume (20, then a new runner to
   30) and one injected failure after the optimizer at step 25 (rolled
   back to step 20's checkpoint on the card) against an uninterrupted
   30, and the device idle share of 10 profiled steps. ``train_dien``:
   DIEN at the published config (2^26 item rows, seq_len 100) with the
   state drawn on the card, 20 timed steps at a batch of 32,768 (the
   published 65,536 does not fit beside the ~15 GB state; no
   checkpoint), one profiled step, then the ``serve`` bundle at
   ``serve_p99`` (512) and ``retrieval`` at ``retrieval_cand``
   (1,000,448 candidates) once each on the trained parameters; then the
   checks above on the smoke config. Then ``train_launcher``: ``python
   -m repro_torch.launch.train --arch gcn-cora --steps 20``, again
   ``--steps 30 --resume``, ``--arch dimenet --shape molecule --steps
   20`` and ``--arch dien --smoke --steps 20``.
14. builders — ``er:10000:2.2@1`` built with ``builder="host"`` and
   ``builder="device"`` from one seed must give the same hierarchy and
   labels, bitwise; then whether the 10^6 graph's labels fit delta16.
15. kernels — each kernel on the card against its plain PyTorch version
   (``torch.equal``) on the inputs the main path gave it, with
   CUDA-event times and the bound of the same work. The label kernels
   also run at ``repro``'s serving batches (Q = 64, 256, 1024) beside
   the launch floor (a one-element ``fill_``), on gathered rows too, and
   with the whole μ-only lane (``query_mu_only``) timed at each Q on the
   ``ell_loop`` and ``compressed`` indexes (``label_sweep``).
   ``spmv_relax_kernel``
   is replayed round by round on both ``ell_loop`` queries (output, mask
   and flag of every round), and its replayed round count must equal
   the route's. ``fused_relax_kernel`` is timed in both variants on the
   fused core, ``minplus_matmul_kernel`` with its instruction-issue bound
   at the SM clock read under its load. Each path's query is profiled
   once (device idle share).

16. lm_<arch> — LM serving (no kernel of ``kernels/`` lies on its path:
   each phase must launch none), run right after ``build`` in a child
   process (``--lm``: its own allocator, expandable segments), under
   ``torch.inference_mode()`` and sync debug mode "error" but for the
   counted reads: ``granite-8b`` and ``qwen2-moe-a2.7b`` at full size,
   bf16 weights drawn on the card through ``build_bundle`` and
   ``init_state``. A 1,024-token prefill and 8 teacher-forced decode
   steps at the decode batch against ``forward`` on all 1,032 tokens
   (``max|d| / max|logit|`` within 5e-2 and the argmax agreement; an
   MoE's bf16 decode is batch-dependent by design, capacity drops and
   bf16 router near ties, so it is reported, and the gates are the same
   check with a capacity no call exceeds at 256 prompt tokens: in fp32
   within 1e-4, and in bf16 within 5e-2 on the positions whose routing
   equals ``forward``'s; in both, every expert set that first departs
   from ``forward``'s does so where its router logits lie within 4 bf16
   ulps, and the routing witness counts the departures); then
   ``decode_32k`` from that cache (8 and 4 sequences, Smax 32,768: 32
   greedy steps with no host read, step ms first and median, tokens/s,
   the bytes bound of the weights and the whole cache and its share,
   the bound of the weights and the filled slots alone and its share,
   then 4 profiled steps: launches a step, idle share) and
   ``prefill_32k`` at one sequence (ms, tokens/s, the model's FLOPs
   over the 989 TFLOP/s bf16 peak, peak device bytes); MoE dropped
   assignments at each. ``lm_width``: yi-34b and qwen2-72b at depth 2,
   kimi-k2 at depth 1, full width: a 4,096-token prefill and the decode
   check. ``lm_cpu``: the five smoke configs in fp32, the card against
   the CPU over a prefill and 4 decode steps (rtol 1e-4, atol 1e-5).
   ``lm_launcher``: ``python -m repro_torch.launch.serve --mode lm
   --arch granite-8b`` and ``--arch qwen2-moe-a2.7b`` at the launcher's
   defaults.
17. train_lm_<arch> — LM training (no kernel of ``kernels/`` lies on its
   path: each phase must launch none), in a child process of its own
   (``--lm-train``) right after the LM serving child, with the same
   allocator: ``train_4k`` at 4,096 tokens and full width through
   ``build_bundle(spec, "train_4k", device, {"grad_accum": 4})``,
   ``init_state`` (fp32 parameters drawn on the card, AdamW) and
   ``FaultTolerantRunner`` with no checkpoint, 6 steps under sync debug
   mode "error": ``granite-8b`` cut to 4 layers and 8 sequences,
   ``qwen2-moe-a2.7b`` to 2 layers and 4. Step ms (first, median),
   tokens/s, ``train_mfu`` (3 x the forward's model FLOPs over 989
   TFLOP/s bf16), peak device bytes, loss first and last, the MoE's
   dropped-assignment share; 2 profiled steps (launches a step, idle
   share, device ms by kind) and one profiled optimizer update.
   ``train_lm_checks``: granite at 2 layers and qwen2-moe at
   1, in fp32 (the MoE with a capacity no call exceeds): (a) the
   bundle's loss bitwise equal to ``lm_loss`` under ``no_grad``; (b)
   the gradient along a seeded direction against a central difference
   (within 1e-2 at eps 3e-3); (c) the remat policies' gradients against
   each other and their peak backward bytes (none <= dots <= off, none <
   off) at 4,096 tokens; (d) ``grad_accum`` 4 against 1 on 4 sequences
   of 512 (the MoE without its load-balance loss). ``train_lm_smoke``:
   the five smoke configs in fp32 (kimi-k2's parameters bf16 with
   Adafactor, under deterministic algorithms: its resume and rollback
   bitwise) through ``phase_train``'s checks (card against
   CPU, each with a lost step as its control; restore, resume, one
   injected failure), beside them ``launch/train.py --arch
   granite-8b --smoke`` and ``--arch kimi-k2-1t-a32b --smoke``.
   ``prefetch``: granite's cell above (4 layers, 8 x 4,096,
   ``grad_accum`` 4) fed through ``PrefetchPipeline(depth=2)`` from
   pinned host batches for 6 steps: losses bitwise equal to the same
   steps fed directly, a ``reset`` seek returning the same batch, and a
   profile whose host-to-device copies run on a stream none of the
   step's kernels use; step ms of both runs.
18. islabel_serve_1m — the ``islabel`` arch's query step (no kernel of
   ``kernels/`` lies on its path) at ``serve_1m``'s published shape (n
   = 2^20, l_cap 64, n_core 2^17, 2^22 core edges, Q = 4,096) on
   inputs drawn on the card from a seed, at ``relax_chunks`` 64 (the
   cut: 0 would gather 68.7 GB): step ms, the bytes it needs and moves
   and their bounds, peak device bytes; the first 16 queries bitwise
   equal to the same bundle on the CPU; the ``fused`` index through the
   bundle (rounds past its route's) equal to ``idx.query`` on its 1,024
   pairs. islabel_build_16m — one peel level at n = 2^24 (e_cap 2^26)
   on a random graph drawn on the card (halved until its reckoned peak
   fits the card, the cut recorded): the chosen set independent, and
   the level equal to ``build_hierarchy_device``'s first level on the
   same graph and permutation.
19. distributed — ``torchrun --nproc-per-node=<cards> chip_smoke.py
   --distributed`` (NCCL): granite-8b's smoke step over
   ``make_host_mesh`` against the unsharded step (bitwise at one card),
   granite-8b at full width through the split mesh path, the GNNs and
   DIEN through theirs (``MESH_GRAPH``: ``gcn-cora`` on
   ``full_graph_sm``, ``egnn`` and ``dimenet`` on ``molecule`` at their
   published shapes; DIEN at its published widths and tables,
   ``MESH_DIEN_BATCH``; 3 steps each, DIEN's ``serve`` and
   ``retrieval`` once), ``compress_pods`` on a ``(pod, data, model)``
   mesh at full width (``MESH_COMPRESSED``: granite-8b at 4 layers and 8
   x 4,096 tokens, qwen2-moe at 2 layers and 2 x 4,096; 3 steps,
   bitwise at one pod the unsharded step through quantize ->
   dequantize, seconds and peak beside the plain mesh step's),
   ``compressed_psum_pod`` and
   ``lookup_mod_sharded`` against their one-device forms; then
   ``torchrun ... -m repro_torch.launch.train --arch granite-8b --smoke
   --steps 20``. On a one-card machine the world is 1.
20. dryrun — after every timed phase, its processes on the host's
   cores (CPU only, the fake process group, no card): ``python -m
   repro_torch.launch.dryrun --all --include-islabel --multipod single``
   and ``--multipod multi`` on ``perf.py``'s ``:mp`` cells, every cell
   ``ok``; per cell FLOPs, bytes, collective bytes, argument and peak
   bytes per device and the dominant term on the H100 model; the
   granite-8b and qwen2-moe ``train_4k`` cells with ``--compress-pods``
   on the 512 ranks (``DRYRUN_INT8``: FLOPs, peak, ``fits_80gb`` and
   collective bytes beside the plain cell's; each must fit a card with
   FLOPs within 10% of the plain cell's or below); and ``python -m
   repro_torch.launch.perf --cell islabel:serve_128m``.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits nonzero and prints no result. It needs one CUDA card and the
repository's ``src/`` beside it.

``--lm`` and ``--lm-train`` run the LM serving and LM training phases
alone (the whole script runs each so, in a child process);
``--distributed`` is the ``distributed`` phase's per-rank check, run
under ``torchrun``.
``--label-sweep SRC`` builds the four paths' indexes with the port under
``SRC`` (for instance an older commit unpacked with ``git archive``) and
prints ``label_sweep``'s line with each path's query times, so two
trees' stage 1 and queries can be timed in turns in one
call.
"""
from __future__ import annotations

import atexit
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MAIN_QUERIES = 1024
QUERY_REPEATS = 10       # timed query calls after the first two
# the serving buckets of repro's batcher (src/repro/serve/batcher.py:52)
SWEEP_QS = (64, 256, 1024)
KERNELS = {
    "label_intersect_kernel": (
        "src/repro_torch/kernels/csrc/label_intersect.cu",
        "src/repro/kernels/label_intersect/kernel.py:59"),
    "spmv_relax_kernel": (
        "src/repro_torch/kernels/csrc/spmv_relax.cu",
        "src/repro/kernels/spmv_relax/kernel.py:55"),
    "fused_relax_kernel": (
        "src/repro_torch/kernels/csrc/fused_relax.cu",
        "src/repro/kernels/spmv_relax/kernel.py:107"),
    "minplus_matmul_kernel": (
        "src/repro_torch/kernels/csrc/minplus_matmul.cu",
        "src/repro/kernels/minplus_matmul/kernel.py:38"),
    "label_intersect_packed_kernel": (
        "src/repro_torch/kernels/csrc/label_intersect_packed.cu",
        "src/repro/kernels/label_intersect/kernel.py:95"),
}
# (path, stage-2 route, graph spec, generator call, IndexConfig overrides,
#  the kernels the path launches)
PATHS = [
    ("ell_loop", "ell_loop", "er:1000000:2.2@1",
     ("er_graph", (1_000_000, 2.2), 1), dict(l_cap=64, label_chunk=8192),
     {"label_intersect_kernel", "spmv_relax_kernel"}),
    ("fused", "fused", "er:10000:2.2@1", ("er_graph", (10_000, 2.2), 1),
     dict(l_cap=64, label_chunk=4096),
     {"label_intersect_kernel", "fused_relax_kernel"}),
    ("dense", "dense", "rmat:12:24@1", ("rmat_graph", (12, 24.0), 1),
     dict(l_cap=512, label_chunk=1024),
     {"label_intersect_kernel", "minplus_matmul_kernel"}),
    # the query preset of benchmarks/bench_query.py (_compressed_row);
    # n <= 32768, so no id gap can overflow int16
    ("compressed", "ell_loop", "rmat:15:8@1", ("rmat_graph", (15, 8.0), 1),
     dict(l_cap=1024, label_chunk=2048, label_dtype="compressed"),
     {"label_intersect_packed_kernel", "spmv_relax_kernel"}),
]
BUILDER_GRAPH = ("er:10000:2.2@1", ("er_graph", (10_000, 2.2), 1),
                 dict(l_cap=64, label_chunk=4096))
# the path lane on each main path's index: the kernel its stage 2
# launches (its μ and meet come from the plain label intersection)
PATH_LANE_KERNELS = {"ell_loop": {"spmv_relax_kernel"},
                     "fused": {"fused_relax_kernel"},
                     "dense": {"minplus_matmul_kernel"},
                     "compressed": {"spmv_relax_kernel"}}
PATH_HOP_CAP = 256       # repro's DEFAULT_HOP_CAP
PATH_REPEATS = 5         # timed path batches after the first two
ORACLE_PATHS = ("fused", "dense")   # host path oracle checked on 8 pairs
# §8.3 on a hold-out build of the fused path's graph; insert and delete
# through the index's entry points, queries and paths on the fused route
MUTATION_GRAPH = BUILDER_GRAPH
MUTATION_CYCLES = 3      # timed insert/delete pairs
MUTATION_KERNELS = {"label_intersect_kernel", "fused_relax_kernel"}
# the serving engine on each main path's index, at launch/serve.py's
# defaults (buckets: repro's batcher, src/repro/serve/batcher.py:52)
SERVE_BUCKETS = (64, 256, 1024)
SERVE_WAIT_MS = 2.0
SERVE_CACHE = 65_536
SERVE_RATE = 50_000.0    # requests/s on the trace clock
SERVE_SCENARIOS = ("hotspot", "uniform")
SERVE_REQUESTS = {"ell_loop": 1024}   # 4096 elsewhere
SERVE_ORACLE = {"fused": 256, "dense": 256}   # Dijkstra sample
SERVE_PATH_REQUESTS = {"fused": 512, "dense": 512}
SERVE_HOP_CAPS = (64, 256)
# versioned mutation under traffic (§8.3 live): each path builds its own
# index over n_base + VERSION_SPARES ids (launch/serve.py --spares) and
# serves a readwrite trace through DistanceServer(versioned=True)
# (path, expected route, graph spec, generator call, IndexConfig
#  overrides, requests, write ratio)
VERSIONED = [
    ("fused", "fused", "er:10000:2.2@1", ("er_graph", (10_000, 2.2), 1),
     dict(l_cap=64, label_chunk=4096), 4096, 0.05),
    # write ratio 0.01 on the 10^6 graph keeps its rebuild audits short
    ("ell_loop", "ell_loop", "er:1000000:2.2@1",
     ("er_graph", (1_000_000, 2.2), 1), dict(l_cap=64, label_chunk=8192),
     1024, 0.01),
    ("compressed", "ell_loop", "rmat:15:8@1", ("rmat_graph", (15, 8.0), 1),
     dict(l_cap=1024, label_chunk=2048, label_dtype="compressed"), 1024,
     0.05),
]
VERSION_SPARES = 16
LAUNCHER_WRITE_RATIO = 0.05   # launch/serve.py --write-ratio
VERSION_WRITE_BATCH = 2
VERSION_REBUILD_EVERY = 8     # rebuild audit: every 8th segment and the last
VERSION_ORACLE = {"fused": 256}   # Dijkstra sample of the reads
# sharded indexes (repro_torch.shard) over each main path's index, every
# shard on this card: tests/test_shard.py's largest P and launch/serve.py's
# --shard-strategy default
SHARDS = 4
SHARD_STRATEGY = "level"
SHARD_QUERIES = {"ell_loop": 256}          # MAIN_QUERIES elsewhere
SHARD_REPEATS = 5                          # timed calls after the first two
SHARD_SERVE_REQUESTS = {"ell_loop": 256}   # 1024 elsewhere
SHARD_PATH_REQUESTS = 256                  # path lane and batch, fused only
# the HTTP service (serve/frontend.py) over a ReplicaSet on the fused
# index, with launch/serve.py's --slo-latency-ms and --stall-s defaults
HTTP_REPLICAS = 2
HTTP_REQUESTS = 2048
HTTP_STRAGGLER_REQUESTS = 1024
HTTP_BATCH = 64                            # pairs a /query request
HTTP_SLO_S = 1.0
HTTP_STALL_S = 5.0
HTTP_LAUNCHER = ["--mode", "http", "--graph", "er", "--n", "10000",
                 "--l-cap", "64", "--replicas", "2", "--scenario",
                 "straggler", "--audit", "index"]
# directed graphs (§8.2): tests/test_directed.py's _digraph at scale
DIRECTED = dict(n=100_000, e=400_000, seed=0, maxw=5, l_cap=256,
                label_chunk=8192)
DIRECTED_QUERIES = 1024
DIRECTED_CALL = 256           # pairs a call: the dense [q, m_core] gathers
DIRECTED_DIJKSTRA = 16
DIRECTED_PATHS = 8
# GNN training (train_<arch>): published configs on the launcher's shapes
TRAIN = [("gcn-cora", "full_graph_sm"), ("graphsage-reddit", "full_graph_sm"),
         ("egnn", "molecule"), ("dimenet", "molecule")]
TRAIN_STEPS = 50
TRAIN_CKPT_EVERY = 10
TRAIN_CPU_STEPS = 5           # card against CPU from one state and batch
TRAIN_RESUME = (20, 30)       # run 20, then a new runner to 30
TRAIN_FAIL_AT = 25            # one injected failure after the optimizer
TRAIN_PROFILE_STEPS = 10
# card against CPU: float index_add/scatter_add atomics and GEMM
# algorithms reorder sums on the card, so the check is not bitwise
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
TRAIN_LAUNCHER = ["--arch", "gcn-cora", "--steps", "20"]
TRAIN_LAUNCHER_RESUME = ["--arch", "gcn-cora", "--steps", "30", "--resume"]
TRAIN_LAUNCHER_MORE = [["--arch", "dimenet", "--shape", "molecule", "--steps",
                        "20"], ["--arch", "dien", "--smoke", "--steps", "20"]]
# the VC-Index baseline (Table 8): benchmarks/bench_baselines.py's graphs
# (the full preset of benchmarks/common.py:85-88) and its IndexConfig
# (bench_baselines.py:86-87); each graph built as IS-LABEL and as the
# one-level VC index, both queried on the same pairs
VC_GRAPHS = [("rmat:17:8@1", ("rmat_graph", (17, 8.0), 1)),
             ("rmat:15:8@1", ("rmat_graph", (15, 8.0), 1)),
             ("er:65536:2.2@2", ("er_graph", (1 << 16, 2.2), 2)),
             ("grid:181@3", ("grid_graph", (181,), 3))]
VC_CONFIG = dict(l_cap=1024, label_chunk=2048)
STAGE2_KERNEL = {"ell_loop": "spmv_relax_kernel",
                 "fused": "fused_relax_kernel",
                 "dense": "minplus_matmul_kernel"}
# the entry points outside the package (repro_torch.examples and
# .scripts), each twin's main in-process at its own defaults but two:
# distance_serving runs at the paper's scale, rmat:17 (131,072 vertices)
# and 65,536 requests, its sharded lane on 4 shards of this card; train_lm
# takes 100 of its 300 steps (one checkpoint), since a step of the
# world-1 mesh took 0.43 s on the host (PERF.md, PR 28)
EXAMPLES_SMOKE_GRAPHS = ("er", "rmat", "grid", "caveman")
EXAMPLES_SERVING = ["17", "65536", "--shards", "4"]
EXAMPLES_LM = ["--steps", "100"]
# DIEN at the published config: AdamW's state over the 2^26- and 2^22-row
# tables is ~15 GB, so no checkpoint is written; train_batch's 65,536 is
# cut to 32,768 (PERF.md §4: the saved GRU activations of 65,536 do not
# fit one 80 GB card beside the state); serve and retrieval once each
DIEN_TRAIN_BATCH = 32_768
DIEN_STEPS = 20
DIEN_SERVE_REPEATS = 5
# LM serving (lm_<arch>, lm_width): LM_SHAPES' cells at their sequence
# lengths with the batch cut to fit one 80 GB card (PERF.md §4):
# prefill_32k at 1 sequence (from 32), decode_32k at 8 on granite-8b and
# 4 on qwen2-moe-a2.7b (from 128); bf16 weights drawn on the card
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
LM_FULL = [("granite-8b", 8), ("qwen2-moe-a2.7b", 4)]
LM_PREFILL_BATCH = 1
LM_PROMPT = 1024                 # decode_32k's prefill before the steps
LM_CHECK_STEPS = 8               # teacher-forced steps held to forward
LM_DECODE_STEPS = 32             # greedy steps, timed
LM_PROFILE_STEPS = 4
LM_PROFILE_LAYERS = 2            # prefill_32k profiled on its first 2 layers
LM_TOL = 5e-2                    # max|d| / max|logit|, repro's tolerance
# An MoE's bf16 decode is batch-dependent by design: capacity drops
# depend on the tokens routed together, and bf16 router logits lie close,
# so a rounding difference swaps experts. Its bf16 check at the published
# capacity is reported. The gates run with a capacity no call exceeds, at
# a prompt short enough for kimi-k2's no-drop buffer (384 x (T + 1) rows):
# in fp32 at LM_EXACT_TOL, and in bf16 at LM_TOL on the positions whose
# routing, and that of every earlier position, equals forward's at every
# layer; in both, every expert set that first departs from forward's must
# do so at a near tie, within LM_TIE_ULPS bf16 ulps (route_witness)
LM_MOE_EXACT_PROMPT = 256
LM_EXACT_TOL = 1e-4              # max|d| / max|logit|, fp32 no-drop check
LM_TIE_ULPS = 4                  # a primary reroute's router-logit gap
# full width, depth cut: (arch, layers); a 4,096-token prefill at 1 sequence
LM_WIDTH = [("yi-34b", 2), ("qwen2-72b", 2), ("kimi-k2-1t-a32b", 1)]
LM_WIDTH_PROMPT = 4096
LM_CPU_STEPS = 4                 # lm_cpu: prefill + 4 decode steps, fp32
LM_CPU_RTOL, LM_CPU_ATOL = 1e-4, 1e-5
LM_LAUNCHER = [["--mode", "lm", "--arch", "granite-8b"],
               ["--mode", "lm", "--arch", "qwen2-moe-a2.7b"]]
# LM training (train_lm_<arch>): train_4k at its 4,096 tokens and full
# width with depth and batch cut to fit one 80 GB card (PERF.md §4):
# (arch, layers, global batch, grad_accum); fp32 parameters and AdamW
LM_TRAIN = [("granite-8b", 4, 8, 4), ("qwen2-moe-a2.7b", 2, 4, 4)]
LM_TRAIN_STEPS = 6               # through the runner, no checkpoint
LM_TRAIN_PROFILE_STEPS = 2
# train_lm_checks: the cells cut to (arch, layers) in fp32; one sequence
# of 512 tokens for (a) and (b), four for (d), and one of 4,096 for the
# remat policies (c), where activations and not the gradient buffers set
# the backward's peak
LM_CHECKS = [("granite-8b", 2), ("qwen2-moe-a2.7b", 1)]
LM_CHECK_SEQ = 512
LM_REMAT_SEQ = 4096
LM_ACCUM_CHECK = 4
# (b): a direction of N(0, 1) entries times each leaf's RMS, zero on the
# MoE's routing inputs (embed, attention, ln1, ln2, router: top-k is
# piecewise constant there and a flip makes the loss jump). eps = 3e-3
# balances the central difference's truncation (~eps^2) against the fp32
# rounding of a ~10.8 loss over a change of ~1e-3 (~1/eps): 5e-4 of
# <g, d> on a CPU sweep of a narrow dense and MoE config
LM_FD_EPS = (3e-3, 1e-2, 1e-3)   # the first is gated, the others reported
LM_FD_RTOL = 1e-2
LM_GRAD_RTOL = 1e-5              # remat policies: max|d| / max|g|
LM_ACCUM_RTOL = 1e-5             # grad_accum 4 against 1: loss, gnorm, mu
# train_lm_smoke: the five smoke configs in fp32 (kimi-k2's parameters in
# bf16, Adafactor) through phase_train, the launcher beside. kimi-k2's
# gradients are bf16, and the embedding's index_add sums them in bf16 in
# the atomics' order unless torch.use_deterministic_algorithms is on
# (then one sorted pass): kimi runs under it, its resume and rollback
# held bitwise and its card against the CPU at TRAIN_RTOL / TRAIN_ATOL
# phase_train's runs, shortened (the script's time): 12 steps; resume 10
# then 12; a failure at step 11, rolled back to step 10's checkpoint; 2
# profiled steps
LM_SMOKE_RUNS = (12, (10, 12), 11, 2)
LM_TRAIN_LAUNCHER = [["--arch", "granite-8b", "--smoke"],
                     ["--arch", "kimi-k2-1t-a32b", "--smoke"]]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


# timings whose device ms may hold host gaps (see cuda_ms)
UNCOVERED = [0]


def cuda_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, wall ms) of one call of ``fn``, means over ``iters``
    calls after one warm-up call.

    Device ms: the calls are queued behind a device-side sleep long
    enough to cover their host-side launch cost, and CUDA events around
    them time the device alone. If the sleep ended before the last call
    was queued (the start event had completed by then), the device may
    have waited on the host: the run is repeated behind a longer sleep,
    up to 2 s, and counted in ``UNCOVERED`` if it still was. Wall ms:
    the same calls back to back on the host clock, ending in a
    synchronize, launch cost included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()                       # the queue is empty: this times the enqueue
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_s = min(2 * enqueue_s * iters, 2.0)
    for _ in range(3):
        # at most 2e9 SM cycles a second on an H100
        torch.cuda._sleep(int(sleep_s * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered or sleep_s >= 2.0:
            break
        sleep_s = min(4 * sleep_s, 2.0)
    UNCOVERED[0] += not covered
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return start.elapsed_time(end) / iters, wall


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.float(), b.float()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    if smi.returncode or not lines:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "--id=0"], capture_output=True, text=True, timeout=60)
    if clk.returncode:
        fail(f"nvidia-smi failed: {clk.stderr.strip()}")
    return {"name": torch.cuda.get_device_name(0), "smi": lines,
            "clock_max_mhz": float(clk.stdout.split()[0]),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = (lib.parent / "ptxas.log").read_text().splitlines()
    usage = [ln.split("ptxas info    :")[-1].strip() for ln in log
             if "registers" in ln or "spill" in ln]
    return {"seconds": time.perf_counter() - t0, "library": str(lib),
            "ptxas": usage}


def drive_route(route, spec, gen_call, overrides, device):
    """Build and query one graph on the card; returns (record, index,
    s, t, graph) and checks answers against Dijkstra (and, for a
    compressed index, that the codec is delta16 with an int32 distance
    plane). ``graph`` is the generated (n, src, dst, w)."""
    import numpy as np
    import torch
    from repro_torch.core import ISLabelIndex, IndexConfig, ref, sync
    from repro_torch.graphs import generators as gen

    t0 = time.perf_counter()
    fn, args, seed = gen_call
    n, src, dst, w = getattr(gen, fn)(*args, seed=seed)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(**overrides),
                                 device=device)
        mode = idx.engine.relaxer.mode if idx.engine.relaxer else "none"
        rng = np.random.default_rng(0)
        s = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
        t = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
        times, syncs = [], []
        build_peak = torch.cuda.max_memory_allocated()
        for _ in range(2):       # first call builds the core layouts
            torch.cuda.reset_peak_memory_stats()
            with sync.sync_span() as span:
                t1 = time.perf_counter()
                ans = idx.query(s, t)   # ends on a blocking read of rounds
                times.append((time.perf_counter() - t1) * 1e3)
            syncs.append(span.count)
        repeats = []
        for _ in range(QUERY_REPEATS):
            t1 = time.perf_counter()
            idx.query(s, t)
            repeats.append((time.perf_counter() - t1) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if mode != route:
        fail(f"{spec}: expected route {route}, took {mode}")
    eng = idx.engine
    if overrides.get("label_dtype", "fp32") != "fp32" and (
            eng.codec != "delta16" or eng.enc_d.dtype != torch.int32):
        fail(f"{spec}: codec {eng.codec} with a {eng.enc_d.dtype} distance "
             f"plane, expected delta16 with int32")
    got = ans.cpu().numpy()
    n_check = min(MAIN_QUERIES, 16 if n > 100_000 else 128)
    oracle = ref.dijkstra_oracle(n, src, dst, w, s[:n_check])
    want = oracle[np.arange(n_check), t[:n_check]].astype(np.float32)
    if got.shape != (MAIN_QUERIES,) or not np.array_equal(got[:n_check], want):
        fail(f"{spec}: answers differ from Dijkstra on the first {n_check} "
             f"sources")
    if np.isnan(got).any():
        fail(f"{spec}: NaN answers")
    st = idx.stats
    rec = {"route": mode, "graph": spec, "n": n, "m": len(src) // 2,
           "k": st.k, "n_core": st.n_core, "m_core": st.m_core // 2,
           "gen_s": gen_s, "build_s": st.build_seconds,
           "peel_s": st.peel_seconds, "label_s": st.label_seconds,
           "mis_rounds": st.mis_rounds, "peel_iters": st.peel_iters,
           "peel_loop_syncs": st.peel_loop_syncs,
           "syncs_per_level": st.peel_loop_syncs / max(1, st.peel_iters),
           "build_syncs": st.host_syncs,
           "rounds": idx.engine._last_rounds,
           "query_ms_first": times[0], "query_ms": times[1],
           "query_ms_median": statistics.median(repeats),
           "query_ms_repeats": repeats,
           "query_syncs": syncs[1], "queries": MAIN_QUERIES,
           "dijkstra_checked": n_check,
           "peak_device_bytes_build": build_peak,
           "peak_device_bytes_query": torch.cuda.max_memory_allocated(),
           "label_entries": st.label_entries, "codec": eng.codec}
    if eng.codec == "delta16":
        from repro_torch.core.labels import encoded_nbytes
        rec["label_plane_bytes_fp32"] = (eng.lbl_ids.numel() * 4
                                         + eng.lbl_d.numel() * 4)
        rec["label_plane_bytes_encoded"] = encoded_nbytes(
            eng.enc_ids, eng.enc_base, eng.enc_d)
        rec["enc_d_dtype"] = str(eng.enc_d.dtype)
    return rec, idx, s, t, (n, src, dst, w)


def phase_builders(fp32_1e6) -> dict:
    """Host and device builders on one graph and seed: the same
    hierarchy and labels, bitwise; then whether the labels of the 10^6
    graph (``fp32_1e6``, an fp32 index) would fit the delta16 codec."""
    import numpy as np
    import torch
    from repro_torch.core import ISLabelIndex, IndexConfig, sync
    from repro_torch.core.labels import LabelCompressionError, encode_labels
    from repro_torch.graphs import generators as gen

    spec, (fn, args, seed), overrides = BUILDER_GRAPH
    n, src, dst, w = getattr(gen, fn)(*args, seed=seed)
    built, rec = {}, {"graph": spec, "n": n}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for builder in ("host", "device"):
            idx = ISLabelIndex.build(
                n, src, dst, w, IndexConfig(builder=builder, **overrides),
                device="cuda")
            st = idx.stats
            rec[builder] = {"build_s": st.build_seconds,
                            "peel_s": st.peel_seconds, "k": st.k,
                            "peel_iters": st.peel_iters,
                            "peel_loop_syncs": st.peel_loop_syncs,
                            "syncs_per_level":
                                st.peel_loop_syncs / max(1, st.peel_iters)}
            labels = sync.host_read((idx.lbl_ids, idx.lbl_d, idx.lbl_pred))
            built[builder] = (idx.level, idx.up_ids, idx.up_w, idx.up_via,
                              idx.core_src, idx.core_dst, idx.core_w,
                              idx.core_via, *labels)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fields = ("level", "up_ids", "up_w", "up_via", "core_src", "core_dst",
              "core_w", "core_via", "lbl_ids", "lbl_d", "lbl_pred")
    differ = [f for f, a, b in zip(fields, built["host"], built["device"])
              if a.dtype != b.dtype or not np.array_equal(a, b)]
    if differ:
        fail(f"{spec}: host and device builders differ in {differ}")
    rec["bitwise_equal"] = list(fields)

    # outside any timed region: one host copy of the 10^6 labels
    ids, d = sync.host_read((fp32_1e6.lbl_ids, fp32_1e6.lbl_d))
    try:
        encode_labels(ids, d, fp32_1e6.n)
        rec["delta16_fits_1e6"] = {"fits": True}
    except LabelCompressionError as err:
        rec["delta16_fits_1e6"] = {"fits": False, "reason": str(err)}
    return rec


def zero(tables) -> None:
    for tab in tables:
        for key in tab:
            tab[key] = 0


def launches_of(tables) -> dict:
    return {k: v for tab in tables for k, v in tab.items()}


def check_launches(what, launches, kernels) -> None:
    launched = {k for k, v in launches.items() if v}
    if launched != kernels:
        fail(f"{what} launched {sorted(launched)}, expected "
             f"{sorted(kernels)}")


def host_batch(out):
    """A ``PathBatch`` of numpy arrays (one blocking read)."""
    from repro_torch.core.sync import host_read
    return type(out)(*host_read(tuple(out)))


def phase_paths(path, idx, s, t, graph, tables) -> dict:
    """The path lane on one main path's index: ``path_batch_fn(256)`` on
    the path's 1024 pairs (two calls, then ``PATH_REPEATS`` timed ones,
    each ending on the blocking read of the batch), under sync debug
    mode "error", with the launch counters zeroed around it. ``dist``
    must equal the query's answers bitwise and ``rounds`` the query's
    count; every path must pass ``check_path_batch`` against the
    generated edge list (after escalating ``hop_cap`` as ``paths()``
    does, where one overflowed); on ``ORACLE_PATHS`` the host oracle
    ``shortest_path`` must give the query's distance and a valid path on
    8 pairs."""
    import numpy as np
    import torch
    from repro_torch.core import sync
    from repro_torch.paths import (check_path_batch, check_vertex_path,
                                   edge_weight_map)
    zero(tables)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        eng = idx.path_engine()
        engine_ms = (time.perf_counter() - t0) * 1e3
        fn = eng.path_batch_fn(PATH_HOP_CAP)
        times, syncs = [], []
        for _ in range(2):
            with sync.sync_span() as span:
                t1 = time.perf_counter()
                batch = host_batch(fn(s, t))
                times.append((time.perf_counter() - t1) * 1e3)
            syncs.append(span.count)
        repeats = []
        for _ in range(PATH_REPEATS):
            t1 = time.perf_counter()
            host_batch(fn(s, t))
            repeats.append((time.perf_counter() - t1) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = launches_of(tables)
    check_launches(f"path lane on {path}", launches, PATH_LANE_KERNELS[path])
    peak = torch.cuda.max_memory_allocated()
    want = sync.host_read(idx.query(s, t))
    if not np.array_equal(batch.dist, want):
        fail(f"{path}: path-lane distances differ from the query's")
    if int(batch.rounds) != idx.engine._last_rounds:
        fail(f"{path}: path lane ran {int(batch.rounds)} rounds, the query "
             f"{idx.engine._last_rounds}")
    n, src, dst, w = graph
    edges = edge_weight_map(src, dst, w)
    hc, escalations, checked = PATH_HOP_CAP, 0, batch
    overflowed = int((~batch.ok).sum())
    while not checked.ok.all() and escalations < 4:
        hc, escalations = 2 * hc, escalations + 1
        checked = host_batch(eng.path_batch_fn(hc)(s, t))
    rep = check_path_batch(edges, s, t, checked)
    if rep["violations"] or rep["overflowed"]:
        fail(f"{path}: path check failed at hop_cap {hc}: "
             f"{rep['overflowed']} overflowed, {rep['violations'][:3]}")
    rec = {"hop_cap": PATH_HOP_CAP, "queries": len(s),
           "path_ms_first": times[0], "path_ms": times[1],
           "path_ms_median": statistics.median(repeats),
           "path_ms_repeats": repeats, "path_syncs": syncs[1],
           "engine_ms": engine_ms, "rounds": int(batch.rounds),
           "overflowed": overflowed, "escalations": escalations,
           "lens_max": int(checked.lens.max()),
           "lens_mean": float(checked.lens[checked.lens > 0].mean()),
           "reachable": int(np.isfinite(batch.dist).sum()),
           "checked": rep["checked"], "launches": launches,
           "chase_width": int(eng.ell_ids.shape[1]),
           "peak_device_bytes_path": peak}
    if path in ORACLE_PATHS:
        for i in range(8):
            d, p = idx.shortest_path(int(s[i]), int(t[i]))
            bad = check_vertex_path(edges, int(s[i]), int(t[i]), d, p)
            if np.float32(d) != want[i] or bad:
                fail(f"{path}: shortest_path({s[i]}, {t[i]}) gave {d} "
                     f"(query {want[i]}) {bad[:2]}")
        rec["oracle_pairs"] = 8
    return rec


def holdout():
    """``MUTATION_GRAPH`` and its held-out vertex u: the last vertex of
    degree 2–6 in the graph's largest component. Returns (n, src, dst,
    w, u, keep, nbrs, ws): ``keep`` masks the edges not touching u, and
    (nbrs, ws) are u's edges."""
    import numpy as np
    from scipy.sparse.csgraph import connected_components
    from repro_torch.core import ref
    from repro_torch.graphs import generators as gen
    _, (fn, args, seed), _ = MUTATION_GRAPH
    n, src, dst, w = getattr(gen, fn)(*args, seed=seed)
    deg = np.bincount(src, minlength=n)
    _, comp = connected_components(ref.build_csr(n, src, dst, w))
    giant = comp == np.bincount(comp).argmax()
    u = int(np.flatnonzero(giant & (deg >= 2) & (deg <= 6))[-1])
    keep = (src != u) & (dst != u)
    return (n, src, dst, w, u, keep, dst[src == u].tolist(),
            w[src == u].tolist())


def phase_mutation(tables, device="cuda") -> dict:
    """§8.3 on a hold-out build of ``MUTATION_GRAPH``: u is the last
    vertex of degree 2–6 in the graph's largest component; the index is
    built without u's edges. Then ``MUTATION_CYCLES`` times
    ``insert_vertex(u, ...)`` and ``delete_vertex(u)``, each timed on
    the host clock (the engine rebuild included), under sync debug mode
    "error". After the first insert, u's distances to every vertex are
    never shorter than Dijkstra's on the full graph and finite only
    where u reaches (the lazy insert is exact where u attaches to the
    core, and otherwise reaches only its neighbours' descendants), and
    u's paths to 1024 vertices and to every vertex it reaches pass
    ``check_path_batch`` against the full graph's edges with ``dist``
    equal to the query's (paths through an entry pushed into a non-core
    neighbour come back ``ok=False``, as in the JAX package, and are
    counted). After the last delete (the exact
    inverse of the insert), answers on 1024 pairs equal the hold-out
    index's before the first insert, and on 256 of them are never
    shorter than Dijkstra's without u (the rule of
    ``tests/test_paths_updates.py::test_delete_vertex``)."""
    import numpy as np
    import torch
    from repro_torch.core import ISLabelIndex, IndexConfig, ref, sync
    from repro_torch.paths import check_path_batch, edge_weight_map

    spec, _, overrides = MUTATION_GRAPH
    n, src, dst, w, u, keep, nbrs, ws = holdout()
    deg = np.bincount(src, minlength=n)
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
    t = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
    zero(tables)
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx = ISLabelIndex.build(n, src[keep], dst[keep], w[keep],
                                 IndexConfig(**overrides), device=device)
        level_u = int(idx.level[u])
        nbrs_core = int((idx.level[nbrs] == idx.k).sum())
        before = sync.host_read(idx.query(s, t))
        insert_ms, delete_ms = [], []
        for cycle in range(MUTATION_CYCLES):
            t0 = time.perf_counter()
            touched = idx.insert_vertex(u, nbrs, ws)
            insert_ms.append((time.perf_counter() - t0) * 1e3)
            if cycle == 0:
                touched_ins = touched
                row = sync.host_read(idx.query(np.full(n, u, np.int32),
                                               np.arange(n, dtype=np.int32)))
                # 1024 random targets, then every vertex u reaches
                ends = np.concatenate([t, np.flatnonzero(np.isfinite(row))])
                ends = ends.astype(np.int32)
                us = np.full(len(ends), u, np.int32)
                batch = host_batch(
                    idx.path_engine().path_batch_fn(PATH_HOP_CAP)(us, ends))
            t0 = time.perf_counter()
            touched_del = idx.delete_vertex(u)
            delete_ms.append((time.perf_counter() - t0) * 1e3)
        after = sync.host_read(idx.query(s, t))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = launches_of(tables)
    check_launches("mutation", launches, MUTATION_KERNELS)
    full = ref.dijkstra_oracle(n, src, dst, w, [u])[0].astype(np.float32)
    fin = np.isfinite(row)
    if not (np.isfinite(full[fin]).all() and (row[fin] >= full[fin]).all()):
        fail(f"{spec}: after inserting {u} a distance is shorter than "
             f"Dijkstra's, or finite where {u} does not reach")
    if not np.array_equal(batch.dist, row[ends]):
        fail(f"{spec}: paths of {u} differ in distance from its queries")
    # a path through an entry the insert pushed into a non-core
    # neighbour v cannot be chased (its pred is v itself, as in the JAX
    # package): ok drops there, and only there may a path be missing
    rep = check_path_batch(edge_weight_map(src, dst, w), us, ends, batch)
    if rep["violations"]:
        fail(f"{spec}: paths of {u}: {rep['violations'][:3]}")
    if not np.array_equal(after, before):
        fail(f"{spec}: deleting {u} did not restore the answers")
    m = 256
    mask = (s[:m] != u) & (t[:m] != u)
    want = ref.dijkstra_oracle(n, src[keep], dst[keep], w[keep], s[:m][mask])[
        np.arange(mask.sum()), t[:m][mask]].astype(np.float32)
    got = after[:m][mask]
    ok = np.isfinite(got)
    cover = ok & np.isfinite(want)
    if not ((got[ok] >= want[ok]).all()
            and (got[cover] == want[cover]).mean() > 0.8):
        fail(f"{spec}: answers after deleting {u} break the conservative "
             f"rule")
    return {"graph": spec, "n": n, "u": u, "degree": int(deg[u]),
            "neighbours_in_core": nbrs_core, "level_before": level_u,
            "k": idx.k,
            "insert_ms": insert_ms, "delete_ms": delete_ms,
            "insert_ms_median": statistics.median(insert_ms),
            "delete_ms_median": statistics.median(delete_ms),
            "touched_insert": len(touched_ins),
            "touched_delete": len(touched_del),
            "row_reachable": int(fin.sum()),
            "dijkstra_reachable": int(np.isfinite(full).sum()),
            "row_exact": int((row[fin] == full[fin]).sum()),
            "paths_checked": rep["checked"], "paths_not_ok": rep["overflowed"],
            "paths_reachable": int(np.isfinite(batch.dist).sum()),
            "delete_exact_share": float((got[cover] == want[cover]).mean()),
            "launches": launches}


def profile_idle(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: host wall ms, the time
    the device was busy (the union of the kernels' and copies'
    intervals in the trace), and the device's idle share of the wall
    time; repeated up to three times while the trace holds no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    by_kind = {}
    for name, (ms, c) in by_name.items():
        kind = kernel_kind(name)
        k_ms, k_n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (k_ms + ms, k_n + c)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "attempts": attempt,
            "idle_share": (1 - busy_us / 1e3 / wall_ms) if spans else None,
            "device_events": len(spans),
            "top": [{"name": k[:80], "device_ms": ms, "count": c}
                    for k, (ms, c) in top],
            "by_kind": {k: {"device_ms": ms, "count": c}
                        for k, (ms, c) in sorted(by_kind.items())}}


def kernel_kind(name: str) -> str:
    """A trace event's kind by its name: ``gemm`` (cuBLAS and CUTLASS
    products), ``softmax``, ``copy`` (memcpy, memset, copies and casts
    by ``copy_``), ``reduce``, ``index`` (gathers, scatters, sorts) or
    ``elementwise``."""
    n = name.lower()
    for kind, keys in (("gemm", ("gemm", "nvjet", "cutlass", "xmma",
                                 "cublas")),
                       ("softmax", ("softmax",)),
                       ("copy", ("memcpy", "memset", "copy")),
                       ("reduce", ("reduce",)),
                       ("index", ("index", "scatter", "gather", "sort",
                                  "radix", "cub::"))):
        if any(k in n for k in keys):
            return kind
    return "elementwise"


class LaneMeter:
    """Instruments one ``DistanceServer``'s lanes for the serving phase:
    the kernel launches and the counted syncs inside each lane's entry
    point, and the wall time and counted syncs of each executed batch
    (``_execute`` / ``_execute_path``, whose timed ``exec_s`` the
    metrics hold). The
    entry points keep their ``shapes``, so ``compile_cache_sizes``
    reads through."""

    def __init__(self, srv, tables):
        from repro_torch.core import sync
        self.tables = tables
        self.launches: dict = {}
        self.inner_syncs: dict = {}
        self.exec_wall_s: dict = {}
        self.exec_syncs: dict = {}

        def entry(fn, lane):
            def run(*args):
                before = launches_of(tables)
                with sync.sync_span() as span:
                    out = fn(*args)
                after = launches_of(tables)
                tab = self.launches.setdefault(lane, {})
                for k, v in after.items():
                    tab[k] = tab.get(k, 0) + v - before[k]
                self.inner_syncs[lane] = (self.inner_syncs.get(lane, 0)
                                          + span.count)
                return out
            run.shapes = fn.shapes
            return run

        def timed(fn, lane_of):
            def run(*args):
                t0 = time.perf_counter()
                with sync.sync_span() as span:
                    out = fn(*args)
                lane = lane_of(args)
                self.exec_wall_s[lane] = (self.exec_wall_s.get(lane, 0.0)
                                          + time.perf_counter() - t0)
                self.exec_syncs[lane] = (self.exec_syncs.get(lane, 0)
                                         + span.count)
                return out
            return run

        srv._fns = {lane: entry(fn, lane) for lane, fn in srv._fns.items()}
        srv._path_fns = {h: entry(fn, "path")
                         for h, fn in srv._path_fns.items()}
        srv._execute = timed(srv._execute, lambda a: a[0])
        srv._execute_path = timed(srv._execute_path, lambda a: "path")

    def reset(self) -> None:
        self.launches.clear()
        self.inner_syncs.clear()
        self.exec_wall_s.clear()
        self.exec_syncs.clear()


def lane_batches(batches) -> dict:
    """{lane: {bucket: batches}} of a list of ``BatchRecord``s."""
    out: dict = {}
    for b in batches:
        tab = out.setdefault(b.lane, {})
        tab[str(b.bucket)] = tab.get(str(b.bucket), 0) + 1
    return out


def check_lanes(what, meter, batches, kernels) -> None:
    """Each lane that ran a batch launched exactly its kernels; a lane
    that ran none launched nothing."""
    ran = {b.lane for b in batches}
    for lane, want in kernels.items():
        got = {k for k, v in meter.launches.get(lane, {}).items() if v}
        if got != (want if lane in ran else set()):
            fail(f"{what}: lane {lane} launched {sorted(got)}, expected "
                 f"{sorted(want) if lane in ran else []}")


def replay_record(srv, meter, batches, wall_s, syncs) -> dict:
    """The serving numbers of one replay: the metrics of its batches
    (``batches``, this replay's ``BatchRecord``s) and the host share of
    a batch (``_execute`` wall time minus the timed ``exec_s``)."""
    import numpy as np
    exec_s = sum(b.exec_s for b in batches)
    wall_exec = sum(meter.exec_wall_s.values())
    per_lane = {}
    for lane in sorted({b.lane for b in batches}):
        bs = [b for b in batches if b.lane == lane]
        lane_exec = sum(b.exec_s for b in bs)
        per_lane[lane] = {
            "batches": len(bs), "requests": sum(b.n_real for b in bs),
            "exec_ms_mean": lane_exec / len(bs) * 1e3,
            "host_ms_per_batch": (meter.exec_wall_s[lane] - lane_exec)
            / len(bs) * 1e3,
            "fill": float(np.mean([b.fill for b in bs])),
            "rounds_mean": float(np.mean([b.rounds for b in bs])),
            "launches": dict(meter.launches.get(lane, {})),
            "entry_syncs": meter.inner_syncs.get(lane, 0)}
    return {"batches": len(batches), "replay_wall_s": wall_s,
            "exec_s": exec_s, "batch_wall_s": wall_exec,
            "host_ms_per_batch": (wall_exec - exec_s) / len(batches) * 1e3,
            "host_share_of_batch": (wall_exec - exec_s) / wall_exec,
            "syncs": syncs, "lanes": per_lane,
            "by_lane_bucket": lane_batches(batches)}


def phase_serving(path, route, idx, graph, tables, kernels) -> dict:
    """The serving engine (``repro_torch.serve.DistanceServer``) on one
    main path's index: buckets 64/256/1024, a 2 ms deadline and a
    65,536-entry cache. A ``hotspot`` and a ``uniform`` trace
    (``make_trace``, seed 0, 50,000 req/s on the trace clock) replayed
    under sync debug mode "error": every served answer equal to
    ``idx.query`` bitwise (and, on ``SERVE_ORACLE``, a Dijkstra sample);
    each lane launching exactly its kernels (``mu``: the label kernel;
    ``full``: that and the route's stage-2 kernel); no first-use build
    in ``serve_read`` and ``compile_cache_sizes`` unchanged; exactly one
    counted sync a batch beyond the entry points' own exit-flag reads
    (none on the fused route). Then one more ``uniform`` replay, cache
    cleared, under ``torch.profiler`` (the device's idle share); the
    section-0 check (``classify`` and ``query_host`` on CUDA tensors
    equal to the same calls on numpy arrays, ``classify`` in one
    ``host_read``); and on ``SERVE_PATH_REQUESTS`` a path-lane replay at
    hop caps 64 and 256 whose paths all pass the launcher's
    ``_audit_paths``. Returns the record and the launches of the served
    batches."""
    import numpy as np
    import torch
    from repro_torch.core import ref, sync
    from repro_torch.launch.serve import _audit_paths
    from repro_torch.obs import BuildWatcher
    from repro_torch.serve import DistanceServer, make_trace

    stage2 = PATH_LANE_KERNELS[path]
    lane_kernels = {"mu": kernels - stage2, "full": kernels}
    n, src, dst, w = graph
    n_req = SERVE_REQUESTS.get(path, 4096)
    kw = dict(buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
              cache_size=SERVE_CACHE)
    zero(tables)
    with BuildWatcher() as builds:
        srv = DistanceServer(idx, name=path, **kw)
    rec = {"buckets": list(SERVE_BUCKETS), "max_wait_ms": SERVE_WAIT_MS,
           "cache_size": SERVE_CACHE, "rate_qps": SERVE_RATE,
           "requests": n_req, "warmup_seconds": srv.warmup_seconds,
           "warmup_builds": builds.snapshot(), "replays": {}}
    meter = LaneMeter(srv, tables)
    served_launches: dict = {}
    for scenario in SERVE_SCENARIOS:
        trace = make_trace(scenario, n=n, num_requests=n_req,
                           rate_qps=SERVE_RATE, seed=0)
        shapes = srv.compile_cache_sizes()
        first = len(srv.metrics.batches)
        hits0 = srv.metrics.cache_hits
        meter.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with BuildWatcher() as watch, sync.sync_span() as span:
                t0 = time.perf_counter()
                served = srv.serve_trace(trace)
                wall_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        batches = srv.metrics.batches[first:]
        what = f"serving {scenario} on {path}"
        if watch.count("serve_read") or watch.count():
            fail(f"{what}: first-use builds after warmup "
                 f"{watch.snapshot()}")
        if srv.compile_cache_sizes() != shapes:
            fail(f"{what}: shapes {shapes} -> {srv.compile_cache_sizes()}")
        inner = sum(meter.inner_syncs.values())
        if span.count - inner != len(batches) or (
                route == "fused" and inner):
            fail(f"{what}: {span.count} syncs for {len(batches)} batches "
                 f"({inner} inside the entry points)")
        check_lanes(what, meter, batches, lane_kernels)
        for tab in meter.launches.values():
            for k, v in tab.items():
                served_launches[k] = served_launches.get(k, 0) + v
        want = sync.host_read(idx.query(trace.s, trace.t))
        if served.shape != want.shape or not np.array_equal(served, want):
            fail(f"{what}: {int((served != want).sum())} answers differ "
                 f"from idx.query")
        one = replay_record(srv, meter, batches, wall_s, span.count)
        one.update(cache_hits=srv.metrics.cache_hits - hits0,
                   cache_hit_rate=(srv.metrics.cache_hits - hits0) / n_req)
        if path in SERVE_ORACLE:
            k = SERVE_ORACLE[path]
            srcs, inv = np.unique(trace.s[:k], return_inverse=True)
            oracle = ref.dijkstra_oracle(n, src, dst, w, srcs)
            if not np.array_equal(served[:k], oracle[inv, trace.t[:k]]
                                  .astype(np.float32)):
                fail(f"{what}: answers differ from Dijkstra")
            one["dijkstra_checked"] = k
        # the per-request routing cost (route of one pair, as submit
        # without a lane does it)
        t0 = time.perf_counter()
        for i in range(256):
            srv.route(int(trace.s[i]), int(trace.t[i]))
        one["route_us_per_request"] = (time.perf_counter() - t0) / 256 * 1e6
        t0 = time.perf_counter()
        srv.route(trace.s, trace.t)
        one["route_s"] = time.perf_counter() - t0
        rec["replays"][scenario] = one
    snap = srv.metrics.snapshot()
    rec.update({k: snap[k] for k in (
        "served", "qps_compute", "qps_offered", "latency_ms",
        "batch_fill_ratio", "cache_hit_rate", "bucket_counts",
        "query_types")})
    rec["by_lane_bucket"] = lane_batches(srv.metrics.batches)
    rec["compiled_shapes"] = srv.compile_cache_sizes()

    # the device's idle share of one replay (cache cleared)
    trace = make_trace("uniform", n=n, num_requests=n_req,
                       rate_qps=SERVE_RATE, seed=0)
    srv.cache.clear()
    rec["profile"] = profile_idle(lambda: srv.serve_trace(trace))

    # section 0: classify and query_host take CUDA tensors
    s_np, t_np = trace.s[:256], trace.t[:256]
    s_cu, t_cu, lev_cu = (torch.as_tensor(x, device=idx.device)
                          for x in (s_np, t_np, idx.level))
    with sync.sync_span() as span:
        cls = idx.engine.classify(s_cu, t_cu, lev_cu, idx.k)
    if span.count != 1 or not np.array_equal(
            cls, idx.engine.classify(s_np, t_np, idx.level, idx.k)):
        fail(f"{path}: classify on CUDA tensors ({span.count} syncs) "
             f"differs from classify on numpy arrays")
    if not (np.array_equal(idx.query_types(s_cu, t_cu),
                           idx.query_types(s_np, t_np))
            and np.array_equal(idx.query_host(s_cu, t_cu),
                               idx.query_host(s_np, t_np))):
        fail(f"{path}: query_types or query_host differ on CUDA tensors")
    rec["cuda_tensor_inputs"] = "equal"

    if path in SERVE_PATH_REQUESTS:
        with BuildWatcher() as builds:
            psrv = DistanceServer(idx, name=f"{path}-paths",
                                  path_hop_caps=SERVE_HOP_CAPS, **kw)
        pmeter = LaneMeter(psrv, tables)
        trace = make_trace("hotspot", n=n,
                           num_requests=SERVE_PATH_REQUESTS[path],
                           rate_qps=SERVE_RATE, seed=0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with BuildWatcher() as watch:
                t0 = time.perf_counter()
                dist, paths, valid = psrv.serve_path_trace(trace)
                wall_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        what = f"path lane serving on {path}"
        if watch.count():
            fail(f"{what}: first-use builds after warmup "
                 f"{watch.snapshot()}")
        batches = psrv.metrics.batches
        check_lanes(what, pmeter, batches, {"path": stage2})
        for k, v in pmeter.launches.get("path", {}).items():
            served_launches[k] = served_launches.get(k, 0) + v
        if _audit_paths(src, dst, w, trace, dist, paths, valid):
            fail(f"{what}: a served path failed the audit")
        want = sync.host_read(idx.query(trace.s, trace.t))
        if not np.array_equal(dist, want):
            fail(f"{what}: distances differ from idx.query")
        psnap = psrv.metrics.snapshot()
        one = replay_record(psrv, pmeter, batches, wall_s, None)
        one.update(requests=len(trace), hop_caps=list(SERVE_HOP_CAPS),
                   warmup_seconds=psrv.warmup_seconds,
                   warmup_builds=builds.snapshot(),
                   path_overflows=psnap["path_overflows"],
                   qps_compute=psnap["qps_compute"],
                   latency_ms=psnap["latency_ms"],
                   cache_hit_rate=psnap["cache_hit_rate"],
                   path_vertices_max=max(len(p) for p in paths))
        rec["path_lane"] = one
    rec["launches"] = served_launches
    return rec


def mirror_writes(src, dst, w, ops):
    """The undirected edge list after one §8.3 write batch: an insert
    adds both directions of its edges, a delete drops every edge of its
    vertex (``launch/serve.py``'s ``_audit_rebuild`` model, in numpy)."""
    import numpy as np
    for op in ops:
        u = int(op.u)
        if op.kind == "insert":
            nb = np.asarray(op.nbrs, np.int32)
            ws = np.asarray(op.ws, np.float32)
            src = np.concatenate([src, np.full(len(nb), u, np.int32), nb])
            dst = np.concatenate([dst, nb, np.full(len(nb), u, np.int32)])
            w = np.concatenate([w, ws, ws])
        else:
            keep = (src != u) & (dst != u)
            src, dst, w = src[keep], dst[keep], w[keep]
    return src, dst, w


def pcts(xs) -> dict:
    import numpy as np
    if not len(xs):
        return {"p50": None, "p99": None, "max": None}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "max": float(max(xs))}


def phase_versioned(path, route, spec, gen_call, overrides, n_req,
                    write_ratio, tables, device="cuda") -> dict:
    """Versioned mutation under traffic on one graph: the index is built
    over n_base + ``VERSION_SPARES`` ids and served by
    ``DistanceServer(versioned=True)`` at ``launch/serve.py``'s defaults;
    a ``readwrite`` trace (seed 0, 50,000 req/s, ``write_ratio``, write
    batches of up to 2 ops, reads over the n_base ids, inserts attached
    to the core) is replayed under sync debug mode "error". Checks:
    the family's route is ``route`` and ``repro``'s rule (fused iff the
    working-set model of the pinned ELL width fits 12 MiB); every served
    read equals ``version.index.query`` of the version that served it,
    bitwise (each version audited as it retires, the last after the
    replay); every ``VERSION_REBUILD_EVERY``-th version segment and the
    last equal a from-scratch build of the mirrored graph (and a
    Dijkstra sample on ``VERSION_ORACLE``); each lane launches exactly
    its kernels (``mu``: the codec's label kernel; ``full``: it and the
    route's stage-2 kernel); the shape counts unchanged across the
    swaps, no first-use build in ``serve_read`` and one layout build a
    swap in ``mutation``; one counted sync a read batch beyond the entry
    points' own; every retired version dropped after ``drain``."""
    import numpy as np
    import torch
    from repro_torch.core import ISLabelIndex, IndexConfig, ref, sync
    from repro_torch.core.dispatch import FUSED_VMEM_BUDGET
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels.spmv_relax.kernel import fused_vmem_bytes
    from repro_torch.obs import (BuildWatcher, compile_region,
                                 version_family_gauges)
    from repro_torch.serve import DistanceServer, make_trace

    t0 = time.perf_counter()
    fn, args, seed = gen_call
    n_base, src, dst, w = getattr(gen, fn)(*args, seed=seed)
    n = n_base + VERSION_SPARES
    gen_s = time.perf_counter() - t0
    zero(tables)
    torch.cuda.reset_peak_memory_stats()
    idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(**overrides),
                             device=device)
    build_s = time.perf_counter() - t0 - gen_s
    codec_kernel = ("label_intersect_packed_kernel"
                    if idx.engine.codec == "delta16"
                    else "label_intersect_kernel")
    stage2 = {"fused": "fused_relax_kernel",
              "ell_loop": "spmv_relax_kernel"}[route]
    lane_kernels = {"mu": {codec_kernel}, "full": {codec_kernel, stage2}}
    t1 = time.perf_counter()
    with BuildWatcher() as warm:
        srv = DistanceServer(idx, name=f"versioned-{path}",
                             buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
                             cache_size=SERVE_CACHE, versioned=True)
    server_s = time.perf_counter() - t1
    mgr, fam = srv.versions, srv.versions.family
    rule = ("fused" if fused_vmem_bytes(fam.vp, fam.ell_width, fam.bq)
            <= FUSED_VMEM_BUDGET else "ell_loop")
    if not fam.relax_mode == rule == route:
        fail(f"versioned {path}: family route {fam.relax_mode}, repro's "
             f"rule {rule}, expected {route}")
    trace = make_trace("readwrite", n=n, num_requests=n_req,
                       rate_qps=SERVE_RATE, seed=0, write_ratio=write_ratio,
                       write_batch=VERSION_WRITE_BATCH, n_read=n_base,
                       spares=range(n_base, n), attach_to=idx.core_ids)
    reads = np.flatnonzero([x is None for x in trace.writes])
    # the version each read is served under: the writes before it
    read_vid = np.cumsum([x is not None for x in trace.writes])[reads]

    # audit each version as it retires (its reads are all answered by
    # then: a swap force-flushes the pending batches), outside the sync
    # debug mode and in a region of its own
    want = np.full(len(trace), np.nan, np.float32)
    applied, retire_s = [], []

    def audit(version):
        sel = reads[read_vid == version.vid]
        if not len(sel):
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with compile_region("audit"):
                want[sel] = sync.host_read(version.index.query(
                    trace.s[sel], trace.t[sel]))
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    apply, retire, build_layout = mgr.apply, mgr.retire, fam.build_layout
    layout_s = []

    def timed_layout(*args):
        t2 = time.perf_counter()
        out = build_layout(*args)
        layout_s.append(time.perf_counter() - t2)
        return out

    def audited_apply(ops):
        audit(mgr.current)
        v = apply(ops)
        # a record, not the version: retired versions must drop
        applied.append({"ops": ops, "swap_s": v.swap_seconds,
                        "stages": v.stage_seconds,
                        "touched": len(v.touched_rows)})
        return v

    def timed_retire(version):
        t2 = time.perf_counter()
        retire(version)
        retire_s.append(time.perf_counter() - t2)

    mgr.apply, mgr.retire = audited_apply, timed_retire
    fam.build_layout = timed_layout
    meter = LaneMeter(srv, tables)
    shapes = srv.compile_cache_sizes()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with BuildWatcher() as watch, sync.sync_span() as span:
            t1 = time.perf_counter()
            served, vids = srv.serve_readwrite_trace(trace)
            replay_s = time.perf_counter() - t1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    audit(mgr.current)
    peak = torch.cuda.max_memory_allocated()
    what = f"versioned {path}"
    writes = len(applied)
    if writes != trace.meta["writes"] or not np.array_equal(vids[reads],
                                                            read_vid):
        fail(f"{what}: {writes} swaps for {trace.meta['writes']} writes, "
             f"or reads served under other versions")
    if not np.array_equal(served[reads], want[reads]):
        fail(f"{what}: {int((served[reads] != want[reads]).sum())} served "
             f"reads differ from their version's index.query")
    if srv.compile_cache_sizes() != shapes:
        fail(f"{what}: shapes {shapes} -> {srv.compile_cache_sizes()}")
    builds = watch.snapshot()
    if builds.get("serve_read") or builds.get("mutation") != writes:
        fail(f"{what}: first-use builds {builds}, expected none in "
             f"serve_read and {writes} in mutation")
    batches = srv.metrics.batches
    check_lanes(what, meter, batches, lane_kernels)
    inner = sum(meter.inner_syncs.values())
    layer = sum(meter.exec_syncs.values()) - inner
    if layer != len(batches) or (route == "fused" and inner):
        fail(f"{what}: {layer} serving-layer syncs for {len(batches)} "
             f"batches ({inner} inside the entry points)")

    # from-scratch rebuilds of the mirrored graph, and a Dijkstra sample
    t1 = time.perf_counter()
    cfg = {k: v for k, v in overrides.items() if k != "label_dtype"}
    m_src, m_dst, m_w = src, dst, w
    last = int(vids.max())
    n_oracle = VERSION_ORACLE.get(path, 0)
    rebuilt, oracle_checked = [], 0
    for vid in range(last + 1):
        if vid:
            m_src, m_dst, m_w = mirror_writes(m_src, m_dst, m_w,
                                              applied[vid - 1]["ops"])
        sel = reads[read_vid == vid]
        if not len(sel):
            continue
        if vid % VERSION_REBUILD_EVERY == 0 or vid == last:
            scratch = ISLabelIndex.build(n, m_src, m_dst, m_w,
                                         IndexConfig(**cfg), device=device)
            got = sync.host_read(scratch.query(trace.s[sel], trace.t[sel]))
            if not np.array_equal(got, served[sel]):
                fail(f"{what}: version {vid} differs from its rebuild on "
                     f"{int((got != served[sel]).sum())} reads")
            rebuilt.append(vid)
            del scratch
        sample = sel[np.isin(sel, reads[:n_oracle])]
        if len(sample):
            srcs, inv = np.unique(trace.s[sample], return_inverse=True)
            dist = ref.dijkstra_oracle(n, m_src, m_dst, m_w, srcs)
            if not np.array_equal(dist[inv, trace.t[sample]].astype(
                    np.float32), served[sample]):
                fail(f"{what}: version {vid} differs from Dijkstra")
            oracle_checked += len(sample)
    audit_s = time.perf_counter() - t1

    gauges = version_family_gauges(mgr, server=srv.name)
    srv.drain()
    if mgr.live_versions() != [mgr.current.vid]:
        fail(f"{what}: versions {mgr.live_versions()} live after drain")
    stages = {k: pcts([a["stages"][k] * 1e3 for a in applied])
              for k in ("cow_apply", "device_update", "publish")}
    stages["retire"] = pcts([x * 1e3 for x in retire_s])
    # the route's layout of each new version, inside device_update
    stages["layout"] = pcts([x * 1e3 for x in layout_s])
    touched = [a["touched"] for a in applied]
    snap = srv.metrics.snapshot()
    launches = {}
    for tab in meter.launches.values():
        for k, v in tab.items():
            launches[k] = launches.get(k, 0) + v
    return {
        "graph": spec, "n_base": n_base, "spares": VERSION_SPARES,
        "route": fam.relax_mode, "codec": fam.codec, "d_dtype": fam.d_dtype,
        "k": idx.k, "n_core": len(idx.core_ids), "m_core":
            len(idx.core_src) // 2, "core_cap": fam.core_cap,
        "edge_cap": fam.edge_cap, "ell_width": fam.ell_width, "vp": fam.vp,
        "gen_s": gen_s, "build_s": build_s, "server_s": server_s,
        "warmup_seconds": srv.warmup_seconds,
        "warmup_builds": warm.snapshot(), "requests": n_req,
        "write_ratio": write_ratio,
        "write_ratio_cut": (None if write_ratio == LAUNCHER_WRITE_RATIO
                            else f"{write_ratio} instead of the launcher's "
                                 f"{LAUNCHER_WRITE_RATIO}, to keep the "
                                 f"rebuild audits short"),
        "trace": trace.meta,
        "reads": len(reads), "versions": writes + 1,
        "replay_wall_s": replay_s,
        "swap_ms": pcts([a["swap_s"] * 1e3 for a in applied]),
        "stage_ms": stages,
        "touched_rows": {"mean": float(np.mean(touched)) if touched else 0.0,
                         "max": max(touched, default=0)},
        "qps_compute": snap["qps_compute"], "qps_offered": snap["qps_offered"],
        "latency_ms": snap["latency_ms"], "cache_hit_rate":
            snap["cache_hit_rate"], "served": snap["served"],
        "batches": len(batches), "by_lane_bucket": lane_batches(batches),
        "full_exec_ms_mean": float(np.mean(
            [b.exec_s for b in batches if b.lane == "full"] or [0.0])) * 1e3,
        "mu_exec_ms_mean": float(np.mean(
            [b.exec_s for b in batches if b.lane == "mu"] or [0.0])) * 1e3,
        "syncs": {"replay": span.count, "serving_layer": layer,
                  "entry_points": inner,
                  "per_read_batch": layer / max(1, len(batches))},
        "compiled_shapes": srv.compile_cache_sizes(),
        "builds_during_replay": builds,
        "audited_reads": len(reads),
        "rebuilt_versions": rebuilt, "dijkstra_checked": oracle_checked,
        "audit_s": audit_s,
        "state_bytes": gauges["state_bytes"], "live_before_drain":
            gauges["live"], "peak_device_bytes": peak,
        "launches": launches}


def phase_directed(device="cuda") -> dict:
    """Directed IS-LABEL (§8.2) on a random digraph made as
    ``tests/test_directed.py``'s ``_digraph``: build (doubling ``l_cap``
    from ``DIRECTED["l_cap"]`` while the labels overflow), then 1,024
    seeded pairs in calls of 256 (two passes, then 5 timed calls of
    the first 256): the first 16 sources bitwise against Dijkstra on the
    directed edges, ``reachable`` equal to ``isfinite`` of the answers,
    and ``shortest_path`` on 8 pairs (every hop a directed edge, the
    weight sum the distance). No kernel runs on this path (as in
    ``repro``): the launch counters must stay 0."""
    import numpy as np
    import torch
    from repro_torch.core import IndexConfig, ref, sync
    from repro_torch.core.directed import DiISLabelIndex
    from repro_torch.paths import check_vertex_path, edge_weight_map

    d = DIRECTED
    rng = np.random.default_rng(d["seed"])
    src = rng.integers(0, d["n"], d["e"]).astype(np.int32)
    dst = rng.integers(0, d["n"], d["e"]).astype(np.int32)
    keep = src != dst
    w = rng.integers(1, d["maxw"], keep.sum()).astype(np.float32)
    src, dst, n = src[keep], dst[keep], d["n"]
    torch.cuda.reset_peak_memory_stats()
    l_cap, overflows = d["l_cap"], []
    while True:
        try:
            t0 = time.perf_counter()
            idx = DiISLabelIndex.build(
                n, src, dst, w, IndexConfig(l_cap=l_cap,
                                            label_chunk=d["label_chunk"]),
                device=device)
            build_s = time.perf_counter() - t0
            break
        except RuntimeError as err:
            if "label capacity overflow" not in str(err) or l_cap >= 4096:
                raise
            overflows.append(l_cap)
            l_cap *= 2
    build_peak = torch.cuda.max_memory_allocated()
    qr = np.random.default_rng(1)
    s = qr.integers(0, n, DIRECTED_QUERIES).astype(np.int32)
    t = qr.integers(0, n, DIRECTED_QUERIES).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    calls, rounds = [], []
    for _ in range(2):
        got, ms = [], []
        for i in range(0, DIRECTED_QUERIES, DIRECTED_CALL):
            t1 = time.perf_counter()
            got.append(idx.query_host(s[i:i + DIRECTED_CALL],
                                      t[i:i + DIRECTED_CALL]))
            ms.append((time.perf_counter() - t1) * 1e3)
            rounds.append([int(x) for x in sync.host_read(
                torch.stack(idx._last_rounds))])
        calls.append(ms)
    ans = np.concatenate(got)
    repeats = []
    for _ in range(5):
        t1 = time.perf_counter()
        idx.query_host(s[:DIRECTED_CALL], t[:DIRECTED_CALL])
        repeats.append((time.perf_counter() - t1) * 1e3)
    query_peak = torch.cuda.max_memory_allocated()
    k = DIRECTED_DIJKSTRA
    want = ref.dijkstra_oracle(n, src, dst, w, s[:k])[np.arange(k), t[:k]]
    if not np.array_equal(ans[:k], want.astype(np.float32)):
        fail("directed: answers differ from Dijkstra on the first "
             f"{k} sources")
    if np.isnan(ans).any() or ans.shape != (DIRECTED_QUERIES,):
        fail("directed: NaN answers or a wrong shape")
    if not np.array_equal(idx.reachable(s, t), np.isfinite(ans)):
        fail("directed: reachable differs from isfinite of the answers")
    edges = edge_weight_map(src, dst, w)
    t1 = time.perf_counter()
    path_lens = []
    for i in range(DIRECTED_PATHS):
        dist, p = idx.shortest_path(int(s[i]), int(t[i]))
        bad = check_vertex_path(edges, int(s[i]), int(t[i]), dist, p)
        if np.float32(dist) != ans[i] or bad:
            fail(f"directed: shortest_path({s[i]}, {t[i]}) gave {dist} "
                 f"(query {ans[i]}) {bad[:2]}")
        path_lens.append(len(p))
    paths_s = time.perf_counter() - t1
    flat = [r for pair in rounds for r in pair]
    return {"n": n, "m": len(src), "maxw": d["maxw"], "l_cap": l_cap,
            "l_cap_overflowed": overflows, "label_chunk": d["label_chunk"],
            "k": idx.k, "n_core": idx.n_core,
            "m_core": len(idx.core_host[0]), "build_s": build_s,
            "queries": DIRECTED_QUERIES, "call": DIRECTED_CALL,
            "query_ms_first_pass": calls[0], "query_ms_second_pass": calls[1],
            "query_ms": calls[1][0],
            "query_ms_median": statistics.median(repeats),
            "query_ms_repeats": repeats,
            "rounds_fwd_bwd": rounds[len(rounds) // 2:],
            "rounds_max": max(flat), "reachable_share":
                float(np.isfinite(ans).mean()),
            "dijkstra_checked": k, "paths_checked": DIRECTED_PATHS,
            "path_vertices": path_lens, "paths_s": paths_s,
            "peak_device_bytes_build": build_peak,
            "peak_device_bytes_query": query_peak}


def block_bytes(rows) -> int:
    """Bytes of the label planes in ``rows`` (a ``LabelRows``)."""
    return sum(x.numel() * x.element_size() for x in rows if x is not None)


def timed_calls(fn, repeats: int) -> dict:
    """Host ms of ``fn()`` (which ends on a blocking read): the first
    and second calls, then the median of ``repeats`` more."""
    times = []
    for _ in range(2 + repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"ms_first": times[0], "ms": times[1],
            "ms_median": statistics.median(times[2:])}


def phase_sharded(path, route, idx, s, t, graph, tables, kernels) -> dict:
    """``ShardedIndex.from_index(idx, SHARDS, strategy="level")`` on one
    main path's index, all shards on this card: partition seconds,
    entries and block bytes per shard beside the unsharded planes'.
    Then, under sync debug mode "error", ``SHARD_QUERIES`` of the path's
    pairs: answers, rounds (every shard's) and the μ-only lane bitwise
    equal to the unsharded index; exactly ``SHARDS`` times the unsharded
    query's launches of each kernel and one cross-shard reduction a
    call; query ms (second call, median of ``SHARD_REPEATS``) beside the
    unsharded query's. A ``hotspot`` replay through ``DistanceServer``
    over the sharded index at the serving phase's settings: answers
    equal to ``idx.query``, no first-use build after warmup, and its
    ``qps_compute`` and latency. On ``fused``, a path-lane replay whose
    paths pass the launcher's audit and ``check_path_batch``, and
    ``apply_mutations`` inserting the mutation phase's hold-out vertex
    into a sharded hold-out index, answering as the unsharded hold-out
    index after ``insert_vertex``."""
    import numpy as np
    import torch
    from repro_torch.core import sync
    from repro_torch.launch.serve import _audit_paths
    from repro_torch.obs import BuildWatcher
    from repro_torch.serve import DistanceServer, make_trace
    from repro_torch.shard import ShardedIndex

    n, src, dst, w = graph
    q = SHARD_QUERIES.get(path, MAIN_QUERIES)
    sq, tq = s[:q], t[:q]
    ue = idx.engine
    t0 = time.perf_counter()
    sidx = ShardedIndex.from_index(idx, SHARDS, strategy=SHARD_STRATEGY)
    from_index_s = time.perf_counter() - t0
    eng = sidx.engine
    if eng.codec != ue.codec or eng.relaxer.mode != route:
        fail(f"sharded {path}: codec {eng.codec}, route {eng.relaxer.mode}")
    if len(eng.relaxers) != 1:
        fail(f"sharded {path}: {len(eng.relaxers)} relaxers on one card")
    rec = {"shards": SHARDS, "strategy": SHARD_STRATEGY, "route": route,
           "codec": eng.codec, "queries": q, "from_index_s": from_index_s,
           "partition_s": sidx.partition_seconds, "cap": eng.cap,
           "l_cap": idx.cfg.l_cap,
           "entries_per_shard": sidx.entries_per_shard.tolist(),
           "entries_unsharded": int(idx.stats.label_entries),
           "block_bytes_per_shard": [block_bytes(b) for b in eng.blocks],
           "plane_bytes_unsharded": block_bytes((ue.enc_ids, ue.enc_base,
                                                 ue.enc_d))}

    zero(tables)
    want = sync.host_read(idx.query(sq, tq))
    one = launches_of(tables)
    want_rounds = ue._last_rounds
    want_mu = sync.host_read(ue.query_mu_only(sq, tq))
    zero(tables)
    torch.cuda.set_sync_debug_mode("error")
    try:
        red0 = eng.reductions
        with sync.sync_span() as span:
            got = sync.host_read(sidx.query(sq, tq))
        syncs = span.count
        shard_rounds = sync.host_read(torch.stack(eng.last_shard_rounds))
        calls = 1 + 2 + SHARD_REPEATS
        rec["query"] = timed_calls(lambda: sidx.query(sq, tq), SHARD_REPEATS)
        reductions = eng.reductions - red0
        launches = launches_of(tables)
        zero(tables)
        mu = sync.host_read(eng.query_mu_only(sq, tq))
        mu_launches = launches_of(tables)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rec["query_unsharded"] = timed_calls(lambda: idx.query(sq, tq),
                                         SHARD_REPEATS)
    if not np.array_equal(got, want) or not np.array_equal(mu, want_mu):
        fail(f"sharded {path}: answers or μ differ from the unsharded index")
    if eng._last_rounds != want_rounds or set(shard_rounds) != {want_rounds}:
        fail(f"sharded {path}: rounds {shard_rounds.tolist()}, unsharded "
             f"{want_rounds}")
    expect = {k: calls * SHARDS * v for k, v in one.items()}
    if launches != expect or reductions != calls:
        fail(f"sharded {path}: launches {launches} (expected {expect}), "
             f"{reductions} reductions for {calls} calls")
    label = {k for k in kernels if k.startswith("label_")}
    check_launches(f"sharded {path} μ lane", mu_launches, label)
    rec.update(rounds=want_rounds, query_syncs=syncs, reductions=reductions,
               launches_per_call={k: v // calls for k, v in launches.items()},
               speed_vs_unsharded=rec["query_unsharded"]["ms_median"]
               / rec["query"]["ms_median"])

    # serving over the shards
    n_req = SHARD_SERVE_REQUESTS.get(path, 1024)
    kw = dict(buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
              cache_size=SERVE_CACHE)
    with BuildWatcher() as warm:
        srv = DistanceServer(sidx, name=f"sharded_{path}", **kw)
    trace = make_trace("hotspot", n=n, num_requests=n_req,
                       rate_qps=SERVE_RATE, seed=0)
    shapes = srv.compile_cache_sizes()
    zero(tables)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with BuildWatcher() as watch, sync.sync_span() as span:
            t0 = time.perf_counter()
            served = srv.serve_trace(trace)
            wall_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    serve_launches = launches_of(tables)
    if watch.count() or srv.compile_cache_sizes() != shapes:
        fail(f"sharded {path} serving: builds {watch.snapshot()}, shapes "
             f"{shapes} -> {srv.compile_cache_sizes()}")
    if not np.array_equal(served, sync.host_read(idx.query(trace.s,
                                                           trace.t))):
        fail(f"sharded {path} serving: answers differ from idx.query")
    check_launches(f"sharded {path} serving", serve_launches, kernels)
    snap = srv.metrics.snapshot()
    rec["serving"] = {
        "requests": n_req, "scenario": "hotspot", "replay_wall_s": wall_s,
        "warmup_seconds": srv.warmup_seconds,
        "warmup_builds": warm.snapshot(), "syncs": span.count,
        "batches": len(srv.metrics.batches), "launches": serve_launches,
        **{k: snap[k] for k in ("served", "qps_compute", "latency_ms",
                                "cache_hit_rate", "batch_fill_ratio")}}
    total = {k: launches[k] + mu_launches[k] + serve_launches[k]
             for k in launches}
    if path != "fused":
        rec["launches"] = total
        return rec

    # the path lane over the shards, then §8.3 on a sharded hold-out
    from repro_torch.core import ISLabelIndex, IndexConfig
    from repro_torch.paths import check_path_batch, edge_weight_map
    from repro_torch.serve import MutationOp
    zero(tables)
    with BuildWatcher() as warm:
        psrv = DistanceServer(sidx, name="sharded_fused-paths",
                              path_hop_caps=SERVE_HOP_CAPS, **kw)
    trace = make_trace("hotspot", n=n, num_requests=SHARD_PATH_REQUESTS,
                       rate_qps=SERVE_RATE, seed=0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with BuildWatcher() as watch:
            t0 = time.perf_counter()
            dist, paths, valid = psrv.serve_path_trace(trace)
            wall_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if watch.count():
        fail(f"sharded path lane: first-use builds {watch.snapshot()}")
    if _audit_paths(src, dst, w, trace, dist, paths, valid):
        fail("sharded path lane: a served path failed the audit")
    if not np.array_equal(dist, sync.host_read(idx.query(trace.s,
                                                         trace.t))):
        fail("sharded path lane: distances differ from idx.query")
    batch = host_batch(sidx.path_engine().path_batch_fn(PATH_HOP_CAP)(
        sq[:SHARD_PATH_REQUESTS], tq[:SHARD_PATH_REQUESTS]))
    rep = check_path_batch(edge_weight_map(src, dst, w),
                           sq[:SHARD_PATH_REQUESTS],
                           tq[:SHARD_PATH_REQUESTS], batch)
    if rep["violations"]:
        fail(f"sharded path batch: {rep['violations'][:3]}")
    path_launches = launches_of(tables)
    psnap = psrv.metrics.snapshot()
    rec["path_lane"] = {"requests": SHARD_PATH_REQUESTS,
                        "hop_caps": list(SERVE_HOP_CAPS),
                        "replay_wall_s": wall_s,
                        "warmup_builds": warm.snapshot(),
                        "qps_compute": psnap["qps_compute"],
                        "latency_ms": psnap["latency_ms"],
                        "checked": rep["checked"],
                        "not_ok": rep["overflowed"],
                        "launches": path_launches}

    n, src, dst, w, u, keep, nbrs, ws = holdout()
    _, _, overrides = MUTATION_GRAPH
    zero(tables)
    held = ISLabelIndex.build(n, src[keep], dst[keep], w[keep],
                              IndexConfig(**overrides), device=idx.device)
    sheld = ShardedIndex.from_index(held, SHARDS, strategy=SHARD_STRATEGY)
    with BuildWatcher() as watch:
        t0 = time.perf_counter()
        new, info = sheld.apply_mutations([MutationOp("insert", u,
                                                      tuple(nbrs),
                                                      tuple(ws))])
        apply_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    held.insert_vertex(u, nbrs, ws)
    insert_ms = (time.perf_counter() - t0) * 1e3
    ends = np.concatenate([tq, np.arange(n, dtype=np.int32)])
    starts = np.concatenate([sq, np.full(n, u, np.int32)])
    if not np.array_equal(sync.host_read(new.query(starts, ends)),
                          sync.host_read(held.query(starts, ends))):
        fail(f"sharded apply_mutations: answers after inserting {u} differ "
             f"from the unsharded index after insert_vertex")
    if watch.count("serve_read") or not watch.count("mutation"):
        fail(f"sharded apply_mutations: builds {watch.snapshot()}")
    mut_launches = launches_of(tables)
    rec["mutation"] = {"u": u, "apply_ms": apply_ms,
                       "insert_vertex_ms": insert_ms,
                       "touched_rows": len(info["touched_rows"]),
                       "touched_shards": info["touched_shards"],
                       "builds": watch.snapshot(),
                       "pairs_checked": len(ends)}
    for tab in (path_launches, mut_launches):
        for k, v in tab.items():
            total[k] += v
    rec["launches"] = total
    return rec


def prom_samples(text: str) -> int:
    """Samples in a Prometheus text exposition (0.0.4); fails on a line
    that is neither a comment, blank, nor ``name{labels} value``."""
    import re
    line_re = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (\S+)$')
    count = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if not m:
            fail(f"/metrics: malformed line {line!r}")
        float(m.group(2))
        count += 1
    return count


def http_run(idx, name, scenario, n_req, tables, **trace_kw) -> dict:
    """One replay over HTTP: a ``ReplicaSet`` of ``HTTP_REPLICAS`` on
    ``idx`` (warmed up here, on this thread) behind a
    ``ServiceFrontend`` on localhost with the launcher's SLOs, the trace
    sent through ``replay_http`` in ``HTTP_BATCH``-pair requests under
    sync debug mode "error" (the loop thread serves every batch). Each
    request's wall time over the wire is kept."""
    import numpy as np
    import torch
    from repro_torch.core import sync
    from repro_torch.obs import (BuildWatcher, EventLog, SLOEngine,
                                 compiles_source, default_serving_slos,
                                 latency_source)
    from repro_torch.serve import (HttpClient, IndexRegistry, ReplicaSet,
                                   ServiceFrontend, make_trace, replay_http)
    kw = dict(buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
              cache_size=SERVE_CACHE)
    with BuildWatcher() as warm:
        group = ReplicaSet(idx, HTTP_REPLICAS, name=name, **kw)
    registry = IndexRegistry()
    registry.install(name, group)
    trace = make_trace(scenario, n=idx.n, num_requests=n_req,
                       rate_qps=SERVE_RATE, seed=0, **trace_kw)
    group.apply_injection(trace.meta)
    watcher = BuildWatcher().start()
    log = EventLog()
    slo = SLOEngine(default_serving_slos(latency_threshold_s=HTTP_SLO_S),
                    log=log)
    slo.attach("latency", latency_source(HTTP_SLO_S,
                                         servers=group.server_names))
    slo.attach("read_compiles", compiles_source(watcher))
    fe = ServiceFrontend(registry, slo=slo, log=log)
    host, port = fe.start_background()
    client = HttpClient(host, port, graph=name)
    wire_ms = []
    batch_call = client.query_batch

    def timed_batch(pairs):
        t0 = time.perf_counter()
        out = batch_call(pairs)
        wire_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    client.query_batch = timed_batch
    zero(tables)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        served = replay_http(client, trace, batch=HTTP_BATCH)
        wall_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = launches_of(tables)
    samples = prom_samples(client.metrics_text())
    time.sleep(4 * fe.slo_interval_s)      # the pump task steps the SLO
    stats = client.stats()["graphs"][name]
    client.close()
    fe.stop()
    watcher.stop()
    if watcher.count("serve_read"):
        fail(f"http {scenario}: first-use builds {watcher.snapshot()}")
    if not np.array_equal(served, sync.host_read(idx.query(trace.s,
                                                           trace.t))):
        fail(f"http {scenario}: answers over the wire differ from "
             f"idx.query")
    return {"scenario": scenario, "requests": n_req, "batch": HTTP_BATCH,
            "replicas": HTTP_REPLICAS, "wall_s": wall_s,
            "req_per_s": n_req / wall_s,
            "wire_ms": pcts(wire_ms), "http_requests": len(wire_ms),
            "server_latency_ms": stats["latency_ms"],
            "qps_compute": stats["qps_compute"], "served": stats["served"],
            "healthy": list(group.healthy),
            "evictions": group._evictions.total(),
            "fired": slo.breach_summary()["fired"],
            "prometheus_samples": samples, "warmup_builds": warm.snapshot(),
            "launches": launches}


def phase_http(idx, tables, kernels) -> dict:
    """The HTTP service on the ``fused`` index: a clean ``uniform`` replay
    of ``HTTP_REQUESTS`` (no alert may fire) and a ``straggler`` replay
    whose stalled replica must be evicted and fire the latency SLO,
    every answer over the wire equal to ``idx.query``. Then
    ``launch/serve.py --mode http`` on the card as a subprocess
    (``HTTP_LAUNCHER``), which must exit 0."""
    import os
    clean = http_run(idx, "http", "uniform", HTTP_REQUESTS, tables)
    check_launches("http uniform", clean["launches"], kernels)
    if clean["fired"]:
        fail(f"http uniform: alerts fired on a clean run {clean['fired']}")
    strag = http_run(idx, "http_straggler", "straggler",
                     HTTP_STRAGGLER_REQUESTS, tables, stall_replica=0,
                     stall_s=HTTP_STALL_S)
    if "latency" not in strag["fired"] or strag["healthy"] != [False, True]:
        fail(f"http straggler: fired {strag['fired']}, healthy "
             f"{strag['healthy']}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *HTTP_LAUNCHER], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    launcher_s = time.perf_counter() - t0
    if run.returncode:
        fail(f"launch/serve.py {' '.join(HTTP_LAUNCHER)} exited "
             f"{run.returncode}:\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    keep = [ln.strip() for ln in run.stdout.splitlines()
            if "req/s on the wire" in ln or "audit[" in ln
            or "p99=" in ln]
    launches = {k: clean["launches"][k] + strag["launches"][k]
                for k in clean["launches"]}
    return {"uniform": clean, "straggler": strag,
            "launcher": {"args": HTTP_LAUNCHER, "seconds": launcher_s,
                         "lines": keep},
            "launches": launches}


def tree_close(what, a, b, rtol, atol) -> float:
    """Max abs difference between two state trees (any devices), after
    checking that they hold the same arrays and agree within
    ``rtol``/``atol``; 0 for bitwise-equal trees at ``rtol = atol = 0``."""
    import torch
    from repro_torch.tree import flatten_with_paths
    fa, fb = dict(flatten_with_paths(a)), dict(flatten_with_paths(b))
    if fa.keys() != fb.keys():
        fail(f"{what}: arrays {sorted(fa.keys() ^ fb.keys())} differ")
    err = 0.0
    for k in fa:
        x, y = fa[k].cpu(), fb[k].cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            fail(f"{what}: {k} is {x.dtype}{list(x.shape)} against "
                 f"{y.dtype}{list(y.shape)}")
        same = torch.allclose(x, y, rtol=rtol, atol=atol) if rtol or atol \
            else torch.equal(x, y)
        if not same:
            fail(f"{what}: {k} differs by {max_abs_err(x, y)} (rtol {rtol}, "
                 f"atol {atol})")
        err = max(err, max_abs_err(x, y))
    return err


def need_rtol(a, b, atol) -> float:
    """The least rtol at which every array of tree ``a`` but ``step`` is
    within (rtol, ``atol``) of ``b``'s, elementwise (inf where ``b`` is 0
    and the difference exceeds ``atol``)."""
    import torch
    from repro_torch.tree import flatten_with_paths
    fb, need = dict(flatten_with_paths(b)), 0.0
    for k, x in flatten_with_paths(a):
        if k == "step":
            continue
        x, y = x.cpu().double(), fb[k].cpu().double()
        over = (x - y).abs() - atol
        hit = over > 0
        if bool(hit.any()):
            need = max(need, float(torch.where(
                hit, over / y.abs(), torch.zeros_like(over)).max()))
    return need


def phase_train(arch, shape, tables, device="cuda", smoke=False,
                spec=None, tol=(TRAIN_RTOL, TRAIN_ATOL), rerun_tol=None,
                runs=(TRAIN_STEPS, TRAIN_RESUME, TRAIN_FAIL_AT,
                      TRAIN_PROFILE_STEPS)) -> dict:
    """Training on the card through ``launch/train.py``'s functions
    (its smoke spec with ``smoke``; ``spec`` in place of the registry's)
    and ``FaultTolerantRunner``, the card against the CPU within ``tol``
    (rtol, atol), the resume and the rollback against a straight run
    within ``rerun_tol`` (``tol`` if None), and the runs' lengths
    ``runs`` (the main run's steps, the resume's two legs, the step that
    fails, the profiled steps),
    checkpoints every ``TRAIN_CKPT_EVERY``
    steps into a temporary directory: ``n_steps`` timed steps under
    sync debug mode "error" with the launch counters zeroed around them
    (no kernel of ``kernels/`` may launch), then the card against the
    CPU from one state and batch (its control, the card against the CPU
    one step short, must fall outside ``tol``), a restore of the last
    checkpoint, a resume, one injected failure after the optimizer, and
    a profiled window of the profiled steps (device idle share)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import snapshot, state_from_tree
    from repro_torch.configs import registry
    from repro_torch.core.sync import host_read, sync_count
    from repro_torch.fault import FaultTolerantRunner, RunnerConfig
    from repro_torch.fault import runner as runner_mod
    from repro_torch.launch.train import init_state, make_batch_fn, smoke_spec
    from repro_torch.train.steps import build_bundle
    from repro_torch.tree import leaves
    what = f"train_{arch}"
    rtol, atol = tol
    rerun_tol = tol if rerun_tol is None else rerun_tol
    n_steps, (first, then), fail_at, n_profile = runs
    if spec is None:
        spec = registry.get_spec(arch)
        if smoke:
            spec = smoke_spec(spec)
    base = torch.cuda.memory_allocated()     # held by earlier phases
    t0 = time.perf_counter()
    bundle = build_bundle(spec, shape, device)
    state0 = init_state(spec, bundle)
    make_batch = make_batch_fn(spec, shape, device=device)
    batch = make_batch(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rec = {"arch": arch, "shape": shape, "cfg": str(
        bundle.static_meta["cfg"]),
        "params": sum(int(v.numel()) for v in leaves(state0["params"])),
        "batch_bytes": sum(int(v.numel() * v.element_size())
                           for v in batch.values()),
        "setup_s": setup_s}

    with tempfile.TemporaryDirectory() as tmp:
        def runner(sub, step_fn=bundle.fn, state=state0):
            return FaultTolerantRunner(
                step_fn, state, make_batch,
                RunnerConfig(f"{tmp}/{sub}", ckpt_every=TRAIN_CKPT_EVERY,
                             handle_sigterm=False))

        # the main run: timed, its loss reads and checkpoint saves timed
        main = runner("main")
        reads, saves = [], []
        plain_read, plain_save = runner_mod.host_read, main.ckpt.maybe_save

        def timed_read(x):
            t = time.perf_counter()
            out = plain_read(x)
            reads.append(time.perf_counter() - t)
            return out

        def timed_save(step, state, force=False):
            t = time.perf_counter()
            saved = plain_save(step, state, force)
            if saved:
                saves.append(time.perf_counter() - t)
            return saved

        losses = []
        runner_mod.host_read, main.ckpt.maybe_save = timed_read, timed_save
        zero(tables)
        torch.cuda.reset_peak_memory_stats()
        s0 = sync_count()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            main.run(n_steps, on_metrics=lambda s, m: losses.append(
                m["loss"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
            runner_mod.host_read = plain_read
        syncs = sync_count() - s0
        launches = launches_of(tables)
        check_launches(what, launches, set())
        peak = torch.cuda.max_memory_allocated() - base
        losses = [float(x) for x in host_read(tuple(losses))]
        if len(losses) != n_steps or not all(np.isfinite(losses)):
            fail(f"{what}: losses {losses}")
        if not losses[-1] < losses[0] * 1.5:
            fail(f"{what}: loss diverged {losses[0]} -> {losses[-1]}")
        if main.events:
            fail(f"{what}: fault events on a clean run {main.events}")
        step_ms = [h[0] * 1e3 for h in main.monitor.history]
        med = statistics.median(step_ms[1:])
        rec.update({
            "first_step_ms": step_ms[0], "step_ms_median": med,
            "step_ms_min": min(step_ms[1:]), "steps_per_s": n_steps / wall,
            "steps_per_s_after_first":
                (n_steps - 1) / (wall - step_ms[0] / 1e3),
            "wall_s": wall, "syncs": syncs,
            "syncs_per_step": syncs / n_steps,
            "loss_read_ms_median": statistics.median(reads) * 1e3,
            "loss_read_share": statistics.median(reads) * 1e3 / med,
            "ckpt_saves": len(saves),
            "ckpt_save_ms_mean": statistics.fmean(saves) * 1e3,
            "ckpt_save_share": sum(saves) / wall,
            "peak_device_bytes": peak, "loss_step1": losses[0],
            f"loss_step{n_steps}": losses[-1], "launches": launches})

        # card against CPU: TRAIN_CPU_STEPS steps from state0 and the batch
        t_cpu = time.perf_counter()
        cpu_bundle = build_bundle(spec, shape, "cpu")
        cpu_batch = make_batch_fn(spec, shape, device="cpu")(0)
        cs = state_from_tree(snapshot(state0), "cpu")
        gs, rel = state0, 0.0
        for i in range(TRAIN_CPU_STEPS):
            short = cs                  # the control: one step short
            cs, cm = cpu_bundle.fn(cs, cpu_batch)
            gs, gm = bundle.fn(gs, batch)
            for k in ("loss", "gnorm"):
                a, b = float(cm[k]), float(host_read(gm[k]))
                if not abs(a - b) <= atol + rtol * abs(a):
                    fail(f"{what}: step {i + 1} {k} {b} on the card, {a} on "
                         "the CPU")
                rel = max(rel, abs(a - b) / max(abs(a), 1e-30))
            if i == 0:
                # the warm-up multiplier is 0 at step 0: params unchanged
                tree_close(f"{what} step 1 params", gs["params"],
                           state0["params"], 0, 0)
            if i == 1 and tree_close(f"{what} step 2 params", gs["params"],
                                     state0["params"], 1.0, 1.0) == 0:
                fail(f"{what}: parameters unchanged after step 2")
        need = (need_rtol(gs, cs, atol), need_rtol(gs, short, atol))
        if not need[1] > rtol:
            fail(f"{what}: a CPU state one step short is within rtol {rtol} "
                 f"of the card's (it needs {need[1]})")
        rec["card_vs_cpu"] = {
            "steps": TRAIN_CPU_STEPS, "rtol": rtol, "atol": atol,
            "max_abs_err": tree_close(f"{what} card vs CPU", gs, cs,
                                      rtol, atol),
            "need_rtol": need[0], "control_need_rtol": need[1],
            "metric_max_rel_err": rel,
            "seconds": time.perf_counter() - t_cpu}

        # a fresh runner restores the step-50 checkpoint onto the card
        fresh = runner("main")
        t0 = time.perf_counter()
        got = fresh.restore()
        restore_s = time.perf_counter() - t0
        if got != n_steps or not all(v.device.type == bundle.device.type
                                         for v in leaves(fresh.state)):
            fail(f"{what}: restored step {got}")
        tree_close(f"{what} restore", fresh.state, main.state, 0, 0)

        # resume: 20 steps, then a new runner from 20 to 30, against an
        # uninterrupted 30; and one injected failure after the optimizer
        runner("resume").run(first)
        resumed = runner("resume")
        if resumed.restore() != first:
            fail(f"{what}: resume did not restore step {first}")
        resumed.run(then)
        straight = runner("straight")
        straight.run(then)
        fired = []

        def failing(state, b):
            new_state, metrics = bundle.fn(state, b)
            if flaky.step == fail_at and not fired:
                fired.append(flaky.step)
                raise RuntimeError(f"injected fault at step {flaky.step}")
            return new_state, metrics

        flaky = runner("flaky", step_fn=failing)
        flaky.run(then)
        kinds = [(s, k) for s, k, _ in flaky.events]
        want = [(fail_at, "step_failure"),
                (fail_at // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY,
                 "rollback")]
        if kinds != want or not all(v.device.type == bundle.device.type
                                    for v in leaves(flaky.state)):
            fail(f"{what}: injected failure gave events {kinds}")
        rec["resume"] = {
            "rtol": rerun_tol[0], "atol": rerun_tol[1],
            "max_abs_err": tree_close(f"{what} resume", resumed.state,
                                      straight.state, *rerun_tol),
            "restore_s": restore_s}
        rec["injected_failure"] = {
            "events": kinds,
            "max_abs_err": tree_close(f"{what} rollback", flaky.state,
                                      straight.state, *rerun_tol)}

    def window():
        st = main.state
        for _ in range(n_profile):
            st, m = bundle.fn(st, batch)
            host_read(m["loss"])

    rec["profile"] = profile_idle(window)
    check_launches(f"{what} (all runs)", launches_of(tables), set())
    return rec


def phase_vc(tables, device="cuda") -> dict:
    """Table 8: on each of ``VC_GRAPHS``, IS-LABEL (``ISLabelIndex.build``)
    and the one-level VC index (``build_vc_index``) built on the card at
    ``VC_CONFIG`` and queried on the same ``MAIN_QUERIES`` seeded pairs
    (two calls, then ``QUERY_REPEATS`` timed ones) under sync debug mode
    "error", launch counters zeroed before each build and read after
    its queries: each index must launch exactly the label kernel and its
    route's stage-2 kernel. Both answers must be bitwise equal, and the
    first 16 sources equal to Dijkstra. Returns the per-graph records
    and the launches summed over both indexes of every graph."""
    import numpy as np
    import torch
    from repro_torch.core import ISLabelIndex, IndexConfig, ref
    from repro_torch.core.vc_baseline import build_vc_index
    from repro_torch.graphs import generators as gen
    out, total = {}, {}
    for spec, (fn, args, seed) in VC_GRAPHS:
        n, src, dst, w = getattr(gen, fn)(*args, seed=seed)
        rng = np.random.default_rng(0)
        s = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
        t = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
        rec, answers = {"n": n, "m": len(src) // 2}, {}
        for name, build in (("islabel", ISLabelIndex.build),
                            ("vc", build_vc_index)):
            zero(tables)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.set_sync_debug_mode("error")
            try:
                idx = build(n, src, dst, w, IndexConfig(**VC_CONFIG),
                            device=device)
                times = []
                for _ in range(2 + QUERY_REPEATS):
                    t1 = time.perf_counter()
                    ans = idx.query(s, t)    # ends on a blocking read
                    times.append((time.perf_counter() - t1) * 1e3)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            mode = idx.engine.relaxer.mode if idx.engine.relaxer else "none"
            launches = launches_of(tables)
            check_launches(f"vc_baseline {spec} {name}", launches,
                           {"label_intersect_kernel", STAGE2_KERNEL[mode]})
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            answers[name] = ans.cpu().numpy()
            st = idx.stats
            rec[name] = {
                "k": st.k, "n_core": st.n_core, "m_core": st.m_core // 2,
                "route": mode, "rounds": idx.engine._last_rounds,
                "build_s": st.build_seconds, "peel_s": st.peel_seconds,
                "label_s": st.label_seconds,
                "label_entries": st.label_entries,
                "query_ms_first": times[0], "query_ms": times[1],
                "query_ms_median": statistics.median(times[2:]),
                "peak_device_bytes": torch.cuda.max_memory_allocated(),
                "launches": launches}
            del idx
        if not np.array_equal(answers["islabel"], answers["vc"]):
            fail(f"vc_baseline {spec}: VC and IS-LABEL answers differ")
        n_check = 16
        oracle = ref.dijkstra_oracle(n, src, dst, w, s[:n_check])
        want = oracle[np.arange(n_check), t[:n_check]].astype(np.float32)
        if not np.array_equal(answers["vc"][:n_check], want):
            fail(f"vc_baseline {spec}: answers differ from Dijkstra")
        if np.isnan(answers["vc"]).any():
            fail(f"vc_baseline {spec}: NaN answers")
        rec["dijkstra_checked"] = n_check
        rec["vc_over_islabel_query"] = (rec["vc"]["query_ms_median"]
                                        / rec["islabel"]["query_ms_median"])
        out[spec] = rec
        torch.cuda.empty_cache()
    return {"graphs": out, "config": VC_CONFIG, "queries": MAIN_QUERIES,
            "launches": total}


def phase_examples(tables, device="cuda") -> list:
    """The twins of ``examples/`` and ``scripts/``: ``smoke_core`` a graph
    at a time, ``quickstart``, ``distance_serving`` at
    ``EXAMPLES_SERVING``, ``gnn_molecules`` and ``train_lm`` at
    ``EXAMPLES_LM`` (checkpoints in a temporary directory), each ``main``
    called in-process with the launch counters zeroed and the peak
    memory reset before it and read after it: an index twin must launch
    exactly the label kernel and its route's stage-2 kernel, the
    training twins none. Beside ``train_lm`` (host-bound on one core)
    runs ``python -m repro_torch.examples.quickstart`` as a user types
    it, which must exit 0. A twin's stdout is kept (its last lines in
    the record); an exception in a twin fails the run. Returns one
    record a twin."""
    import contextlib
    import io
    import os
    import tempfile
    import torch
    from repro_torch.examples import (distance_serving, gnn_molecules,
                                      quickstart, train_lm)
    from repro_torch.scripts import smoke_core
    out = []

    def run(name, main, argv, keep, route_of=None):
        zero(tables)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = main(argv + ["--device", device])
        except BaseException:
            sys.stderr.write(buf.getvalue())
            raise
        seconds = time.perf_counter() - t0
        launches = launches_of(tables)
        route = route_of(res) if route_of else None
        kernels = set() if route is None else {"label_intersect_kernel"} | (
            {STAGE2_KERNEL[route]} if route in STAGE2_KERNEL else set())
        check_launches(f"examples {name}", launches, kernels)
        lines = buf.getvalue().splitlines()
        out.append({"phase": f"examples_{name}", "seconds": seconds,
                    "argv": argv, **{k: res[k] for k in keep},
                    "route": route,
                    "held_device_bytes": held,
                    "peak_device_bytes": torch.cuda.max_memory_allocated(),
                    "launches": launches, "stdout_tail": lines[-3:]})
        return res, lines

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        env["TMPDIR"] = tmp          # where the CLI run saves its index
        for g in EXAMPLES_SMOKE_GRAPHS:
            _, lines = run(f"smoke_core_{g}", smoke_core.main,
                           ["--graph", g], ["graphs"],
                           lambda r, g=g: r["graphs"][g]["route"])
            if lines[-1] != "ALL OK":
                fail(f"examples smoke_core {g}: {lines[-3:]}")
        run("quickstart", quickstart.main, ["--out", f"{tmp}/index"],
            ["n", "m", "k", "n_core", "build_s", "path_dist"],
            lambda r: r["route"])
        run("distance_serving", distance_serving.main, EXAMPLES_SERVING,
            ["n", "m", "k", "n_core", "build_s", "served", "serve_s",
             "qps", "batch", "batch_p50_ms", "batch_p99_ms", "audited",
             "mix", "shards", "entries_per_shard", "paths_checked",
             "paths_overflowed", "paths_s"], lambda r: r["route"])
        torch.cuda.empty_cache()
        res, _ = run("gnn_molecules", gnn_molecules.main, [],
                     ["steps", "final_mse"])
        out[-1]["first_mse"] = res["losses"][0]
        cli = start_launchers([("quickstart", [])], None, env,
                              "repro_torch.examples.quickstart")
        res, _ = run("train_lm", train_lm.main,
                     EXAMPLES_LM + ["--ckpt-dir", f"{tmp}/lm"],
                     ["params", "steps", "batch", "seq", "last_checkpoint"])
        out[-1].update(first_loss=res["losses"][0],
                       final_loss=res["losses"][-1])
        if res["last_checkpoint"] != res["steps"]:
            fail(f"examples train_lm: last checkpoint "
                 f"{res['last_checkpoint']}, not {res['steps']}")
        rec = wait_launchers(cli)["quickstart"]
        if rec["lines"][-1:] != ["save/load roundtrip ok"]:
            fail(f"examples quickstart CLI: {rec['lines'][-3:]}")
        out.append({"phase": "examples_quickstart_cli",
                    "seconds": rec["seconds"],
                    "argv": ["python", "-m",
                             "repro_torch.examples.quickstart"],
                    "stdout_tail": rec["lines"][-3:]})
    torch.cuda.empty_cache()
    return out


def dien_request(cfg, kind: str, batch: int, device):
    """A seeded serve or retrieval batch for DIEN on ``device``: the
    launcher's ``dien_batch`` without its label, plus
    ``r512(n_candidates)`` candidate ids for retrieval."""
    import numpy as np
    from repro_torch.configs.base import r512
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.core.sync import upload
    from repro_torch.data.synthetic import dien_batch
    b = dien_batch(1, 0, batch, cfg.seq_len, cfg.n_items, cfg.n_cats,
                   cfg.n_users)
    del b["label"]
    if kind == "retrieval":
        b["cand_items"] = np.random.default_rng(2).integers(
            0, cfg.n_items, r512(RECSYS_SHAPES["retrieval_cand"]
                                 .n_candidates)).astype(np.int32)
    return {k: upload(v, device) for k, v in b.items()}


def phase_dien(tables, device="cuda") -> dict:
    """DIEN at the published config (67M item rows, seq_len 100): the
    state drawn on the card, ``DIEN_STEPS`` timed steps of the train
    bundle at ``DIEN_TRAIN_BATCH`` under sync debug mode "error" with
    the launch counters zeroed around them (no kernel of ``kernels/``
    may launch; no checkpoint), one profiled step (launches, idle
    share), then the ``serve`` bundle at ``serve_p99`` and the
    ``retrieval`` bundle at ``retrieval_cand`` on the trained
    parameters. The card against the CPU, restore, resume and the
    injected failure run on the smoke config (``phase_train``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import RecShape
    from repro_torch.core.sync import host_read, sync_count
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.train.steps import build_bundle
    from repro_torch.tree import leaves
    spec = registry.get_spec("dien")
    cfg = spec.model_cfg
    published = spec.shapes["train_batch"].batch
    spec = dataclasses.replace(spec, shapes={
        **spec.shapes,
        "train_batch": RecShape("train_batch", "train", DIEN_TRAIN_BATCH)})
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bundle = build_bundle(spec, "train_batch", device)
    state = init_state(spec, bundle)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    make = make_batch_fn(spec, "train_batch", device=device)
    batches = [make(i) for i in range(DIEN_STEPS)]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    state_bytes = sum(int(v.numel() * v.element_size())
                      for v in leaves(state) if isinstance(v, torch.Tensor))
    rec = {"cfg": str(cfg), "batch": DIEN_TRAIN_BATCH,
           "published_batch": published,
           "params": sum(int(v.numel()) for v in leaves(state["params"])),
           "state_bytes": state_bytes, "init_s": init_s,
           "data_s": data_s}
    zero(tables)
    torch.cuda.reset_peak_memory_stats()
    s0 = sync_count()
    losses, step_ms = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:
            t1 = time.perf_counter()
            state, m = bundle.fn(state, b)
            losses.append(float(host_read(m["loss"])))
            step_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sync_count() - s0
    peak = torch.cuda.max_memory_allocated() - base
    check_launches("train_dien", launches_of(tables), set())
    if not all(np.isfinite(losses)) or int(host_read(state["step"])) \
            != DIEN_STEPS:
        fail(f"train_dien: losses {losses}")
    if not losses[-1] < losses[0] * 1.5:
        fail(f"train_dien: loss diverged {losses[0]} -> {losses[-1]}")
    med = statistics.median(step_ms[1:])
    rec.update({"steps": DIEN_STEPS, "first_step_ms": step_ms[0],
                "step_ms_median": med, "step_ms_min": min(step_ms[1:]),
                "samples_per_s": DIEN_TRAIN_BATCH / med * 1e3,
                "syncs_per_step": syncs / DIEN_STEPS,
                "peak_device_bytes": peak, "loss_step1": losses[0],
                "loss_last": losses[-1]})

    def one_step():
        host_read(bundle.fn(state, batches[0])[1]["loss"])
    rec["profile"] = profile_idle(one_step)
    rec["launches_per_step"] = rec["profile"]["device_events"]
    params = state["params"]
    del state, batches
    torch.cuda.empty_cache()

    # serve and retrieval on the trained parameters
    for shape, kind in (("serve_p99", "serve"),
                        ("retrieval_cand", "retrieval")):
        sb = build_bundle(spec, shape, device)
        req = dien_request(cfg, kind, spec.shapes[shape].batch, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = sb.fn(params, req)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t1) * 1e3
        times = []
        for _ in range(DIEN_SERVE_REPEATS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = sb.fn(params, req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        got = out.cpu()
        want = (spec.shapes[shape].batch,) if kind == "serve" else \
            (1, req["cand_items"].shape[0])
        finite = bool(torch.isfinite(got).all())
        if tuple(got.shape) != want or not finite or (
                kind == "serve" and not bool(((got > 0) & (got < 1)).all())):
            fail(f"dien {kind}: shape {tuple(got.shape)}, finite {finite}")
        rec[kind] = {"shape": shape, "batch": spec.shapes[shape].batch,
                     "out_shape": list(got.shape), "finite": finite,
                     "ms_first": first, "ms_median": statistics.median(times),
                     "ms": times}
    check_launches("train_dien serve/retrieval", launches_of(tables), set())
    del params
    torch.cuda.empty_cache()
    return rec


def start_launchers(runs, tmp: str | None, env,
                    module: str = "repro_torch.launch.train") -> tuple:
    """Each ``(name, args)`` of ``runs`` as ``python -m <module> *args``
    on the card (with ``tmp``: ``--ckpt-dir <tmp>/<args[1]>`` appended),
    all started together (independent runs; ``wait_launchers`` collects
    them)."""
    procs = [(name, args, subprocess.Popen(
        [sys.executable, "-m", module, *args] + (
            ["--ckpt-dir", f"{tmp}/{args[1]}"] if tmp else []), cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)) for name, args in runs]
    atexit.register(stop_groups, [p for *_, p in procs])
    return time.perf_counter(), procs, module


def wait_launchers(started) -> dict:
    """``start_launchers``'s runs, each of which must exit 0: ``{name:
    {"args", "seconds" (from their common start), "lines"}}``."""
    t0, procs, module = started
    out = {}
    for name, args, p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            stop_groups([p])
            fail(f"{module} {' '.join(args)} ran past 600 s")
        if p.returncode:
            fail(f"{module} {' '.join(args)} exited "
                 f"{p.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
        out[name] = {"args": args, "seconds": time.perf_counter() - t0,
                     "lines": stdout.strip().splitlines()}
    return out


def phase_train_launcher() -> dict:
    """``python -m repro_torch.launch.train`` on the card as a subprocess
    (``TRAIN_LAUNCHER``), then again with ``--resume`` from its
    checkpoints (``TRAIN_LAUNCHER_RESUME``), and beside those each of
    ``TRAIN_LAUNCHER_MORE`` (DimeNet, DIEN); all must exit 0."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        more = start_launchers([(args[1], args)
                                for args in TRAIN_LAUNCHER_MORE], tmp, env)
        out = wait_launchers(start_launchers([("first", TRAIN_LAUNCHER)],
                                             tmp, env))
        out.update(wait_launchers(start_launchers(
            [("resume", TRAIN_LAUNCHER_RESUME)], tmp, env)))
        out.update(wait_launchers(more))
    if "resumed at step 20" not in out["resume"]["lines"]:
        fail(f"launch/train.py --resume: {out['resume']['lines']}")
    return out


# ------------------------------------------------------------ LM serving
class sync_errors:
    """Sync debug mode "error" inside the block: any device sync but a
    counted ``host_read`` raises."""

    def __enter__(self):
        import torch
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)


class DropMeter:
    """Counts the MoE assignments kept under the capacity (``keep``) and
    routed in all, on the device, by wrapping ``models.moe.route``; read
    once with ``share()``."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.plain, self.kept, self.total = moe, moe.route, [], 0

    def __enter__(self):
        def counted(*args, **kw):
            r = self.plain(*args, **kw)
            self.kept.append(r.keep.sum())
            self.total += r.keep.numel()
            return r
        self.moe.route = counted
        return self

    def __exit__(self, *exc):
        self.moe.route = self.plain

    def share(self):
        from repro_torch.core.sync import host_read
        if not self.total:
            return None
        import torch
        kept = float(host_read(torch.stack(self.kept).sum()))
        return 1.0 - kept / self.total


def lm_flops(cfg, b: int, s: int) -> float:
    """A prefill's operations as ``repro`` computes them: 2 x the active
    per-layer parameters x tokens, the attention products at full S x S
    per query chunk (scores and the product with V, 4 B H S^2 Dh a
    layer), and the last position's unembedding."""
    per_layer = (cfg.active_param_count() - 2 * cfg.vocab * cfg.d_model) \
        // cfg.n_layers
    attn = 4 * b * cfg.n_heads * s * s * cfg.hd
    return float(cfg.n_layers * (2 * per_layer * b * s + attn)
                 + 2 * b * cfg.d_model * cfg.vocab)


def lm_params(spec, arch_cfg, device):
    """``(spec, prefill bundle, decode bundle, params)`` through the
    entry points a user calls: ``build_bundle`` and ``init_state`` with
    bf16 weights drawn on the card."""
    import dataclasses
    from repro_torch.launch.train import init_state
    from repro_torch.train.steps import build_bundle
    spec = dataclasses.replace(spec, model_cfg=arch_cfg,
                               param_dtype="bfloat16")
    pre = build_bundle(spec, "prefill_32k", device)
    dec = build_bundle(spec, "decode_32k", device)
    return spec, pre, dec, init_state(spec, pre)["params"]


def lm_check(cfg, pre, dec, params, b: int, prompt: int, device,
             tol: float | None = LM_TOL):
    """A ``prompt``-token prefill into ``pre``'s cache, then
    ``LM_CHECK_STEPS`` teacher-forced decode steps, each step's logits
    against ``forward`` on all ``prompt + LM_CHECK_STEPS`` tokens at
    that position: ``max|d| / max|logit|`` (held to ``tol`` unless it is
    None) and the share of positions whose argmax agrees. Returns the
    record, the cache, the last step's greedy token and each position's
    ``max|d| / max|logit|`` ([b, LM_CHECK_STEPS + 1] on the device)."""
    import numpy as np
    import torch
    from repro_torch.core.sync import host_read, upload
    from repro_torch.models.transformer import forward
    n = prompt + LM_CHECK_STEPS
    toks = upload(np.random.default_rng(7).integers(
        0, cfg.vocab, (b, n)).astype(np.int32), device)
    t0 = time.perf_counter()
    logits, cache = pre.fn(params, {"tokens": toks[:, :prompt]})
    got = [logits]
    for j in range(LM_CHECK_STEPS):
        logits, cache = dec.fn(params, cache, toks[:, prompt + j:prompt + j + 1])
        got.append(logits)
    got = torch.cat(got, 1)                       # positions prompt-1 .. n-1
    ref = forward(params, cfg, toks)[0][:, prompt - 1:]
    row_err = (got - ref).abs().amax(-1) / ref.abs().max()
    err = row_err.max()
    agree = (got.argmax(-1) == ref.argmax(-1)).to(torch.float32).mean()
    finite = torch.isfinite(got).all()
    err, agree, finite, clen = host_read((err, agree, finite, cache["len"]))
    rec = {"prompt": prompt, "steps": LM_CHECK_STEPS, "batch": b,
           "max_err_over_max_logit": float(err),
           "argmax_agreement": float(agree), "tolerance": tol,
           "seconds": time.perf_counter() - t0}
    if not finite or int(clen) != n or (
            tol is not None and not float(err) <= tol):
        fail(f"{cfg.name}: decode against forward {rec}, cache len {clen}")
    return rec, cache, torch.argmax(logits, -1).to(torch.int32), row_err


class RouteRecorder:
    """Records, on the device, each ``models.moe.route`` call's top-k
    experts (sorted, a set a row) and the gap between the row's k-th and
    (k+1)-th router logits in bf16 ulps of the k-th (the spacing of bf16
    values there): a gap of one ulp or none is a near tie, which a
    rounding difference in the hidden state can swap."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.plain, self.calls = moe, moe.route, []

    def __enter__(self):
        import torch

        def recorded(p, cfg, xf, dtype=torch.bfloat16, dist=None):
            r = self.plain(p, cfg, xf, dtype, dist)
            logits = (xf @ p["router"].to(dtype)).to(torch.float32)
            top = torch.topk(logits, cfg.top_k + 1, dim=-1).values
            kth, nxt = top[:, -2], top[:, -1]
            ulp = torch.ldexp(torch.ones_like(kth), torch.frexp(kth)[1] - 8)
            self.calls.append((torch.sort(r.top_i, -1).values,
                               (kth - nxt) / ulp))
            return r
        self.moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self.plain


def route_witness(calls, n_layers: int, b: int, prompt: int, row_err):
    """``lm_check``'s routes (``RouteRecorder.calls``: the prefill's
    layers, each decode step's, then ``forward``'s) against
    ``forward``'s, row by row: M[l, b, p] says that position p's expert
    set at layer l differs. A primary mismatch has no mismatch before it
    at a lower layer and a position up to its own, so its router input
    differs from ``forward``'s by rounding alone; its gap (bf16 ulps,
    the smaller of the two sides') says how near a tie it broke. Clean
    check positions have no mismatch at any layer up to them; ``row_err``
    is read over those. Returns the mismatch shares at the prefill's and
    the decode steps' positions, the decode tokens that diverge, the
    primary mismatches and their largest gap, ``forward``'s near-tie
    share, and the clean positions and their error. Read once."""
    import torch
    from repro_torch.core.sync import host_read
    steps = LM_CHECK_STEPS
    n = prompt + steps
    pre = calls[:n_layers]
    dec = calls[n_layers:n_layers * (steps + 1)]
    fwd = calls[n_layers * (steps + 1):]
    if len(fwd) != n_layers:
        fail(f"route_witness: {len(calls)} route calls for {n_layers} layers")
    mism, gaps, fwd_gap = [], [], []
    for layer in range(n_layers):
        ft, fg = fwd[layer][0].view(b, n, -1), fwd[layer][1].view(b, n)
        at = torch.cat([pre[layer][0].view(b, prompt, -1)] + [
            dec[j * n_layers + layer][0].view(b, 1, -1)
            for j in range(steps)], 1)                             # [b, n, k]
        ag = torch.cat([pre[layer][1].view(b, prompt)] + [
            dec[j * n_layers + layer][1].view(b, 1)
            for j in range(steps)], 1)                             # [b, n]
        mism.append((at != ft).any(-1))
        gaps.append(torch.minimum(ag, fg))
        fwd_gap.append(fg)
    mism, gaps = torch.stack(mism), torch.stack(gaps)             # [L, b, n]
    seen = mism.to(torch.int32).cummax(2).values.cummax(0).values
    before = torch.cat([torch.zeros_like(seen[:1]), seen[:-1]], 0)
    primary = mism & (before == 0)
    clean = seen[-1, :, prompt - 1:] == 0                          # [b, s + 1]
    zero = row_err.new_zeros(())
    vals = host_read((
        mism[..., :prompt].float().mean(), mism[..., prompt:].float().mean(),
        mism[..., prompt:].any(0).sum(), primary.sum(),
        torch.where(primary, gaps, zero).max(),
        (torch.stack(fwd_gap) <= 1).float().mean(), clean.sum(),
        torch.where(clean, row_err, zero).max()))
    keys = ("prefill_route_mismatch_share", "decode_route_mismatch_share",
            "decode_tokens_diverged", "primary_mismatches",
            "max_gap_ulps_at_primary_mismatch", "forward_near_tie_share",
            "clean_positions", "clean_max_err_over_max_logit")
    out = {k: float(v) for k, v in zip(keys, vals)}
    out["decode_tokens"] = b * steps
    out["positions"] = b * (steps + 1)
    return out


def lm_exact_check(spec, params, b: int, device,
                   dtype: str = "float32") -> dict:
    """``lm_check`` of an MoE config in ``dtype`` with a capacity no call
    exceeds (``capacity_factor = n_experts / top_k``: cap = T + 1), at
    ``LM_MOE_EXACT_PROMPT`` prompt tokens into a cache of the prompt and
    the steps, with ``route_witness``; no assignment may drop. In fp32
    every position is held to ``LM_EXACT_TOL``; in bf16 the clean
    positions are held to ``LM_TOL``."""
    import dataclasses

    import torch
    from repro_torch.configs.shapes import LMShape
    from repro_torch.train.steps import build_bundle
    cfg = spec.model_cfg
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    n = LM_MOE_EXACT_PROMPT + LM_CHECK_STEPS
    spec = dataclasses.replace(spec, model_cfg=cfg, shapes={
        k: LMShape(k, kind, n, b) for k, kind in (("prefill_32k", "prefill"),
                                                  ("decode_32k", "decode"))})
    torch.cuda.empty_cache()
    fp32 = dtype == "float32"
    with torch.inference_mode(), DropMeter() as drops, \
            RouteRecorder() as routes, sync_errors():
        rec, cache, _, row_err = lm_check(
            cfg, build_bundle(spec, "prefill_32k", device),
            build_bundle(spec, "decode_32k", device), params, b,
            LM_MOE_EXACT_PROMPT, device, LM_EXACT_TOL if fp32 else None)
        rec["routing"] = route_witness(routes.calls, cfg.n_layers, b,
                                       LM_MOE_EXACT_PROMPT, row_err)
    del cache, routes
    rec["dropped_share"] = drops.share()
    if rec["dropped_share"]:
        fail(f"{cfg.name}: the no-drop check dropped {rec['dropped_share']}")
    rec["max_gap_ulps_tolerance"] = LM_TIE_ULPS
    if not rec["routing"]["max_gap_ulps_at_primary_mismatch"] <= LM_TIE_ULPS:
        fail(f"{cfg.name}: an expert set differs from forward's away from "
             f"a near tie {rec}")
    if not fp32:
        rec["clean_tolerance"] = LM_TOL
        if not rec["routing"]["clean_max_err_over_max_logit"] <= LM_TOL:
            fail(f"{cfg.name}: bf16 decode against forward where the "
                 f"routing agrees {rec}")
    torch.cuda.empty_cache()
    return rec


def lm_prefill(cfg, pre, params, b: int, s: int, device) -> dict:
    """One timed prefill of ``s`` tokens at batch ``b``: ms, tokens/s,
    the model's FLOPs over the bf16 peak, and peak device bytes."""
    import numpy as np
    import torch
    from repro_torch.core.sync import host_read, upload
    toks = upload(np.random.default_rng(8).integers(
        0, cfg.vocab, (b, s)).astype(np.int32), device)
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = pre.fn(params, {"tokens": toks})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    finite = bool(host_read(torch.isfinite(logits).all()))
    del cache
    if not finite:
        fail(f"{cfg.name}: prefill of {s} tokens gave non-finite logits")
    flops = lm_flops(cfg, b, s)
    return {"batch": b, "seq_len": s, "ms": ms,
            "tokens_per_s": b * s / ms * 1e3, "flops": flops,
            "prefill_mfu": flops / (ms / 1e3) / BF16_OPS_PER_S,
            "peak_device_bytes_over_weights": peak}


def lm_prefill_profile(spec, params, b: int, s: int, device) -> dict:
    """The kernel mix of a prefill of ``s`` tokens cut to its first
    ``LM_PROFILE_LAYERS`` layers (the same layers' work, profiled):
    device ms by kind and the top kernels, with the idle share."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.sync import upload
    from repro_torch.train.steps import build_bundle
    cfg = dataclasses.replace(spec.model_cfg, n_layers=LM_PROFILE_LAYERS)
    pre = build_bundle(dataclasses.replace(spec, model_cfg=cfg),
                       "prefill_32k", device)
    toks = upload(np.random.default_rng(8).integers(
        0, cfg.vocab, (b, s)).astype(np.int32), device)
    pre.fn(params, {"tokens": toks})            # the same shapes, warm
    return {"layers": LM_PROFILE_LAYERS,
            **profile_idle(lambda: pre.fn(params, {"tokens": toks}))}


def lm_decode(cfg, dec, params, cache, nxt, filled: int) -> dict:
    """``LM_DECODE_STEPS`` greedy steps from ``cache`` (holding
    ``filled`` tokens) and the token ``nxt`` with no host read in the
    loop (CUDA events between steps), under sync debug mode "error",
    then ``LM_PROFILE_STEPS`` profiled steps: step ms (first, median),
    tokens/s, the bytes bound (the weights a step reads plus the whole
    Smax cache, which the masked attention reads) and its share, the
    bound of the work a step needs (the weights plus the filled slots,
    on average over the steps) and its share, launches a step, idle
    share."""
    import torch
    from repro_torch.core.sync import host_read
    b, smax = nxt.shape[0], cache["k"].shape[2]
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(LM_DECODE_STEPS + 1)]
    torch.cuda.synchronize()
    with sync_errors():
        t0 = time.perf_counter()
        evs[0].record()
        for i in range(LM_DECODE_STEPS):
            logits, cache = dec.fn(params, cache, nxt)
            nxt = torch.argmax(logits, -1).to(torch.int32)
            evs[i + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(LM_DECODE_STEPS)]
    if not bool(host_read(torch.isfinite(logits).all())):
        fail(f"{cfg.name}: decode gave non-finite logits")
    med = statistics.median(step_ms)
    e, v = cfg.d_model, cfg.vocab
    weight_bytes = 2 * (cfg.param_count() - v * e + b * e)   # bf16; B rows
    cache_bytes = cache["k"].numel() * cache["k"].element_size() * 2
    bound_ms = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    # step i reads the slots up to filled + i, the one it writes included
    needed_cache_bytes = cache_bytes * (
        filled + (LM_DECODE_STEPS + 1) / 2) / smax
    needed_ms = (weight_bytes + needed_cache_bytes) / HBM_BYTES_PER_S * 1e3

    def steps():
        nonlocal cache
        x = nxt
        for _ in range(LM_PROFILE_STEPS):
            out, cache = dec.fn(params, cache, x)
            x = torch.argmax(out, -1).to(torch.int32)

    prof = profile_idle(steps)
    return {"batch": b, "smax": smax, "steps": LM_DECODE_STEPS,
            "first_step_ms": step_ms[0], "step_ms_median": med,
            "step_ms_min": min(step_ms),
            "tokens_per_s": b * LM_DECODE_STEPS / wall,
            "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
            "bound_ms": bound_ms, "bound_share": bound_ms / med,
            "filled_slots_at_start": filled,
            "needed_cache_bytes": needed_cache_bytes,
            "needed_bound_ms": needed_ms, "needed_bound_share": needed_ms / med,
            "launches_per_step": prof["device_events"] / LM_PROFILE_STEPS,
            "profile": prof}


def phase_lm(arch, decode_batch, tables, device="cuda") -> dict:
    """``arch`` at its full config with bf16 weights drawn on the card:
    the check against ``forward`` (``LM_PROMPT``-token prefill and
    ``LM_CHECK_STEPS`` teacher-forced steps at the decode batch; an MoE
    is gated on ``lm_exact_check``), the decode_32k cell from there
    (greedy, timed, profiled), then prefill_32k at
    ``LM_PREFILL_BATCH``. No kernel of ``kernels/`` may
    launch; the model runs under ``torch.inference_mode()`` and sync
    debug mode "error" but for the counted reads."""
    import torch
    from repro_torch.configs import registry
    spec = registry.get_spec(arch)
    cfg = spec.model_cfg
    torch.cuda.empty_cache()
    zero(tables)
    t0 = time.perf_counter()
    spec, pre, dec, params = lm_params(spec, cfg, device)
    torch.cuda.synchronize()
    rec = {"arch": arch, "cfg": str(cfg), "params": cfg.param_count(),
           "setup_s": time.perf_counter() - t0,
           "weight_device_bytes": torch.cuda.memory_allocated()}
    with torch.inference_mode():
        if cfg.moe:
            for key, dt in (("fp32", "float32"), ("bf16", "bfloat16")):
                rec[f"check_{key}_no_drop"] = lm_exact_check(
                    spec, params, decode_batch, device, dt)
        with DropMeter() as drops, sync_errors():
            rec["check"], cache, nxt, _ = lm_check(
                cfg, pre, dec, params, decode_batch, LM_PROMPT, device,
                None if cfg.moe else LM_TOL)
        with DropMeter() as dec_drops:
            rec["decode_32k"] = lm_decode(cfg, dec, params, cache, nxt,
                                          LM_PROMPT + LM_CHECK_STEPS)
        del cache
        torch.cuda.empty_cache()
        with DropMeter() as pre_drops, sync_errors():
            rec["prefill_32k"] = lm_prefill(
                cfg, pre, params, LM_PREFILL_BATCH,
                spec.shape("prefill_32k").seq_len, device)
        torch.cuda.empty_cache()
        rec["prefill_32k"]["profile"] = lm_prefill_profile(
            spec, params, LM_PREFILL_BATCH,
            spec.shape("prefill_32k").seq_len, device)
    if cfg.moe:
        rec["dropped_share"] = {"check": drops.share(),
                                "decode_32k": dec_drops.share(),
                                "prefill_32k": pre_drops.share()}
    rec["launches"] = launches_of(tables)
    check_launches(f"lm_{arch}", rec["launches"], set())
    del params, pre, dec
    torch.cuda.empty_cache()
    return rec


def phase_lm_width(tables, device="cuda") -> dict:
    """yi-34b and qwen2-72b at full width and depth 2, kimi-k2 at full
    width and depth 1: a ``LM_WIDTH_PROMPT``-token prefill at batch 1
    and ``LM_CHECK_STEPS`` teacher-forced steps against ``forward``
    (kimi-k2 gated on ``lm_exact_check``), then the prefill timed; each
    model freed before the next."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    out = {}
    for arch, depth in LM_WIDTH:
        spec = registry.get_spec(arch)
        cfg = dataclasses.replace(spec.model_cfg, n_layers=depth)
        torch.cuda.empty_cache()
        zero(tables)
        t0 = time.perf_counter()
        spec, pre, dec, params = lm_params(spec, cfg, device)
        torch.cuda.synchronize()
        rec = {"layers": depth, "params": cfg.param_count(),
               "setup_s": time.perf_counter() - t0,
               "weight_device_bytes": torch.cuda.memory_allocated()}
        if cfg.moe:     # first: its fp32 casts need 21 GB blocks whole
            for key, dt in (("fp32", "float32"), ("bf16", "bfloat16")):
                rec[f"check_{key}_no_drop"] = lm_exact_check(
                    spec, params, 1, device, dt)
        with torch.inference_mode(), DropMeter() as drops, sync_errors():
            rec["check"], cache, _, _ = lm_check(
                cfg, pre, dec, params, 1, LM_WIDTH_PROMPT, device,
                None if cfg.moe else LM_TOL)
            del cache
            rec["prefill"] = lm_prefill(cfg, pre, params, 1,
                                        LM_WIDTH_PROMPT, device)
        if cfg.moe:
            rec["dropped_share"] = drops.share()
        rec["launches"] = launches_of(tables)
        check_launches(f"lm_width {arch}", rec["launches"], set())
        rec["seconds"] = time.perf_counter() - t0
        out[arch] = rec
        del params, pre, dec
        torch.cuda.empty_cache()
    return out


def phase_lm_cpu(tables) -> dict:
    """The five smoke configs at ``dtype="float32"``: the port on the
    card (under sync debug mode "error") against the port on the CPU
    from the same parameters and tokens, a prefill and ``LM_CPU_STEPS``
    teacher-forced steps, logits and caches after each at
    ``LM_CPU_RTOL``/``LM_CPU_ATOL`` (GEMM algorithms and atomics reorder
    sums on the card; TF32 is off)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.transformer import (decode_step, init_lm,
                                                prefill, tiny_like)
    from repro_torch.tree import tree_map

    def run(params, cfg, toks):
        """Logits and cache copies after the prefill and each step."""
        logits, cache = prefill(params, cfg, toks[:, :8], 16)
        out = [(logits, cache["k"].clone(), cache["v"].clone(),
                cache["len"].clone())]
        for j in range(LM_CPU_STEPS):
            logits, cache = decode_step(params, cfg, cache,
                                        toks[:, 8 + j:9 + j])
            out.append((logits, cache["k"].clone(), cache["v"].clone(),
                        cache["len"].clone()))
        return out

    out = {}
    zero(tables)
    for arch in ("granite-8b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                 "yi-34b", "qwen2-72b"):
        cfg = dataclasses.replace(
            tiny_like(registry.get_spec(arch).model_cfg), dtype="float32")
        cpu = init_lm(cfg, 0, "cpu")
        card = tree_map(lambda a: a.to("cuda"), cpu)
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab, (2, 8 + LM_CPU_STEPS)).astype(np.int32))
        toks_card = toks.cuda()
        with torch.inference_mode():
            with sync_errors():
                got = run(card, cfg, toks_card)
            want = run(cpu, cfg, toks)
        err = 0.0
        for j, (g, w) in enumerate(zip(got, want)):
            for what, a, b in zip(("logits", "k", "v", "len"), w, g):
                b = b.cpu()
                if not torch.allclose(b, a, rtol=LM_CPU_RTOL,
                                      atol=LM_CPU_ATOL):
                    fail(f"lm_cpu {arch} step {j} {what} differs by "
                         f"{max_abs_err(a, b)}")
                err = max(err, max_abs_err(a, b))
        out[arch] = {"max_abs_err": err}
    check_launches("lm_cpu", launches_of(tables), set())
    return {"rtol": LM_CPU_RTOL, "atol": LM_CPU_ATOL, "steps": LM_CPU_STEPS,
            "archs": out}


def phase_lm_launcher() -> dict:
    """``python -m repro_torch.launch.serve`` with each of
    ``LM_LAUNCHER`` (the launcher's defaults otherwise: batch 256,
    gen-len 32, the smoke config) on the card, started together; each
    must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return wait_launchers(start_launchers(
        [(args[args.index("--arch") + 1], args) for args in LM_LAUNCHER],
        None, env, "repro_torch.launch.serve"))


# ------------------------------------------------------------ LM training
def lm_train_spec(arch, layers: int, batch: int, seq: int = 4096,
                  dtype: str | None = None, no_drop: bool = False):
    """``arch``'s spec at full width cut to ``layers``, its ``train_4k``
    cell at ``batch`` sequences of ``seq``; ``dtype`` the compute dtype,
    ``no_drop`` a capacity no MoE call exceeds (cap = T + 1)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import LMShape
    spec = registry.get_spec(arch)
    cfg = dataclasses.replace(spec.model_cfg, n_layers=layers)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if no_drop and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return dataclasses.replace(spec, model_cfg=cfg, shapes={
        "train_4k": LMShape("train_4k", "train", seq, batch)})


def lm_train_flops(cfg, b: int, s: int) -> float:
    """A train step's model FLOPs: 3 x the forward's, which is 2 x the
    active per-layer parameters x tokens, the attention products at full
    S x S a chunk as ``repro`` computes them (4 B H S^2 Dh a layer), and
    the unembedding at every position. Remat's recompute is not
    counted."""
    per_layer = (cfg.active_param_count() - 2 * cfg.vocab * cfg.d_model) \
        // cfg.n_layers
    attn = 4 * b * cfg.n_heads * s * s * cfg.hd
    return 3.0 * (cfg.n_layers * (2 * per_layer * b * s + attn)
                  + 2 * b * s * cfg.d_model * cfg.vocab)


def phase_lm_train(arch, layers, batch, accum, tables,
                   device="cuda") -> dict:
    """The ``train_4k`` cell of ``arch`` at full width cut to ``layers``
    and ``batch`` sequences with ``grad_accum`` ``accum``: the state drawn
    on the card through ``build_bundle`` and ``init_state``,
    ``LM_TRAIN_STEPS`` steps through ``FaultTolerantRunner`` with no
    checkpoint under sync debug mode "error" (no kernel of ``kernels/``
    may launch), then ``LM_TRAIN_PROFILE_STEPS`` profiled steps
    (launches, idle share, device ms by kind), one profiled optimizer
    update."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.sync import host_read, sync_count
    from repro_torch.fault import FaultTolerantRunner, RunnerConfig
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.train.steps import build_bundle
    from repro_torch.tree import leaves, tree_map
    what = f"train_lm_{arch}"
    spec = lm_train_spec(arch, layers, batch)
    cfg, seq = spec.model_cfg, spec.shape("train_4k").seq_len
    published = registry.get_spec(arch)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bundle = build_bundle(spec, "train_4k", device, {"grad_accum": accum})
    state = init_state(spec, bundle)
    make_batch = make_batch_fn(spec, "train_4k", device=device)
    torch.cuda.synchronize()
    flops = lm_train_flops(cfg, batch, seq)
    rec = {"arch": arch, "cfg": str(cfg), "layers": layers,
           "published_layers": published.model_cfg.n_layers,
           "seq_len": seq, "global_batch": batch,
           "published_global_batch":
               published.shape("train_4k").global_batch,
           "grad_accum": accum, "micro_batch": batch // accum,
           "tokens_per_step": batch * seq, "remat_policy": cfg.remat_policy,
           "param_dtype": spec.param_dtype, "compute_dtype": cfg.dtype,
           "optimizer": spec.optimizer,
           "params": sum(int(v.numel()) for v in leaves(state["params"])),
           "state_bytes": sum(int(v.numel() * v.element_size())
                              for v in leaves(state)),
           "flops_per_step": flops, "setup_s": time.perf_counter() - t0}

    with tempfile.TemporaryDirectory() as tmp:
        runner = FaultTolerantRunner(bundle.fn, state, make_batch,
                                     RunnerConfig(tmp, ckpt_every=0,
                                                  handle_sigterm=False))
        # no checkpoint, the run's closing save included (~20 GB a save)
        runner.ckpt.maybe_save = lambda step, st, force=False: False
        del state
        losses = []
        zero(tables)
        torch.cuda.reset_peak_memory_stats()
        s0 = sync_count()
        with DropMeter() as drops, sync_errors():
            t0 = time.perf_counter()
            runner.run(LM_TRAIN_STEPS, on_metrics=lambda s, m: losses.append(
                m["loss"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        syncs = sync_count() - s0
        peak = torch.cuda.max_memory_allocated() - base
        check_launches(what, launches_of(tables), set())
        if runner.events:
            fail(f"{what}: fault events on a clean run {runner.events}")
        step_ms = [h[0] * 1e3 for h in runner.monitor.history]
        state = runner.state
        del runner
    losses = [float(x) for x in host_read(tuple(losses))]
    if len(losses) != LM_TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0] * 1.5:
        fail(f"{what}: losses {losses}")
    med = statistics.median(step_ms[1:])
    rec.update({
        "steps": LM_TRAIN_STEPS, "first_step_ms": step_ms[0],
        "step_ms_median": med, "step_ms_min": min(step_ms[1:]),
        "step_ms": step_ms, "wall_s": wall,
        "tokens_per_s": batch * seq / med * 1e3,
        "train_mfu": flops / (med / 1e3) / BF16_OPS_PER_S,
        "syncs_per_step": syncs / LM_TRAIN_STEPS,
        "peak_device_bytes": peak, "loss_first": losses[0],
        "loss_last": losses[-1], "losses": losses,
        "dropped_share": drops.share()})

    def window():
        nonlocal state
        for i in range(LM_TRAIN_PROFILE_STEPS):
            state, m = bundle.fn(state, make_batch(LM_TRAIN_STEPS + i))
            host_read(m["loss"])

    prof = profile_idle(window)
    rec["profile"] = prof
    rec["launches_per_step"] = prof["device_events"] / LM_TRAIN_PROFILE_STEPS
    rec["device_ms_per_step_by_kind"] = {
        k: v["device_ms"] / LM_TRAIN_PROFILE_STEPS
        for k, v in prof["by_kind"].items()}

    # the optimizer alone: one update on gradients of the state's shapes
    grads = tree_map(lambda p: torch.full(p.shape, 1e-3, dtype=torch.float32,
                                          device=p.device), state["params"])
    opt_prof = profile_idle(lambda: bundle.optimizer.update(
        grads, state["opt"], state["params"], state["step"]))
    del grads
    rec["optimizer"] = {"device_ms": opt_prof["device_busy_ms"],
                        "launches": opt_prof["device_events"],
                        "wall_ms": opt_prof["wall_ms"],
                        "share_of_step_busy_ms": opt_prof["device_busy_ms"]
                        / (prof["device_busy_ms"] / LM_TRAIN_PROFILE_STEPS)}
    torch.cuda.empty_cache()

    check_launches(f"{what} (all runs)", launches_of(tables), set())
    del state, bundle
    torch.cuda.empty_cache()
    return rec


def lm_grads(cfg, params, tokens, targets):
    """(loss, gradient leaves) of ``lm_loss`` through autograd."""
    import torch
    from repro_torch.models.transformer import lm_loss
    from repro_torch.tree import leaves, tree_map
    p = tree_map(lambda a: a.detach().requires_grad_(), params)
    loss = lm_loss(p, cfg, tokens, targets)
    return loss.detach(), torch.autograd.grad(loss, leaves(p))


def lm_check_cell(arch, layers, device="cuda") -> dict:
    """(a)-(d) of ``train_lm_checks`` on ``arch`` cut to ``layers`` in
    fp32 (an MoE with a capacity no call exceeds)."""
    import dataclasses

    import torch
    from repro_torch.core.sync import host_read
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.steps import build_bundle
    from repro_torch.tree import (flatten_with_paths, leaves, tree_map,
                                  unflatten_paths)
    what = f"train_lm_checks {arch}"
    rec = {"layers": layers}
    spec = lm_train_spec(arch, layers, 1, LM_CHECK_SEQ, "float32", True)
    cfg = spec.model_cfg
    bundle = build_bundle(spec, "train_4k", device)
    state = init_state(spec, bundle)
    batch = make_batch_fn(spec, "train_4k", device=device)(0)
    tok, tgt = batch["tokens"], batch["targets"]

    # (a) the bundle's step-0 loss against lm_loss under no_grad, bitwise
    new, m = bundle.fn(state, batch)
    del new
    with torch.no_grad():
        ref = lm_loss(state["params"], cfg, tok, tgt)
    a_loss, a_ref = (float(x) for x in host_read((m["loss"], ref)))
    rec["a_loss"] = {"bundle": a_loss, "no_grad": a_ref,
                     "bitwise": torch.equal(m["loss"], ref)}
    if not rec["a_loss"]["bitwise"]:
        fail(f"{what} (a): bundle loss {a_loss} != lm_loss {a_ref}")

    # (b) <g, d> against a central difference along a seeded direction
    params = state["params"]
    loss, grads = lm_grads(cfg, params, tok, tgt)
    gen = torch.Generator(device).manual_seed(5)
    routed = ("embed", "blocks/attn/", "blocks/ln1/", "blocks/ln2/",
              "blocks/ffn/router")
    d = unflatten_paths(
        (path, torch.zeros_like(a) if cfg.moe and path.startswith(routed)
         else torch.randn(a.shape, generator=gen, device=a.device,
                          dtype=a.dtype) * a.square().mean().sqrt())
        for path, a in flatten_with_paths(params))
    gd = float(host_read(sum(torch.sum(g.double() * v.double())
                             for g, v in zip(grads, leaves(d)))))
    del grads
    fd = {}
    with torch.no_grad():
        for eps in LM_FD_EPS:
            lp, lm_ = (lm_loss(tree_map(lambda a, v, s=sign: a + s * eps * v,
                                        params, d), cfg, tok, tgt)
                       for sign in (1.0, -1.0))
            lp, lm_ = (float(x) for x in host_read((lp, lm_)))
            f = (lp - lm_) / (2 * eps)
            fd[str(eps)] = {"fd": f, "rel_err": abs(f - gd) / abs(gd),
                            "loss_plus": lp, "loss_minus": lm_}
    del d
    rec["b_grad"] = {"directional": gd, "eps_gated": LM_FD_EPS[0],
                     "rtol": LM_FD_RTOL, "fd": fd,
                     "zero_on": list(routed) if cfg.moe else []}
    if not fd[str(LM_FD_EPS[0])]["rel_err"] <= LM_FD_RTOL:
        fail(f"{what} (b): central difference {fd} against <g, d> {gd}")

    # (d) grad_accum 4 against 1 on the same 4 sequences; an MoE without
    # its load-balance loss, a product of batch means (so not a mean over
    # micro-batches, in repro as here)
    spec4 = lm_train_spec(arch, layers, LM_ACCUM_CHECK, LM_CHECK_SEQ,
                          "float32", True)
    if cfg.moe:
        spec4 = dataclasses.replace(spec4, model_cfg=dataclasses.replace(
            spec4.model_cfg, moe=dataclasses.replace(
                spec4.model_cfg.moe, router_aux_weight=0.0)))
    batch4 = make_batch_fn(spec4, "train_4k", device=device)(0)
    outs = {}
    for accum in (1, LM_ACCUM_CHECK):
        b = build_bundle(spec4, "train_4k", device, {"grad_accum": accum})
        new, m = b.fn(state, batch4)
        outs[accum] = (m["loss"], m["gnorm"], new["opt"]["mu"])
        del new
    (l1, g1, mu1), (l4, g4, mu4) = outs[1], outs[LM_ACCUM_CHECK]
    mu_err = max(max_abs_err(x, y) for x, y in zip(leaves(mu1), leaves(mu4)))
    mu_max = max(float(x.abs().max()) for x in leaves(mu1))
    l1, l4, g1, g4 = (float(x) for x in host_read((l1, l4, g1, g4)))
    rec["d_accum"] = {"grad_accum": LM_ACCUM_CHECK, "loss": [l1, l4],
                      "gnorm": [g1, g4], "mu_max_abs_err": mu_err,
                      "mu_max": mu_max, "rtol": LM_ACCUM_RTOL}
    if not (abs(l1 - l4) <= LM_ACCUM_RTOL * abs(l1)
            and abs(g1 - g4) <= LM_ACCUM_RTOL * abs(g1)
            and mu_err <= LM_ACCUM_RTOL * mu_max):
        fail(f"{what} (d): {rec['d_accum']}")
    del outs, mu1, mu4

    # (c) the remat policies at one sequence of LM_REMAT_SEQ tokens
    spec_c = lm_train_spec(arch, layers, 1, LM_REMAT_SEQ, "float32", True)
    batch_c = make_batch_fn(spec_c, "train_4k", device=device)(0)
    got, peaks = {}, {}
    for policy in ("none", "dots", "off"):
        c = dataclasses.replace(spec_c.model_cfg, remat_policy=policy)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got[policy] = lm_grads(c, params, batch_c["tokens"],
                               batch_c["targets"])[1]
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated() - start
    g_max = max(float(g.abs().max()) for g in got["none"])
    errs = {p: max(max_abs_err(x, y) for x, y in zip(got[p], got["none"]))
            for p in ("dots", "off")}
    rec["c_remat"] = {"seq_len": LM_REMAT_SEQ,
                      "peak_backward_bytes": peaks,
                      "gradient_bytes": sum(int(g.numel() * g.element_size())
                                            for g in got["none"]),
                      "max_abs_err_vs_none": errs, "grad_max": g_max,
                      "rtol": LM_GRAD_RTOL}
    if not all(e <= LM_GRAD_RTOL * g_max for e in errs.values()):
        fail(f"{what} (c): gradients differ across policies {errs}")
    # with one layer "none" recomputes every activation the backward then
    # holds at once, which "dots" also reaches: only none < off is strict
    if not (peaks["none"] <= peaks["dots"] <= peaks["off"]
            and peaks["none"] < peaks["off"]):
        fail(f"{what} (c): peak bytes not none <= dots <= off: {peaks}")
    del got, state, params, bundle
    torch.cuda.empty_cache()
    return rec


def phase_lm_train_checks(tables, device="cuda") -> dict:
    """(a)-(d) on each of ``LM_CHECKS`` (``lm_check_cell``); no kernel of
    ``kernels/`` may launch."""
    zero(tables)
    out = {}
    for arch, layers in LM_CHECKS:
        t0 = time.perf_counter()
        out[arch] = {**lm_check_cell(arch, layers, device),
                     "seconds": time.perf_counter() - t0}
    check_launches("train_lm_checks", launches_of(tables), set())
    return out


def phase_lm_train_smoke(tables, device="cuda") -> dict:
    """The five smoke configs in fp32 (kimi-k2's parameters bf16 with
    Adafactor) through ``phase_train``: steps, the card against the CPU,
    restore, resume, one injected failure (kimi-k2 under deterministic
    algorithms: its resume and rollback bitwise); beside them
    ``LM_TRAIN_LAUNCHER`` as subprocesses started together, each exiting
    0."""
    import dataclasses
    import os
    import tempfile

    import torch
    from repro_torch.configs import registry
    from repro_torch.launch.train import smoke_spec
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = tempfile.TemporaryDirectory()
    launchers = start_launchers(
        [(f"launcher {args[1]}", args) for args in LM_TRAIN_LAUNCHER],
        tmp.name, env)
    out = {}
    for arch in ("granite-8b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                 "yi-34b", "qwen2-72b"):
        spec = smoke_spec(registry.get_spec(arch))
        spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(
            spec.model_cfg, dtype="float32"))
        bf16 = spec.param_dtype == "bfloat16"
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(bf16)
        try:
            rec = phase_train(arch, "train_4k", tables, device, smoke=True,
                              spec=spec, runs=LM_SMOKE_RUNS,
                              rerun_tol=(0, 0) if bf16 else None)
        finally:
            torch.use_deterministic_algorithms(False)
        out[arch] = {"param_dtype": spec.param_dtype,
                     "optimizer": spec.optimizer,
                     "deterministic_algorithms": bf16,
                     "seconds": time.perf_counter() - t0,
                     **{k: rec[k] for k in (
                         "first_step_ms", "step_ms_median", "loss_step1",
                         f"loss_step{LM_SMOKE_RUNS[0]}", "card_vs_cpu",
                         "resume",
                         "injected_failure", "launches")}}
    with tmp:
        out.update(wait_launchers(launchers))
    return out


def label_seeds(idx, s, t):
    """The stage-2 label seeds of one query batch, as ``QueryEngine``
    hands them to ``CoreRelaxer.run``, and the gathered label rows."""
    import torch
    from repro_torch.core.labels import decode_rows
    eng = idx.engine
    rs, rt = (eng._rows(torch.as_tensor(x, device=idx.device))
              for x in (s, t))
    seeds = [eng._label_seeds(*decode_rows(r, idx.n, eng.codec))
             for r in (rs, rt)]
    return seeds, rs, rt


def frontier(idx, s, t, vp: int):
    """The stacked, padded [2Q, Vp] row-major stage-2 seeds of one query
    batch (the fused and dense routes' layout)."""
    from repro_torch.core.dispatch import seed_rows, stack_frontiers
    seeds, rs, rt = label_seeds(idx, s, t)
    v = idx.engine.n_core + 1
    return stack_frontiers(*(seed_rows(x, v) for x in seeds), vp, 8), rs, rt


def _fns():
    """name -> (CUDA kernel binding, plain PyTorch version)."""
    from repro_torch.kernels.label_intersect.kernel import (
        label_intersect_kernel, label_intersect_packed_kernel)
    from repro_torch.kernels.label_intersect.ref import (
        label_intersect_packed_ref, label_intersect_ref)
    from repro_torch.kernels.minplus_matmul.kernel import \
        minplus_matmul_kernel
    from repro_torch.kernels.minplus_matmul.ref import minplus_matmul_ref
    from repro_torch.kernels.spmv_relax.kernel import (fused_relax_kernel,
                                                       spmv_relax_kernel)
    from repro_torch.kernels.spmv_relax.ref import (fused_relax_ref,
                                                    spmv_relax_ref)
    return {
        "label_intersect_kernel": (label_intersect_kernel,
                                   label_intersect_ref),
        "spmv_relax_kernel": (spmv_relax_kernel, spmv_relax_ref),
        # the last argument picks the kernel's variant; the plain version
        # has none
        "fused_relax_kernel": (
            lambda d, edges, r, var: fused_relax_kernel(
                d, edges, max_rounds=r, variant=var),
            lambda d, edges, r, var: fused_relax_ref(d, edges, r)),
        "minplus_matmul_kernel": (minplus_matmul_kernel, minplus_matmul_ref),
        "label_intersect_packed_kernel": (label_intersect_packed_kernel,
                                          label_intersect_packed_ref),
    }


def fused_variants(v: int) -> list:
    """The fused kernel's variants that take a core of ``v`` vertices:
    the global one always, the shared one where the route picks it."""
    from repro_torch.kernels.spmv_relax.kernel import fused_variant
    return sorted({"global", fused_variant(v)})


def fused_work(d0, edges, blk_rounds, bq: int = 8) -> int:
    """Operations the fused route's rounds need on this input: per block
    and round, an add and a min for each (row, in-edge) whose source
    changed in the block's previous round (any row finite before the
    first), and a min per entry."""
    import torch
    from repro_torch.kernels.spmv_relax.ref import _edge_round, sliced_dst
    live = torch.isfinite(edges.w)
    src = edges.src.long()[live]
    dst = sliced_dst(edges)[live]
    q, v = d0.shape
    nb = q // bq
    d = d0
    changed = torch.isfinite(d).view(nb, bq, v).any(1)
    pairs = 0
    for r in range(int(blk_rounds.max())):
        on = blk_rounds > r
        pairs += int((changed[:, src].sum(1) * on).sum()) * bq
        d2 = _edge_round(d, src, dst, edges.w[live])
        changed = (d2 < d).view(nb, bq, v).any(1)
        d = d2
    return 2 * pairs + int(blk_rounds.sum()) * bq * v


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# spmv_relax_kernel's operands that it writes (out, changed_out, flag_out)
OUTPUT_ARGS = {"spmv_relax_kernel": (4, 5, 6)}


def _own_outputs(name, args):
    """``args`` with copies of the operands that the kernel writes, so
    kernel and plain version start from the same contents and leave the
    caller's buffers alone."""
    outs = OUTPUT_ARGS.get(name, ())
    return tuple(a.clone() if i in outs else a for i, a in enumerate(args))


def compare(name, args) -> float:
    """Run kernel and plain version on ``args``; fail unless every output
    is ``torch.equal``. Returns the max abs error (0.0)."""
    import torch
    kernel, plain = _fns()[name]
    outs = _as_tuple(kernel(*_own_outputs(name, args)))
    refs = _as_tuple(plain(*_own_outputs(name, args)))
    torch.cuda.synchronize()
    for a, b in zip(outs, refs):
        if not torch.equal(a, b):
            shapes = [tuple(x.shape) for x in args if hasattr(x, "shape")]
            fail(f"{name}: kernel differs from its plain version at "
                 f"{shapes} (max abs err {max_abs_err(a, b)})")
    return max(max_abs_err(a, b) for a, b in zip(outs, refs))


def phase_ragged(dev="cuda") -> dict:
    """Each kernel against its plain version on small random inputs off
    every block multiple — before the main path leans on them."""
    import numpy as np
    import torch
    from repro_torch.core.labels import encode_labels
    from repro_torch.kernels.spmv_relax.kernel import (HEAVY_DEGREE,
                                                       ROW_TILE, RelaxCSR,
                                                       SlicedEdges,
                                                       TILE_SECTORS,
                                                       pack_sectors)
    from repro_torch.kernels.spmv_relax.ops import coo_to_csr, coo_to_sliced
    g = torch.Generator(device=dev).manual_seed(0)
    r = np.random.default_rng(0)
    inf = float("inf")

    def packed_rows(q, l, n_sent, d_dtype):
        """Encoded s and t rows: t shares about half of each s row's ids;
        rows of every fill, a fully padded row, a row whose slot 0 is a
        pad with stray deltas after it, and a gap of exactly 32767. The
        ids of a row lie in one window of 2**15, so every gap fits."""
        ids = np.full((2, q, l), n_sent, np.int64)
        span = min(n_sent, 2 ** 15)
        for i in range(q):
            lo = 7 if i == 2 else int(r.integers(0, n_sent - span + 1))
            row = np.unique(r.integers(lo, lo + span,
                                       int(r.integers(0, l + 1))))
            if i == 2:
                row = np.array([lo, lo + span - 1])
            shared = row[r.random(len(row)) < 0.5]
            other = np.unique(r.integers(lo, lo + span, l - len(shared)))
            t_row = np.union1d(shared, other)[:l]
            ids[0, i, :len(row)] = row
            ids[1, i, :len(t_row)] = t_row
        d = np.where(ids < n_sent, r.integers(0, 90, ids.shape), inf)
        out = []
        for side in range(2):
            delta, base, d_enc = encode_labels(ids[side], d[side], n_sent,
                                               d_dtype)
            if q > 1:
                delta[0] = -1                               # all pad
                delta[1] = r.integers(0, 50, l)             # slot 0 pad,
                delta[1, 0] = -1                            # stray after it
            out += [torch.from_numpy(x).to(dev) for x in (delta, base, d_enc)]
        return (*out, n_sent)

    def rows(q, l, n_sent):
        ids = torch.randint(0, n_sent + 1, (q, l), generator=g, device=dev,
                            dtype=torch.int64).sort(1).values.to(torch.int32)
        dup = torch.zeros_like(ids, dtype=torch.bool)
        dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
        ids = torch.where(dup, n_sent, ids).sort(1).values
        d = torch.randint(0, 9, (q, l), generator=g, device=dev).float()
        return ids, torch.where(ids < n_sent, d, inf)

    def plane_cases(n, l, q, dup, d_dtype=None):
        """Label planes [n+1, L] read in place by endpoint id, and the
        same rows gathered (null index): rows of 0, 1, 31, 32, 33, 63,
        64, 65, 96 and 97 real ids (cut to L), then random counts; with
        ``dup`` every third row has repeated ids (any distances); row n
        all pad. Endpoints (the last Q of): those rows against each other
        and themselves, repeated ids, random ids, and n on either side and
        both; then the in-place case again with ids n, n+3, -1, -2 and
        -(n+5) among the endpoints. ``d_dtype`` encodes the planes as
        delta16 with that distance plane."""
        counts = (0, 1, 31, 32, 33, 63, 64, 65, 96, 97)
        ids = np.full((n + 1, l), n, np.int64)
        d = np.full((n + 1, l), inf)
        for v in range(n):
            k = min(l, counts[v] if v < len(counts)
                    else int(r.integers(0, l + 1)))
            ids[v, :k] = np.sort(r.choice(n, k, replace=dup and v % 3 == 0))
            d[v, :k] = r.integers(0, 90, k)
        if d_dtype is None:
            planes = (ids.astype(np.int32), d.astype(np.float32))
        else:
            planes = encode_labels(ids, d, n, d_dtype)
        planes = [torch.from_numpy(x).to(dev) for x in planes]
        k = len(counts)
        s, t = (r.integers(0, n + 1, max(q, 2 * k + 8)) for _ in range(2))
        s[:2 * k] = np.tile(np.arange(k), 2)
        t[:2 * k] = np.concatenate([np.arange(k), np.roll(np.arange(k), 1)])
        s[2 * k:2 * k + 4] = s[2 * k + 4]
        s[-3:-1], t[-2:] = n, n
        s, t = (torch.from_numpy(x[-q:].astype(np.int32)).to(dev)
                for x in (s, t))
        gathered = [p[e.long()] for e in (s, t) for p in planes]
        # endpoint ids n, n+3, -1, -2 and -(n+5) on either side and both:
        # rows as the JAX package gathers them (row_index)
        odd = torch.tensor([n, n + 3, -1, -2, -(n + 5)], dtype=torch.int32,
                           device=dev)[torch.arange(q, device=dev) % 5]
        s_odd, t_odd = s.clone(), t.clone()
        s_odd[::3], t_odd[1::3] = odd[::3], odd.flip(0)[1::3]
        return [(*planes, *planes, n, s, t), (*gathered, n),
                (*planes, *planes, n, s_odd, t_odd)]

    def fused_cases(q, v, deg, max_rounds):
        """fused_relax operands, one case per variant that takes ``v``
        (``fused_variants``): about ``deg`` random in-edges a vertex into
        the first half of the vertices, a hub of in-degree 3 deg, one
        zero a row, the last block without seeds."""
        e = deg * v // 2
        src = np.concatenate([r.integers(0, v, e), r.integers(0, v, 3 * deg)])
        dst = np.concatenate([r.integers(0, max(1, v // 2), e),
                              np.full(3 * deg, v // 3)])
        w = r.integers(1, 5, len(src)).astype(np.float32)
        dist = torch.full((q, v), inf, device=dev)
        dist[torch.arange(q, device=dev),
             torch.randint(0, v, (q,), generator=g, device=dev)] = 0.0
        if q > 8:
            dist[q - 8:] = inf
        edges = SlicedEdges(*(torch.from_numpy(x).to(dev)
                              for x in coo_to_sliced(v, src, dst, w)))
        return [(dist, edges, max_rounds, var) for var in fused_variants(v)]

    def csr_case(vp, rows, e, hubs, mask, flag_in=1, full=1):
        """spmv_relax operands: e random edges into the first half of the
        vertices (the rest have no in-edges) plus one hub for each
        in-degree in ``hubs``, a frontier about 10% finite, a sector mask
        "all", "none" or "random" (30% of the bits), and outputs filled
        with garbage; with ``full`` 0, ``out`` starts as the frontier
        (the buffer of a round before that changed nothing else)."""
        src = r.integers(0, vp, e)
        dst = r.integers(0, max(1, vp // 2), e)
        for hub, deg in enumerate(hubs):
            src = np.concatenate([src, r.integers(0, vp, deg)])
            dst = np.concatenate([dst, np.full(deg, 7 + hub)])
        w = r.integers(1, 9, len(src)).astype(np.float32)
        indptr, s_, w_, order, n_heavy = coo_to_csr(vp, src, dst, w)
        csr = RelaxCSR(*(torch.from_numpy(x).to(dev)
                         for x in (indptr, s_, w_, order)), n_heavy)
        dist = torch.randint(0, 30, (vp, rows), generator=g,
                             device=dev).float()
        dist[torch.rand((vp, rows), generator=g, device=dev) < 0.9] = inf
        n_tiles = -(-rows // ROW_TILE)
        p_bit = {"all": 1.0, "none": 0.0, "random": 0.3}[mask]
        bits = torch.rand((n_tiles, vp, TILE_SECTORS), generator=g,
                          device=dev) < p_bit
        flag = torch.full((1,), flag_in, dtype=torch.int32, device=dev)
        out = dist.clone() if not full else torch.full_like(dist, 5.0)
        chg_out = torch.randint(-2 ** 15, 2 ** 15, (n_tiles, vp),
                                generator=g, device=dev,
                                dtype=torch.int16)
        return (dist, csr, pack_sectors(bits), flag, out, chg_out,
                torch.zeros(1, dtype=torch.int32, device=dev), full)

    def mat(m, k, p_inf):
        x = torch.randint(0, 20, (m, k), generator=g, device=dev).float()
        return torch.where(torch.rand((m, k), generator=g, device=dev)
                           < p_inf, inf, x)

    def inf_lines(m, k, n):
        """A [m, k] x [k, n] pair with all-inf rows of A and columns of B."""
        a, b = mat(m, k, 0.2), mat(k, n, 0.2)
        a[::7] = inf
        b[:, 3::5] = inf
        return a, b

    minplus = [(mat(37, 100, 0.3), mat(100, 70, 0.3)),
               (torch.full((65, 3), inf, device=dev),
                torch.ones((3, 129), device=dev)),
               (mat(130, 260, 0.5), mat(260, 5, 0.0)),
               (mat(200, 5, 0.1), mat(5, 131, 0.1)),      # K < one slice
               (mat(129, 1, 0.0), mat(1, 257, 0.3)),
               (mat(5, 0, 0.0), mat(0, 7, 0.0)),          # K = 0: all inf
               (mat(100, 40, 0.2), mat(40, 132, 0.2)),    # N % 4 == 0
               (mat(128, 48, 0.2), mat(48, 128, 0.2)),    # whole tiles
               inf_lines(257, 33, 190), inf_lines(300, 161, 260)]

    # (n, L, Q, duplicate ids) of the planes read in place; L on and off
    # the 32-slot chunks
    planes = ((1000, 45, 77, False), (1000, 64, 130, True),
              (300, 70, 41, True), (2000, 129, 200, False),
              (300, 257, 64, True), (400, 97, 5, False))
    cases = {
        "label_intersect_packed_kernel": [
            packed_rows(q, l, n_sent, d_dtype)
            for d_dtype in ("int32", "float32")
            for q, l, n_sent in ((13, 100, 100_000), (1, 1, 5),
                                 (40, 257, 300_000), (37, 33, 70_000))] + [
            case for d_dtype in ("int32", "float32") for n, l, q, dup in planes
            for case in plane_cases(n, l, q, dup, d_dtype)],
        "label_intersect_kernel": [
            (*rows(13, 100, 1000), *rows(13, 100, 1000), 1000),
            (*rows(1, 1, 5), *rows(1, 1, 5), 5),
            (*rows(40, 257, 300), *rows(40, 257, 300), 300)] + [
            case for n, l, q, dup in planes
            for case in plane_cases(n, l, q, dup)],
        "spmv_relax_kernel": [
            csr_case(1001, 40, 5000, (HEAVY_DEGREE + 1, HEAVY_DEGREE),
                     "random"),
            csr_case(77, 8, 200, (), "all"),
            csr_case(130, 16, 400, (HEAVY_DEGREE * 3,), "none"),
            csr_case(5003, 136, 30000, (2512,), "random"),
            csr_case(300, 48, 900, (600,), "all"),
            csr_case(700, 264, 3000, (300,), "random"),
            csr_case(1001, 256, 5000, (HEAVY_DEGREE + 1, 3 * HEAVY_DEGREE),
                     "random"),
            csr_case(500, 24, 2000, (), "all", flag_in=0),
            csr_case(1001, 40, 5000, (HEAVY_DEGREE + 1,), "random", full=0),
            csr_case(5003, 136, 30000, (2512,), "random", full=0),
            csr_case(700, 264, 3000, (300,), "none", full=0)],
        # V on both sides of the shared variant's limit (3,521 vertices),
        # none a multiple of the 1024 threads
        "fused_relax_kernel": [
            case for q, v, deg, mr in (
                (24, 1000, 16, 10000), (8, 77, 32, 3), (16, 300, 16, 0),
                (16, 2047, 12, 1), (16, 2049, 12, 7), (24, 3521, 8, 7),
                (16, 3522, 8, 10000), (16, 5001, 6, 1),
                (32, 1920, 17, 10000))
            for case in fused_cases(q, v, deg, mr)],
        "minplus_matmul_kernel": minplus,
    }
    for name, args_list in cases.items():
        for args in args_list:
            compare(name, args)
    return {name: len(v) for name, v in cases.items()}


def time_kernel(name, args, n_bytes, n_ops, iters) -> dict:
    """Check the kernel on the main path's inputs, then time it and its
    plain version there; the bound is of the same work."""
    kernel, plain = _fns()[name]
    err = compare(name, args)
    ms, wall_ms = cuda_ms(lambda: kernel(*args), iters)
    plain_ms, _ = cuda_ms(lambda: plain(*args), max(1, iters // 10))
    b_ms, b_by = bound(n_bytes, n_ops)
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "wall_ms": wall_ms,
            "shape": [list(x.shape) for x in args if hasattr(x, "shape")]}


def label_case(idx, s, t, d_plane=None) -> dict:
    """Stage 1 of the pairs (s, t) on ``idx``: the kernel's name, its
    arguments reading the rows in place (the label planes for each side,
    then the endpoint ids; ``None`` where the tree's kernels take only
    gathered rows) and on rows gathered first, and the work: the bytes
    the in-place form needs (each row's ids up to and including its first
    pad, the bases, the distances of the hits, the endpoint ids and μ),
    the same with the full [Q, L] rows, the real entries and the hits.
    ``d_plane`` replaces the distance plane (``lbl_d``: a delta16 index
    with a float32 one; 4 bytes a distance either way)."""
    import inspect
    import torch
    from repro_torch.core.labels import decode_rows
    from repro_torch.core.sync import host_read
    eng = idx.engine
    sq, tq = (torch.as_tensor(x, dtype=torch.int32, device=idx.device)
              for x in (s, t))
    if eng.codec == "none":
        name, slot_bytes, base_bytes = "label_intersect_kernel", 4, 0
        planes = (eng.lbl_ids, eng.lbl_d if d_plane is None else d_plane)
    else:
        name, slot_bytes, base_bytes = "label_intersect_packed_kernel", 2, 4
        planes = (eng.enc_ids, eng.enc_base,
                  eng.enc_d if d_plane is None else d_plane)
    gathered = (*(p[e.long()] for e in (sq, tq) for p in planes), idx.n)
    in_place = "idx_s" in inspect.signature(_fns()[name][0]).parameters
    indexed = (*planes, *planes, idx.n, sq, tq) if in_place else None
    (ids_s, _), (ids_t, _) = (decode_rows(eng._rows(e), idx.n, eng.codec)
                              for e in (sq, tq))
    q, l = ids_s.shape
    real_rows = torch.stack([(x < idx.n).sum(1) for x in (ids_s, ids_t)])
    pos = torch.searchsorted(ids_t, ids_s).clamp(max=l - 1)
    hits = ((ids_t.gather(1, pos) == ids_s) & (ids_s < idx.n)).sum()
    real, slots, hits = (int(x) for x in host_read(
        (real_rows.sum(), (real_rows + 1).clamp(max=l).sum(), hits)))
    ends = 2 * q * (base_bytes + 4) + q * 4     # bases, endpoint ids, μ
    return {"name": name, "indexed": indexed, "gathered": gathered,
            "bytes": slots * slot_bytes + hits * 2 * 4 + ends,
            "bytes_full": 2 * q * l * (slot_bytes + 4) + ends,
            "ops": 2 * real, "real_entries": real, "hits": hits}


def launch_floor() -> dict:
    """Device and wall ms of the smallest launch, a one-element
    ``fill_``, under the same timing as the kernels (``cuda_ms``)."""
    import torch
    x = torch.zeros(1, device="cuda")
    ms, wall_ms = cuda_ms(lambda: x.fill_(1.0), 200)
    return {"ms": ms, "wall_ms": wall_ms}


def label_sweep(indexes) -> dict:
    """Stage 1 at ``repro``'s serving batches (SWEEP_QS) on the
    ``ell_loop`` index (fp32 rows, 10^6 vertices) and the ``compressed``
    one (delta16), on the first Q pairs of the main path: the kernel
    reading rows in place (where the tree's kernels can) and on gathered
    rows, each held ``torch.equal`` to the plain version; the plain
    version's ms; both byte bounds; and the whole μ-only lane
    (``query_mu_only`` on int32 endpoint ids on the card), device and
    wall ms a call. Runs on any tree of the port (``--label-sweep``)."""
    import torch
    out = {"floor": launch_floor(), "paths": {}}
    for path in ("ell_loop", "compressed"):
        idx, s, t = indexes[path]
        eng = idx.engine
        recs = []
        for q in SWEEP_QS:
            case = label_case(idx, s[:q], t[:q])
            kernel, plain = _fns()[case["name"]]
            rec = {"q": q, "real_entries": case["real_entries"],
                   "hits": case["hits"],
                   "bound_ms": bound(case["bytes"], case["ops"])[0],
                   "bound_ms_full_rows": bound(case["bytes_full"], 0)[0]}
            if case["indexed"] is not None:
                compare(case["name"], case["indexed"])
                rec["ms"], rec["wall_ms"] = cuda_ms(
                    lambda: kernel(*case["indexed"]), 200)
            compare(case["name"], case["gathered"])
            rec["gathered_ms"], rec["gathered_wall_ms"] = cuda_ms(
                lambda: kernel(*case["gathered"]), 200)
            rec["plain_ms"], _ = cuda_ms(lambda: plain(*case["gathered"]), 20)
            sq, tq = (torch.as_tensor(x, dtype=torch.int32, device=idx.device)
                      for x in (s[:q], t[:q]))
            if not torch.equal(eng.query_mu_only(sq, tq),
                               plain(*case["gathered"])):
                fail(f"{path}: query_mu_only differs from the plain "
                     f"intersect at Q = {q}")
            # 50 calls: a lane that gathers rows launches about nine
            # kernels a call, and more than the launch queue holds would
            # let the device wait on the host
            rec["lane_ms"], rec["lane_wall_ms"] = cuda_ms(
                lambda: eng.query_mu_only(sq, tq), 50)
            recs.append(rec)
        out["paths"][path] = {"kernel": case["name"], "batches": recs}
    return out


def csr_round_work(csr, changed, changed_out, rows: int, full: int):
    """(bytes, operations) one spmv_relax round must move and do on these
    inputs, counted per 32-byte sector as the kernel moves them: with
    ``full`` a read and a write of the whole [Vp, R] frontier (the
    output buffer holds nothing yet), else a read of each frontier
    sector whose ``changed`` bit is set and a write of each one that
    improved (``changed_out``); each in-edge (id and weight) whose source
    has some bit set, indptr, order and both masks once; an add and a
    min for each (edge, row) whose source's sector bit is set.
    ``portbench/work.py`` counts the same work per value."""
    import torch
    from repro_torch.core.sync import host_read
    from repro_torch.kernels.spmv_relax.kernel import (SECTOR_ROWS,
                                                       sector_bits)
    vp = csr.order.shape[0]
    n_tiles = changed.shape[0]
    src = csr.src.long()
    bits_in = sector_bits(changed)
    set_in, set_out, pairs, edges = (int(x) for x in host_read(torch.stack([
        bits_in.sum(dtype=torch.int64),
        sector_bits(changed_out).sum(dtype=torch.int64),
        bits_in[:, src].sum(dtype=torch.int64) * SECTOR_ROWS,
        (changed != 0).any(0)[src].sum()])))
    frontier = 2 * vp * rows * 4 if full else 32 * (set_in + set_out)
    n_bytes = (frontier + 8 * edges + (vp + 1) * 4 + vp * 4
               + 2 * 2 * n_tiles * vp)
    return n_bytes, 2 * pairs


def replay_csr(idx, s, t) -> dict:
    """Replay the query's ell_loop relaxation round by round, as
    ``relax_csr_rounds`` runs it: round 0 writes all of a fresh buffer
    (``full``), each later round writes into the buffer of the round
    before's input (``full`` 0). Each round's output, mask and flag from
    the kernel are held against the plain version's on the same inputs
    (``torch.equal``), until the first round that improves nothing; the
    count must equal the route's ``rounds``. Times the first round (at
    the seed frontier) with its plain version, every round's kernel
    against its sector-level bound (``csr_round_work``), a quiet launch
    (flag in 0) and the whole ``relax_csr_rounds`` loop on the host
    clock."""
    import torch
    from repro_torch.core.dispatch import relax_csr_rounds, seed_vertex_major
    from repro_torch.core.sync import host_read
    from repro_torch.kernels.spmv_relax.kernel import spmv_relax_kernel
    eng = idx.engine
    idx.query(s, t)              # the route's round count of these pairs
    csr = eng.relaxer.csr()
    seeds, rs, _ = label_seeds(idx, s, t)
    vp = csr.order.shape[0]
    bq = eng.relaxer.bq          # the route's row rounding
    rows = -(-2 * rs.ids.shape[0] // bq) * bq
    del rs

    def round_args(cur, changed, flag_in, out, changed_out, full):
        return (cur, csr, changed, flag_in, out, changed_out,
                torch.zeros(1, dtype=torch.int32, device=cur.device), full)

    def loop_ms():
        d0, c0 = seed_vertex_major(*seeds, vp, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, r = relax_csr_rounds(d0, c0, csr, eng.max_rounds)
        host_read(r)
        return (time.perf_counter() - t0) * 1e3

    cur, changed = seed_vertex_major(*seeds, vp, rows)
    flag_in = torch.ones(1, dtype=torch.int32, device=cur.device)
    args = round_args(cur, changed, flag_in, torch.empty_like(cur),
                      torch.empty_like(changed), 1)
    spmv_relax_kernel(*args)     # the round's changed_out, for its bound
    n_bytes, n_ops = csr_round_work(csr, changed, args[5], rows, 1)
    rec = time_kernel("spmv_relax_kernel", args, n_bytes, n_ops, iters=10)
    quiet = round_args(cur, changed, torch.zeros_like(flag_in),
                       torch.empty_like(cur), torch.empty_like(changed), 1)
    rec["quiet_ms"], rec["quiet_wall_ms"] = cuda_ms(
        lambda: spmv_relax_kernel(*quiet), 50)
    del quiet
    rounds, all_ms, all_bound, per_round = 0, 0.0, 0.0, []
    while rounds < eng.max_rounds:
        if rounds:
            args = round_args(cur, changed, flag_in, prev, prev_changed, 0)
            compare("spmv_relax_kernel", args)
        ms, _ = cuda_ms(lambda: spmv_relax_kernel(*args), 3)
        spmv_relax_kernel(*args)
        if rounds:
            n_bytes, n_ops = csr_round_work(csr, changed, args[5], rows, 0)
        b_ms, _ = bound(n_bytes, n_ops)
        prev, prev_changed = cur, changed
        cur, changed, flag_in = args[4], args[5], args[6]
        rounds += 1
        all_ms += ms
        all_bound += b_ms
        per_round.append(ms)
        if not host_read(flag_in)[0]:
            break
    if rounds != eng._last_rounds:
        fail(f"replay ran {rounds} rounds, the route counted "
             f"{eng._last_rounds}")
    del cur, changed, args, prev, prev_changed
    rec.update(
        rounds=rounds, all_rounds_ms=all_ms, all_rounds_bound_ms=all_bound,
        per_round_ms=per_round, all_rounds_wall_ms=loop_ms(), vp=vp,
        rows=rows, edges=csr.src.numel(), n_heavy=csr.n_heavy,
        max_in_degree=int(torch.diff(csr.indptr).max()))
    return rec


def profile_query(idx, s, t) -> dict:
    """One more call of the path's query under ``torch.profiler``
    (``profile_idle``): host wall time, device busy time and idle
    share, and the kernels that took most of the busy time."""
    return profile_idle(lambda: idx.query(s, t))


def clock_under_load(fn, seconds: float = 1.0) -> dict:
    """The SM clock and power draw (``nvidia-smi``) read while ``fn``
    runs back to back on the card for about ``seconds``."""
    import threading
    import torch
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()

    th = threading.Thread(target=spin)
    th.start()
    try:
        time.sleep(seconds / 2)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=60)
        time.sleep(seconds / 2)
    finally:
        stop.set()
        th.join()
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    clk, watts = (float(x) for x in smi.stdout.split(","))
    return {"clock_sm_mhz": clk, "power_draw_w": watts}


def phase_kernels(indexes, clock_max_hz: float) -> list:
    """Each kernel on the inputs its route gave it in the main path;
    ``clock_max_hz`` is the card's highest SM clock."""
    import torch
    from repro_torch.kernels.minplus_matmul.kernel import \
        minplus_matmul_kernel
    from repro_torch.kernels.spmv_relax.kernel import fused_variant
    from repro_torch.kernels.spmv_relax.ops import ell_width
    from repro_torch.kernels.spmv_relax.ref import fused_relax_ref
    out = []
    # stage 1 of the compressed and the 10^6 graph's 1024-pair queries,
    # rows read in place as the engine reads them; the sweep over the
    # serving batches beside the launch floor
    sweep = label_sweep(indexes)
    for path in ("compressed", "ell_loop"):
        idx, s, t = indexes[path]
        case = label_case(idx, s, t)
        rec = time_kernel(case["name"], case["indexed"], n_bytes=case["bytes"],
                          n_ops=case["ops"], iters=200)
        at_main = sweep["paths"][path]["batches"][-1]
        rec.update(floor_ms=sweep["floor"]["ms"],
                   floor_wall_ms=sweep["floor"]["wall_ms"],
                   bound_ms_full_rows=bound(case["bytes_full"], 0)[0],
                   real_entries=case["real_entries"], hits=case["hits"],
                   gathered_ms=at_main["gathered_ms"],
                   gathered_wall_ms=at_main["gathered_wall_ms"],
                   sweep=sweep["paths"][path]["batches"])
        if path == "compressed":
            f32 = label_case(idx, s, t, d_plane=idx.engine.lbl_d)
            f32 = time_kernel(f32["name"], f32["indexed"], n_bytes=f32["bytes"],
                              n_ops=f32["ops"], iters=200)
            rec["float32_plane"] = {k: f32[k] for k in (
                "ms", "wall_ms", "plain_ms", "bound_ms", "max_abs_err")}
        out.append(rec)

    # every ell_loop round of both ell_loop paths' queries
    out.append(replay_csr(*indexes["ell_loop"]))
    out[-1]["profile"] = profile_query(*indexes["ell_loop"])
    out[-1]["compressed_path"] = replay_csr(*indexes["compressed"])
    out[-1]["compressed_path"]["profile"] = profile_query(
        *indexes["compressed"])
    for key in ("name", "route", "source", "replaces", "launches",
                "library_ms"):
        out[-1]["compressed_path"].pop(key)

    # all rounds of the fused route's query, in every variant that takes
    # its core
    idx, s, t = indexes["fused"]
    relaxer = idx.engine.relaxer
    edges = relaxer.sliced()
    d0, _, _ = frontier(idx, s, t, edges.order.shape[0])
    mr = idx.engine.max_rounds
    _, blk = fused_relax_ref(d0, edges, mr)
    rows, v = d0.shape
    nnz = int(torch.isfinite(edges.w).sum())
    all_edges_ops = int(blk.sum()) * 8 * (2 * nnz + v)
    work = dict(n_bytes=2 * rows * v * 4 + nnz * 8 + (2 * v + 1) * 4,
                n_ops=fused_work(d0, edges, blk))
    variant = fused_variant(v)
    out.append(time_kernel("fused_relax_kernel", (d0, edges, mr, variant),
                           **work, iters=20))
    out[-1]["variants"] = {variant: out[-1]["ms"]}
    for other in fused_variants(v):
        if other != variant:
            out[-1]["variants"][other] = time_kernel(
                "fused_relax_kernel", (d0, edges, mr, other), **work,
                iters=20)["ms"]
    out[-1].update(variant=variant, block_rounds_max=int(blk.max()),
                   block_rounds_sum=int(blk.sum()), edges=nnz,
                   slots=edges.src.numel(), ops=work["n_ops"],
                   bound_ms_all_edges=bound(work["n_bytes"],
                                            all_edges_ops)[0],
                   ell_width=ell_width(v, relaxer.ce_dst, relaxer.d_width),
                   profile=profile_query(idx, s, t))

    # one round of the dense route's query
    idx, s, t = indexes["dense"]
    adj = idx.engine.relaxer.dense_adj()
    d0, _, _ = frontier(idx, s, t, adj.shape[0])
    m, k = d0.shape
    out.append(time_kernel(
        "minplus_matmul_kernel", (d0, adj),
        n_bytes=(2 * m * k + k * k) * 4, n_ops=2 * m * k * k, iters=50))
    # issue bound: an FADD and an FMNMX a term, two of the four issue
    # slots an SM has a clock (FMNMX also runs 64 a clock an SM), so 64
    # terms per SM and clock, at the clock read under this kernel's load
    load = clock_under_load(lambda: minplus_matmul_kernel(d0, adj))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = load["clock_sm_mhz"] * 1e6
    issue_ms = m * k * k / (64 * sms * clock_hz) * 1e3
    out[-1].update(issue_bound_ms=issue_ms, sms=sms,
                   issue_bound_ms_at_max_clock=m * k * k / (
                       64 * sms * clock_max_hz) * 1e3,
                   clock_max_hz=clock_max_hz, under_load=load,
                   share_of_bound=out[-1]["bound_ms"] / out[-1]["ms"],
                   share_of_issue_bound=issue_ms / out[-1]["ms"],
                   profile=profile_query(idx, s, t))
    return out


# ------------------------------------------------ the PR-24 slice's phases
ISLABEL_SEED = 24
ISLABEL_CHUNKS = 64        # serve_1m's cut: relax_chunks 0 gathers 68.7 GB
ISLABEL_STEPS = 3          # timed query steps after one warm-up
ISLABEL_CHECK_Q = 16       # queries held to the CPU bundle bitwise
BUILD_LOG2 = 24            # islabel build_16m: n = 2^24, e_cap = 2^26
DRYRUN_JOBS = 8             # the chip machine's cores
DRYRUN_MULTI = ["qwen2-moe-a2.7b:train_4k", "kimi-k2-1t-a32b:train_4k",
                "granite-8b:train_4k"]
# the same cells with compress_pods on the 512 ranks (--compress-pods)
DRYRUN_INT8 = ["granite-8b:train_4k", "qwen2-moe-a2.7b:train_4k"]
DRYRUN_TIMEOUT = 700
DRYRUN_OUT = ROOT / "experiments" / "chip_smoke"   # the script's own records
PREFETCH_STEPS = 6
DIST_LAUNCHER = ["-m", "repro_torch.launch.train", "--arch", "granite-8b",
                 "--smoke", "--steps", "20"]
# the split mesh phases: (arch, layers, batch, grad_accum), as LM_TRAIN's
MESH_TRAIN = ("granite-8b", 4, 8, 4)
MESH_TRAIN_STEPS = 3
MESH_PROMPT = 256                # prefill into the decode_32k cache
MESH_DECODE_BATCH = 8
MESH_DECODE_STEPS = 8
# the GNN and DIEN mesh steps: (arch, shape) at the published configs
MESH_GRAPH = (("gcn-cora", "full_graph_sm"), ("egnn", "molecule"),
              ("dimenet", "molecule"))
MESH_GRAPH_STEPS = 3
# train_dien's batch: at 65,536 one run needs ~80 GB; the unsharded
# run's final state waits on the host while the mesh run takes the card
MESH_DIEN_BATCH = 32768
# compress_pods at full width: (arch, layers, batch); granite as
# MESH_TRAIN's cell (grad_accum ignored: 32,768 tokens in one pass),
# qwen2-moe at 2 sequences (its update holds state, residual, gradients,
# mean and new state: ~70 GB at 2 layers)
MESH_COMPRESSED = (("granite-8b", 4, 8), ("qwen2-moe-a2.7b", 2, 2))


def islabel_inputs(shp, device, seed: int) -> dict:
    """A ``query`` cell's batch drawn on ``device`` from ``seed``: label
    rows of ``l_cap`` sorted ids below n (a row's first ``fill`` slots;
    the rest padding n, distance +inf), integer-valued fp32 distances,
    ``core_pos`` (a random tenth of the vertices, at most ``n_core``,
    in core positions; the rest ``n_core``), core edges with weights in
    1..4, and Q endpoint pairs."""
    import torch
    g = torch.Generator(device).manual_seed(seed)
    n, l_cap, n_core = shp.n_vertices, shp.l_cap, shp.n_core
    rows = -(-(n + 1) // 512) * 512
    ids = torch.randint(0, n, (rows, l_cap), generator=g, device=device,
                        dtype=torch.int32)
    ids = torch.sort(ids, dim=1).values
    fill = torch.randint(1, l_cap + 1, (rows, 1), generator=g,
                         device=device)
    pad = torch.arange(l_cap, device=device)[None, :] >= fill
    ids = torch.where(pad, n, ids)
    ids[n:] = n
    d = torch.randint(1, 64, (rows, l_cap), generator=g, device=device
                      ).to(torch.float32)
    d = torch.where(ids < n, d, float("inf"))
    core = torch.randperm(n, generator=g, device=device)[:n_core]
    core_pos = torch.full((rows,), n_core, dtype=torch.int32, device=device)
    core_pos[core] = torch.arange(n_core, dtype=torch.int32, device=device)
    e = shp.core_edges
    return {"lbl_ids": ids, "lbl_d": d, "core_pos": core_pos,
            "ce_src": torch.randint(0, n_core, (e,), generator=g,
                                    device=device, dtype=torch.int32),
            "ce_dst": torch.randint(0, n_core, (e,), generator=g,
                                    device=device, dtype=torch.int32),
            "ce_w": torch.randint(1, 5, (e,), generator=g, device=device
                                  ).to(torch.float32),
            "s": torch.randint(0, n, (shp.q_batch,), generator=g,
                               device=device, dtype=torch.int32),
            "t": torch.randint(0, n, (shp.q_batch,), generator=g,
                               device=device, dtype=torch.int32)}


def islabel_bytes(shp, rounds: int, chunks: int) -> dict:
    """A query step's bytes: ``needed`` — each input it reads once (the
    2Q label rows and their core positions, the core edges, the
    endpoints) and its output; ``moved`` — what the step's eager rounds
    move: per side and round, each chunk's gather of Q x chunk frontier
    values, its candidates written and read by the scatter-min, and the
    chunk's edges, plus the frontiers' seeding."""
    q, l_cap, e, v = shp.q_batch, shp.l_cap, shp.core_edges, shp.n_core + 1
    step = e // chunks if chunks else e
    used = step * (chunks or 1)
    needed = 2 * q * l_cap * (4 + 4 + 4) + e * 12 + 2 * q * 4 + q * 4
    per_round = 3 * q * used * 4 + used * 12 + 2 * q * v * 4
    moved = needed + 2 * (q * v * 4 + rounds * per_round)
    return {"needed_bytes": needed, "moved_bytes": moved,
            "needed_bound_ms": needed / HBM_BYTES_PER_S * 1e3,
            "moved_bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def phase_islabel_serve(tables, fused, fused_rounds: int,
                        device="cuda") -> dict:
    """``islabel``'s ``serve_1m`` query step at its published shape (the
    ``islabel_inputs`` batch, ``relax_chunks`` ``ISLABEL_CHUNKS``, 8
    rounds): ``ISLABEL_STEPS`` timed steps after a warm-up, peak device
    bytes; the first ``ISLABEL_CHECK_Q`` queries bitwise equal to the
    same bundle on the CPU on those queries; then the ``fused`` index
    (``er:10000:2.2@1``) through the bundle at a shape sized to it with
    ``relax_rounds`` past its route's rounds, equal to ``idx.query`` on
    its 1,024 pairs. No kernel of ``kernels/`` may launch."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import IndexShape
    from repro_torch.core.sync import host_read
    from repro_torch.train.steps import build_bundle
    spec = registry.get_spec("islabel")
    shp = spec.shape("serve_1m")
    ov = {"relax_chunks": ISLABEL_CHUNKS}
    zero(tables)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    batch = islabel_inputs(shp, device, ISLABEL_SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bundle = build_bundle(spec, "serve_1m", device, ov)
    torch.cuda.reset_peak_memory_stats()
    out = bundle.fn(batch)                              # warm-up
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = []
    for _ in range(ISLABEL_STEPS):
        ev[0].record()
        out = bundle.fn(batch)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated() - base
    check_launches("islabel_serve_1m", launches_of(tables), set())
    got = host_read(out)
    if got.shape != (shp.q_batch,) or np.isnan(got).any():
        fail(f"islabel_serve_1m: output {got.shape}, NaN {np.isnan(got).sum()}")
    # the first queries on the CPU: rows are independent
    qc = ISLABEL_CHECK_Q
    cpu_shp = dataclasses.replace(shp, q_batch=qc)
    cpu_spec = dataclasses.replace(spec, shapes={"serve_1m": cpu_shp})
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_batch["s"], cpu_batch["t"] = cpu_batch["s"][:qc], cpu_batch["t"][:qc]
    t0 = time.perf_counter()
    want = build_bundle(cpu_spec, "serve_1m", "cpu", ov).fn(cpu_batch).numpy()
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(got[:qc], want):
        fail(f"islabel_serve_1m: card {got[:qc]} != CPU {want}")
    med = statistics.median(ms)
    rec = {"shape": dataclasses.asdict(shp), "relax_rounds": 8,
           "relax_chunks": ISLABEL_CHUNKS,
           "cut": "relax_chunks 64 (repro's default 0 gathers a [4096, "
                  "2^22] fp32 block: 68.7 GB, twice)",
           "label_bytes": int(batch["lbl_ids"].numel() * 8),
           "frontier_bytes": int(2 * shp.q_batch * (shp.n_core + 1) * 4),
           "setup_s": setup_s, "step_ms": ms, "step_ms_median": med,
           "queries_per_s": shp.q_batch / med * 1e3,
           "peak_device_bytes": peak, "finite": int(np.isfinite(got).sum()),
           "checked_on_cpu": qc, "cpu_s": cpu_s,
           **islabel_bytes(shp, 8, ISLABEL_CHUNKS)}
    rec["moved_share_of_bound"] = rec["moved_bound_ms"] / med
    del batch, out
    torch.cuda.empty_cache()

    # the fused graph's index through the bundle: answers = idx.query
    idx, s, t = fused
    n, l_cap = idx.n, idx.lbl_ids.shape[1]
    n_core = len(idx.core_ids)
    rows = -(-(n + 1) // 512) * 512
    cpos = np.full(rows, n_core, np.int32)
    cpos[:n + 1] = idx.core_pos_host
    ids = torch.full((rows, l_cap), n, dtype=torch.int32, device=device)
    dd = torch.full((rows, l_cap), float("inf"), device=device)
    ids[:n + 1], dd[:n + 1] = idx.lbl_ids, idx.lbl_d
    fb = {"lbl_ids": ids, "lbl_d": dd,
          "core_pos": torch.from_numpy(cpos).to(device),
          "ce_src": torch.from_numpy(cpos[idx.core_src]).to(device),
          "ce_dst": torch.from_numpy(cpos[idx.core_dst]).to(device),
          "ce_w": torch.from_numpy(np.asarray(idx.core_w, np.float32)
                                   ).to(device),
          "s": torch.as_tensor(s, device=device).to(torch.int32),
          "t": torch.as_tensor(t, device=device).to(torch.int32)}
    fshp = IndexShape("fused", "query", n, l_cap, n_core,
                      len(idx.core_src), q_batch=len(fb["s"]))
    fspec = dataclasses.replace(spec, shapes={"fused": fshp})
    rounds = fused_rounds + 2
    want = host_read(idx.query(fb["s"], fb["t"]))
    zero(tables)
    got = host_read(build_bundle(fspec, "fused", device,
                                 {"relax_rounds": rounds}).fn(fb))
    check_launches("islabel_serve_1m (fused)", launches_of(tables), set())
    if not np.array_equal(got, want):
        fail(f"islabel fused: {int((got != want).sum())} answers differ "
             "from idx.query")
    rec["fused_index"] = {"n": n, "n_core": n_core,
                          "core_edges": len(idx.core_src),
                          "route_rounds": fused_rounds,
                          "relax_rounds": rounds, "pairs": len(fb["s"]),
                          "equal_to_query": True,
                          "finite": int(np.isfinite(got).sum())}
    rec["launches"] = launches_of(tables)
    return rec


def random_graph_cuda(n: int, n_und: int, seed: int, device="cuda"):
    """``n_und`` distinct undirected edges (no loops) over n vertices,
    weights 1..4, both directions, drawn on the card; host arrays."""
    import torch
    g = torch.Generator(device).manual_seed(seed)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < n_und:
        u = torch.randint(0, n, (2 * n_und,), generator=g, device=device)
        v = torch.randint(0, n, (2 * n_und,), generator=g, device=device)
        lo, hi = torch.minimum(u, v), torch.maximum(u, v)
        keys = torch.unique(torch.cat([keys, (lo * n + hi)[lo != hi]]))
    keys = keys[torch.randperm(keys.numel(), generator=g,
                               device=device)[:n_und]]
    lo, hi = keys // n, keys % n
    w = torch.randint(1, 5, (n_und,), generator=g, device=device).float()
    src = torch.cat([lo, hi]).to(torch.int32)
    dst = torch.cat([hi, lo]).to(torch.int32)
    return (src.cpu().numpy(), dst.cpu().numpy(),
            torch.cat([w, w]).cpu().numpy())


LEVEL_BYTES_PER_SLOT = 93     # a peel level's peak a candidate edge slot


def build_level_peak(n: int, e_cap: int, d_cap: int) -> int:
    """A peel level's reckoned peak: ``LEVEL_BYTES_PER_SLOT`` bytes for
    each of its candidate edge slots (the e_cap kept edges and the
    e_cap/2 x d_cap augmenting pairs that the dedup sorts), the rate
    measured at ``build_16m`` (56,086,239,232 B over 603,979,776 slots,
    92.9 B, H100 80GB HBM3); the [n+1, d_cap] neighbour planes are
    within it at this shape."""
    del n
    return LEVEL_BYTES_PER_SLOT * (e_cap + e_cap // 2 * d_cap)


def phase_islabel_build(tables, device="cuda") -> dict:
    """``islabel``'s ``build_16m``: one peel level at n = 2^BUILD_LOG2
    (e_cap 2^(BUILD_LOG2 + 2), the shape's d_cap) on a random graph of
    e_cap / 4 undirected edges (weights 1..4, drawn on the card), laid
    out by ``graphs/csr.from_host_edges``, with a seeded permutation:
    the chosen set independent, no output edge touching it, and the
    level equal to the first level of ``build_hierarchy_device``
    (``k_force=2``) on the same graph and permutation (a consistency
    check: the builder runs the same ``peel_level``). Halves n (and e_cap) until the reckoned peak fits the
    card's free memory; the cut is recorded."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.config import IndexConfig
    from repro_torch.core.hierarchy import build_hierarchy_device
    from repro_torch.core.sync import host_read
    from repro_torch.graphs import csr as gcsr
    from repro_torch.train.steps import build_bundle
    spec = registry.get_spec("islabel")
    shp = spec.shape("build_16m")
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    log2 = BUILD_LOG2
    while build_level_peak(1 << log2, 1 << (log2 + 2), shp.d_cap) \
            > 0.85 * free:
        log2 -= 1
    n, e_cap = 1 << log2, 1 << (log2 + 2)
    rec = {"published": dataclasses.asdict(shp), "n": n, "e_cap": e_cap,
           "d_cap": shp.d_cap, "reckoned_peak_bytes":
               build_level_peak(n, e_cap, shp.d_cap), "free_bytes": free,
           "cut": None if log2 == BUILD_LOG2 else f"n = 2^{log2}"}
    t0 = time.perf_counter()
    src, dst, w = random_graph_cuda(n, e_cap // 4, ISLABEL_SEED, device)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(
        ISLABEL_SEED)).to(torch.int32)
    g = gcsr.from_host_edges(src, dst, w, n, e_cap, device=device)
    rec["graph_s"] = time.perf_counter() - t0
    cell = dataclasses.replace(shp, n_vertices=n, e_cap=e_cap)
    bundle = build_bundle(dataclasses.replace(spec, shapes={"lvl": cell}),
                          "lvl", device)
    batch = {"src": g.src, "dst": g.dst, "w": g.weight, "via": g.via,
             "active": torch.ones(n, dtype=torch.bool, device=device)}
    zero(tables)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bundle.fn(batch, perm.to(device))
    torch.cuda.synchronize()
    rec["level_s"] = time.perf_counter() - t0
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - base
    check_launches("islabel_build_16m", launches_of(tables), set())
    o_src, o_dst, o_w, o_via, in_is = out
    valid = batch["src"] < n
    both = in_is[batch["src"].long().clamp(max=n - 1)] & \
        in_is[batch["dst"].long().clamp(max=n - 1)] & valid
    # the level's output edges join vertices outside the set only
    kept = o_src < n
    touch = (in_is[o_src.long().clamp(max=n - 1)] |
             in_is[o_dst.long().clamp(max=n - 1)]) & kept
    n_is, n_bad, n_out, n_touch = (int(x) for x in host_read(
        (in_is.sum(), both.sum(), kept.sum(), touch.sum())))
    if n_bad or not 0 < n_is < n:
        fail(f"islabel_build_16m: |IS| {n_is}, {n_bad} edges inside it")
    if n_touch:
        fail(f"islabel_build_16m: {n_touch} output edges touch the set")
    rec.update(is_size=n_is, edges_in=len(src), edges_out=n_out,
               out_edges_touching_is=n_touch)
    o_src, o_dst, o_w, o_via, in_is = host_read((o_src, o_dst, o_w, o_via,
                                                 in_is))
    del batch, g, out, valid, both, kept, touch
    torch.cuda.empty_cache()
    cfg = IndexConfig(k_force=2, d_cap=shp.d_cap)
    if cfg.e_cap(len(src)) != e_cap or cfg.aug_cap(len(src)) != e_cap // 2:
        fail("islabel_build_16m: the builder's capacities differ")
    t0 = time.perf_counter()
    hier = build_hierarchy_device(n, src, dst, w, cfg, device,
                                  perms=iter([perm]))
    rec["builder_s"] = time.perf_counter() - t0
    lvl_is = hier.level == 1
    keep = o_src < n
    mine = np.lexsort((o_dst[keep], o_src[keep]))
    theirs = np.lexsort((hier.core_dst, hier.core_src))
    same = (np.array_equal(in_is, lvl_is) and hier.level_sizes[:1] == [n_is]
            and all(np.array_equal(a[keep][mine], b[theirs]) for a, b in (
                (o_src, hier.core_src), (o_dst, hier.core_dst),
                (o_w, hier.core_w), (o_via, hier.core_via))))
    if not same:
        fail("islabel_build_16m: the level differs from the builder's")
    rec["equal_to_builder_level"] = True
    rec["launches"] = launches_of(tables)
    return rec


def prefetch_stream_profile(fn) -> dict:
    """``fn()`` under ``torch.profiler``: the CUDA streams of the trace's
    host-to-device copies and of its kernels (chrome-trace ``tid``s)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    h2d, kern = {}, {}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "gpu_memcpy" and "HtoD" in name:
            h2d[e.get("tid")] = h2d.get(e.get("tid"), 0) + 1
        elif cat == "kernel":
            kern[e.get("tid")] = kern.get(e.get("tid"), 0) + 1
    return {"h2d_copies_by_stream": {str(k): v for k, v in h2d.items()},
            "kernels_by_stream": {str(k): v for k, v in kern.items()}}


def phase_prefetch(tables, device="cuda") -> dict:
    """granite-8b's train cell (4 layers, 8 x 4,096 tokens, ``grad_accum``
    4) fed through ``PrefetchPipeline(depth=2)`` from pinned host
    batches for ``PREFETCH_STEPS`` steps: the losses bitwise equal to
    the same steps fed directly (uploaded by ``make_batch_fn``) from the
    same state, a ``reset`` seek returning the same batch, and a profile
    of two prefetched steps whose host-to-device copies run on a stream
    the step's kernels do not use; step ms of both runs."""
    import numpy as np
    import torch
    from repro_torch.core.sync import host_read
    from repro_torch.data import PrefetchPipeline, synthetic
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.train.steps import build_bundle
    spec = lm_train_spec("granite-8b", 4, 8)
    shp = spec.shape("train_4k")
    torch.cuda.empty_cache()
    bundle = build_bundle(spec, "train_4k", device, {"grad_accum": 4})
    state0 = init_state(spec, bundle)
    direct = make_batch_fn(spec, "train_4k", device=device)

    def host_batch(step):
        return synthetic.lm_batch(0, step, shp.global_batch, shp.seq_len,
                                  spec.model_cfg.vocab)

    def run(get):
        state, losses, ms = state0, [], []
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for i in range(PREFETCH_STEPS):
            ev[0].record()
            state, m = bundle.fn(state, get(i))
            ev[1].record()
            losses.append(m["loss"])
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        return [float(x) for x in host_read(tuple(losses))], ms, state

    zero(tables)
    want, ms_direct, _ = run(direct)
    pipe = PrefetchPipeline(host_batch, depth=2, device=device)
    got, ms_pipe, state = run(pipe)
    if got != want or not all(np.isfinite(got)):
        fail(f"prefetch: losses {got} != direct {want}")
    seek = pipe(3)
    again = pipe(3)
    b3 = direct(3)
    same = all(torch.equal(seek[k], b3[k]) and torch.equal(again[k], b3[k])
               for k in b3)
    if not same:
        fail("prefetch: a reset seek returned another batch")

    def two():
        nonlocal state
        pipe.reset(PREFETCH_STEPS)
        for i in range(2):
            state, m = bundle.fn(state, pipe(PREFETCH_STEPS + i))
        host_read(m["loss"])
    streams = prefetch_stream_profile(two)
    pipe.stop()
    kern = set(streams["kernels_by_stream"])
    if not streams["h2d_copies_by_stream"] or \
            set(streams["h2d_copies_by_stream"]) & kern:
        fail(f"prefetch: copies not on a side stream {streams}")
    check_launches("prefetch", launches_of(tables), set())
    del state, state0
    torch.cuda.empty_cache()
    return {"steps": PREFETCH_STEPS, "losses": got,
            "equal_to_direct": True, "seek_equal": True,
            "step_ms_direct": ms_direct, "step_ms_prefetch": ms_pipe,
            "step_ms_median_direct": statistics.median(ms_direct[1:]),
            "step_ms_median_prefetch": statistics.median(ms_pipe[1:]),
            **streams}


def mesh_lm_train(mesh, dev) -> dict:
    """granite-8b at full width cut to ``MESH_TRAIN``'s layers and batch
    (``train_lm_granite-8b``'s cell): ``MESH_TRAIN_STEPS`` steps of the
    unsharded bundle, then of the mesh bundle (the compute split over
    ``model``) from the same state; the losses and the final states
    compared on the card, leaf by leaf (each rank's block of a DTensor
    against the same block of the unsharded leaf: ``unequal_leaves``)."""
    import torch
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.train.steps import build_bundle
    arch, layers, batch, accum = MESH_TRAIN
    spec = lm_train_spec(arch, layers, batch)
    ov = {"grad_accum": accum, "warmup": 1}
    t0 = time.perf_counter()
    plain = build_bundle(spec, "train_4k", dev, ov)
    sharded = build_bundle(spec, "train_4k", dev, ov, mesh)
    state0 = init_state(spec, plain)
    mb = make_batch_fn(spec, "train_4k", device=dev)
    torch.cuda.synchronize()
    out, secs = {}, {"setup": time.perf_counter() - t0}
    for tag, bundle in (("plain", plain), ("mesh", sharded)):
        st = state0 if tag == "plain" else sharded.place_state(state0)
        losses = []
        t0 = time.perf_counter()
        for i in range(MESH_TRAIN_STEPS):
            batch_i = mb(i) if tag == "plain" else sharded.place_batch(mb(i))
            st, m = bundle.fn(st, batch_i)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        out[tag] = (losses, st)
    del state0
    (la, sa), (lb, sb) = out["plain"], out["mesh"]
    t0 = time.perf_counter()
    unequal = unequal_leaves(sharded, sa, sb, dev)
    secs["compare"] = time.perf_counter() - t0
    del out, sa, sb
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": layers, "batch": batch, "accum": accum,
            "losses_plain": la, "losses_mesh": lb, "seconds": secs,
            "bitwise": la == lb and not unequal, "unequal_leaves": unequal}


def mesh_lm_serve(mesh, dev) -> dict:
    """granite-8b at full width cut to ``MESH_TRAIN``'s layers, bf16
    weights: a ``MESH_PROMPT``-token prefill at ``MESH_DECODE_BATCH``
    into the decode_32k cache, then ``MESH_DECODE_STEPS`` greedy decode
    steps, by the unsharded bundles and by the mesh bundles (the cache's
    sequence over ``model``); the greedy tokens compared."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.train import init_state
    from repro_torch.train.steps import build_bundle
    arch, layers = MESH_TRAIN[:2]
    spec = registry.get_spec(arch)
    spec = dataclasses.replace(spec, param_dtype="bfloat16",
                               model_cfg=dataclasses.replace(
                                   spec.model_cfg, n_layers=layers))
    cfg = spec.model_cfg
    g = torch.Generator(dev).manual_seed(25)
    prompt = torch.randint(0, cfg.vocab, (MESH_DECODE_BATCH, MESH_PROMPT),
                           generator=g, device=dev)
    params = None
    toks, logits_all, secs = {}, {}, {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        pre = build_bundle(spec, "prefill_32k", dev, mesh=m)
        dec = build_bundle(spec, "decode_32k", dev, mesh=m)
        if params is None:
            params = init_state(spec, pre)["params"]
        p = params if m is None else pre.place_state(
            {"params": params})["params"]
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = pre.fn(p, pre.place_batch({"tokens": prompt}))
            seq, lg = [], []
            for i in range(MESH_DECODE_STEPS + 1):
                full = logits.full_tensor() if m is not None else logits
                nxt = full.argmax(-1)
                seq.append(nxt)
                lg.append(full)
                if i == MESH_DECODE_STEPS:
                    break
                last = nxt if m is None else shd.place(
                    nxt, dec.shardings["batch"]["last_tokens"])
                logits, cache = dec.fn(p, cache, last)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        toks[tag] = torch.cat(seq, 1).cpu()
        logits_all[tag] = torch.stack(lg)
        del cache, logits, p
        torch.cuda.empty_cache()
    top = float(logits_all["plain"].abs().max())
    return {"arch": arch, "layers": layers, "batch": MESH_DECODE_BATCH,
            "prompt": MESH_PROMPT, "steps": MESH_DECODE_STEPS,
            "tokens_equal": bool(torch.equal(toks["plain"], toks["mesh"])),
            "logits_max_abs_diff_rel": float(
                (logits_all["plain"] - logits_all["mesh"]).abs().max()) / top,
            "seconds": secs}


def unequal_leaves(sharded, plain_state, mesh_state, dev) -> list:
    """The leaves of ``mesh_state`` (``sharded``'s, a mesh bundle's) that
    differ from the unsharded ``plain_state``'s: each rank's block
    against the same block of the unsharded leaf, compared on the card
    (``torch.equal``), one leaf at a time (a leaf on the host is
    uploaded for its compare)."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.tree import flatten_with_paths
    out = []
    for (k, a), (_, sh), (_, b) in zip(
            flatten_with_paths(plain_state),
            flatten_with_paths(sharded.shardings["state"]),
            flatten_with_paths(mesh_state)):
        if not torch.equal(shd.local(shd.place(a.to(dev), sh)),
                           shd.local(b)):
            out.append(k)
    return out


def mesh_graph_step(mesh, dev, arch: str, shape: str) -> dict:
    """``arch`` on ``shape`` at its published config: ``MESH_GRAPH_STEPS``
    steps of the unsharded bundle, then of the mesh bundle (the nodes
    and edges in blocks over every axis) from the same state on the
    same batches; the losses and the final states compared on the card;
    each run's seconds and peak device bytes above what it started
    with."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.train.steps import build_bundle
    spec = registry.get_spec(arch)
    plain = build_bundle(spec, shape, dev)
    sharded = build_bundle(spec, shape, dev, None, mesh)
    state0 = init_state(spec, plain)
    make = make_batch_fn(spec, shape, device=dev)
    batches = [make(i) for i in range(MESH_GRAPH_STEPS)]
    rec = {"arch": arch, "shape": shape, "steps": MESH_GRAPH_STEPS}
    states = {}
    for tag, bundle in (("plain", plain), ("mesh", sharded)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        st = state0 if tag == "plain" else sharded.place_state(state0)
        losses = []
        for b in batches:
            st, m = bundle.fn(st, b if tag == "plain" else
                              sharded.place_batch(b))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        rec[f"seconds_{tag}"] = time.perf_counter() - t0
        rec[f"peak_bytes_{tag}"] = torch.cuda.max_memory_allocated() - base
        rec[f"losses_{tag}"] = losses
        states[tag] = st
    rec["unequal_leaves"] = unequal_leaves(sharded, states["plain"],
                                           states["mesh"], dev)
    rec["bitwise"] = rec["losses_plain"] == rec["losses_mesh"] and not \
        rec["unequal_leaves"]
    rec["finite"] = all(math.isfinite(x) for x in rec["losses_mesh"])
    del states, state0, batches
    torch.cuda.empty_cache()
    return rec


def mesh_dien(mesh, dev) -> dict:
    """DIEN at its published widths and tables (2^26 / 10,000 / 2^22
    rows), ``MESH_DIEN_BATCH`` a step: one ``serve_p99`` and one
    ``retrieval_cand`` call through the unsharded and the mesh bundles
    (each table read from its ``model`` blocks) on the initial
    parameters, outputs compared on the card; then ``MESH_GRAPH_STEPS``
    train steps of each from the same state on the same batches, the
    unsharded run's final state kept on the host while the mesh run
    holds the card; losses and final states compared on the card."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import RecShape
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.train.steps import build_bundle
    from repro_torch.tree import tree_map
    spec = registry.get_spec("dien")
    spec = dataclasses.replace(spec, shapes={
        **spec.shapes, "train_batch": RecShape("train_batch", "train",
                                               MESH_DIEN_BATCH)})
    cfg = spec.model_cfg
    rec = {"batch": MESH_DIEN_BATCH, "steps": MESH_GRAPH_STEPS}
    plain = build_bundle(spec, "train_batch", dev)
    sharded = build_bundle(spec, "train_batch", dev, None, mesh)
    state0 = init_state(spec, plain)
    for shape, kind in (("serve_p99", "serve"),
                        ("retrieval_cand", "retrieval")):
        req = dien_request(cfg, kind, spec.shapes[shape].batch, dev)
        outs = {}
        for tag, m in (("plain", None), ("mesh", mesh)):
            sb = build_bundle(spec, shape, dev, None, m)
            p = state0["params"] if m is None else \
                sb.place_state({"params": state0["params"]})["params"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sb.fn(p, sb.place_batch(req))
            torch.cuda.synchronize()
            rec[f"{kind}_ms_{tag}"] = (time.perf_counter() - t0) * 1e3
            outs[tag] = out.full_tensor() if m is not None else out
        rec[f"{kind}_equal"] = bool(torch.equal(outs["plain"], outs["mesh"]))
        rec[f"{kind}_finite"] = bool(torch.isfinite(outs["plain"]).all())
        del outs, req
    make = make_batch_fn(spec, "train_batch", device=dev)
    final = {}
    for tag, bundle in (("plain", plain), ("mesh", sharded)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        st = state0 if tag == "plain" else sharded.place_state(state0)
        losses = []
        for i in range(MESH_GRAPH_STEPS):
            b = make(i)
            st, m = bundle.fn(st, b if tag == "plain" else
                              sharded.place_batch(b))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        rec[f"seconds_{tag}"] = time.perf_counter() - t0
        rec[f"peak_bytes_{tag}"] = torch.cuda.max_memory_allocated() - base
        rec[f"losses_{tag}"] = losses
        # the unsharded run's state waits on the host
        final[tag] = tree_map(lambda x: x.cpu(), st) if tag == "plain" \
            else st
        del st, m, b
    t0 = time.perf_counter()
    rec["unequal_leaves"] = unequal_leaves(sharded, final["plain"],
                                           final["mesh"], dev)
    rec["compare_s"] = time.perf_counter() - t0
    rec["bitwise"] = rec["losses_plain"] == rec["losses_mesh"] and not \
        rec["unequal_leaves"] and rec["serve_equal"] and \
        rec["retrieval_equal"]
    rec["finite"] = all(math.isfinite(x) for x in rec["losses_mesh"]) and \
        rec["serve_finite"] and rec["retrieval_finite"]
    del final, state0
    torch.cuda.empty_cache()
    return rec


def mesh_lm_compressed(mesh, dev, arch: str, layers: int,
                       batch: int) -> dict:
    """``compress_pods`` at full width: ``arch`` cut to ``layers``, its
    ``train_4k`` cell at ``batch`` sequences (``grad_accum`` ignored, as
    ``repro``'s compressed step ignores it), ``MESH_TRAIN_STEPS`` steps
    on the ``(pod, data, model)`` mesh against the unsharded step whose
    gradients go through the plain quantize -> dequantize with error
    feedback (at one pod that is the compressed mean): losses, gradient
    norms and every leaf of the state, ``err`` included, compared on
    the card. Beside it the plain mesh step (no ``compress_pods``) on
    the same mesh. Each run's seconds and peak device bytes above what
    it started with, and each step's seconds (the first holds the
    run's first-call costs). Each run draws the initial state anew on
    the card (the same seeded draw), and the unsharded run's final state
    waits in host memory while the compressed run holds the card
    (qwen2-moe's state and residual are 28 GB)."""
    import torch
    from repro_torch.distributed.compression import (dequantize_int8,
                                                     init_error_feedback,
                                                     quantize_int8)
    from repro_torch.launch.train import init_state, make_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import _value_and_grad, build_bundle
    from repro_torch.tree import tree_map
    spec = lm_train_spec(arch, layers, batch)
    cfg = spec.model_cfg
    ov = {"warmup": 1, "grad_accum": 4}
    comp = build_bundle(spec, "train_4k", dev, dict(ov, compress_pods=True),
                        mesh)
    plain_mesh = build_bundle(spec, "train_4k", dev, dict(ov, grad_accum=1),
                              mesh)
    single = build_bundle(spec, "train_4k", dev, dict(ov, grad_accum=1))
    opt = single.optimizer
    grad_fn = _value_and_grad(lambda p, b: T.lm_loss(
        p, cfg, b["tokens"], b["targets"]))

    def one(g, e):
        gf = g.to(torch.float32) + e[0]
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
        q = quantize_int8(gf, scale)
        return (torch.mean(dequantize_int8(q[None], scale), dim=0).to(
            g.dtype), (gf - dequantize_int8(q, scale))[None])

    def reference(state, batch):
        loss, grads = grad_fn(state["params"], batch)
        out = tree_map(one, grads, state["err"])
        del grads
        new_p, new_opt, gnorm = opt.update(
            tree_map(lambda o: o[0], out), state["opt"], state["params"],
            state["step"])
        return ({"params": new_p, "opt": new_opt,
                 "err": tree_map(lambda o: o[1], out),
                 "step": state["step"] + 1}, {"loss": loss, "gnorm": gnorm})

    def initial(err: bool):
        state = init_state(spec, single)
        if err:
            state["err"] = init_error_feedback(state["params"],
                                               comp.static_meta["n_pods"])
        return state

    make = make_batch_fn(spec, "train_4k", device=dev)
    rec = {"arch": arch, "layers": layers, "batch": batch,
           "steps": MESH_TRAIN_STEPS, "mesh": list(mesh.shape),
           "grad_accum_asked": ov["grad_accum"],
           "grad_accum_run": comp.static_meta["grad_accum"]}
    final = {}
    for tag, bundle, fn in (("unsharded_int8", None, reference),
                            ("compressed", comp, comp.fn),
                            ("plain_mesh", plain_mesh, plain_mesh.fn)):
        t0 = time.perf_counter()
        state = initial(tag != "plain_mesh")
        if bundle is not None:
            state = bundle.place_state(state)
        torch.cuda.synchronize()
        rec[f"setup_s_{tag}"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        losses, gnorms, step_s = [], [], []
        for i in range(MESH_TRAIN_STEPS):
            b = make(i)
            state, m = fn(state, b if bundle is None else
                          bundle.place_batch(b))
            losses.append(m["loss"])
            gnorms.append(m["gnorm"])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0 - sum(step_s))
        rec[f"seconds_{tag}"] = time.perf_counter() - t0
        rec[f"step_s_{tag}"] = step_s
        rec[f"peak_bytes_{tag}"] = torch.cuda.max_memory_allocated() - base
        rec[f"losses_{tag}"] = [float(x) for x in losses]
        rec[f"gnorms_{tag}"] = [float(x) for x in gnorms]
        if tag == "unsharded_int8":       # waits on the host
            t0 = time.perf_counter()
            final[tag] = tree_map(lambda x: x.cpu(), state)
            rec["park_s"] = time.perf_counter() - t0
        elif tag == "compressed":
            t0 = time.perf_counter()
            rec["unequal_leaves"] = unequal_leaves(
                comp, final.pop("unsharded_int8"), state, dev)
            rec["compare_s"] = time.perf_counter() - t0
        del state, m, b, losses, gnorms
        torch.cuda.empty_cache()
    rec["bitwise"] = not rec["unequal_leaves"] and all(
        rec[f"{k}_compressed"] == rec[f"{k}_unsharded_int8"]
        for k in ("losses", "gnorms"))
    rec["finite"] = all(math.isfinite(x) for x in rec["losses_compressed"])
    return rec


def dist_main() -> int:
    """``chip_smoke.py --distributed`` under ``torchrun`` (one process a
    card, NCCL, deterministic algorithms): granite-8b's smoke train step
    over ``make_host_mesh`` against the unsharded step from the same
    state (bitwise at one rank, rtol 1e-5 above), granite-8b at full
    width through the mesh path (``mesh_lm_train``: bitwise at one rank;
    ``mesh_lm_serve``: greedy tokens equal), the GNNs and DIEN through
    theirs (``mesh_graph_step``, ``mesh_dien``: bitwise at one rank,
    losses within 1e-4 above), ``compress_pods`` at full width
    (``mesh_lm_compressed``: bitwise at one rank), ``compressed_psum_pod``
    over a ``pod`` mesh of every rank against its one-device form, and
    ``lookup_mod_sharded`` against the same arithmetic on the whole
    table. Rank 0 prints one line."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.checkpoint.checkpoint import snapshot
    from repro_torch.configs import registry
    from repro_torch.distributed.compression import (compressed_psum_pod,
                                                     dequantize_int8,
                                                     quantize_int8)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import init_state, make_batch_fn, smoke_spec
    from repro_torch.models.embedding import lookup, lookup_mod_sharded
    from repro_torch.train.steps import build_bundle
    from repro_torch.tree import flatten_with_paths
    t0 = time.perf_counter()
    # bitwise at one rank: the embedding's backward sums in atomics'
    # order unless the algorithms are deterministic
    torch.use_deterministic_algorithms(True)
    mesh = make_host_mesh(1, "cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = smoke_spec(registry.get_spec("granite-8b"))
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(
        spec.model_cfg, dtype="float32"))
    plain = build_bundle(spec, "train_4k", dev, {"warmup": 1})
    sharded = build_bundle(spec, "train_4k", dev, {"warmup": 1}, mesh)
    state = init_state(spec, plain)
    mb = make_batch_fn(spec, "train_4k", device=dev)
    a, b = state, sharded.place_state(state)
    la, lb = [], []
    for i in range(3):
        a, ma = plain.fn(a, mb(i))
        b, mbm = sharded.fn(b, sharded.place_batch(mb(i)))
        la.append(float(ma["loss"]))
        lb.append(float(mbm["loss"]))
    sa, sb = dict(flatten_with_paths(snapshot(a))), dict(
        flatten_with_paths(snapshot(b)))
    if world == 1:
        step_ok = la == lb and all(np.array_equal(sa[k], sb[k]) for k in sa)
    else:
        step_ok = np.allclose(la, lb, rtol=1e-5) and all(
            np.allclose(sa[k], sb[k], rtol=1e-5, atol=1e-5) for k in sa)
    del a, b, state, sa, sb
    full_train = mesh_lm_train(mesh, dev)
    full_serve = mesh_lm_serve(mesh, dev)
    # bitwise at one rank; several ranks sum in other orders
    full_ok = full_serve["tokens_equal"] and (
        full_train["bitwise"] if world == 1 else np.allclose(
            full_train["losses_plain"], full_train["losses_mesh"],
            rtol=1e-3))
    # the GNNs (nodes and edges in blocks) and DIEN (tables by row block)
    graph = [mesh_graph_step(mesh, dev, a, sh) for a, sh in MESH_GRAPH]
    graph.append(mesh_dien(mesh, dev))
    graph_ok = all(r["finite"] and (r["bitwise"] if world == 1 else
                                    np.allclose(r["losses_plain"],
                                                r["losses_mesh"], rtol=1e-4))
                   for r in graph)
    # compress_pods at full width on a (pod, data, model) mesh, one pod a
    # card: bitwise the unsharded step through quantize -> dequantize at
    # one pod
    pm3 = init_device_mesh("cuda", (world, 1, 1),
                           mesh_dim_names=("pod", "data", "model"))
    compressed = [mesh_lm_compressed(pm3, dev, *c) for c in MESH_COMPRESSED]
    compressed_ok = all(r["finite"] and (r["bitwise"] or world > 1)
                        for r in compressed)
    # int8 across a pod axis of every rank, against its one-device form
    pm = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    r = np.random.default_rng(5)
    g_all = torch.from_numpy((r.standard_normal((world, 4099)) * 2).astype(
        np.float32)).to(dev)
    e_all = torch.from_numpy((r.standard_normal((world, 4099)) * .01).astype(
        np.float32)).to(dev)
    mean, err = compressed_psum_pod({"a": g_all[rank]}, {"a": e_all[rank]},
                                    pm)
    gf = g_all + e_all
    scale = gf.abs().max() / 127.0 + 1e-12
    q = quantize_int8(gf, scale)
    comp_ok = torch.equal(mean["a"], dequantize_int8(q, scale).mean(0)) and \
        torch.equal(err["a"], (gf - dequantize_int8(q, scale))[rank])
    # the mod-sharded lookup over a "model" axis of every rank
    mm = init_device_mesh("cuda", (world,), mesh_dim_names=("model",))
    n = 64 * world
    table = torch.arange(n * 8, dtype=torch.float32, device=dev).view(n, 8)
    ids = torch.tensor([0, 1, 5, n - 1, n, n + 3, -1, -2, -n, -n - 1],
                       device=dev)
    got = lookup_mod_sharded(distribute_tensor(table, mm, [Shard(0)],
                                               src_data_rank=None), ids, mm)
    k = n // world
    local = torch.div(ids, world, rounding_mode="floor")
    want = lookup(table, torch.remainder(ids, world) * k
                  + torch.remainder(local, k))
    want = torch.where(((local >= -k) & (local < k))[:, None], want,
                       float("nan"))
    look_ok = torch.equal(torch.nan_to_num(got, nan=-1.0),
                          torch.nan_to_num(want, nan=-1.0))
    flags = torch.tensor([int(step_ok), int(comp_ok), int(look_ok),
                          int(full_ok), int(graph_ok), int(compressed_ok)],
                         device=dev)
    dist.all_reduce(flags, dist.ReduceOp.MIN)
    if rank == 0:
        emit({"world": world, "backend": dist.get_backend(),
              "mesh": list(mesh.shape), "losses_plain": la,
              "losses_mesh": lb, "step_equal": bool(flags[0]),
              "compressed_equal": bool(flags[1]),
              "mod_lookup_equal": bool(flags[2]),
              "full_width_ok": bool(flags[3]), "full_train": full_train,
              "full_serve": full_serve, "graph_ok": bool(flags[4]),
              "graph": graph, "compressed_steps_ok": bool(flags[5]),
              "compressed_steps": compressed,
              "seconds": time.perf_counter() - t0})
    dist.destroy_process_group()
    return 0 if bool(flags.all()) else 1


def phase_distributed() -> dict:
    """``dist_main`` under ``torchrun --nproc-per-node=<cards>`` and,
    beside it, ``torchrun ... -m repro_torch.launch.train --arch
    granite-8b --smoke --steps 20``; both must exit 0."""
    import os
    import tempfile

    import torch
    torch.cuda.empty_cache()          # the ranks' NCCL setup needs room
    count = torch.cuda.device_count()
    # the compressed qwen2-moe step holds ~70 GB: segments that grow
    # keep the freed ones of earlier checks from fragmenting the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={count}"]
    # the launcher's torchrun beside the checks' (an exit code to check)
    ckpt = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    launch = subprocess.Popen(run + DIST_LAUNCHER + ["--ckpt-dir", ckpt.name],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True)
    atexit.register(stop_groups, [launch])
    checks = subprocess.run(run + [str(Path(__file__).resolve()),
                                   "--distributed"], cwd=ROOT, env=env,
                            capture_output=True, text=True, timeout=600)
    checks_s = time.perf_counter() - t0
    lines = [ln for ln in checks.stdout.splitlines() if ln.startswith("{")]
    if checks.returncode or not lines:
        err = checks.stderr
        first = err.find("Traceback")
        fail(f"distributed checks exited {checks.returncode}: "
             f"{checks.stdout[-1500:]} {err[first:first + 3000]}")
    rec = json.loads(lines[-1])
    try:
        out, err = launch.communicate(timeout=600)
    finally:
        stop_groups([launch])
        ckpt.cleanup()
    if launch.returncode:
        fail(f"torchrun launcher exited {launch.returncode}: {err[-3000:]}")
    return {"cards": count, "checks": rec, "checks_s": checks_s,
            "launcher_s": time.perf_counter() - t0,
            "launcher_tail": out.strip().splitlines()[-4:]}


def start_dryrun() -> list:
    """The dry run's processes, started together (CPU only, on the fake
    process group, after the timed phases): ``--all --include-islabel
    --multipod single`` with ``DRYRUN_JOBS`` workers, ``--multipod
    multi`` on each ``DRYRUN_MULTI`` cell and ``--multipod multi --compress-pods`` on
    each ``DRYRUN_INT8`` cell (records under ``DRYRUN_OUT / "dryrun"``),
    and ``launch.perf --cell islabel:serve_128m`` (``DRYRUN_OUT /
    "perf"``)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    import shutil
    out = DRYRUN_OUT / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(DRYRUN_OUT / "perf", ignore_errors=True)
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
            str(out)]
    cmds = [base + ["--all", "--include-islabel", "--multipod", "single",
                    "--jobs", str(DRYRUN_JOBS)]]
    for cell in DRYRUN_MULTI:
        arch, shape = cell.split(":")
        cmds.append(base + ["--arch", arch, "--shape", shape, "--multipod",
                            "multi"])
    for cell in DRYRUN_INT8:
        arch, shape = cell.split(":")
        cmds.append(base + ["--arch", arch, "--shape", shape, "--multipod",
                            "multi", "--compress-pods"])
    cmds.append([sys.executable, "-m", "repro_torch.launch.perf", "--cell",
                 "islabel:serve_128m", "--out",
                 str(DRYRUN_OUT / "perf")])
    procs = [(c, time.perf_counter(), subprocess.Popen(
        c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, start_new_session=True))
        for c in cmds]
    atexit.register(stop_groups, [p for _, _, p in procs])
    return procs


def stop_groups(procs) -> None:
    """Kill each process's group (its pool workers too) if it still
    runs: a failed phase exits without waiting for the dry run."""
    import os
    import signal
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def phase_dryrun(procs) -> dict:
    """Wait for ``start_dryrun``'s processes (each must exit 0, every
    cell ``ok``); per cell FLOPs, bytes, collective bytes by kind,
    argument and peak bytes per device, whether that peak fits 80 GB,
    and the dominant term (``lm_cells``: the LM cells' FLOPs, peak,
    ``fits_80gb`` and collective bytes by kind; ``int8pods``: each
    ``DRYRUN_INT8`` cell plain and with ``compress_pods``); the perf
    variants' lines."""
    cells, secs, outs = [], [], []
    for cmd, t0, p in procs:
        try:
            out, _ = p.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            fail(f"dryrun {cmd[5:]} ran past {DRYRUN_TIMEOUT} s")
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        if p.returncode:
            fail(f"dryrun {cmd[3:]} exited {p.returncode}: {out[-2000:]}")
    out_dir = DRYRUN_OUT / "dryrun"
    for f in sorted(out_dir.glob("*.json")):
        r = json.loads(f.read_text())
        if not r.get("ok"):
            fail(f"dryrun cell {f.name}: {r.get('error')}")
        cells.append({k: r[k] for k in (
            "arch", "shape", "mesh", "flops_per_device", "bytes_per_device",
            "argument_bytes_per_device", "peak_bytes_per_device",
            "fits_80gb", "dominant", "t_compute_s", "t_memory_s",
            "t_collective_s", "collective_bytes_per_device")})
        cells[-1]["int8pods"] = bool(r["overrides"].get("compress_pods"))
    if len(cells) != 38 + len(DRYRUN_MULTI) + len(DRYRUN_INT8):
        fail(f"dryrun: {len(cells)} cell records")
    # compress_pods under the split: within 10% of the plain 512-rank
    # cell's FLOPs or below, and within a card
    int8 = []
    for cell in DRYRUN_INT8:
        arch, shape = cell.split(":")
        got = [c for c in cells if (c["arch"], c["shape"]) == (arch, shape)
               and c["mesh"] == "2x16x16"]
        plain = [c for c in got if not c["int8pods"]]
        comp = [c for c in got if c["int8pods"]]
        if len(plain) != 1 or len(comp) != 1:
            fail(f"dryrun: {cell} lacks its multipod records")
        plain, comp = plain[0], comp[0]
        row = {"arch": arch, "shape": shape,
               "plain": {k: plain[k] for k in (
                   "flops_per_device", "peak_bytes_per_device", "fits_80gb",
                   "collective_bytes_per_device")},
               "after": {k: comp[k] for k in (
                   "flops_per_device", "peak_bytes_per_device", "fits_80gb",
                   "collective_bytes_per_device")}}
        int8.append(row)
        if not comp["fits_80gb"] or comp["flops_per_device"] > \
                1.1 * plain["flops_per_device"]:
            fail(f"dryrun: {cell} with compress_pods {row}")
    from repro_torch.configs import registry
    lm = [{k: c[k] for k in ("arch", "shape", "mesh", "int8pods",
                             "flops_per_device", "peak_bytes_per_device",
                             "fits_80gb", "collective_bytes_per_device")}
          for c in cells if registry.get_spec(c["arch"]).family == "lm"]
    return {"cells": cells, "lm_cells": lm, "int8pods": int8,
            "process_s": secs,
            "perf": [ln for ln in outs[-1].splitlines()
                     if ln.startswith("[")]}


def sweep_main(src: Path) -> int:
    """``--label-sweep SRC``: build the four paths' indexes with the port
    found under ``SRC`` (this tree's ``src`` or an unpacked older
    commit's), run ``label_sweep`` and print it as one line with each
    path's query times, so two trees' label kernels, μ-only lanes and
    queries can be timed in one call on one card."""
    dev = phase_device()
    emit({"phase": "build", **phase_build()})
    indexes, queries = {}, {}
    for path, route, spec, gen_call, overrides, _ in PATHS:
        rec, idx, s, t, _ = drive_route(route, spec, gen_call, overrides,
                                        "cuda")
        indexes[path] = (idx, s, t)
        queries[path] = {k: rec[k] for k in ("rounds", "query_ms",
                                             "query_ms_median",
                                             "query_ms_repeats")}
    emit({"label_sweep": label_sweep(indexes), "queries": queries,
          "src": str(src),
          "uncovered_timings": UNCOVERED[0], "power_limit": dev["smi"]})
    return 0


def main_lm(tables) -> None:
    """The LM phases: ``lm_<arch>`` for ``LM_FULL``, ``lm_width``,
    ``lm_cpu`` and ``lm_launcher``."""
    for arch, decode_batch in LM_FULL:
        t0 = time.perf_counter()
        rec = phase_lm(arch, decode_batch, tables)
        emit({"phase": f"lm_{arch}", "seconds": time.perf_counter() - t0,
              **rec})
    for name, fn in (("lm_width", lambda: phase_lm_width(tables)),
                     ("lm_cpu", lambda: phase_lm_cpu(tables)),
                     ("lm_launcher", phase_lm_launcher)):
        t0 = time.perf_counter()
        rec = fn()
        emit({"phase": name, "seconds": time.perf_counter() - t0, **rec})


def main_lm_train(tables) -> None:
    """The LM training phases: ``train_lm_<arch>`` for ``LM_TRAIN``,
    ``train_lm_checks``, ``train_lm_smoke`` and ``prefetch``. cuBLAS gets a fixed
    workspace before its first product (deterministic algorithms need
    one: ``train_lm_smoke``)."""
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    for arch, layers, batch, accum in LM_TRAIN:
        t0 = time.perf_counter()
        rec = phase_lm_train(arch, layers, batch, accum, tables)
        emit({"phase": f"train_lm_{arch}",
              "seconds": time.perf_counter() - t0, **rec})
    for name, fn in (("train_lm_checks", phase_lm_train_checks),
                     ("train_lm_smoke", phase_lm_train_smoke),
                     ("prefetch", phase_prefetch)):
        t0 = time.perf_counter()
        rec = fn(tables)
        emit({"phase": name, "seconds": time.perf_counter() - t0, **rec})


CHILDREN = {"--lm": ("LM serving", main_lm),
            "--lm-train": ("LM training", main_lm_train)}


def phase_child(flag: str) -> None:
    """The phases of ``flag`` (``CHILDREN``) in a child process
    (``chip_smoke.py <flag>``) with a fresh caching allocator of
    expandable segments: the earlier phases' freed segments fragment the
    card (kimi-k2's fp32 check casts 22.5 GB at once; a training step
    holds two states of up to 28 GB). Its lines are relayed; it must exit
    0."""
    import os
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          flag], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         text=True, timeout=900)
    sys.stdout.write(run.stdout)
    sys.stdout.flush()
    if run.returncode:
        fail(f"the {CHILDREN[flag][0]} phases exited {run.returncode}")
    emit({"phase": f"child {flag}", "seconds": time.perf_counter() - t0})


def child_main(flag: str) -> int:
    """``chip_smoke.py <flag>``: the phases of ``flag`` alone, each line
    emitted."""
    import torch
    from repro_torch.kernels.label_intersect import ops as li_ops
    from repro_torch.kernels.minplus_matmul import ops as mp_ops
    from repro_torch.kernels.spmv_relax import ops as sp_ops
    free, total = torch.cuda.mem_get_info()
    emit({"phase": f"process {flag}", "device_free_bytes": free,
          "device_total_bytes": total})
    CHILDREN[flag][1]((li_ops.LAUNCHES, sp_ops.LAUNCHES, mp_ops.LAUNCHES))
    return 0


def main(argv) -> int:
    src = ROOT / "src"
    if argv[:1] == ["--label-sweep"] and len(argv) == 2:
        src = Path(argv[1]).resolve()
    elif argv and not (len(argv) == 1 and (argv[0] in CHILDREN
                                           or argv[0] == "--distributed")):
        print("usage: chip_smoke.py [--label-sweep SRC | --lm | --lm-train "
              "| --distributed]", file=sys.stderr)
        return 2
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # fp32 products in full fp32 (the card-against-CPU checks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if argv and argv[0] in CHILDREN:
        return child_main(argv[0])
    if argv == ["--distributed"]:
        return dist_main()
    if argv:
        return sweep_main(src)
    from repro_torch.kernels.label_intersect import ops as li_ops
    from repro_torch.kernels.minplus_matmul import ops as mp_ops
    from repro_torch.kernels.spmv_relax import ops as sp_ops
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    dev = phase_device()
    emit({"phase": "device", "seconds": time.perf_counter() - t0, **dev})
    emit({"phase": "build", **phase_build()})
    # LM serving, then LM training, first, each in a child process on a
    # card this one has not filled yet: granite-8b's decode cell holds
    # ~58 GB, qwen2-moe's train step two 21 GB states
    phase_child("--lm")
    phase_child("--lm-train")
    t0 = time.perf_counter()
    emit({"phase": "ragged_checks", "cases": phase_ragged(),
          "seconds": time.perf_counter() - t0})

    tables = (li_ops.LAUNCHES, sp_ops.LAUNCHES, mp_ops.LAUNCHES)
    counters = {k: 0 for tab in tables for k in tab}
    indexes, graphs, rounds = {}, {}, {}
    for path, route, spec, gen_call, overrides, kernels in PATHS:
        zero(tables)              # each path starts from zero
        t0 = time.perf_counter()
        rec, idx, s, t, graphs[path] = drive_route(route, spec, gen_call,
                                                   overrides, "cuda")
        launches = launches_of(tables)
        rec["launches"] = launches
        emit({"phase": f"route_{path}", "seconds": time.perf_counter() - t0,
              **rec})
        check_launches(f"path {path}", launches, kernels)
        for k, v in launches.items():
            counters[k] += v
        indexes[path] = (idx, s, t)
        rounds[path] = int(rec["rounds"])

    # the path lane (§8.1) on each path's index, the serving engine,
    # then §8.3 mutation
    for path, *_ in PATHS:
        t0 = time.perf_counter()
        rec = phase_paths(path, *indexes[path], graphs[path], tables)
        emit({"phase": f"paths_{path}", "seconds": time.perf_counter() - t0,
              **rec})
        for k, v in rec["launches"].items():
            counters[k] += v
    for path, route, _, _, _, kernels in PATHS:
        t0 = time.perf_counter()
        rec = phase_serving(path, route, indexes[path][0], graphs[path],
                            tables, kernels)
        emit({"phase": f"serving_{path}", "seconds": time.perf_counter() - t0,
              **rec})
        for k, v in rec["launches"].items():
            counters[k] += v
    t0 = time.perf_counter()
    rec = phase_mutation(tables)
    emit({"phase": "mutation", "seconds": time.perf_counter() - t0, **rec})
    for k, v in rec["launches"].items():
        counters[k] += v

    # versioned mutation under traffic (§8.3 live), then directed graphs
    for path, *spec in VERSIONED:
        t0 = time.perf_counter()
        rec = phase_versioned(path, *spec, tables)
        emit({"phase": f"versioned_{path}",
              "seconds": time.perf_counter() - t0, **rec})
        for k, v in rec["launches"].items():
            counters[k] += v
    zero(tables)
    t0 = time.perf_counter()
    rec = phase_directed()
    launches = launches_of(tables)
    check_launches("directed", launches, set())
    emit({"phase": "directed", "seconds": time.perf_counter() - t0, **rec})

    # sharded indexes over each path's index, then the HTTP service
    for path, route, _, _, _, kernels in PATHS:
        t0 = time.perf_counter()
        rec = phase_sharded(path, route, *indexes[path], graphs.pop(path),
                            tables, kernels)
        emit({"phase": f"sharded_{path}", "seconds": time.perf_counter() - t0,
              **rec})
        for k, v in rec["launches"].items():
            counters[k] += v
    t0 = time.perf_counter()
    rec = phase_http(indexes["fused"][0], tables,
                     {k for p, *_, ks in PATHS if p == "fused" for k in ks})
    emit({"phase": "http", "seconds": time.perf_counter() - t0, **rec})
    for k, v in rec["launches"].items():
        counters[k] += v

    # the VC-Index baseline (Table 8) beside IS-LABEL on four graphs
    t0 = time.perf_counter()
    rec = phase_vc(tables)
    emit({"phase": "vc_baseline", "seconds": time.perf_counter() - t0, **rec})
    for k, v in rec["launches"].items():
        counters[k] += v

    # the entry points outside the package: the twins of examples/ and
    # scripts/, each in-process (one line a twin), and one CLI run
    t0 = time.perf_counter()
    for rec in phase_examples(tables):
        emit(rec)
        for k, v in rec.get("launches", {}).items():
            counters[k] += v
    emit({"phase": "examples", "seconds": time.perf_counter() - t0})

    # training: the GNNs and DimeNet, then DIEN (no kernel of kernels/
    # lies on their paths), then the launcher as a subprocess
    for arch, shape in TRAIN:
        t0 = time.perf_counter()
        rec = phase_train(arch, shape, tables)
        emit({"phase": f"train_{arch}", "seconds": time.perf_counter() - t0,
              **rec})
    t0 = time.perf_counter()
    rec = {"published": phase_dien(tables),
           "smoke": phase_train("dien", "train_batch", tables, smoke=True)}
    emit({"phase": "train_dien", "seconds": time.perf_counter() - t0, **rec})
    t0 = time.perf_counter()
    rec = phase_train_launcher()
    emit({"phase": "train_launcher", "seconds": time.perf_counter() - t0,
          **rec})

    # the islabel arch: the query step at serve_1m, a peel level at
    # build_16m; then the mesh code over NCCL
    t0 = time.perf_counter()
    rec = phase_islabel_serve(tables, indexes["fused"], rounds["fused"])
    emit({"phase": "islabel_serve_1m", "seconds": time.perf_counter() - t0,
          **rec})
    t0 = time.perf_counter()
    rec = phase_islabel_build(tables)
    emit({"phase": "islabel_build_16m", "seconds": time.perf_counter() - t0,
          **rec})
    t0 = time.perf_counter()
    rec = phase_distributed()
    emit({"phase": "distributed", "seconds": time.perf_counter() - t0,
          **rec})
    t0 = time.perf_counter()
    emit({"phase": "builders", **phase_builders(indexes["ell_loop"][0]),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    kernels = phase_kernels(indexes, dev["clock_max_mhz"] * 1e6)
    for rec in kernels:
        rec["launches"] = counters[rec["name"]]
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "uncovered_timings": UNCOVERED[0], "power_limit": dev["smi"]})

    # the dry run (CPU only, fake process group) after every timed phase:
    # its processes take the host's cores
    t0 = time.perf_counter()
    rec = phase_dryrun(start_dryrun())
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t0, **rec})

    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    for line in dev["smi"]:
        print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
