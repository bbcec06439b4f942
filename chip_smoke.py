"""Quickest proof that lightgbm_tpu_torch runs on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network.
Imports no JAX.  Phases, one line each; any failure exits non-zero:

  1. build    compile csrc/hist.cu, partition.cu and round.cu, one nvcc
              each, all started together (nvcc -Xptxas -v: registers,
              shared memory, spills), and count each kernel's atomic
              instruction forms in cuobjdump -sass where the toolkit has it;
  2. kernels  each histogram kernel against its plain PyTorch version at the
              training path's shapes (1M x 28 x 255, float tile 8, int8 tile
              20) and on a ragged case; timings from CUDA events;
  3. train    lgb.train on a seeded Higgs-shaped binary set (1M train rows
              + 100k held out, 28 features, max_bin=255, 31 leaves, 20
              rounds) in graph mode (fused_training, the default: a
              CUDA-graph replay a round) and eager mode
              (fused_training=false) in turns: iterations/s, replays,
              captures, kernel launches (counted from replays), peak device
              memory, held-out AUC, save/reload bitwise, a small run held
              against the CPU, and torch.profiler windows of 5 rounds in
              each mode (device idle share, launches outside replays);
              each training run (phases 3, 4, 6, 8) must print the model
              sha256 that PERF.md lists (MODEL_SHA), in both modes;
  4. int8     the same set with use_quantized_grad=true, 5 rounds (eager:
              not fused-eligible, as in the JAX package);
  5. epsilon  a seeded Epsilon-shaped set (400k train + 50k held-out rows x
              2000 dense features, 255 bins) binned once for phases 6-9;
  6. windowed lgb.train with windowed_growth=true, 255 leaves, 5 rounds,
              graph and eager in turns: the round megakernel every round
              (one replay), held-out AUC, save/reload, round-driver stats
              and a torch.profiler window in each mode;
  7. kernels  every kernel of the windowed path against its plain version,
              bit for bit, on the real bins with phase 6's gradients: the
              root histogram pass (tile 1, explicit exponents), the
              partition, the float window pass and the round megakernel
              (two sets of split options) at the float leaf tile 10, the
              partition and the int8 window pass at the int8 tile 20, and
              a ragged case; the root pass and the int8 window pass beside
              their bounds, and the round kernel's per-phase device times
              (partition, window pass, subtraction, split search) from a
              torch.profiler window, each beside its own bound; the
              partition's time per Python call (events), its device time
              (profiler) and the floor of one launch from Python; the round
              kernel's categorical and feature_contri modes (64 columns
              marked categorical, a seeded contri vector), timed beside
              their bound;
  8. int8     the same with use_quantized_grad=true, 3 rounds, graph and
              eager: the three-pass round (partition kernel + int8
              histogram kernel);
  9. parity   megakernel=auto against megakernel=0 on 100k of the rows, 2
              trees: the same nodes, leaf counts and leaf values, and each
              run's launches counted; the same with 64 columns re-coded to
              32 integer codes and marked categorical (bitsets equal too);
 10. strict   phase 3's Higgs set with tree_growth_mode=strict, 5 rounds
              (eager: the strict step is not captured): it/s, blocking
              reads inside a tree (none) and an iteration (one: the finish
              check, which stops the strict path at the first all-one-leaf
              iteration), B1 launches (tile 1: the root and one a
              split), held-out AUC, a small run held against the CPU, a
              profiled window, and B1 at its tile-1 call site against its
              plain version;
 11. multi    multiclass softmax at the repo's multiclass-5 shape (500k
              train + 50k held-out rows x 28 features, 5 classes, 31
              leaves, max_bin 63), 10 rounds (50 trees), graph and eager in
              turns: one capture a training, the class trees replaying it,
              held-out multi_logloss and multi_error, graph == eager;
 12. rank     LambdaRank at MSLR-WEB30K width (1M train rows in ~8,300
              queries of 60-180 documents + ~50k held-out rows, 136
              features, relevance 0-4, 255 leaves, max_bin 255), 5 rounds,
              graph and eager in turns: held-out NDCG@{1,3,5,10}; then every
              objective this slice added, its gradients and hessians on the
              card against the CPU at 1M rows;
 13. modes    the boosting modes on phase 3's Higgs set: GOSS (top_rate 0.2,
              other_rate 0.1, learning rate 0.2) and DART (drop_rate 0.1),
              10 rounds each, graph and eager in turns; random forest
              (bagging 0.632 every iteration), 10 rounds, eager by the
              gate; each run's it/s, replays, B1 launches and blocking reads
              a tree, GOSS's rows in the bag past the warm-up, DART's drops
              an iteration, held-out AUC, model sha256 (graph == eager,
              MODEL_SHA), a small run held against the CPU and a bitwise
              reload; init_model 10 + 10 rounds (the replayed training score
              against predict(raw_score=True)); cv, 3 folds x 5 rounds on
              200k rows; B1 at each mode's call site against its plain
              version;
 14. predict  the prediction surface on phase 3's 20-tree Higgs model and
              phase 12's 255-leaf LambdaRank model: Booster.predict latency
              at 1, 1,024 and 100,000 rows (host copies in and out
              included; the median of 50 calls, 10 at 100,000 rows),
              rows/s, the traversal's device time and launches a call from
              a torch.profiler window; pred_leaf card == CPU bitwise at
              100,000 rows; early-stop prediction (freq 5, margin 1.5) with
              its chunks, blocking reads and stopped rows, the rows that ran
              every chunk bitwise the full prediction; pred_contrib on 1,000
              rows (host seconds; contributions sum to the margin); refit on
              the 100,000 held-out rows, card against CPU;
 15. categ    categorical features on a seeded Criteo-shaped cell (2M train
              + 200k held-out rows, 13 integer counts then 26 categorical
              columns of 3 to 50,000 Zipf-distributed codes, 255 leaves,
              max_bin 255, LightGBM's categorical defaults): 20 float
              rounds on the rounds grower, graph and eager in turns (one
              replay a tree-round, no blocking read, graph == eager
              sha256, MODEL_SHA), 20 rounds with hist_precision=bf16 (graph;
              B1's bf16 mode at tile 16), the strict grower 3 rounds on 200k
              rows card against CPU (15 leaves, as phase 3's small run), a
              bitwise reload, predict latency at 1,
              1,024 and 100,000 rows, and B1's float and bf16 modes at the
              cell's call sites against their plain versions;
 16. efb      EFB and data input on a seeded Expo-shaped cell (LightGBM's
              Experiments.rst "Expo": 1M train + 100k held-out rows x 700
              one-hot and integer columns as a CSR matrix, 255 leaves,
              max_bin 255, min_sum_hessian_in_leaf 100), bundled by
              default: the rounds grower 20 rounds graph and eager in turns
              (F, F_b, bundle widths, the tile from F_b, B1 launches, graph
              == eager sha256, MODEL_SHA "expo"), the same bins without the
              plan (a reading), the windowed grower 5 rounds (three-pass:
              megakernel_excluded "efb", B2 and B1 launches, "expo_windowed"),
              int8 5 rounds ("expo_int8"); the first 200k rows written as
              LibSVM: Dataset(path), two_round and save_binary + Dataset(cache)
              give the CSR set's bins and, after 5 rounds, its model text;
              B1 float / int8 / window pass and B2 at the bundled shapes
              against their plain versions, unbundling card vs CPU; a small
              run card vs CPU; predict latency on 1 and 100,000 CSR rows;
 17. envelope the rest of the feature envelope on phase 3's Higgs set (20
              rounds, 31 leaves unless a line says otherwise): (a) +1
              monotone on columns 0, 3, 5, 8, 9 and 12 and (b) the same
              with intermediate bounds and monotone_penalty 1.0, both graph
              and eager in turns, every column swept over its bin
              thresholds for 1,000 held-out rows with predictions never
              falling; (c) interaction sets lepton / jets / masses, graph
              and eager, every root-to-leaf path inside one set; (d) a
              forced prefix (root on column 25 at 1.0, its left child on
              column 0), graph and eager, and the strict grower (5 rounds),
              every tree beginning with it; (e) extra_trees with
              feature_fraction_bynode 0.8 on the rounds grower (eager by
              the gate) and the strict grower, and 3 windowed rounds on
              phase 16's bundled Expo set (three-pass, graph and eager);
              (f) CEGB split, coupled and lazy penalties on the mass
              columns (eager); (g) linear trees, 10 rounds (eager), card
              against CPU on 100,000 rows and a bitwise reload, predict
              latency at 1, 1,024 and 100,000 rows.  Each run: the model
              sha256 (MODEL_SHA), held-out AUC over its floor, a small run
              card against CPU (the card's node draws on both sides); B1 at
              (a)'s site (the model 10 trees in, tile 8) and B2 and the
              window pass at (e)'s windowed site against their plain
              versions; profiles of (a), (f) and (g);
 18. runtime  on phase 3's Higgs set and 20-tree model (nothing binned
              again; at most 60 s): (a) 10 graph-mode rounds with
              snapshot_freq 5 (snapshot write ms), a torn snapshot_iter_15
              beside them, then resume="auto" to 20 rounds: it skips the
              torn file, resumes from 10 (load + score replay ms) and prints
              the uninterrupted run's sha256 (MODEL_SHA "higgs_float");
              (b) Booster.predict at 1, 1,024 and 100,000 rows cached (the
              packed ensemble warm) against uncached (the pack version
              bumped before each call), medians of phase 14's call counts,
              outputs bitwise, one blocking read a warm call, a profiled
              window of each at 100,000 rows (device ms, idle share,
              launches a call); (c) lgb.serve(serve_max_wait_ms=2), 8
              clients x 200 requests of 1/7/64/300 held-out rows, a
              swap_model to the 10-round snapshot midway: requests/s,
              rows/s, p50/p99 latency, batches, rows a batch, one blocking
              read and one traversal a batch, launches a batch (profiled),
              every response bitwise one model's Booster.predict; then a
              2-replica ServingFleet under LGBMTPU_FAULT=replica_death:3,
              no request lost; (d) 5 graph-mode rounds trained while 4
              clients keep the runtime busy: captured and replayed, the
              model text of a 5-round run alone;
 19. fleet    lgb.train_fleet on phase 3's bins: 16 lanes (lane b's labels
              the Higgs labels with 5% flipped by RandomState(SEED + b),
              lanes 8-15 weighing a seeded 20% of rows 0, lanes 12-15 5
              rounds), 10 float rounds graph and eager, 5 int8 (16 gradient
              bins) graph: lanes 0, 5, 10, 15 bitwise their solo windowed runs
              (sha256), lane-mode B1 and B2 one launch each a fleet round,
              model-rounds/s against the solo runs, lane 0's held-out AUC, a
              profiled window's idle share; the lane kernels at L = 16, W =
              131,072 a lane bitwise their plain versions, with times, bounds
              and the library yardsticks (at most 60 s);
 20. ooc      phase 3's bins as a stored bin cache: (a) resident, chunk
              131,072, phase 3's sha256; (b) spill, max_rows_in_hbm 262,144,
              chunks 131,072 and 65,536, 5 rounds, phase 10's strict sha256,
              streamed rows/s, GB/s, chunk launches a tree, blocking reads a
              split, the carried B1 bitwise its plain version with times;
              (c) 65,536 rows appended as a segment, read back bitwise,
              compacted (at most 60 s);
 21. continual phase 3's model behind lgb.serve, 8 clients: 4 ingested
              chunks of 65,536 Higgs rows, a refit rollover and an append
              rollover (2 trees), each bitwise its offline application, the
              card's refit within 1e-6 of the CPU's, staleness gauges 0 after
              each, every response bitwise one version's predict (at most
              60 s);
 22. device   nvidia-smi's name and power limit;
 23. distributed (at most 60 s, reported after phase 21): (a) B3 unfused
              (the TPU kernel's fuse_tail=False, round_cuda.
              round_partition_window) bitwise against its plain version at
              phase 7's Epsilon round geometry, timed beside its bound (no
              library call computes it); (b) world size 1 over NCCL:
              grow_tree_windowed_data_parallel on the Epsilon set, merge
              psum and scatter, 2 trees, each bitwise the serial windowed
              tree (B3 unfused launches counted, the int64 all-reduce, the
              owned-feature search), run right after phase 7 while the
              Epsilon set is on the card; (c) two ranks on the one card
              over gloo (NCCL refuses two ranks on one GPU):
              train_distributed on the Higgs cell split in two, tree_learner
              =data on the rounds grower (20 float rounds, 5 int8 rounds:
              the serial pins; the float launch is 24b's recovery run),
              feature on the strict grower (5 rounds: phase 10's pin) and
              voting (5 rounds: held-out AUC over its floor), three
              launches at a time; merges a tree, bytes a merge and the wall
              time of each.
              A distributed model's text differs from the serial one in its
              parameter record [tree_learner: ...] alone; its sha256 is
              taken with that line read as serial (``serial_sha``).
 24. meshes   (at most 45 s: its set-up at phase 7 and its wall after 23c,
              reported after 23): (a) one run_spmd launch of 4 gloo ranks
              on cuda:0 fed by a bin cache in save_binary's format of
              phase 5's first 100,000 rows through bin_cache_shard (F
              2,000, 255 bins), one tree each: the 2 x 2 (data, feature)
              mesh float and int8 at 255 leaves, bitwise the serial
              windowed trees (three-pass) the main process grows; the 2 x 2
              (dcn, ici) mesh at 63 leaves with top_k_features 2,000 and
              the all_reduce in slices (bitwise the serial tree too) and
              with top-k 32 and the reduce_scatter, each node's split, leaf
              counts and values bitwise a plain PV-Tree replay
              (pv_tree_replay); bytes a tree by axis beside a flat
              all_reduce's; (b) 23c's data float launch: fleet snapshots
              every 5 rounds, rank 1 killed at iteration 12, max_restarts
              1: relaunched from round 10, the serial pin; (c)
              predict(mesh=) over two entries of cuda:0 at 100,000 Higgs
              rows, bitwise predict, both latencies.

Then a JSON line with every kernel's numbers (launches on the main path,
graph mode; whether it runs inside a graph and its launches a replay; B1
once for each call site: Higgs rounds, Epsilon root and window, strict,
multiclass, LambdaRank, GOSS, DART, random forest, Criteo float and bf16,
Expo float, int8 and window pass, the monotone site and the per-node
sampling window pass; B2 at the Epsilon and Expo geometries and at the
per-node sampling site; B3 numerical, categorical and unfused; B1 and B2 in their
lane mode and B1 in its carried mode), and last the device
line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --turns CHECKOUT

trains the Higgs-shaped cell with another checkout's package (e.g. the
parent commit's, unpacked with git archive) and with this one in graph and
eager mode, in turns, printing each run's it/s and model sha256.

    python3 chip_smoke.py --variants [CHECKOUT]

times the histogram, partition and round kernels' design variants against
each other in turns (``variants``), each held bitwise to the plain
versions; with CHECKOUT, another checkout's lightgbm_tpu_torch (e.g. the
parent commit's, unpacked with git archive), its own wrappers and kernels,
is one more variant.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20251016
N_TRAIN, N_TEST, N_FEAT, MAX_BIN = 1_000_000, 100_000, 28, 255
ROUNDS_FLOAT, ROUNDS_INT8, NUM_LEAVES = 20, 5, 31
# Held-out AUC floors.  Training is deterministic run to run (fixed-point
# float histograms, exact int8), and the card read 0.85044 after 20 float
# rounds and 0.80947 after 5 int8 rounds (PERF.md); each floor sits 0.01
# under its reading, so a fault that only degrades the trees still fails.
AUC_FLOOR = 0.84
AUC_FLOOR_INT8 = 0.80
# the Epsilon-shaped cell (PASCAL Large Scale Learning Challenge "epsilon":
# 400k train rows x 2000 dense features; the real set is not on the machine)
EPS_N_TRAIN, EPS_N_TEST, EPS_FEAT, EPS_LEAVES = 400_000, 50_000, 2000, 255
EPS_ROUNDS_FLOAT, EPS_ROUNDS_INT8, EPS_PARITY_ROWS = 5, 3, 100_000
EPS_BIN_SAMPLE = 50_000  # bin_construct_sample_cnt (PERF.md section 4)
# the card read 0.64003 (5 float rounds) and 0.62815 (3 int8 rounds) on
# this generator (PERF.md); each floor sits 0.01 under its reading
AUC_FLOOR_EPS = 0.63
AUC_FLOOR_EPS_INT8 = 0.61
# phase 23: tree_learner=voting on the Higgs cell, 2 ranks, 5 rounds, top_k
# 5; the card read 0.81766 (PERF.md) and the floor sits 0.01 under it
AUC_FLOOR_VOTING = 0.80
DIST_RANKS, DIST_ROUNDS_VOTING, DIST_TOP_K = 2, 5, 5
# sha256 prefixes of the four training runs' model text (phases 3, 4, 6, 8;
# PERF.md): graph and eager training, every kernel change, must keep them
MODEL_SHA = {"higgs_float": "3cb1e5ba", "higgs_int8": "900c2628",
             "eps_float": "3e51d1cd", "eps_int8": "c2599a30",
             # phases 10-12 (PERF.md)
             "higgs_strict": "b0263266", "multiclass": "a178220f",
             "lambdarank": "d37e8ddd",
             # phase 13 (PERF.md)
             "goss": "87c6f557", "dart": "e9ea51f1", "rf": "c06c0dd1",
             # phase 15 (PERF.md)
             "criteo": "0586e933", "criteo_bf16": "4960ac72",
             # phase 16 (PERF.md)
             "expo": "add98dac", "expo_windowed": "6abc116e", "expo_int8": "5f609696",
             # phase 17 (PERF.md)
             "mono": "562806e0", "mono_int": "87df87b1", "inter": "05374480",
             "forced": "e2e8c367", "forced_strict": "2faa452d", "extra": "d5c74a4b",
             "extra_strict": "860ce530", "extra_windowed": "ca3ea16a",
             "cegb": "dea763ab", "linear": "9c02cd81"}
# phase 10: the strict grower on the Higgs cell; the card read AUC 0.81766
# (PERF.md), the floor sits 0.01 under it
ROUNDS_STRICT = 5
AUC_FLOOR_STRICT = 0.80
# phase 11: the README's "multiclass-5 softmax 500k x 28" row, generated as
# benchmarks/workload_smoke.py::bench_multiclass does (it stands for the
# Airline multiclass workload of BASELINE.md)
MC_N_TRAIN, MC_N_TEST, MC_FEAT, MC_CLASSES, MC_BIN = 500_000, 50_000, 28, 5, 63
MC_ROUNDS = 10
# the card read multi_logloss 1.28050 and multi_error 0.41170 on the
# held-out rows (PERF.md); each ceiling sits 0.01 over its reading
MC_LOGLOSS_CEIL, MC_ERROR_CEIL = 1.29, 0.42
# phase 12: LambdaRank at MSLR-WEB30K width (136 features, relevance 0-4,
# ~120 documents a query; 1M of its ~3.7M rows), LightGBM's ranking
# experiment parameters (docs/Experiments.rst: 255 leaves, learning rate
# 0.1, max_bin 255)
RK_N_TRAIN, RK_N_TEST, RK_FEAT, RK_LEAVES, RK_ROUNDS = 1_000_000, 50_000, 136, 255, 5
RK_QMIN, RK_QMAX = 60, 180
RK_EVAL_AT = (1, 3, 5, 10)
# the card read NDCG@1,3,5,10 = 0.76316, 0.72857, 0.70391, 0.66570 on the
# held-out queries (PERF.md); each floor sits 0.01 under its reading
NDCG_FLOORS = {1: 0.75, 3: 0.71, 5: 0.69, 10: 0.65}
# the objectives this slice added, held card against CPU at RK_N_TRAIN rows
NEW_OBJECTIVES = ("regression_l1", "huber", "fair", "poisson", "gamma", "tweedie",
                  "quantile", "mape", "multiclass", "multiclassova", "cross_entropy",
                  "cross_entropy_lambda", "lambdarank", "rank_xendcg")
OBJECTIVE_RTOL = 1e-5
# phase 13: the boosting modes on the Higgs cell, each 10 rounds; their
# sha256 prefixes are in MODEL_SHA, and each AUC floor sits 0.01 under the
# card's first reading (PERF.md)
MODE_ROUNDS, CV_ROWS, CV_FOLDS, CV_ROUNDS = 10, 200_000, 3, 5
MODES = {"goss": {"data_sample_strategy": "goss", "top_rate": 0.2, "other_rate": 0.1,
                  "learning_rate": 0.2},
         "dart": {"boosting": "dart", "drop_rate": 0.1},
         "rf": {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.632}}
# (read 0.84828, 0.82501 and 0.78992)
AUC_FLOOR_MODES = {"goss": 0.83, "dart": 0.81, "rf": 0.77}
# phase 14: prediction
PRED_BATCHES, PRED_CALLS, PRED_CALLS_BIG = (1, 1024, 100_000), 50, 10
ES_FREQ, ES_MARGIN, CONTRIB_ROWS = 5, 1.5, 1000
# phase 15: the Criteo display-advertising shape (BASELINE.json's Criteo
# CTR config, Kaggle layout: 13 integer count features, then 26 hashed
# categorical ones), generated from a seed; binary, 255 leaves, learning
# rate 0.1, max_bin 255, LightGBM's categorical defaults
CR_N_TRAIN, CR_N_TEST, CR_INT, CR_CAT, CR_LEAVES = 2_000_000, 200_000, 13, 26, 255
CR_ROUNDS, CR_STRICT_ROWS, CR_STRICT_ROUNDS = 20, 200_000, 3
# cardinalities of the 26 categorical columns: two with at most 4 values
# (LightGBM's one-hot rule applies), the others over 255 (the binner keeps
# the 255 most frequent), up to 5 x 10^4
CR_CARD = (3, 4, 300, 450, 600, 800, 1000, 1300, 1700, 2200, 2800, 3500, 4500,
           5500, 7000, 9000, 11000, 14000, 17000, 21000, 26000, 31000, 37000,
           42000, 47000, 50000)
# the card read held-out AUC 0.75739 (float) and 0.75616 (bf16) after 20
# rounds (PERF.md); each floor sits 0.01 under its reading
AUC_FLOOR_CRITEO, AUC_FLOOR_CRITEO_BF16 = 0.74, 0.74
# phase 9's categorical case: 64 Epsilon columns re-coded to 32 codes
EPS_CAT_COLS, EPS_CAT_CODES = 64, 32
# phase 16: LightGBM's "Expo" experiment set (docs/Experiments.rst: the ASA
# Data Expo airline on-time records one-hot encoded to 700 columns, 11M
# training rows, binary; num_leaves 255, learning rate 0.1, max_bin 255,
# min_sum_hessian_in_leaf 100), generated from a seed: one-hot blocks (name,
# columns, Zipf exponent or 0), four integer columns; 1M training rows
EX_BLOCKS = (("Month", 12, 0.0), ("DayofMonth", 31, 0.0), ("DayOfWeek", 7, 0.0),
             ("DepHour", 24, 0.0), ("UniqueCarrier", 22, 1.1), ("Origin", 300, 1.1),
             ("Dest", 300, 1.1))
EX_NUMERIC, EX_POSITIVE = 4, 0.19
EX_FEAT = sum(b for _, b, _ in EX_BLOCKS) + EX_NUMERIC  # 700
EX_N_TRAIN, EX_N_TEST, EX_LEAVES, EX_ROUNDS, EX_ROUNDS_SHORT = 1_000_000, 100_000, 255, 20, 5
EX_FILE_ROWS, EX_SMALL_ROWS = 200_000, 20_000
# the card read held-out AUC 0.67499 after 20 rounds (PERF.md); the floor
# sits 0.01 under it
AUC_FLOOR_EXPO = 0.66
# phase 17: the rest of the feature envelope on phase 3's Higgs set (and
# phase 16's bundled Expo set for per-node sampling on the windowed
# grower): +1 monotone on the columns higgs_like shifts up with the signal
# (lepton pT, missing-energy magnitude, jet-1 pT and b-tag, jet-2 pT and
# b-tag), interaction sets lepton / jets / masses, a forced prefix (root on
# column 25 at 1.0, its left child on column 0 at 1.0), CEGB penalties on
# the seven mass columns, linear trees
ENV_ROUNDS, ENV_LINEAR_ROUNDS, ENV_WIN_ROUNDS = 20, 10, 3
ENV_MONO_COLS = (0, 3, 5, 8, 9, 12)
ENV_SETS = [list(range(0, 5)), list(range(5, 21)), list(range(21, 28))]
ENV_FORCED = {"feature": 25, "threshold": 1.0, "left": {"feature": 0, "threshold": 1.0}}
ENV_MASS = tuple(range(21, 28))
ENV_CEGB = {"cegb_penalty_split": 1e-6,
            "cegb_penalty_feature_coupled": [50.0 if j in ENV_MASS else 0.0
                                             for j in range(N_FEAT)],
            "cegb_penalty_feature_lazy": [1e-4 if j in ENV_MASS else 0.0
                                          for j in range(N_FEAT)]}
ENV_SWEEP_ROWS, ENV_LINEAR_ROWS = 1000, 100_000
# held-out AUC floors, each the card's first reading less 0.01, cut to
# three decimals (read 0.84988, 0.85009, 0.84881, 0.84460, 0.80326,
# 0.84662, 0.81283, 0.85007, 0.84102, and 0.66689 on the Expo set; PERF.md)
AUC_FLOOR_ENV = {"mono": 0.839, "mono_int": 0.840, "inter": 0.838, "forced": 0.834,
                 "forced_strict": 0.793, "extra": 0.836, "extra_strict": 0.802,
                 "cegb": 0.840, "linear": 0.831, "extra_windowed": 0.656}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, non-tensor-core f32 (integer adds counted alike)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# data: a seeded set with the shape of UCI HIGGS (21 low-level kinematic
# columns, then 7 high-level masses; ~53% signal)
# ---------------------------------------------------------------------------
def higgs_like(n: int, seed: int):
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.53).astype(np.float64)
    s = y[:, None]
    X = np.empty((n, N_FEAT), np.float64)
    # lepton pT/eta/phi, missing energy magnitude/phi
    X[:, 0] = rng.lognormal(-0.1 + 0.1 * y, 0.5)
    X[:, 1] = rng.randn(n) * 1.1
    X[:, 2] = rng.uniform(-np.pi, np.pi, n)
    X[:, 3] = rng.lognormal(-0.2 + 0.15 * y, 0.6)
    X[:, 4] = rng.uniform(-np.pi, np.pi, n)
    # 4 jets x (pT, eta, phi, b-tag)
    for j in range(4):
        c = 5 + 4 * j
        X[:, c] = rng.lognormal(-0.1 * j + 0.05 * y, 0.5)
        X[:, c + 1] = rng.randn(n) * (1.0 + 0.1 * j)
        X[:, c + 2] = rng.uniform(-np.pi, np.pi, n)
        p_b = 0.25 + 0.2 * y * (j < 2)
        X[:, c + 3] = np.where(rng.rand(n) < p_b, 2.17, 0.0) + np.where(
            rng.rand(n) < 0.1, 1.09, 0.0)
    # 7 high-level masses: signal peaks, background broad
    peaks = np.array([1.0, 1.02, 0.98, 0.95, 0.85, 1.05, 1.1])
    for k in range(7):
        sig = rng.normal(peaks[k], 0.12 + 0.03 * k, n)
        bkg = rng.lognormal(np.log(peaks[k]) + 0.1, 0.45, n)
        X[:, 21 + k] = np.where(s[:, 0] > 0, np.where(rng.rand(n) < 0.6, sig, bkg), bkg)
    # some missing values, as the real set has none but users' data do
    X[rng.rand(n, N_FEAT) < 0.01] = np.nan
    return X, y


def auc(y: np.ndarray, p: np.ndarray) -> float:
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p), np.float64)
    ranks[order] = np.arange(1, len(p) + 1)
    # ties share their mean rank
    _, inv, cnt = np.unique(p, return_inverse=True, return_counts=True)
    sums = np.bincount(inv, weights=ranks)
    ranks = (sums / cnt)[inv]
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_inputs(n, f, b, tile, leaf_base, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev, dtype=torch.int16)
    grad = torch.randn(n, generator=g, device=dev)
    hess = torch.rand(n, generator=g, device=dev) * 0.25
    mask = torch.rand(n, generator=g, device=dev) < 0.9
    # slots beyond [leaf_base, leaf_base + tile) and -1 are inactive rows
    slot = torch.randint(-1, tile + leaf_base + 2, (n,), generator=g,
                         device=dev, dtype=torch.int32)
    gq = torch.randint(-2, 3, (n,), generator=g, device=dev, dtype=torch.int8)
    hq = torch.randint(0, 5, (n,), generator=g, device=dev, dtype=torch.int8)
    return bins, grad, hess, mask, slot, gq, hq


def library_call(bins, vals, mask, slot, leaf_base, tile, num_bins, dtype):
    """One index_add_ over flat (slot, feature, bin) cells of all three
    channels: the PyTorch yardstick (indices built outside the timing)."""
    from lightgbm_tpu_torch.ops.hist_cuda import _rows_and_index

    rows, idx = _rows_and_index(bins, mask, slot, leaf_base, tile, num_bins)
    f = bins.shape[1]
    v = torch.stack([vals[0][rows].to(dtype), vals[1][rows].to(dtype),
                     torch.ones_like(vals[0][rows], dtype=dtype)], dim=1)
    v = v[:, None, :].expand(-1, f, -1).reshape(-1, 3).contiguous()
    idx = idx.reshape(-1).contiguous()
    acc = torch.zeros((tile * f * num_bins, 3), dtype=dtype, device=bins.device)

    def run():
        acc.zero_()
        acc.index_add_(0, idx, v)

    return run, rows


def library_partition(order, seg_start, seg_len, go_left):
    """The PyTorch yardstick (timed, never called by the port): one stable
    sort of the in-segment positions by (segment start, goes right) gives
    the same permutation.  Returns the call to time (keys built outside)."""
    from lightgbm_tpu_torch.ops.partition import segment_ids

    n = order.shape[0]
    sid = segment_ids(seg_start, seg_len, n).long()
    in_seg = sid >= 0
    start = seg_start.long()[sid.clamp_min(0)]
    key = torch.where(in_seg, start * 2 + (~go_left).long(), -1)
    pos = torch.nonzero(in_seg).squeeze(1)
    key_in = key[pos]

    def run():
        perm = torch.sort(key_in, stable=True).indices
        out = order.clone()
        out[pos] = order[pos[perm]]
        return out

    return run


# Segment geometries a round can hand the partition (kChunk = 4096): name ->
# (N, seg_start, seg_len), segments in admission order.
PARTITION_EDGES = {
    # unsorted starts, positions outside every segment
    "admission_order": (20_000, [12_000, 0, 3000, 7000], [5000, 2500, 4000, 1]),
    # empty entries at 0 beside a real segment that starts at 0 (the grower's
    # slots with no split)
    "empty_at_0": (9000, [0, 0, 0, 6000, 0], [0, 4000, 0, 1000, 0]),
    # a round whose windows do not fit W passes every length as 0
    "all_empty": (5000, [0, 100, 3000, 0], [0, 0, 0, 0]),
    "one_covers_all": (70_001, [0], [70_001]),
    "one_position": (3000, [1500], [1]),
    # lengths kChunk - 1, kChunk, kChunk + 1, 2 kChunk; ends on chunk edges
    "chunk_edges": (32_768, [0, 4095, 8192, 16_384], [4095, 4096, 4097, 8192]),
    "below_one_chunk": (3000, [100, 0, 2000], [200, 50, 999]),
    "one_segment": (5000, [1000], [3321]),
    "twenty_segments": (50_000, list(range(0, 50_000, 2500)), [2400 - 97 * i for i in range(20)]),
}


def partition_edge(name, seed=0):
    """One PARTITION_EDGES geometry as numpy arrays: (order (N,) i32, a
    permutation; seg_start, seg_len (S,) i32; go (N,) bool, 40% left, with
    the second segment (where there is one) all left)."""
    n, start, length = PARTITION_EDGES[name]
    rng = np.random.RandomState(seed)
    order = rng.permutation(n).astype(np.int32)
    go = rng.rand(n) < 0.4
    if len(start) > 1:
        go[start[1]:start[1] + length[1]] = True
    return (order, np.asarray(start, np.int32), np.asarray(length, np.int32), go)


SECTOR = 32  # bytes: the unit in which the card reads scattered rows


def sector_bytes(rows: torch.Tensor, row_bytes: int) -> int:
    """Bytes of the 32-B sectors that rows ``rows`` of an array with
    ``row_bytes`` bytes a row touch (each sector counted once)."""
    r = rows.to(torch.int64)
    first = r * row_bytes // SECTOR
    last = ((r + 1) * row_bytes - 1) // SECTOR
    span = int((last - first).max()) + 1 if r.numel() else 0
    secs = torch.cat([torch.minimum(first + k, last) for k in range(span)]) \
        if span else r
    return int(torch.unique(secs).numel()) * SECTOR


def bound(n, f, tile, num_bins, rows, value_bytes, out_bytes):
    """Least time for one call on this run's data.  The function must read
    mask (1 B) and slot (4 B) of every row to learn which rows contribute;
    then only the contributing rows' bins (F x 2 B) and grad and hess
    (``value_bytes`` each), in the 32-B sectors those scattered rows touch;
    and write the (tile, 3, F, B) output once.  Operations: three adds per
    contributing row and feature."""
    nbytes = (n * 5 + sector_bytes(rows, f * 2) + 2 * sector_bytes(rows, value_bytes)
              + tile * 3 * f * num_bins * out_bytes)
    return bound_of(nbytes, int(rows.numel()) * f * 3)


def check_kernel_case(hc, n, f, b, tile, tile_q, leaf_base, dev, seed, timed):
    """Float kernel (tile) and int8 kernel (tile_q) against their plain
    versions on one set of inputs; with ``timed``, their times too."""
    bins, grad, hess, mask, slot, gq, hq = kernel_inputs(
        n, f, b, max(tile, tile_q), leaf_base, seed, dev)
    out = {}
    # float: within f32 summation order of the plain version, and repeatable
    k1 = hc.histogram_multi(bins, grad, hess, mask, slot, leaf_base, tile, b)
    k2 = hc.histogram_multi(bins, grad, hess, mask, slot, leaf_base, tile, b)
    p = hc.histogram_multi_plain(bins, grad, hess, mask, slot, leaf_base, tile, b)
    torch.cuda.synchronize()
    tol = 1e-5 * (float(hess.abs().max()) + 1.0)
    err = float((k1 - p).abs().max())
    if not torch.equal(k1, k2):
        raise AssertionError("float kernel: two launches differ")
    if not (err <= tol):
        raise AssertionError(f"float kernel vs plain: max|d| {err} > {tol}")
    if float(k1[:, 2].sum()) <= 0:
        raise AssertionError("float kernel: empty histogram")
    out["float"] = dict(max_abs_err=err, bitwise_plain=bool(torch.equal(k1, p)))
    # int8: exact
    q1 = hc.histogram_multi_quantized(bins, gq, hq, mask, slot, leaf_base,
                                      tile_q, b)
    qp = hc.histogram_multi_quantized_plain(bins, gq, hq, mask, slot, leaf_base,
                                            tile_q, b)
    torch.cuda.synchronize()
    if not torch.equal(q1, qp):
        raise AssertionError("int8 kernel differs from its plain version: "
                             f"max|d| {int((q1 - qp).abs().max())}")
    out["int8"] = dict(max_abs_err=0.0, bitwise_plain=True)
    if not timed:
        return out
    for name, tl, kern, plain, vals, dt, vb, ob in (
            ("float", tile, hc.histogram_multi, hc.histogram_multi_plain,
             (grad, hess), torch.float32, 4, 4),
            ("int8", tile_q, hc.histogram_multi_quantized,
             hc.histogram_multi_quantized_plain, (gq, hq), torch.int32, 1, 4)):
        args = (bins, vals[0], vals[1], mask, slot, leaf_base, tl, b)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), iters=5, warmup=1)
        lib, rows = library_call(bins, vals, mask, slot, leaf_base, tl, b, dt)
        library_ms = cuda_ms(lib)
        b_ms, b_by = bound(n, f, tl, b, rows, vb, ob)
        out[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b_ms, bound_by=b_by, tile=tl,
                         rows=int(rows.numel()))
    return out


ATOMIC_OP = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)(?![A-Z0-9_])")


def sass_atomics(so, nvcc_path):
    """Atomic instruction forms per kernel of a built library, counted in
    cuobjdump -sass: {kernel: {form: count}}; None where the toolkit has no
    cuobjdump.  Kernel names are demangled with cu++filt where it exists."""
    bindir = os.path.dirname(nvcc_path)
    tool = os.path.join(bindir, "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = ATOMIC_OP.search(line)
        if m and fn is not None:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    filt = os.path.join(bindir, "cu++filt")
    if counts and os.path.isfile(filt):
        names = list(counts)
        dm = subprocess.run([filt, *names], capture_output=True, text=True,
                            timeout=60).stdout.splitlines()
        if len(dm) == len(names):
            short = [d.replace("(anonymous namespace)::", "").split("(")[0]
                     .replace("void ", "").replace("lgbt::", "") for d in dm]
            counts = {k: counts[n] for k, n in zip(short, names)}
    return counts


def sass_summary(so, nvcc_path) -> str:
    """One line of ``sass_atomics``: each kernel's atomic forms and counts."""
    forms = sass_atomics(so, nvcc_path)
    if forms is None:
        return "not counted (no cuobjdump in the toolkit)"
    return "; ".join(f"{k}: " + ", ".join(f"{op} x{c}" for op, c in sorted(v.items()))
                     for k, v in sorted(forms.items()) if v)


# ---------------------------------------------------------------------------
# phases 3 and 4: training through the package's entry points
# ---------------------------------------------------------------------------
def train_timed(lgt, params, train_set, rounds):
    """lgb.train with a callback that stamps synchronized round ends."""
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    bst = lgt.train(params, train_set, rounds, callbacks=[stamp])
    it_s = (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else float("nan")
    return bst, it_s


def small_vs_cpu(lgt, params, Xtr, ytr, Xte, n=20000, rounds=3,
                 categorical_feature="auto") -> float:
    """Train on ``n`` rows on the card and on the CPU (the plain versions
    throughout) and return the largest gap in predictions; fails above
    1e-4 (f32 arithmetic order of the torch ops on each side).  Both sides
    take the grower the card takes (auto is the strict grower on the
    CPU)."""
    params = {"tree_growth_mode": "rounds", **params}
    cpu = {**params, "device_type": "cpu"}
    cf = categorical_feature
    pc = lgt.train(cpu, lgt.Dataset(Xtr[:n], label=ytr[:n], params=cpu,
                                    categorical_feature=cf), rounds).predict(Xte[:5000])
    pg = lgt.train(params, lgt.Dataset(Xtr[:n], label=ytr[:n], params=dict(params),
                                       categorical_feature=cf),
                   rounds).predict(Xte[:5000])
    err = float(np.abs(pc - pg).max())
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU disagree on a small input: {err} "
                             f"({params})")
    return err


def dev_us(e) -> float:
    """Device microseconds of a profiler event average."""
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, k):
            return float(getattr(e, k))
    return 0.0


def device_events(prof):
    """The profiler's device-side events (kernels, copies, sets), each once:
    host operators also carry the device time of what they launched."""
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]


def model_sha(bst) -> str:
    """sha256 of a booster's model text: equal digests, equal trees."""
    return hashlib.sha256(bst.model_to_string().encode()).hexdigest()


RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                    "cuLaunchKernel", "cuLaunchKernelEx")


def profile_rounds(lgt, params, train_set, rounds, warm=1):
    """torch.profiler over ``rounds`` boosting rounds after ``warm`` warm
    ones (Booster.update; in graph mode the first captures the graphs): wall
    time, device time summed over the device's own events (kernels, copies,
    sets: one stream, so their sum is the busy time), the five largest of
    them, and from the host's runtime calls, per tree, the kernels launched
    outside replays, the graph replays and the copies and sets."""
    from torch.profiler import ProfilerActivity, profile

    bst = lgt.Booster(params=dict(params), train_set=train_set)
    for _ in range(warm):
        bst.update()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:5]
    host = {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("cu") and not str(getattr(e, "device_type", "")).endswith("CUDA")}
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle=(1 - busy_ms / wall_ms) if busy_ms > 0 else float("nan"),
                top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top],
                launches=sum(c for k, c in host.items() if k in RUNTIME_LAUNCHES) / rounds,
                replays=host.get("cudaGraphLaunch", 0) / rounds,
                copies=sum(c for k, c in host.items()
                           if k.startswith(("cudaMemcpy", "cudaMemset"))) / rounds,
                runtime={k: c for k, c in sorted(host.items()) if c >= rounds})


def profile_line(what, r) -> str:
    if r["busy_ms"] <= 0:
        return (f"{what}: wall_ms={r['wall_ms']:.2f}, device time not measured (the "
                "profiler saw no device activity)")
    return (f"{what}: wall_ms={r['wall_ms']:.2f} device_busy_ms={r['busy_ms']:.2f} "
            f"idle_share={r['idle']:.4f} per tree: kernel launches outside replays="
            f"{r['launches']:.1f} replays={r['replays']:.1f} copies+sets={r['copies']:.1f} "
            f"runtime calls {json.dumps(r['runtime'])} top: "
            + "; ".join(f"{k} {ms:.3f} ms x{c}" for k, ms, c in r["top"]))


def tree_stats(bst):
    """The round drivers' counts over a booster's trees."""
    s = bst._gbdt.round_stats
    tot = {k: sum(t.get(k, 0) for t in s) for k in (
        "rounds", "retries", "host_syncs", "async_resolves", "captures", "replays",
        "dispatches", "megakernel_fallbacks")}
    seen, new_keys = set(), []
    for t in s:  # captures a tree must make: the window rungs (keys) it meets first
        keys = set(t["windows"])
        new_keys.append(len(keys - seen))
        seen |= keys
    graphs = bst._gbdt._round_graphs
    per_replay = {}
    for per in (graphs.launches_per_replay().values() if graphs is not None else ()):
        for k, v in per.items():
            per_replay[k] = max(per_replay.get(k, 0), v)
    return dict(trees=len(s), resolves=tot["async_resolves"], **tot,
                captures_per_tree=[t["captures"] for t in s], new_keys=new_keys,
                windows=sorted({w for t in s for w in t["windows"] if w is not None}),
                megakernel=[t.get("megakernel") for t in s],
                excluded=[t.get("megakernel_excluded") for t in s], per_replay=per_replay)


def train_turns(lgt, params, train_set, rounds, want_sha, counts, plain_total,
                turns=("graph", "eager", "graph", "eager")):
    """lgb.train in graph mode (fused_training, the default) and in eager
    mode (fused_training=false), in turns (a turn "ineligible" is
    fused_training=true where GBDT._fused_eligible does not hold): each
    run's it/s, round stats, kernel launches (``counts()``, reset before
    it), peak device memory above what was allocated before it, and model
    sha256.  Fails unless every run's sha256 starts with ``want_sha``
    (PERF.md's) and no plain version ran; in graph mode unless every round
    was one replay and graphs were captured only for the keys a tree met
    first; otherwise unless nothing was captured or replayed.  The first
    run's booster is kept."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc

    runs = []
    for mode in turns:
        for m in (hc, pc, rc):
            m.reset_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bst, it_s = train_timed(lgt, {**params, "fused_training": mode != "eager"},
                                train_set, rounds)
        torch.cuda.synchronize()
        st = tree_stats(bst)
        run = dict(mode=mode, it_s=it_s, sha=model_sha(bst), st=st, launches=counts(),
                   peak_mb=(torch.cuda.max_memory_allocated() - base) / 2**20,
                   bst=bst if not runs else None)
        if plain_total():
            raise AssertionError(f"a plain version ran in {mode} mode: {run}")
        if mode == "graph":
            ok = (st["replays"] == st["rounds"] == st["dispatches"]
                  and st["captures_per_tree"] == st["new_keys"] and st["captures"] >= 1)
        else:
            ok = st["replays"] == st["captures"] == st["dispatches"] == 0
        if not (ok and run["sha"].startswith(want_sha)):
            raise AssertionError(f"{mode} run (model sha256 should start {want_sha}): "
                                 f"{ {k: v for k, v in run.items() if k != 'bst'} }")
        runs.append(run)
        del bst
    return runs


def turn_line(what, r) -> str:
    st = r["st"]
    return (f"{what} {r['mode']}: it/s={r['it_s']:.4f} tree-rounds={st['rounds']} "
            f"replays={st['replays']} captures={st['captures']} "
            f"(per tree {st['captures_per_tree']}) dispatches={st['dispatches']} "
            f"blocking reads/tree={st['host_syncs'] / st['trees']:.2f} "
            f"launches (B1 float, B1 int8, B2, B3)={r['launches']} "
            f"launches/replay={json.dumps(st['per_replay'])} "
            f"peak_mem_mb={r['peak_mb']:.1f} model_sha256={r['sha']}")


# ---------------------------------------------------------------------------
# phases 5-9: the windowed grower at Epsilon width
# ---------------------------------------------------------------------------
def epsilon_like(n: int, seed: int):
    """A seeded set of the shape of PASCAL "epsilon": 2000 dense
    standardized features, a balanced binary label from a noisy linear
    model plus pairwise interactions, 1% of the values missing."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, EPS_FEAT), dtype=np.float32)
    w = (rng.standard_normal(EPS_FEAT) * np.exp(-np.arange(EPS_FEAT) / 300.0)
         ).astype(np.float32)
    z = X @ w / np.sqrt(float((w * w).sum()))
    for a, b in ((0, 1), (2, 3), (10, 20), (30, 40)):
        z += 0.5 * X[:, a] * X[:, b]
    z += rng.standard_normal(n).astype(np.float32)
    y = (z > np.median(z)).astype(np.float64)
    X[rng.random((n, EPS_FEAT), dtype=np.float32) < 0.01] = np.nan
    return X, y


def split_case(bins, num_bins, T, seed, ragged=False):
    """One round's split geometry on the real bins: T segments tiling the
    rows (a tree a few rounds in), each split on a real feature at a seeded
    threshold; the windows are the small children.  ``ragged`` adds an
    empty segment, an all-left one and positions outside every segment."""
    from lightgbm_tpu_torch.ops.partition import segment_ids

    dev = bins.device
    n, f = bins.shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    cuts = torch.sort(torch.randperm(n - 1, generator=g)[:T - 1] + 1).values
    seg_start = torch.cat([torch.zeros(1, dtype=torch.int64), cuts])
    seg_len = torch.diff(torch.cat([seg_start, torch.tensor([n])]))
    if ragged:
        seg_len[1] = 0  # empty
        seg_len[-1] -= 17  # positions outside every segment
    seg_start, seg_len = seg_start.int().to(dev), seg_len.int().to(dev)
    order = torch.randperm(n, generator=g).int().to(dev)
    feats = torch.randint(0, f, (T,), generator=g).to(dev)
    thr = torch.randint(num_bins // 6, num_bins * 5 // 6, (T,), generator=g).to(dev)
    sid = segment_ids(seg_start, seg_len, n).long()
    col = bins[order.long(), feats[sid.clamp_min(0)]].int()
    go = col <= thr[sid.clamp_min(0)]
    if ragged:
        go[seg_start[2]:seg_start[2] + seg_len[2]] = True  # all left
    in_seg = sid >= 0
    n_left = torch.zeros(T + 1, dtype=torch.int64, device=dev).index_add_(
        0, sid + 1, (go & in_seg).long())[1:].int()
    small_left = (2 * n_left <= seg_len).int()
    return dict(order=order, go=go, seg_start=seg_start, seg_len=seg_len,
                n_left=n_left, small_left=small_left, sid=sid, in_seg=in_seg,
                win_start=torch.where(small_left > 0, seg_start, seg_start + n_left),
                win_cnt=torch.where(small_left > 0, n_left, seg_len - n_left))


def round_case(bins, grad, hess, nbpf, mbpf, num_bins, sp, shift):
    """The round kernel's arguments for split ``sp``: the segments' own
    histograms as parents (the histogram kernel on the permuted rows, with
    the tree's exponents) and the 2T children's sums in cand_tab (their
    outputs, row 3, come from ``with_outputs``)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    dev = bins.device
    n, f = bins.shape
    T = sp["seg_start"].shape[0]
    sid, in_seg, go = sp["sid"], sp["in_seg"], sp["go"]
    rows = sp["order"].long()
    parent = hc.histogram_multi(bins.index_select(0, rows), grad[rows], hess[rows],
                                in_seg, torch.where(in_seg, sid, -1).int(), 0, T,
                                num_bins, shift=shift)
    ps = parent[:, :, 0].sum(2)  # (T, 3) totals from feature 0
    lsum = torch.zeros((T + 1, 3), dtype=torch.float64, device=dev).index_add_(
        0, torch.where(go & in_seg, sid + 1, 0),
        torch.stack([grad[rows], hess[rows], torch.ones_like(grad)], 1).double()
    )[1:].float()
    cand = torch.stack([torch.cat([lsum[:, i], ps[:, i] - lsum[:, i]])
                        for i in range(3)]
                       + [torch.zeros(2 * T, device=dev)]).contiguous()
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    return (bins, sp["order"], go, grad, hess, mask, sp["seg_start"], sp["seg_len"],
            sp["n_left"], sp["win_start"], sp["win_cnt"], sp["small_left"], parent,
            cand, nbpf, mbpf, fmask)


def with_outputs(args, params):
    """The round's arguments with the children's leaf outputs under
    ``params`` in cand_tab row 3 (what path smoothing reads)."""
    from lightgbm_tpu_torch.ops.split import leaf_output

    cand = args[13].clone()
    cand[3] = leaf_output(cand[0], cand[1], params)
    return args[:13] + (cand,) + args[14:]


def same(a, b, what):
    """Bit-for-bit equality of a kernel's output and its plain version's."""
    if not torch.equal(a, b):
        d = float((a.double() - b.double()).abs().max()) if a.shape == b.shape else None
        raise AssertionError(f"{what}: kernel differs from its plain version, "
                             f"max|d| {d}")


def compare_round(kout, pout, what):
    """Round kernel against its plain version, bit for bit: the new order,
    the left/right histograms (same fixed point, same exponents) and the
    per-feature bests (the same float64 prefix sums rounded to f32, the same
    gain formulas op for op)."""
    for name, a, b in (("new order", kout[0], pout[0]), ("left", kout[1], pout[1]),
                       ("right", kout[2], pout[2])):
        same(a, b, f"round kernel ({what}): {name}")
    for name in kout[3]._fields:
        same(getattr(kout[3], name), getattr(pout[3], name),
             f"round kernel ({what}): per-feature {name}")


def bound_of(nbytes, ops):
    """The larger of bytes over the memory rate and operations over the f32
    rate, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def partition_bytes(n, in_seg):
    """Bytes the partition must move: the row id (4 B) and go flag (1 B) of
    every in-segment position read and its row id written (4 B); every
    other position's row id read and written (8 B)."""
    return 9 * in_seg + 8 * (n - in_seg)


def device_window(fn, calls, marker):
    """The device events of a torch.profiler window over ``calls`` calls of
    ``fn`` (after one outside it), and the calls the profiler saw, counted
    by the events whose name holds one of ``marker`` (one a call).  The
    profiler can miss the first kernels of a window, all of them when the
    calls are short: a window in which it saw none is taken again, three
    windows at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        seen = sum(e.count for e in events if any(m in e.key for m in marker))
        if seen:
            return events, seen
    raise AssertionError(f"the profiler saw no {marker} launch in three windows")


# the partition's last launch of a call: this kernel's, or a two-launch one's
PARTITION_MARKER = ("partition_kernel", "partition_move")


def partition_device_ms(fn, calls=100):
    """Device ms a call of the partition kernel: every device event of a
    profiler window (what the wrapper launches and the kernel's launches),
    summed and divided by the calls the profiler saw.  Returns (ms, calls
    seen)."""
    events, seen = device_window(fn, calls, PARTITION_MARKER)
    return sum(dev_us(e) for e in events) / seen / 1e3, seen


def launch_floor_ms(dev) -> float:
    """The floor of one launch from Python: a one-element torch elementwise
    op timed as the kernels are (cuda_ms)."""
    x = torch.zeros(1, device=dev)
    return cuda_ms(lambda: x.add_(1.0))


# operations a (candidate, categorical feature, bin) of the categorical
# search: two bitonic sorts of 256 keys (36 compare-exchange steps a key,
# ~4 operations each) and three candidate gains (~40 each)
CAT_OPS_PER_BIN = 2 * 36 * 4 + 3 * 40


def round_bounds(args, W, n_cat=0):
    """Least time of one round call on this run's data, for the whole call
    and for each of its phases (with ``n_cat`` categorical features, their
    search's operations, CAT_OPS_PER_BIN a bin, join the split search's).  Bytes: the partition's (``partition_bytes``);
    the window rows' order entries (4 B), their bins (F x 2 B) and
    grad, hess, mask in the 32-B sectors those rows touch, and the fresh
    sums written once (T x F x B x 20 B); the subtraction reads the fresh
    sums and the parents and writes left/right; the split search reads
    left/right and writes the per-feature bests (2T x F x 25 B).  The whole
    call counts the parents read and left/right written once.  Operations:
    three adds per window row and feature, and ~40 per (candidate, feature,
    bin) of the split search (two directions of leaf gains).  Returns
    ({phase: (ms, by)}, window rows)."""
    from lightgbm_tpu_torch.ops.round_cuda import window_rows
    from lightgbm_tpu_torch.ops.partition import segment_ids, stable_partition_ranges

    bins, order, go, _, _, _, seg_start, seg_len, _, win_start, win_cnt = args[:11]
    parent = args[12]
    n, f = bins.shape
    T, b = parent.shape[0], parent.shape[3]
    new_order, _ = stable_partition_ranges(order, segment_ids(seg_start, seg_len, n),
                                           seg_start, seg_len, go)
    rows, _, valid = window_rows(new_order, win_start, win_cnt, W)
    rows = rows[valid]
    part = partition_bytes(n, int(seg_len.sum()))
    window = (4 * rows.numel() + sector_bytes(rows, f * 2) + 2 * sector_bytes(rows, 4)
              + sector_bytes(rows, 1))
    hist = parent.numel() * 4  # one (T, 3, F, B) f32 array
    bests = 2 * T * f * 25
    window_ops = rows.numel() * f * 3
    split_ops = 2 * T * (f - n_cat) * b * 40 + 2 * T * n_cat * b * CAT_OPS_PER_BIN
    return dict(
        total=bound_of(part + window + 3 * hist + bests, window_ops + split_ops),
        # B3 unfused: the partition and the window pass, the sums written once
        unfused=bound_of(part + window + T * f * b * 20, window_ops),
        partition=bound_of(part, 0),
        window=bound_of(window + T * f * b * 20, window_ops),
        subtract=bound_of(T * f * b * 20 + 3 * hist, 0),
        split=bound_of(2 * hist + bests, split_ops)), int(rows.numel())


ROUND_PHASES = (("partition", ("partition_",)), ("window", ("hist_kernel", "Memset")),
                ("subtract", ("subtract_kernel",)), ("split", ("gain_kernel",)))


def round_phases(rc, args, kw, calls=20):
    """Device ms a call of each phase of the round kernel, from a
    torch.profiler window over ``calls`` calls: the partition (B2's device
    code as one fused launch), the window pass (two memsets and the
    gather-mode histogram kernel), the subtraction and the split search;
    "other" holds what the wrapper launches around the kernel.  Sums are
    divided by the calls the profiler saw (its split-search launches, one a
    call), returned as "calls"."""
    events, seen = device_window(lambda: rc.round_megakernel(*args, **kw), calls,
                                 ("gain_kernel",))
    out = {name: 0.0 for name, _ in ROUND_PHASES}
    out["other"] = 0.0
    for e in events:
        name = next((n for n, keys in ROUND_PHASES if any(k in e.key for k in keys)), "other")
        out[name] += dev_us(e) / seen / 1e3
    out["calls"] = seen
    return out


def check_epsilon_kernels(ts, grad, hess, params, tile, tile_q):
    """Every kernel of the windowed path against its plain version, bit for
    bit, on the real Epsilon bins with the gradients of a model a few trees
    in: the root histogram pass (tile 1, the tree's exponents given
    explicitly); at the float leaf tile ``tile``, the partition, the
    three-pass float window pass and the round kernel under the training's
    split parameters and under all of L1, L2, max_delta_step, path
    smoothing and min_gain_to_split; at the int8 leaf tile ``tile_q``, the
    partition and the int8 window pass on the gathered window; and a
    ragged case (odd N, 257 features, an empty segment, an all-left one,
    positions outside every segment).  Times on the float-tile case; the
    root pass and the int8 window pass (the histogram kernel alone, on the
    gathered window) with their plain versions, index_add_ yardsticks and
    bounds; the round kernel's phases from a profiler window."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.treegrow_fast import quantize_gradients
    from lightgbm_tpu_torch.ops.treegrow_windowed import _window_size

    bins, b = ts.bins_device, ts.max_num_bins
    nbpf, mbpf = ts.num_bins_pf_device, ts.missing_bin_pf_device
    n, f = bins.shape
    dev = bins.device
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    pair = hc.fixed_shift_pair(grad, hess)
    shift = hc.fixed_shift_tensor(grad, hess)  # as the grower passes them
    full = params._replace(lambda_l1=0.5, lambda_l2=2.0, max_delta_step=0.7,
                           path_smooth=3.0, min_gain_to_split=0.01,
                           cegb_penalty_split=1e-6)
    out = dict(T=tile, Tq=tile_q, shift=pair)

    # the root pass: tile 1, explicit exponents
    ra = (bins, grad, hess, mask, torch.zeros(n, dtype=torch.int32, device=dev),
          0, 1, b)
    same(hc.histogram_multi(*ra, shift=shift), hc.histogram_multi_plain(*ra, shift=shift),
         "root histogram pass (tile 1, explicit exponents)")
    out["root_ms"] = cuda_ms(lambda: hc.histogram_multi(*ra, shift=shift), iters=5,
                             warmup=1)
    out["root_plain_ms"] = cuda_ms(lambda: hc.histogram_multi_plain(*ra, shift=shift),
                                   iters=2, warmup=1)
    lib, rows = library_call(bins, (grad, hess), mask, ra[4], 0, 1, b, torch.float32)
    out["root_library_ms"] = cuda_ms(lib, iters=2, warmup=1)
    out["root_bound_ms"], out["root_bound_by"] = bound(n, f, 1, b, rows, 4, 4)
    del lib, rows
    torch.cuda.empty_cache()

    def partition(sp, what):
        a = (sp["order"], sp["seg_start"], sp["seg_len"], sp["go"])
        k, p = pc.partition_segments(*a), pc.partition_segments_plain(*a)
        same(k[0], p[0], f"partition ({what})")
        same(k[1], p[1], f"partition left counts ({what})")
        if not torch.equal(k[1], sp["n_left"]):
            raise AssertionError(f"partition ({what}): left counts disagree with the split")
        return a, k[0]

    # float leaf tile: partition, three-pass window pass, round kernel
    sp = split_case(bins, b, tile, SEED + 5)
    pa, new_order = partition(sp, f"T={tile}")
    W = _window_size(int(sp["win_cnt"].sum()), n)
    wa = (new_order, bins, (grad, hess), mask, sp["win_start"], sp["win_cnt"], W,
          tile, b)
    same(rc.window_histograms(hc.histogram_multi, *wa, shift=shift),
         rc.window_histograms(hc.histogram_multi_plain, *wa, shift=shift),
         f"float window pass (T={tile})")
    base = round_case(bins, grad, hess, nbpf, mbpf, b, sp, shift)
    for what, prm in (("training parameters", params), ("all options", full)):
        args = with_outputs(base, prm)
        kw = dict(params=prm, W=W, shift=shift)
        compare_round(rc.round_megakernel(*args, **kw),
                      rc.round_megakernel_plain(*args, **kw), what)
    # the categorical and feature_contri tails (the TPU kernel's has_cat and
    # has_contri): EPS_CAT_COLS seeded columns marked categorical, a seeded
    # contri vector in [-0.1, 1.5)
    g = torch.Generator(device="cpu").manual_seed(SEED + 8)
    cmask = torch.zeros(f, dtype=torch.bool)
    cmask[torch.randperm(f, generator=g)[:EPS_CAT_COLS]] = True
    cmask = cmask.to(dev)
    contri = (torch.rand(f, generator=g) * 1.6 - 0.1).to(dev)
    args = with_outputs(base, params)
    for what, extra, prm in (
            ("categorical", dict(categorical_mask=cmask), params),
            ("feature_contri", dict(feature_contri=contri), params),
            ("categorical + feature_contri, all options",
             dict(categorical_mask=cmask, feature_contri=contri), full)):
        a = with_outputs(base, prm)
        kw = dict(params=prm, W=W, shift=shift, **extra)
        ko = rc.round_megakernel(*a, **kw)
        compare_round(ko, rc.round_megakernel_plain(*a, **kw), what)
        if "categorical_mask" in extra and not bool((ko[3].variant >= 0).any()):
            raise AssertionError(f"round kernel ({what}): no categorical variant")
    kwc = dict(params=params, W=W, shift=shift, categorical_mask=cmask)
    out["round_cat_ms"] = cuda_ms(lambda: rc.round_megakernel(*args, **kwc), iters=10,
                                  warmup=2)
    out["round_cat_plain_ms"] = cuda_ms(lambda: rc.round_megakernel_plain(*args, **kwc),
                                        iters=2, warmup=1)
    out["round_cat_bound_ms"], out["round_cat_bound_by"] = round_bounds(
        args, W, EPS_CAT_COLS)[0]["total"]
    kw = dict(params=params, W=W, shift=shift)
    out.update(W=W, in_seg=int(sp["seg_len"].sum()))
    out["part_ms"] = cuda_ms(lambda: pc.partition_segments(*pa))
    out["part_plain_ms"] = cuda_ms(lambda: pc.partition_segments_plain(*pa),
                                   iters=5, warmup=1)
    lib = library_partition(*pa)
    if not torch.equal(lib(), new_order):
        raise AssertionError("the stable-sort yardstick disagrees")
    out["part_library_ms"] = cuda_ms(lib)
    out["part_device_ms"], out["part_seen"] = partition_device_ms(
        lambda: pc.partition_segments(*pa))
    out["part_floor_ms"] = launch_floor_ms(dev)
    out["part_bound_ms"] = bound_of(partition_bytes(n, out["in_seg"]), 0)[0]
    out["round_ms"] = cuda_ms(lambda: rc.round_megakernel(*args, **kw), iters=10,
                              warmup=2)
    out["round_plain_ms"] = cuda_ms(lambda: rc.round_megakernel_plain(*args, **kw),
                                    iters=2, warmup=1)
    bounds, out["window_rows"] = round_bounds(args, W)
    out["round_bound_ms"], out["round_bound_by"] = bounds["total"]
    out["round_phases"] = round_phases(rc, args, kw)
    out["round_phase_bounds"] = bounds
    # B3 unfused (phase 23a): the partition and the window pass, the sums
    # left in fixed point, bitwise against the plain version
    ua = args[:11]
    ukw = dict(num_bins=b, W=W, shift=shift)
    ko, po = rc.round_partition_window(*ua, **ukw), rc.round_partition_window_plain(*ua, **ukw)
    for name, x, y in zip(("new order", "acc64", "acc32"), ko, po):
        same(x, y, f"round kernel unfused: {name}")
    out["unfused_ms"] = cuda_ms(lambda: rc.round_partition_window(*ua, **ukw), iters=10,
                                warmup=2)
    out["unfused_plain_ms"] = cuda_ms(lambda: rc.round_partition_window_plain(*ua, **ukw),
                                      iters=2, warmup=1)
    out["unfused_bound_ms"], out["unfused_bound_by"] = bounds["unfused"]
    del ko, po
    del base, args, wa
    torch.cuda.empty_cache()

    # int8 leaf tile: partition and the int8 window pass
    gq, hq = quantize_gradients(grad, hess, mask, 4, False, None)[:2]
    sq = split_case(bins, b, tile_q, SEED + 7)
    _, new_q = partition(sq, f"T={tile_q}")
    Wq = _window_size(int(sq["win_cnt"].sum()), n)
    qa = (new_q, bins, (gq, hq), mask, sq["win_start"], sq["win_cnt"], Wq, tile_q, b)
    same(rc.window_histograms(hc.histogram_multi_quantized, *qa),
         rc.window_histograms(hc.histogram_multi_quantized_plain, *qa),
         f"int8 window pass (T={tile_q})")
    out.update(Wq=Wq, int8_window_ms=cuda_ms(
        lambda: rc.window_histograms(hc.histogram_multi_quantized, *qa), iters=5,
        warmup=1))
    # the kernel alone, on the window gathered as the three-pass round does
    wrows, wslot, valid = rc.window_rows(new_q, sq["win_start"], sq["win_cnt"], Wq)
    ga = (bins.index_select(0, wrows), gq[wrows], hq[wrows], mask[wrows] & valid, wslot,
          0, tile_q, b)
    out["int8_hist_ms"] = cuda_ms(lambda: hc.histogram_multi_quantized(*ga), iters=5,
                                  warmup=1)
    out["int8_hist_plain_ms"] = cuda_ms(lambda: hc.histogram_multi_quantized_plain(*ga),
                                        iters=2, warmup=1)
    lib, rows = library_call(ga[0], ga[1:3], ga[3], ga[4], 0, tile_q, b, torch.int32)
    out["int8_hist_library_ms"] = cuda_ms(lib, iters=2, warmup=1)
    out["int8_hist_bound_ms"], out["int8_hist_bound_by"] = bound(Wq, f, tile_q, b, rows, 1, 4)
    del qa, ga, lib, rows
    torch.cuda.empty_cache()

    # the edge geometries of the partition, each against the plain version
    for name in PARTITION_EDGES:
        order, seg_start, seg_len, go = (torch.from_numpy(v).to(dev) for v in partition_edge(name))
        n_left = pc.partition_segments_plain(order, seg_start, seg_len, go)[1]
        partition(dict(order=order, seg_start=seg_start, seg_len=seg_len, go=go, n_left=n_left),
                  name)
    out["edges"] = len(PARTITION_EDGES)

    # ragged: partition and round kernel (all options)
    nr, nf = 100_003, 257
    rb = bins[:nr, :nf].contiguous()
    sr = split_case(rb, b, 6, SEED + 6, ragged=True)
    partition(sr, "ragged")
    Wr = _window_size(int(sr["win_cnt"].sum()), nr)
    args = with_outputs(round_case(rb, grad[:nr], hess[:nr], nbpf[:nf].contiguous(),
                                   mbpf[:nf].contiguous(), b, sr, shift), full)
    kw = dict(params=full, W=Wr, shift=shift)
    compare_round(rc.round_megakernel(*args, **kw), rc.round_megakernel_plain(*args, **kw),
                  "ragged")
    del args, rb
    torch.cuda.empty_cache()
    return out


def trees_agree(a, b) -> float:
    """Megakernel and three-pass trees: every node's feature, threshold and
    default direction and every leaf count equal; leaf values within 1e-5
    relative.  Returns the largest relative leaf-value gap."""
    worst = 0.0
    for i, (ta, tb) in enumerate(zip(a._gbdt.models, b._gbdt.models)):
        if ta.num_leaves != tb.num_leaves:
            raise AssertionError(f"tree {i}: {ta.num_leaves} vs {tb.num_leaves} leaves")
        for name in ("split_feature", "threshold_bin", "leaf_count"):
            if not np.array_equal(getattr(ta, name), getattr(tb, name)):
                raise AssertionError(f"tree {i}: {name} differs")
        if not np.array_equal(ta.default_left(), tb.default_left()):
            raise AssertionError(f"tree {i}: default_left differs")
        if not (ta.num_cat == tb.num_cat
                and np.array_equal(ta.cat_boundaries, tb.cat_boundaries)
                and np.array_equal(ta.cat_threshold, tb.cat_threshold)):
            raise AssertionError(f"tree {i}: categorical splits differ")
        gap = np.abs(ta.leaf_value - tb.leaf_value) / (np.abs(tb.leaf_value) + 1e-12)
        worst = max(worst, float(gap.max()))
    if len(a._gbdt.models) != len(b._gbdt.models) or not worst <= 1e-5:
        raise AssertionError(f"leaf values differ by {worst} relative")
    return worst


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --variants [CHECKOUT]: the design choices of the
# histogram, partition and round kernels timed against each other in turns,
# each a patched copy of csrc/ built beside the package's own (and, given
# another checkout of the repo, that checkout's wrappers and kernels as one
# more variant)
# ---------------------------------------------------------------------------
# The split search with its lanes over 32 bins at a time and a carry between
# steps: replaces round.cu's lane-run prefix, up to the per-bin evaluation.
GAIN_PER32 = """\
  double carry_g = 0.0, carry_h = 0.0, carry_c = 0.0;
  float best = -INFINITY, blg = 0.f, blh = 0.f, blc = 0.f;
  int bthr = INT_MAX;
  bool bleft = false;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    double xg = 0.0, xh = 0.0, xc = 0.0;
    if (b < B && b != mb) {
      xg = (double)hg[b];
      xh = (double)hh[b];
      xc = (double)hc[b];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double yg = __shfl_up_sync(0xffffffffu, xg, o);
      const double yh = __shfl_up_sync(0xffffffffu, xh, o);
      const double yc = __shfl_up_sync(0xffffffffu, xc, o);
      if (lane >= o) {
        xg += yg;
        xh += yh;
        xc += yc;
      }
    }
    const double cg = carry_g + xg, chs = carry_h + xh, cc = carry_c + xc;
    carry_g = __shfl_sync(0xffffffffu, cg, 31);
    carry_h = __shfl_sync(0xffffffffu, chs, 31);
    carry_c = __shfl_sync(0xffffffffu, cc, 31);
    if (b >= B) continue;
"""

# name -> patches (file, old text or (start, end) of a span, new text)
VARIANTS = {
    "kept": [],
    "lookahead1": [("hist_common.cuh", "kLookahead = 4;", "kLookahead = 1;")],
    "lookahead8": [("hist_common.cuh", "kLookahead = 4;", "kLookahead = 8;")],
    "slots_max": [("hist_common.cuh", "for (int sb = 1; sb <= sb_max; ++sb)",
                   "for (int sb = sb_max; sb <= sb_max; ++sb)")],
    "waves2": [("hist_common.cuh", "wave = (int64_t)sms * occ;",
                "wave = (int64_t)sms * occ * 2;")],
    "gain_per32": [("round.cu", ("  const int K = (B + 31) / 32;",
                                 "    const float sg = (float)cg"), GAIN_PER32)],
}
# B2 as two cooperative launches, a count launch and a move launch (the
# move's chunks read their prefixes from the count launch's status words), in
# place of one launch with a grid-wide barrier between the two passes.
TWO_LAUNCH_KERNELS = """__global__ void __launch_bounds__(kBlock)
partition_count_kernel(PartitionArgs a) {
  __shared__ ChunkTable t;
  const unsigned epoch = begin_launch(a, t, true);
  partition_chunks<kCountMode>(a, t, epoch);
  finish_launch(a.scratch);
}

__global__ void __launch_bounds__(kBlock)
partition_move_kernel(PartitionArgs a) {
  __shared__ ChunkTable t;
  const unsigned epoch = begin_launch(a, t, false);
  partition_chunks<kMoveMode>(a, t, epoch);
  finish_launch(a.scratch);
}

// One wave of resident blocks of ``kernel``"""
TWO_LAUNCHES = """    return cudaErrorInvalidValue;
  if (!n_left_given) {
    const void* count = reinterpret_cast<const void*>(partition_count_kernel);
    const void* move = reinterpret_cast<const void*>(partition_move_kernel);
    void* args[] = {&a};
    int grid = 0;
    cudaError_t e = partition_grid(count, chunks_of(a.n) + a.S, &grid);
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(count, dim3(grid), dim3(kBlock), args, 0, st);
    if (e == cudaSuccess) e = partition_grid(move, chunks_of(a.n) + 2 * (int64_t)a.S + 1, &grid);
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(move, dim3(grid), dim3(kBlock), args, 0, st);
    return e;
  }
  const void* fn = n_left_given"""
VARIANTS["two_launches"] = [
    ("partition_common.cuh", "// One wave of resident blocks of ``kernel``", TWO_LAUNCH_KERNELS),
    ("partition_common.cuh", "    return cudaErrorInvalidValue;\n  const void* fn = n_left_given",
     TWO_LAUNCHES)]
# Chunks of 1024 and 2048 positions, 1 and 2 a thread (more chunks, fewer
# loads in flight a thread).
VARIANTS.update({f"items{k}": [("partition_common.cuh", "constexpr int kItems = 4;",
                                f"constexpr int kItems = {k};")] for k in (1, 2)})
# The order copied whole by the copy engine before the kernel, which then
# skips the gap chunks (the parent's way of keeping the other positions).
VARIANTS["memcpy"] = [
    ("partition_common.cuh",
     "  const int total = kMode == kCountMode ? n_seg : t.gap_first[a.S + 1];",
     "  const int total = n_seg;"),
    ("partition_common.cuh", "  void* args[] = {&a};\n",
     "  void* args[] = {&a};\n"
     "  e = cudaMemcpyAsync(a.out, a.order, (size_t)a.n * 4, cudaMemcpyDeviceToDevice, st);\n"
     "  if (e != cudaSuccess) return e;\n")]
# Timing only (wrong sums by design): skipping every cell of the flush
# leaves the rest of the call, so the kept time less this one's is the
# flush's share (its global atomics and the shared words' reset).
PROBES = {"no_flush": [("hist_common.cuh", "if (cnt == 0) continue;",
                        "if (cnt != 0xffffffffu) continue;")]}


def variant_sources(name, patches, csrc):
    """A copy of ``csrc`` under build/variants/<name> with ``patches``
    applied (each old text or span start must occur exactly once)."""
    from lightgbm_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for fname, old, new in patches:
        path = d / fname
        text = path.read_text()
        first = old[0] if isinstance(old, tuple) else old
        if text.count(first) != 1:
            raise AssertionError(f"variant {name}: {first!r} is not in {fname} once")
        i = text.index(first)
        j = text.index(old[1], i) if isinstance(old, tuple) else i + len(old)
        path.write_text(text[:i] + new + text[j:])
    return d


def ptxas_summary(log_text):
    """Registers and spill bytes of each kernel in an nvcc -Xptxas -v log."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log_text)]
    return f"registers {regs} spill bytes {sum(spills)}"


def load_checkout(root):
    """Another checkout's lightgbm_tpu_torch, imported beside this one as
    the package ``checkout_lgt``: its (hist_cuda, partition_cuda,
    round_cuda), whose wrappers call its own kernels (built into the
    checkout's build/), so a checkout whose C interfaces differ is timed
    through its own wrappers."""
    import importlib
    import importlib.util

    pkg = Path(root).resolve() / "lightgbm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "checkout_lgt", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    sys.modules["checkout_lgt"] = mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"checkout_lgt.ops.{m}")
                 for m in ("hist_cuda", "partition_cuda", "round_cuda"))


def turns(checkout) -> int:
    """The Higgs-shaped cell (phase 3's data and parameters, 20 rounds)
    trained by another checkout's package (``checkout_lgt``, e.g. the
    parent commit's, with its defaults) and by this one in graph and in
    eager mode, in turns: it/s and model sha256 of each run, so both modes
    are held against the other checkout on one card in one call."""
    import lightgbm_tpu_torch as lgt

    load_checkout(checkout)
    other = sys.modules["checkout_lgt"]
    X, y = higgs_like(N_TRAIN + N_TEST, SEED)
    base = {"objective": "binary", "max_bin": MAX_BIN, "num_leaves": NUM_LEAVES,
            "learning_rate": 0.1, "device_type": "cuda", "verbosity": -1, "seed": 7}
    sets = {}
    for name, pkg in (("checkout", other), ("this", lgt)):
        sets[name] = pkg.Dataset(X[:N_TRAIN], label=y[:N_TRAIN], params=dict(base))
        sets[name].construct()
    runs = [("checkout", other, {}), ("this graph", lgt, {"fused_training": True}),
            ("this eager", lgt, {"fused_training": False})]
    for label, pkg, extra in runs + runs[::-1]:
        bst, it_s = train_timed(pkg, {**base, **extra}, sets[label.split()[0]],
                                ROUNDS_FLOAT)
        log(f"turns {label}: {ROUNDS_FLOAT} rounds it/s={it_s:.4f} "
            f"model_sha256={model_sha(bst)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    return 0


def variants(parent) -> int:
    """Every variant's histogram, partition and round libraries, built at
    once (a variant that nvcc refuses is reported and left out); then, in
    turns (each variant once forward, once in reverse order), each held bit
    for bit against the plain versions and timed with CUDA events: B1 at
    the phase 2 shapes (1M x 28, float tile 8, int8 tile 20), the Epsilon
    root pass (400k x 2000, tile 1), the int8 window pass on a gathered T =
    20 window, B2 at phase 7's geometry (T = 10 and T = 20 segments tiling
    400k positions) and on one chunk (N = 3000, its fixed cost) with its
    device time from a profiler window, and B3 at
    phase 7's geometry (T = 10, W = 131,072) with its phases from a
    profiler window; beside them the floor of one launch from Python.  Then
    two probes of the kept kernels: the flush's share of each call
    (PROBES), and the root pass on bins that put a warp's atomics on 32
    banks or on one.  Bins are seeded random (no binning), so each
    segment's go flags come from a seeded threshold on a random bin, as
    phase 7's do from the real bins."""
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.ops.treegrow_windowed import _window_size

    dev = torch.device("cuda", 0)
    mods = (hc, pc, rc)
    n_base = len(cuda_build.NVCC_FLAGS)
    trios = {}
    for name, patches in {**VARIANTS, **PROBES}.items():
        d = variant_sources(name, patches, cuda_build.CSRC)
        trios[name] = tuple(cuda_build.KernelLibrary(str(d / m.LIBRARY.src.name), m._bind,
                                                     m.LIBRARY.flags[n_base:]) for m in mods)
    checkout = load_checkout(parent) if parent else None
    if checkout:
        trios["checkout"] = tuple(m.LIBRARY for m in checkout)
    # variants that patch one file share the others' libraries: build each once
    built = {lib.target(): lib for trio in trios.values() for lib in trio}
    t0 = time.perf_counter()
    procs = {so: lib.start(force=True) for so, lib in built.items()}
    refused = set()
    for so, lib in built.items():
        try:
            lib.finish(procs[so])
        except RuntimeError as e:
            log(f"variant library {so.name} not built: {e}")
            refused.add(so)
    trios = {name: trio for name, trio in trios.items()
             if not any(lib.target() in refused for lib in trio)}
    log(f"variants built: {len(built) - len(refused)} libraries in "
        f"{time.perf_counter() - t0:.2f} s; timed: {' '.join(trios)}")
    for name, trio in trios.items():
        for lib in trio:
            so = lib.target()
            log(f"variant {name} {lib.src.name}: {ptxas_summary(built[so].log)}; sass "
                f"atomics {sass_summary(so, cuda_build.nvcc())}")

    def use(name):
        """The (hist, partition, round) modules that run variant ``name``."""
        if name == "checkout":
            return checkout
        hc.LIBRARY, pc.LIBRARY, rc.LIBRARY = trios[name]
        return mods

    bins, grad, hess, mask, slot, gq, hq = kernel_inputs(N_TRAIN, N_FEAT, MAX_BIN, 20, 0, 1,
                                                         dev)
    hf = (bins, grad, hess, mask, slot, 0, 8, MAX_BIN)
    hqa = (bins, gq, hq, mask, slot, 0, 20, MAX_BIN)
    n, f = EPS_N_TRAIN, EPS_FEAT
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ebins = torch.randint(0, MAX_BIN, (n, f), generator=g, device=dev, dtype=torch.int16)
    eg = torch.randn(n, generator=g, device=dev) * 0.3
    eh = torch.rand(n, generator=g, device=dev) * 0.25
    emask = torch.ones(n, dtype=torch.bool, device=dev)
    shift = hc.fixed_shift_pair(eg, eh)
    shift_t = hc.fixed_shift_tensor(eg, eh)
    ra = (ebins, eg, eh, emask, torch.zeros(n, dtype=torch.int32, device=dev), 0, 1, MAX_BIN)
    nbpf = torch.full((f,), MAX_BIN, dtype=torch.int32, device=dev)
    mbpf = torch.full((f,), -1, dtype=torch.int32, device=dev)
    mbpf[::3] = MAX_BIN - 1
    prm = SplitParams(min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    sp = split_case(ebins, MAX_BIN, 10, SEED + 5)
    W = _window_size(int(sp["win_cnt"].sum()), n)
    args = with_outputs(round_case(ebins, eg, eh, nbpf, mbpf, MAX_BIN, sp, shift), prm)
    kw = dict(params=prm, W=W, shift=shift)
    gqe = torch.randint(-8, 9, (n,), generator=g, device=dev, dtype=torch.int8)
    hqe = torch.randint(0, 17, (n,), generator=g, device=dev, dtype=torch.int8)
    sq = split_case(ebins, MAX_BIN, 20, SEED + 7)
    pa10 = (sp["order"], sp["seg_start"], sp["seg_len"], sp["go"])
    pa20 = (sq["order"], sq["seg_start"], sq["seg_len"], sq["go"])
    pa_tiny = tuple(torch.from_numpy(v).to(dev) for v in partition_edge("below_one_chunk"))
    new_q = pc.partition_segments_plain(*pa20)[0]
    Wq = _window_size(int(sq["win_cnt"].sum()), n)
    wrows, wslot, valid = rc.window_rows(new_q, sq["win_start"], sq["win_cnt"], Wq)
    ga = (ebins.index_select(0, wrows), gqe[wrows], hqe[wrows], emask[wrows] & valid, wslot,
          0, 20, MAX_BIN)
    # the variants with fewer positions a thread need more status words than
    # the kept chunk size allocates: grow the shared scratch once for them
    pc.scratch(dev, torch.cuda.current_stream(dev).cuda_stream, n * pc.CHUNK // 1024, 20)
    want = dict(higgs_f=hc.histogram_multi_plain(*hf),
                higgs_q=hc.histogram_multi_quantized_plain(*hqa),
                root=hc.histogram_multi_plain(*ra, shift=shift),
                int8_win=hc.histogram_multi_quantized_plain(*ga),
                round=rc.round_megakernel_plain(*args, **kw),
                part10=pc.partition_segments_plain(*pa10),
                part20=pc.partition_segments_plain(*pa20),
                part_tiny=pc.partition_segments_plain(*pa_tiny))
    log(f"variants inputs: round T=10 W={W} window rows {int(sp['win_cnt'].sum())}; "
        f"int8 window T=20 W={Wq}; partition N={n} T=10 and T=20, and N=3000 (one chunk)")

    def calls(mh, mp, mr):
        # wrappers that read the exponents from device memory take them as
        # a tensor (a pair of ints would cost them a copy a call)
        s = shift_t if hasattr(mh, "shift_on") else shift
        return dict(higgs_f=lambda: mh.histogram_multi(*hf),
                    higgs_q=lambda: mh.histogram_multi_quantized(*hqa),
                    root=lambda: mh.histogram_multi(*ra, shift=s),
                    int8_win=lambda: mh.histogram_multi_quantized(*ga),
                    round=lambda: mr.round_megakernel(*args, **{**kw, "shift": s}),
                    part10=lambda: mp.partition_segments(*pa10),
                    part20=lambda: mp.partition_segments(*pa20),
                    part_tiny=lambda: mp.partition_segments(*pa_tiny))

    def iters(k):
        return 20 if k.startswith(("higgs", "part")) else 5

    turns = [name for name in trios if name not in PROBES]
    times = {name: [] for name in turns}
    for name in turns + turns[::-1]:
        trio = use(name)
        fns = calls(*trio)
        for k, fn in fns.items():
            if k == "round":
                compare_round(fn(), want[k], f"variant {name}")
            elif k.startswith("part"):
                got = fn()
                same(got[0], want[k][0], f"variant {name} {k} order")
                same(got[1], want[k][1], f"variant {name} {k} left counts")
            else:
                same(fn(), want[k], f"variant {name} {k}")
        t = {k: cuda_ms(fn, iters=iters(k), warmup=2) for k, fn in fns.items()}
        for k in ("part10", "part20", "part_tiny"):
            t[f"{k}_device"], t[f"{k}_seen"] = partition_device_ms(fns[k])
        t["floor"] = launch_floor_ms(dev)
        ph = round_phases(trio[2], args, kw)
        t["round_partition"] = ph["partition"]
        t["round_phases"] = ph
        times[name].append(t)
        log(f"variant {name} turn {len(times[name])}: bitwise_plain=True ms "
            + json.dumps(t))
    for name, ts in times.items():
        log(f"variant {name} mean of {len(ts)} turns: " + json.dumps(
            {k: sum(t[k] for t in ts) / len(ts) for k in ts[0] if k != "round_phases"}))
    flush = {"kept": [], "no_flush": []}
    for name in ("kept", "no_flush", "no_flush", "kept"):
        fns = {k: fn for k, fn in calls(*use(name)).items() if not k.startswith("part")}
        flush[name].append({k: cuda_ms(fn, iters=iters(k), warmup=2) for k, fn in fns.items()})
    mean = {name: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]}
            for name, ts in flush.items()}
    log("flush probe ms: " + json.dumps(mean) + " flush share: " + json.dumps(
        {k: 1 - mean["no_flush"][k] / mean["kept"][k] for k in mean["kept"]}))
    # Bank probe: the kept root pass on bins laid out so that a warp's lanes
    # (consecutive features of one row, cells bin_stride(B) = 255 apart, so
    # bank = bin - feature mod 32) hit 32 different banks (bin = 2f + r), or
    # one bank (bin = f + r), against the seeded random bins above.
    use("kept")
    fr = (torch.arange(f, device=dev)[None, :], torch.arange(n, device=dev)[:, None])
    probe = {"random": ebins}
    for name, k in (("32_banks", 2), ("one_bank", 1)):
        probe[name] = ((k * fr[0] + fr[1]) % MAX_BIN).to(torch.int16)
    ms = {}
    for name, pb in probe.items():
        pa = (pb,) + ra[1:]
        same(hc.histogram_multi(*pa, shift=shift_t),
             hc.histogram_multi_plain(*pa, shift=shift), f"bank probe {name}")
        ms[name] = cuda_ms(lambda: hc.histogram_multi(*pa, shift=shift_t), iters=5, warmup=2)
    log("bank probe, root pass ms: " + json.dumps(ms))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    return 0


# ---------------------------------------------------------------------------
# phases 10-12: the strict grower, multiclass and LambdaRank
# ---------------------------------------------------------------------------
def multiclass_like(n: int, k: int, seed: int):
    """benchmarks/workload_smoke.py::bench_multiclass's generator: 28
    standard normal features, the class of the largest of k noisy
    projections on random centers."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, MC_FEAT).astype(np.float32)
    centers = rng.randn(k, MC_FEAT)
    y = np.argmax(X @ centers.T + rng.randn(n, k), axis=1).astype(np.float64)
    return X, y


def query_sizes(rng, n: int) -> np.ndarray:
    """Query lengths uniform in [RK_QMIN, RK_QMAX] (mean 120, as in
    MSLR-WEB30K), the last cut so that they sum to n."""
    sizes = rng.randint(RK_QMIN, RK_QMAX + 1, size=n // RK_QMIN + 2)
    sizes = sizes[:int(np.searchsorted(np.cumsum(sizes), n)) + 1].copy()
    sizes[-1] -= int(sizes.sum()) - n
    return sizes


def mslr_like(seed: int):
    """A seeded set of the shape of MSLR-WEB30K: RK_N_TRAIN + RK_N_TEST rows
    of 136 features in queries of 60-180 documents, relevance 0-4 by the
    rank of a noisy linear score within its query, as
    benchmarks/workload_smoke.py::bench_rank labels them.  Returns (X, y,
    train query sizes, held-out query sizes); the held-out queries follow
    the training ones."""
    rng = np.random.RandomState(seed)
    s_tr, s_te = query_sizes(rng, RK_N_TRAIN), query_sizes(rng, RK_N_TEST)
    sizes = np.concatenate([s_tr, s_te])
    n = int(sizes.sum())
    X = rng.randn(n, RK_FEAT).astype(np.float32)
    rel = X @ (rng.randn(RK_FEAT) / 8) + 0.7 * rng.randn(n)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    order = np.lexsort((-rel, qid))  # by query, then by score descending
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - start[qid[order]]
    y = np.clip(4 - rank // (sizes[qid] // 5 + 1), 0, 4).astype(np.float64)
    return X, y, s_tr, s_te


def check_b1_site(hc, bins, grad, hess, mask, slot, tile, num_bins, precision="f32"):
    """B1 at one of its call sites, on that path's own inputs and with the
    tree's exponent pair (fixed_shift_tensor), as the grower calls it:
    kernel against plain version bit for bit, then the kernel's, the plain
    version's and the library call's times and the bound of this data.
    ``precision="bf16"``: the payload rounded to bfloat16 as the rounds
    grower rounds it (once, before the pass), read as 2 bytes a value; the
    library call adds the rounded values."""
    if precision == "bf16":
        grad, hess = grad.to(torch.bfloat16), hess.to(torch.bfloat16)
    shift = hc.fixed_shift_tensor(grad.float(), hess.float())
    args = (bins, grad, hess, mask, slot, 0, tile, num_bins)
    k = hc.histogram_multi(*args, shift=shift, precision=precision)
    p = hc.histogram_multi_plain(*args, shift=shift, precision=precision)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(f"B1 (tile {tile}) differs from its plain version: "
                             f"max|d| {float((k - p).abs().max())}")
    if float(k[:, 2].sum()) <= 0:
        raise AssertionError("B1: empty histogram")
    ms = cuda_ms(lambda: hc.histogram_multi(*args, shift=shift, precision=precision))
    plain_ms = cuda_ms(lambda: hc.histogram_multi_plain(*args, shift=shift,
                                                        precision=precision),
                       iters=3, warmup=1)
    lib, rows = library_call(bins, (grad.float(), hess.float()), mask, slot, 0, tile,
                             num_bins, torch.float32)
    library_ms = cuda_ms(lib)
    n, f = bins.shape
    b_ms, b_by = bound(n, f, tile, num_bins, rows, grad.element_size(), 4)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, rows=int(rows.numel()), tile=tile)


def b1_line(what, r) -> str:
    return (f"{what}: tile={r['tile']} rows={r['rows']} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) bitwise_plain=True")


def b1_entry(name, r, launches, per_replay):
    return {"name": name, "route": "cuda", "source": "lightgbm_tpu_torch/csrc/hist.cu",
            "replaces": "lightgbm_tpu/ops/hist_pallas.py:120", "launches": launches,
            "in_graph": per_replay > 0, "launches_per_replay": per_replay,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]}


def round_slots(n, tile, seed, dev):
    """The slots a round of the rounds grower hands B1: each row in one of
    ``tile`` small children or (about half the rows) in none (-1)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    s = torch.randint(-tile, tile, (n,), generator=g, device=dev, dtype=torch.int32)
    return torch.where(s < 0, -1, s).to(torch.int32)


def objective_inputs(name, n, rng, rank_label, rank_qb):
    """Seeded (score, label, weight, query boundaries, params) for one
    objective at n rows."""
    params = {"objective": name, "verbosity": -1}
    score = rng.standard_normal(n).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    qb = None
    if name in ("multiclass", "multiclassova"):
        params["num_class"] = MC_CLASSES
        score = rng.standard_normal((n, MC_CLASSES)).astype(np.float32)
        label = rng.integers(0, MC_CLASSES, n).astype(np.float32)
    elif name in ("lambdarank", "rank_xendcg"):
        label, qb, weight = rank_label.astype(np.float32), rank_qb, None
    elif name in ("cross_entropy", "cross_entropy_lambda"):
        label = rng.random(n).astype(np.float32)
    elif name in ("poisson", "tweedie"):
        label = rng.poisson(2.0, n).astype(np.float32)
        score *= 0.5
    elif name == "gamma":
        label = rng.gamma(2.0, 1.5, n).astype(np.float32)
        score *= 0.5
    else:
        label = (3.0 * rng.standard_normal(n)).astype(np.float32)
    return score, label, weight, qb, params


def check_new_objectives(rank_label, rank_qb, dev):
    """Every objective this slice added: gradients and hessians on the card
    against the same objective on the CPU, on the same seeded inputs at
    RK_N_TRAIN rows (the ranking ones on phase 12's queries; XE-NDCG with
    one set of draws given to both).  Fails where the largest difference
    exceeds OBJECTIVE_RTOL x the largest CPU magnitude (f32 arithmetic in
    another order: the card's reductions and transcendentals)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objectives import create_objective

    rng = np.random.default_rng(SEED + 6)
    out = {}
    n = RK_N_TRAIN
    for name in NEW_OBJECTIVES:
        score, label, weight, qb, params = objective_inputs(name, n, rng, rank_label,
                                                            rank_qb)
        res = []
        u = None
        for d in (dev, torch.device("cpu")):
            obj = create_objective(Config.from_dict(params))
            if qb is not None:
                obj.set_query(qb, label, d)
                if u is None:
                    u = torch.rand(tuple(obj._pad_idx.shape),
                                   generator=torch.Generator().manual_seed(SEED))
                obj.draws = lambda shape, device: u.to(device)
            g, h = obj.get_gradients(
                torch.as_tensor(score, device=d), torch.as_tensor(label, device=d),
                None if weight is None else torch.as_tensor(weight, device=d))
            res.append((g.cpu(), h.cpu()))
        (gc, hc), (gp, hp) = res
        errs = []
        for a, b in ((gc, gp), (hc, hp)):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{name}: card output {tuple(a.shape)} not finite "
                                     f"or not the CPU's {tuple(b.shape)}")
            err = float((a - b).abs().max())
            scale = max(1.0, float(b.abs().max()))
            if not err <= OBJECTIVE_RTOL * scale:
                raise AssertionError(f"{name}: card vs CPU max|d| {err} > "
                                     f"{OBJECTIVE_RTOL} x {scale}")
            errs.append(err)
        out[name] = tuple(errs)
    return out


def _wrappers():
    from lightgbm_tpu_torch.ops import hist_cuda, partition_cuda, round_cuda

    return hist_cuda, partition_cuda, round_cuda


def reset():
    """Every kernel wrapper's launch and plain-call counts to 0."""
    for m in _wrappers():
        m.reset_counts()


def plain_total() -> int:
    return sum(sum(m.plain_calls.values()) for m in _wrappers())


def counts():
    """Launches of (B1 float, B1 int8, B2, B3) since the last reset."""
    hc, pc, rc = _wrappers()
    return (hc.launches["histogram_multi"], hc.launches["histogram_multi_quantized"],
            pc.launches["partition_segments"], rc.launches["round_megakernel"])


def higgs_cell(lgt):
    """Phase 3's Higgs-shaped set and parameters: (base params, (train set,
    Xtr, ytr, Xte, yte))."""
    X, y = higgs_like(N_TRAIN + N_TEST, SEED)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    base = {"objective": "binary", "max_bin": MAX_BIN, "num_leaves": NUM_LEAVES,
            "learning_rate": 0.1, "device_type": "cuda", "verbosity": -1,
            "seed": 7}
    # the Dataset keeps its raw values on the card for phase 17's linear
    # trees (a Dataset parameter: the bins and every other training are the
    # same)
    train_set = lgt.Dataset(Xtr, label=ytr, params={**base, "linear_tree": True})
    train_set.construct()
    return base, (train_set, Xtr, ytr, Xte, yte)


def new_phases(lgt, dev, base, higgs, counts, plain_total):
    """Phases 10-12 (the strict grower on the Higgs cell, multiclass,
    LambdaRank); ``higgs`` is phase 3's (train set, Xtr, ytr, Xte, yte).
    Returns the kernel line's B1 entries of their call sites, and the
    LambdaRank model's text with 100,000 of its rows for phase 14."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    h_set, h_Xtr, h_ytr, h_Xte, h_yte = higgs

    # ---- 10. the strict grower on the Higgs cell (eager) ----
    from lightgbm_tpu_torch.utils import sanitizer as san

    t0 = time.perf_counter()
    strict = {**base, "tree_growth_mode": "strict"}
    with san.DispatchCounter() as c10:
        runs10 = train_turns(lgt, strict, h_set, ROUNDS_STRICT, MODEL_SHA["higgs_strict"],
                             counts, plain_total, turns=("ineligible", "ineligible"))
    # the strict path's one read an iteration: its finish check (fault C9)
    reads_iter = c10.host_syncs / (len(runs10) * ROUNDS_STRICT)
    if reads_iter != 1:
        raise AssertionError(f"strict runs: {reads_iter} blocking reads an iteration")
    for r in runs10:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        # B1 at tile 1: the root and one a step (L - 1 steps, the masked
        # no-ops after the last split included); no read inside a tree
        if not (st["trees"] == ROUNDS_STRICT and st["rounds"] == st["trees"] * (NUM_LEAVES - 1)
                and b1 == st["trees"] * NUM_LEAVES and b1q == b2 == b3 == 0
                and st["host_syncs"] == 0):
            raise AssertionError(f"strict run: {st} launches {r['launches']}")
        log(turn_line("phase 10 strict (fused_training=true, not eligible: eager)", r))
    if len({r["sha"] for r in runs10}) != 1:
        raise AssertionError("strict runs grew different models")
    bst_s, b1_strict = runs10[0]["bst"], runs10[0]["launches"][0]
    ps = bst_s.predict(h_Xte)
    a_s = auc(h_yte, ps)
    if not (ps.shape == (N_TEST,) and np.all(np.isfinite(ps)) and a_s >= AUC_FLOOR_STRICT):
        raise AssertionError(f"strict run: held-out AUC {a_s} < floor {AUC_FLOOR_STRICT}")
    if not np.array_equal(ps, lgt.Booster(model_str=bst_s.model_to_string()).predict(h_Xte)):
        raise AssertionError("reloaded strict model predicts differently")
    small_err_s = small_vs_cpu(lgt, {**strict, "num_leaves": 15}, h_Xtr, h_ytr, h_Xte)
    log(f"phase 10 strict: ok {ROUNDS_STRICT} rounds auc={a_s:.5f} (floor "
        f"{AUC_FLOOR_STRICT}) B1 launches={b1_strict} ({b1_strict / ROUNDS_STRICT:.1f}/tree: "
        f"the root + {NUM_LEAVES - 1} steps) blocking reads inside trees=0, an iteration="
        f"{reads_iter:.2f} (the finish check) reload=bitwise "
        f"small-vs-cpu max|d|={small_err_s:.3g} in {time.perf_counter() - t0:.2f} s")
    log(profile_line("phase 10 profile strict (2 trees after a warm one)",
                     profile_rounds(lgt, strict, h_set, 2)))
    # B1 at its tile-1 call site: one child of a split on feature 0 at its
    # median bin, with the gradients of the model 5 trees in
    gb = bst_s._gbdt
    g10, h10 = (v.contiguous() for v in gb.objective.get_gradients(
        gb._score, gb._label, gb._weight))
    col = h_set.bins_device[:, 0]
    mask = col.float() <= col.float().median()
    slot0 = torch.zeros(N_TRAIN, dtype=torch.int32, device=dev)
    b1s = check_b1_site(hc, h_set.bins_device, g10, h10, mask, slot0, 1, h_set.max_num_bins)
    log(b1_line(f"phase 10 kernel B1 strict site N={N_TRAIN} F={N_FEAT}", b1s))
    del runs10, bst_s, gb, g10, h10, h_set

    # ---- 11. multiclass, graph and eager in turns ----
    t0 = time.perf_counter()
    X, y = multiclass_like(MC_N_TRAIN + MC_N_TEST, MC_CLASSES, SEED + 3)
    Xte, yte = X[MC_N_TRAIN:], y[MC_N_TRAIN:]
    mc = {"objective": "multiclass", "num_class": MC_CLASSES, "max_bin": MC_BIN,
          "num_leaves": NUM_LEAVES, "learning_rate": 0.1, "device_type": "cuda",
          "verbosity": -1, "seed": 7}
    mc_set = lgt.Dataset(X[:MC_N_TRAIN], label=y[:MC_N_TRAIN], params=dict(mc))
    mc_set.construct()
    log(f"phase 11 data: {MC_N_TRAIN}+{MC_N_TEST} rows x {MC_FEAT}, {MC_CLASSES} classes, "
        f"max_bin {MC_BIN}, in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    runs11 = train_turns(lgt, mc, mc_set, MC_ROUNDS, MODEL_SHA["multiclass"], counts,
                         plain_total)
    trees = MC_ROUNDS * MC_CLASSES
    for r in runs11:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        # the class trees' rounds share one static key: one capture a
        # training in graph mode, every round of every class tree a replay
        if not (st["trees"] == trees and b1 == trees + st["rounds"] + st["captures"]
                and b1q == b2 == b3 == 0 and st["host_syncs"] == 0
                and st["captures"] == (1 if r["mode"] == "graph" else 0)):
            raise AssertionError(f"multiclass {r['mode']} run: {st} launches {r['launches']}")
        log(turn_line("phase 11 multiclass", r))
    if len({r["sha"] for r in runs11}) != 1:
        raise AssertionError("multiclass graph and eager runs grew different models")
    bst_m, st_m = runs11[0]["bst"], runs11[0]["st"]
    b1_mc, per_replay_mc = runs11[0]["launches"][0], st_m["per_replay"].get("histogram_multi", 0)
    pm = bst_m.predict(Xte)
    if not (pm.shape == (MC_N_TEST, MC_CLASSES) and np.all(np.isfinite(pm))
            and np.allclose(pm.sum(axis=1), 1.0, atol=1e-5)):
        raise AssertionError("multiclass predictions are not (N, K) probabilities")
    mc_ll = float(np.mean(-np.log(np.clip(pm[np.arange(MC_N_TEST), yte.astype(int)],
                                          1e-15, None))))
    mc_err = float(np.mean(np.argmax(pm, axis=1) != yte))
    if not (mc_ll <= MC_LOGLOSS_CEIL and mc_err <= MC_ERROR_CEIL):
        raise AssertionError(f"multiclass held-out multi_logloss {mc_ll} / multi_error "
                             f"{mc_err} over {MC_LOGLOSS_CEIL} / {MC_ERROR_CEIL}")
    if not np.array_equal(pm, lgt.Booster(model_str=bst_m.model_to_string()).predict(Xte)):
        raise AssertionError("reloaded multiclass model predicts differently")
    log(f"phase 11 multiclass: ok {MC_ROUNDS} rounds ({trees} trees) multi_logloss="
        f"{mc_ll:.5f} (ceiling {MC_LOGLOSS_CEIL}) multi_error={mc_err:.5f} (ceiling "
        f"{MC_ERROR_CEIL}) captures={st_m['captures']} replays/tree="
        f"{st_m['replays'] / st_m['trees']:.2f} B1 launches={b1_mc} reload=bitwise graph == "
        f"eager sha256 in {time.perf_counter() - t0:.2f} s")
    for mode in ("graph", "eager"):
        log(profile_line(f"phase 11 profile {mode} (2 iterations after a warm one)",
                         profile_rounds(lgt, {**mc, "fused_training": mode == "graph"},
                                        mc_set, 2)))
    gb = bst_m._gbdt
    g11, h11 = gb.objective.get_gradients(gb._score, gb._label, gb._weight)
    tile_m = hc.recommended_leaf_tile(mc_set.max_num_bins, MC_FEAT, NUM_LEAVES)
    b1m = check_b1_site(hc, mc_set.bins_device, g11[:, 0].contiguous(),
                        h11[:, 0].contiguous(), torch.ones(MC_N_TRAIN, dtype=torch.bool,
                                                           device=dev),
                        round_slots(MC_N_TRAIN, tile_m, SEED, dev), tile_m,
                        mc_set.max_num_bins)
    log(b1_line(f"phase 11 kernel B1 multiclass site N={MC_N_TRAIN} F={MC_FEAT} "
                f"B={mc_set.max_num_bins}", b1m))
    del runs11, bst_m, gb, g11, h11, mc_set, X, y, Xte, yte
    torch.cuda.empty_cache()

    # ---- 12. LambdaRank at MSLR-WEB30K width, graph and eager in turns ----
    t0 = time.perf_counter()
    X, y, s_tr, s_te = mslr_like(SEED + 4)
    t_gen = time.perf_counter() - t0
    rk = {"objective": "lambdarank", "max_bin": MAX_BIN, "num_leaves": RK_LEAVES,
          "learning_rate": 0.1, "device_type": "cuda", "verbosity": -1, "seed": 7,
          "bin_construct_sample_cnt": EPS_BIN_SAMPLE, "eval_at": list(RK_EVAL_AT)}
    rk_set = lgt.Dataset(X[:RK_N_TRAIN], label=y[:RK_N_TRAIN], group=s_tr, params=dict(rk))
    rk_set.construct()
    log(f"phase 12 data: {RK_N_TRAIN}+{len(X) - RK_N_TRAIN} rows x {RK_FEAT} in "
        f"{len(s_tr)}+{len(s_te)} queries of {RK_QMIN}-{RK_QMAX} documents, generated in "
        f"{t_gen:.2f} s, binned in {time.perf_counter() - t0 - t_gen:.2f} s")
    t0 = time.perf_counter()
    runs12 = train_turns(lgt, rk, rk_set, RK_ROUNDS, MODEL_SHA["lambdarank"], counts,
                         plain_total)
    for r in runs12:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        if not (st["trees"] == RK_ROUNDS and b1 == st["trees"] + st["rounds"] + st["captures"]
                and b1q == b2 == b3 == 0 and st["host_syncs"] == 0):
            raise AssertionError(f"lambdarank {r['mode']} run: {st} launches {r['launches']}")
        log(turn_line("phase 12 lambdarank", r))
    if len({r["sha"] for r in runs12}) != 1:
        raise AssertionError("lambdarank graph and eager runs grew different models")
    from lightgbm_tpu_torch.metrics import ndcg_at_k

    bst_r, st_r = runs12[0]["bst"], runs12[0]["st"]
    b1_rk, per_replay_rk = runs12[0]["launches"][0], st_r["per_replay"].get("histogram_multi", 0)
    pr = bst_r.predict(X[RK_N_TRAIN:])
    qb_te = np.concatenate([[0], np.cumsum(s_te)])
    gains = np.asarray([2.0 ** i - 1 for i in range(31)])
    ndcg = {k: ndcg_at_k(pr, y[RK_N_TRAIN:], qb_te, k, gains) for k in RK_EVAL_AT}
    if not (np.all(np.isfinite(pr)) and all(ndcg[k] >= NDCG_FLOORS[k] for k in RK_EVAL_AT)):
        raise AssertionError(f"lambdarank held-out NDCG {ndcg} under floors {NDCG_FLOORS}")
    if not np.array_equal(pr, lgt.Booster(model_str=bst_r.model_to_string()).predict(
            X[RK_N_TRAIN:])):
        raise AssertionError("reloaded lambdarank model predicts differently")
    log(f"phase 12 lambdarank: ok {RK_ROUNDS} rounds held-out "
        + " ".join(f"ndcg@{k}={ndcg[k]:.5f} (floor {NDCG_FLOORS[k]})" for k in RK_EVAL_AT)
        + f" captures={st_r['captures']} replays/tree={st_r['replays'] / st_r['trees']:.2f} "
        f"B1 launches={b1_rk} reload=bitwise graph == eager sha256 "
        f"in {time.perf_counter() - t0:.2f} s")
    for mode in ("graph", "eager"):
        log(profile_line(f"phase 12 profile {mode} (2 trees after a warm one)",
                         profile_rounds(lgt, {**rk, "fused_training": mode == "graph"},
                                        rk_set, 2)))
    gb = bst_r._gbdt
    g12, h12 = (v.contiguous() for v in gb.objective.get_gradients(
        gb._score, gb._label, gb._weight))
    tile_r = hc.recommended_leaf_tile(rk_set.max_num_bins, RK_FEAT, RK_LEAVES)
    b1r = check_b1_site(hc, rk_set.bins_device, g12, h12,
                        torch.ones(RK_N_TRAIN, dtype=torch.bool, device=dev),
                        round_slots(RK_N_TRAIN, tile_r, SEED + 1, dev), tile_r,
                        rk_set.max_num_bins)
    log(b1_line(f"phase 12 kernel B1 lambdarank site N={RK_N_TRAIN} F={RK_FEAT} "
                f"B={rk_set.max_num_bins}", b1r))
    rank_model = (bst_r.model_to_string(), np.ascontiguousarray(X[-100_000:]), None)
    del runs12, bst_r, gb, g12, h12, rk_set
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    obj_errs = check_new_objectives(y[:RK_N_TRAIN], np.concatenate([[0], np.cumsum(s_tr)]),
                                    dev)
    log(f"phase 12 objectives card vs CPU at {RK_N_TRAIN} rows (max|d| grad, hess; "
        f"bound {OBJECTIVE_RTOL} x max|CPU|): "
        + "; ".join(f"{k} {g:.3g}, {h:.3g}" for k, (g, h) in obj_errs.items())
        + f" in {time.perf_counter() - t0:.2f} s")

    return [b1_entry("histogram_multi_strict", b1s, b1_strict, 0),
            b1_entry("histogram_multi_multiclass", b1m, b1_mc, per_replay_mc),
            b1_entry("histogram_multi_lambdarank", b1r, b1_rk, per_replay_rk)], rank_model


# ---------------------------------------------------------------------------
# phases 13-14: the boosting modes and the prediction surface
# ---------------------------------------------------------------------------
class card_draws:
    """GOSS's and the per-node sampling's draws made on the card whatever
    the training device, so a CPU run samples the rows and nodes a card run
    samples (small_vs_cpu)."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        from lightgbm_tpu_torch.models.gbdt import GBDT

        self.real = (GBDT._goss_uniforms, GBDT._node_uniforms)
        dev = self.dev

        def draws(gbdt, n):
            gen = torch.Generator(device=dev)
            gen.manual_seed(gbdt.cfg.bagging_seed + gbdt.iter_)
            return torch.rand(n, generator=gen, device=dev).to(gbdt.device)

        def node_draws(gbdt, c):
            gen = torch.Generator(device=dev)
            gen.manual_seed(gbdt.cfg.extra_seed + gbdt.iter_ * 131 + c)
            shape = (2 * gbdt.cfg.num_leaves - 1, 2, gbdt.train_set.num_feature())
            return torch.rand(shape, generator=gen, device=dev).to(gbdt.device)

        GBDT._goss_uniforms, GBDT._node_uniforms = draws, node_draws
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.models.gbdt import GBDT

        GBDT._goss_uniforms, GBDT._node_uniforms = self.real


def mode_phases(lgt, dev, base, higgs, counts, plain_total):
    """Phase 13 on phase 3's Higgs set: GOSS, DART and random forest,
    init_model and cv.  Returns the kernel line's B1 entries of the modes'
    call sites."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.utils import sanitizer as san

    h_set, h_Xtr, h_ytr, h_Xte, h_yte = higgs
    tile = hc.recommended_leaf_tile(h_set.max_num_bins, N_FEAT, NUM_LEAVES)
    entries = []
    for name, extra in MODES.items():
        t0 = time.perf_counter()
        params = {**base, **extra}
        turns = ("ineligible",) * 2 if name == "rf" else ("graph", "eager")
        with san.DispatchCounter() as sync:
            runs = train_turns(lgt, params, h_set, MODE_ROUNDS, MODEL_SHA[name], counts,
                               plain_total, turns=turns)
        # the counts are live: read before the predictions below add theirs
        reads = sync.host_syncs / (len(runs) * MODE_ROUNDS)
        for r in runs:
            st, (b1, b1q, b2, b3) = r["st"], r["launches"]
            # rounds grower: the root pass a tree, one a round, one a warm-up
            # before each capture; no blocking read inside a tree
            if not (st["trees"] == MODE_ROUNDS and b1 == st["trees"] + st["rounds"]
                    + st["captures"] and b1q == b2 == b3 == 0 and st["host_syncs"] == 0):
                raise AssertionError(f"{name} {r['mode']} run: {st} launches {r['launches']}")
            log(turn_line(f"phase 13 {name}", r))
        if len({r["sha"] for r in runs}) != 1:
            raise AssertionError(f"{name}: graph and eager runs grew different models")
        bst = runs[0]["bst"]
        gb = bst._gbdt
        p = bst.predict(h_Xte)
        a = auc(h_yte, p)
        if not (p.shape == (N_TEST,) and np.all(np.isfinite(p)) and a >= AUC_FLOOR_MODES[name]):
            raise AssertionError(f"{name}: held-out AUC {a} < floor {AUC_FLOOR_MODES[name]}")
        if not np.array_equal(p, lgt.Booster(model_str=bst.model_to_string()).predict(h_Xte)):
            raise AssertionError(f"reloaded {name} model predicts differently")
        with card_draws(dev):
            small = small_vs_cpu(lgt, {**params, "num_leaves": 15}, h_Xtr, h_ytr, h_Xte,
                                 rounds=8)
        g, h = (v.contiguous() for v in gb.objective.get_gradients(
            gb._score, gb._label, gb._weight))
        mask, weight = gb._bagging_mask()  # GOSS: the mask past the warm-up
        if name == "goss":
            detail = (f"rows in the bag past the warm-up={int(mask.sum())} of {N_TRAIN} "
                      f"(weight {float(weight.max()):g} on the drawn ones)")
        elif name == "dart":
            detail = (f"trees dropped an iteration={np.mean(gb.drops):.2f} "
                      f"(drops {gb.drops})")
        else:
            detail = (f"rows in the bag={int(mask.sum())} of {N_TRAIN}, shrinkage 1, "
                      f"the trees' mean")
        # a window past GOSS's warm-up, and one holding DART's drops
        for r in runs[:2]:
            log(profile_line(f"phase 13 profile {name} {r['mode']} (3 trees after 5)",
                             profile_rounds(lgt, {**params, "fused_training": r["mode"] != "eager"},
                                            h_set, 3, warm=5)))
        log(f"phase 13 {name}: ok {MODE_ROUNDS} rounds auc={a:.5f} (floor "
            f"{AUC_FLOOR_MODES[name]}) {detail} blocking reads an iteration={reads:.2f} "
            f"B1 launches a tree={runs[0]['launches'][0] / MODE_ROUNDS:.1f} reload=bitwise "
            f"small-vs-cpu max|d|={small:.3g} model_sha256={runs[0]['sha']} "
            f"in {time.perf_counter() - t0:.2f} s")
        # B1 at this mode's call site: the grower's weighted gradients and mask
        r = check_b1_site(hc, h_set.bins_device, (g * weight).contiguous(),
                          (h * weight).contiguous(), mask,
                          round_slots(N_TRAIN, tile, SEED + 5, dev), tile, h_set.max_num_bins)
        log(b1_line(f"phase 13 kernel B1 {name} site N={N_TRAIN} F={N_FEAT}", r))
        entries.append(b1_entry(f"histogram_multi_{name}", r, runs[0]["launches"][0],
                                runs[0]["st"]["per_replay"].get("histogram_multi", 0)))
        del runs, bst, gb, g, h, mask, weight

    # init_model: 10 rounds, then 10 more from that booster
    t0 = time.perf_counter()
    first = lgt.train(base, h_set, MODE_ROUNDS)
    cont = lgt.train(base, h_set, MODE_ROUNDS, init_model=first)
    torch.cuda.synchronize()
    d = np.abs(cont._gbdt._score.cpu().numpy() - cont.predict(h_Xtr, raw_score=True))
    # the training score walks the bins, predict the raw values in f32: a
    # value within an f32 step above a threshold bins right and predicts
    # left.  Such rows may differ; every other row must agree within 1e-5.
    raw_leaf = cont.predict(h_Xtr, pred_leaf=True)
    flip = np.zeros(N_TRAIN, dtype=bool)
    for i, tree in enumerate(cont._gbdt.models):
        flip |= h_set.predict_leaf_binned_tree(tree).cpu().numpy() != raw_leaf[:, i]
    gap = float(d[~flip].max())
    if not (cont.num_trees() == 2 * MODE_ROUNDS and gap <= 1e-5
            and flip.sum() <= 1e-5 * N_TRAIN):
        raise AssertionError(f"init_model: {cont.num_trees()} trees, replayed score "
                             f"off predict by {gap}, {int(flip.sum())} rows walk "
                             "differently on bins and raw values")
    log(f"phase 13 init_model: ok {MODE_ROUNDS} + {MODE_ROUNDS} rounds = "
        f"{cont.num_trees()} trees, replayed training score vs predict(raw_score=True) "
        f"max|d|={gap:.3g} on the {N_TRAIN - int(flip.sum())} rows whose bins and f32 "
        f"values take the same leaves ({int(flip.sum())} rows do not, max|d| there "
        f"{float(d[flip].max()) if flip.any() else 0.0:.3g}) held-out auc="
        f"{auc(h_yte, cont.predict(h_Xte)):.5f} in {time.perf_counter() - t0:.2f} s")
    del first, cont

    # cv on 200k of the rows
    t0 = time.perf_counter()
    cv_set = lgt.Dataset(h_Xtr[:CV_ROWS], label=h_ytr[:CV_ROWS], params=dict(base))
    res = lgt.cv({**base, "metric": "auc"}, cv_set, CV_ROUNDS, nfold=CV_FOLDS, seed=SEED)
    mean = res["valid auc-mean"]
    if not (len(mean) == CV_ROUNDS and 0.5 < mean[-1] <= 1.0):
        raise AssertionError(f"cv: {res}")
    log(f"phase 13 cv: ok {CV_FOLDS} folds x {CV_ROUNDS} rounds on {CV_ROWS} rows "
        f"valid auc-mean={mean[-1]:.5f} stdv={res['valid auc-stdv'][-1]:.5f} "
        f"in {time.perf_counter() - t0:.2f} s")
    return entries


def latency(bst, X, n, calls):
    """Median wall seconds of Booster.predict on the first ``n`` rows of
    ``X`` (the host copies in and out included) over ``calls`` calls,
    after one warm call."""
    x = X[:n] if hasattr(X, "tocsr") else np.ascontiguousarray(X[:n])
    bst.predict(x)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        bst.predict(x)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def predict_profile(bst, X, calls=5, before=None):
    """Device ms, wall ms and kernel launches a Booster.predict call, from
    a torch.profiler window over ``calls`` calls (``before()`` runs ahead
    of each)."""
    from torch.profiler import ProfilerActivity, profile

    bst.predict(X)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            if before is not None:
                before()
            bst.predict(X)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    busy = sum(dev_us(e) for e in device_events(prof)) / 1e3 / calls
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in RUNTIME_LAUNCHES
                   and not str(getattr(e, "device_type", "")).endswith("CUDA")) / calls
    return busy, wall, launches


def predict_phase(lgt, models):
    """Phase 14: ``models`` maps a name to (model text, rows to predict,
    labels or None)."""
    from lightgbm_tpu_torch.utils import sanitizer as san

    cpu = {"device_type": "cpu"}
    for name, (text, X, y) in models.items():
        t0 = time.perf_counter()
        bst = lgt.Booster(model_str=text)
        lat = {n: latency(bst, X, n, PRED_CALLS if n < 100_000 else PRED_CALLS_BIG)
               for n in PRED_BATCHES}
        busy, wall, launches = predict_profile(bst, X[:100_000])
        log(f"phase 14 predict {name} ({bst.num_trees()} trees, "
            f"{max(t.num_leaves for t in bst._gbdt.models)} leaves max, {X.shape[1]} "
            f"features): latency_ms " + " ".join(f"{n}={lat[n] * 1e3:.3f}" for n in lat)
            + f" rows/s at {PRED_BATCHES[-1]}={PRED_BATCHES[-1] / lat[PRED_BATCHES[-1]]:.0f} "
            f"profiled at 100000 rows: device_ms a call={busy:.3f} wall_ms={wall:.3f} "
            f"idle_share={1 - busy / wall:.4f} kernel launches a call={launches:.0f}")
        host = lgt.Booster(model_str=text, params=cpu)
        leaf, leaf_cpu = bst.predict(X[:100_000], pred_leaf=True), host.predict(
            X[:100_000], pred_leaf=True)
        if not (leaf.shape == (min(len(X), 100_000), bst.num_trees())
                and np.array_equal(leaf, leaf_cpu)):
            raise AssertionError(f"{name}: pred_leaf card != CPU")
        log(f"phase 14 pred_leaf {name}: ok {leaf.shape} card == CPU bitwise "
            f"in {time.perf_counter() - t0:.2f} s")
        if y is None:
            continue
        # early stop: binary margins past ES_MARGIN stop every ES_FREQ trees
        t0 = time.perf_counter()
        es = {"pred_early_stop": True, "pred_early_stop_freq": ES_FREQ,
              "pred_early_stop_margin": ES_MARGIN}
        with san.DispatchCounter() as c:
            r_es = bst.predict(X, raw_score=True, **es)
        reads = c.host_syncs  # the counts are live: read before the next predict
        st = bst._gbdt.early_stop_stats
        full = bst.predict(X, raw_score=True)
        running = np.abs(r_es) < ES_MARGIN  # these never stopped
        if not (reads == st["reads"] == st["chunks"] >= 2 and 0 < st["stopped"]
                and np.array_equal(r_es[running], full[running])):
            raise AssertionError(f"early stop: {st}, {reads} blocking reads")
        log(f"phase 14 early stop {name}: ok freq={ES_FREQ} margin={ES_MARGIN} "
            f"chunks={st['chunks']} blocking reads={reads} rows stopped="
            f"{st['stopped']} of {len(X)} running rows == full prediction bitwise "
            f"in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        contrib = bst.predict(X[:CONTRIB_ROWS], pred_contrib=True)
        t_contrib = time.perf_counter() - t0
        gap = float(np.abs(contrib.sum(axis=1) - full[:CONTRIB_ROWS]).max())
        if not gap <= 1e-5:
            raise AssertionError(f"pred_contrib rows sum off the margin by {gap}")
        log(f"phase 14 pred_contrib {name}: ok {contrib.shape} host seconds="
            f"{t_contrib:.2f} max|sum - margin|={gap:.3g}")
        t0 = time.perf_counter()
        ref = bst.refit(X, y)
        torch.cuda.synchronize()
        t_refit = time.perf_counter() - t0
        ref_cpu = host.refit(X, y)
        gap = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                  for a, b in zip(ref._gbdt.models, ref_cpu._gbdt.models))
        if not gap <= 1e-6:
            raise AssertionError(f"refit: card and CPU leaf values differ by {gap}")
        log(f"phase 14 refit {name}: ok {len(X)} rows seconds={t_refit:.2f} card vs CPU "
            f"leaf values max|d|={gap:.3g} held-out auc before {auc(y, bst.predict(X)):.5f} "
            f"after {auc(y, ref.predict(X)):.5f}")


# ---------------------------------------------------------------------------
# phase 15: categorical features on a Criteo-shaped cell
# ---------------------------------------------------------------------------
def criteo_like(n: int, seed: int):
    """Rows in the Criteo display-advertising layout: 13 integer counts
    (log-normal, heavy-tailed, 10-45% missing), then 26 categorical columns
    of label-encoded codes (CR_CARD values each, Zipf frequencies with
    exponent 1.1, codes in random order, 2-30% missing); labels 25%
    positive, from per-category effects of nine columns plus three count
    terms and logistic noise."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, CR_INT + CR_CAT), np.float64)
    logit = np.zeros(n)
    for j in range(CR_INT):
        v = np.floor(rng.lognormal(rng.uniform(0.0, 3.0), rng.uniform(0.8, 2.0), n))
        if j < 3:
            lv = np.log1p(v)
            logit += 0.4 * (lv - lv.mean()) * (1.0 if j % 2 else -1.0)
        v[rng.rand(n) < rng.uniform(0.1, 0.45)] = np.nan
        X[:, j] = v
    for j, card in enumerate(CR_CARD):
        w = 1.0 / np.arange(1, card + 1) ** 1.1
        rank = np.minimum(np.searchsorted(np.cumsum(w / w.sum()), rng.rand(n)), card - 1)
        code = rng.permutation(card)[rank].astype(np.float64)
        if j % 3 == 0:
            logit += 0.6 * rng.randn(card)[rank]
        code[rng.rand(n) < rng.uniform(0.02, 0.3)] = np.nan
        X[:, CR_INT + j] = code
    z = logit + rng.logistic(size=n)
    return X, (z > np.quantile(z, 0.75)).astype(np.float64)


def categorical_phase(lgt, dev, counts, plain_total):
    """Phase 15 on the Criteo-shaped cell: float training on the rounds
    grower (graph and eager in turns), bf16 training (graph), the strict
    grower card against CPU, a bitwise reload, predict latency, and B1's
    float and bf16 call sites against their plain versions.  Returns the
    kernel line's entries."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    t0 = time.perf_counter()
    X, y = criteo_like(CR_N_TRAIN + CR_N_TEST, SEED + 15)
    Xtr, ytr, Xte, yte = X[:CR_N_TRAIN], y[:CR_N_TRAIN], X[CR_N_TRAIN:], y[CR_N_TRAIN:]
    t_gen = time.perf_counter() - t0
    cats = list(range(CR_INT, CR_INT + CR_CAT))
    base = {"objective": "binary", "num_leaves": CR_LEAVES, "learning_rate": 0.1,
            "max_bin": MAX_BIN, "device_type": dev.type, "verbosity": -1, "seed": 7,
            "tree_growth_mode": "rounds"}
    ts = lgt.Dataset(Xtr, label=ytr, categorical_feature=cats, params=dict(base))
    ts.construct()
    nb = ts.binner.num_bins_per_feature[CR_INT:]
    if not (ts.binner.categorical_mask.tolist() == [False] * CR_INT + [True] * CR_CAT
            and (nb <= 5).sum() >= 2 and (nb == MAX_BIN + 1).sum() == CR_CAT - 2):
        raise AssertionError(f"Criteo bins: categorical {ts.binner.categorical_mask} "
                             f"bins {nb}")
    f = CR_INT + CR_CAT
    tile = hc.recommended_leaf_tile(ts.max_num_bins, f, CR_LEAVES)
    tile_b = hc.recommended_leaf_tile(ts.max_num_bins, f, CR_LEAVES, hist_precision="bf16")
    log(f"phase 15 data: {CR_N_TRAIN}+{CR_N_TEST} rows x {CR_INT} counts + {CR_CAT} "
        f"categorical (cardinalities {min(CR_CARD)}-{max(CR_CARD)}), positive share "
        f"{ytr.mean():.4f}, generated in {t_gen:.2f} s, binned in "
        f"{time.perf_counter() - t0 - t_gen:.2f} s; bins a categorical column "
        f"{int(nb.min())}-{int(nb.max())}; leaf tile {tile} float, {tile_b} bf16")

    # ---- float, graph and eager in turns ----
    t0 = time.perf_counter()
    runs = train_turns(lgt, base, ts, CR_ROUNDS, MODEL_SHA["criteo"], counts, plain_total)
    for r in runs:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        if not (b1 == st["trees"] + st["rounds"] + st["captures"] and b1q == b2 == b3 == 0
                and st["host_syncs"] == 0 and st["trees"] == CR_ROUNDS):
            raise AssertionError(f"Criteo float {r['mode']} run: {st} launches {r['launches']}")
        log(turn_line("phase 15 criteo float", r))
    if len({r["sha"] for r in runs}) != 1:
        raise AssertionError(f"Criteo graph and eager models differ: {[r['sha'] for r in runs]}")
    bst, st = runs[0]["bst"], runs[0]["st"]
    b1_c, per_replay_c = runs[0]["launches"][0], st["per_replay"].get("histogram_multi", 0)
    p = bst.predict(Xte)
    a = auc(yte, p)
    n_cat = sum(t.num_cat for t in bst._gbdt.models)
    if not (np.all(np.isfinite(p)) and a >= AUC_FLOOR_CRITEO and n_cat > 0):
        raise AssertionError(f"Criteo float: AUC {a} (floor {AUC_FLOOR_CRITEO}), "
                             f"{n_cat} categorical nodes")
    text = bst.model_to_string()
    reloaded = lgt.Booster(model_str=text, params={"device_type": dev.type})
    if not np.array_equal(p, reloaded.predict(Xte)):
        raise AssertionError("reloaded Criteo model predicts differently")
    log(f"phase 15 criteo float: ok {CR_ROUNDS} rounds auc={a:.5f} (floor "
        f"{AUC_FLOOR_CRITEO}) categorical nodes={n_cat} of "
        f"{sum(t.num_leaves - 1 for t in bst._gbdt.models)} tree-rounds={st['rounds']} "
        f"replays/tree={st['replays'] / st['trees']:.2f} B1 launches={b1_c} blocking "
        f"reads/tree=0 reload=bitwise graph == eager sha256 {runs[0]['sha'][:8]} "
        f"in {time.perf_counter() - t0:.2f} s")
    del runs
    for mode in ("graph", "eager"):
        log(profile_line(f"phase 15 profile {mode} (2 trees after a warm one)",
                         profile_rounds(lgt, {**base, "fused_training": mode == "graph"},
                                        ts, 2)))

    # ---- bf16, graph mode ----
    t0 = time.perf_counter()
    (rb,) = train_turns(lgt, {**base, "hist_precision": "bf16"}, ts, CR_ROUNDS,
                        MODEL_SHA["criteo_bf16"], counts, plain_total, turns=("graph",))
    stb, b1_bf16 = rb["st"], hc.launches["histogram_multi_bf16"]
    if not (rb["launches"] == (0, 0, 0, 0) and stb["host_syncs"] == 0
            and b1_bf16 == stb["trees"] + stb["rounds"] + stb["captures"]):
        raise AssertionError(f"Criteo bf16 run: {stb} launches {rb['launches']} bf16 "
                             f"{b1_bf16}")
    log(turn_line("phase 15 criteo bf16", rb))
    a_b = auc(yte, rb["bst"].predict(Xte))
    if not a_b >= AUC_FLOOR_CRITEO_BF16:
        raise AssertionError(f"Criteo bf16 AUC {a_b} < floor {AUC_FLOOR_CRITEO_BF16}")
    log(f"phase 15 criteo bf16: ok {CR_ROUNDS} rounds auc={a_b:.5f} (floor "
        f"{AUC_FLOOR_CRITEO_BF16}) bf16 B1 launches={b1_bf16} at tile {tile_b} "
        f"float B1 launches=0 sha256 {rb['sha'][:8]} in {time.perf_counter() - t0:.2f} s")
    per_replay_b = stb["per_replay"].get("histogram_multi_bf16", 0)
    del rb

    # ---- the strict grower, card against CPU ----
    # at phase 3's 15 leaves: at 63 and 255 the two devices' trees part at
    # a near-tie within the first tree (the gradients' and the root sums'
    # last bits differ between the devices; PERF.md)
    t0 = time.perf_counter()
    err = small_vs_cpu(lgt, {**base, "tree_growth_mode": "strict", "num_leaves": 15},
                       Xtr, ytr, Xte, n=CR_STRICT_ROWS, rounds=CR_STRICT_ROUNDS,
                       categorical_feature=cats)
    log(f"phase 15 criteo strict: ok {CR_STRICT_ROUNDS} rounds on {CR_STRICT_ROWS} rows, "
        f"15 leaves, card vs CPU max|d|={err:.3g} in {time.perf_counter() - t0:.2f} s")

    # ---- prediction latency of the categorical model ----
    t0 = time.perf_counter()
    lat = {n: latency(bst, Xte, n, PRED_CALLS if n < 100_000 else PRED_CALLS_BIG)
           for n in PRED_BATCHES}
    log(f"phase 15 criteo predict ({bst.num_trees()} trees, {n_cat} categorical "
        f"nodes): latency_ms " + " ".join(f"{n}={lat[n] * 1e3:.3f}" for n in lat)
        + f" rows/s at {PRED_BATCHES[-1]}={PRED_BATCHES[-1] / lat[PRED_BATCHES[-1]]:.0f} "
        f"in {time.perf_counter() - t0:.2f} s")

    # ---- B1 at the cell's float and bf16 call sites ----
    gb = bst._gbdt  # gradients of the model 20 trees in
    g, h = (v.contiguous() for v in gb.objective.get_gradients(gb._score, gb._label,
                                                               gb._weight))
    mask = torch.ones(CR_N_TRAIN, dtype=torch.bool, device=dev)
    r_f = check_b1_site(hc, ts.bins_device, g, h, mask,
                        round_slots(CR_N_TRAIN, tile, SEED + 16, dev), tile,
                        ts.max_num_bins)
    log(b1_line(f"phase 15 kernel B1 criteo float site N={CR_N_TRAIN} F={f}", r_f))
    r_b = check_b1_site(hc, ts.bins_device, g, h, mask,
                        round_slots(CR_N_TRAIN, tile_b, SEED + 17, dev), tile_b,
                        ts.max_num_bins, precision="bf16")
    log(b1_line(f"phase 15 kernel B1 criteo bf16 site N={CR_N_TRAIN} F={f}", r_b))
    entries = [b1_entry("histogram_multi_criteo", r_f, b1_c, per_replay_c),
               b1_entry("histogram_multi_bf16", r_b, b1_bf16, per_replay_b)]
    del bst, gb, g, h, ts
    return entries


def eps_categorical_parity(lgt, eps, eps_set, Xtr, ytr):
    """Phase 9's categorical case: EPS_CAT_COLS seeded columns of the first
    EPS_PARITY_ROWS rows re-coded to EPS_CAT_CODES integer codes and marked
    categorical (their bin mappers fitted on EPS_BIN_SAMPLE rows, the other
    columns' taken from the full set's), 2 trees with megakernel=auto and
    with megakernel=0: the same trees (the JAX package's invariant).
    Returns (round-kernel launches of the megakernel run, its stats)."""
    from lightgbm_tpu_torch.binning import DatasetBinner, find_bin

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 9)
    cols = np.sort(rng.choice(EPS_FEAT, EPS_CAT_COLS, replace=False))
    Xc = Xtr[:EPS_PARITY_ROWS].copy()
    v = Xc[:, cols]
    lo, hi = np.nanmin(v, axis=0), np.nanmax(v, axis=0)
    Xc[:, cols] = np.clip(np.floor((v - lo) / (hi - lo) * EPS_CAT_CODES), 0,
                          EPS_CAT_CODES - 1)
    mappers = list(eps_set.binner.mappers)
    for j in cols:
        mappers[j] = find_bin(Xc[:EPS_BIN_SAMPLE, j], max_bin=MAX_BIN, is_categorical=True)
    ref = lgt.Dataset(Xc[:1], params=dict(eps))
    ref.binner, ref._constructed = DatasetBinner(mappers=mappers), True
    cat_set = lgt.Dataset(Xc, label=ytr[:EPS_PARITY_ROWS], params=dict(eps), reference=ref)
    cat_set.construct()
    reset()
    b_mk = lgt.train(eps, cat_set, 2)
    torch.cuda.synchronize()
    st_mk, l_mk = tree_stats(b_mk), counts()
    if not (all(st_mk["megakernel"]) and plain_total() == 0
            and l_mk[3] == st_mk["rounds"] + st_mk["captures"]):
        raise AssertionError(f"categorical parity, megakernel: {st_mk} launches {l_mk}")
    reset()
    b_3p = lgt.train({**eps, "megakernel": "0"}, cat_set, 2)
    torch.cuda.synchronize()
    st_3p, l_3p = tree_stats(b_3p), counts()
    if not (not any(st_3p["megakernel"]) and plain_total() == 0 and l_3p[3] == 0):
        raise AssertionError(f"categorical parity, three-pass: {st_3p} launches {l_3p}")
    gap = trees_agree(b_mk, b_3p)
    n_cat = sum(t.num_cat for t in b_mk._gbdt.models)
    if n_cat == 0:
        raise AssertionError("categorical parity: no categorical split")
    log(f"phase 9 categorical megakernel vs three-pass: ok {EPS_PARITY_ROWS} rows, "
        f"{EPS_CAT_COLS} columns of {EPS_CAT_CODES} codes, 2 trees, {n_cat} categorical "
        f"nodes, nodes and bitsets equal, leaf counts equal, leaf values max rel gap "
        f"{gap:.3g}; launches (B1 float, B1 int8, B2, B3) megakernel {l_mk}, three-pass "
        f"{l_3p} in {time.perf_counter() - t0:.2f} s")
    return l_mk[3], st_mk


# ---------------------------------------------------------------------------
# phase 16: EFB on an Expo-shaped cell, and the data-input routes
# ---------------------------------------------------------------------------
def expo_like(n: int, seed: int):
    """Rows in the layout of LightGBM's "Expo" experiment set (the ASA Data
    Expo airline on-time records one-hot encoded to 700 columns): one-hot
    blocks EX_BLOCKS (Month, DayofMonth, DayOfWeek and departure hour
    uniform-ish; UniqueCarrier, Origin and Dest with Zipf frequencies,
    codes in random order), then four integer columns: Distance (miles,
    log-normal), scheduled departure minute of the day, scheduled elapsed
    minutes and taxi-out minutes (5% missing).  A float32 CSR matrix, 11
    stored values a row; the label dep_delayed_15min, ~19% positive, from
    hour, carrier and origin effects and a distance term, with logistic
    noise."""
    import scipy.sparse as sps

    rng = np.random.RandomState(seed)
    cols = np.empty((n, len(EX_BLOCKS) + EX_NUMERIC), np.int64)
    vals = np.ones((n, len(EX_BLOCKS) + EX_NUMERIC), np.float32)
    logit = np.zeros(n)
    off = 0
    hour = None
    for k, (name, card, zipf) in enumerate(EX_BLOCKS):
        if zipf:
            w = 1.0 / np.arange(1, card + 1) ** zipf
            rank = np.minimum(np.searchsorted(np.cumsum(w / w.sum()), rng.rand(n)), card - 1)
            code = rng.permutation(card)[rank]
        elif name == "DepHour":  # few departures at night
            w = np.where(np.arange(card) < 6, 0.2, 1.0)
            code = rng.choice(card, n, p=w / w.sum())
            hour = code
        else:
            code = rng.randint(0, card, n)
        if name == "DepHour":
            logit += 0.09 * np.maximum(code - 6, 0)
        elif name in ("UniqueCarrier", "Origin"):
            logit += (0.5 if name == "UniqueCarrier" else 0.35) * rng.randn(card)[code]
        cols[:, k] = off + code
        off += card
    dist = np.maximum(np.round(np.exp(rng.normal(6.3, 0.6, n))), 30.0)
    dep_min = hour * 60 + rng.randint(0, 60, n)
    elapsed = np.maximum(np.round(dist / 8.0 + 25.0 + 10.0 * rng.randn(n)), 20.0)
    taxi = rng.poisson(14.0, n).astype(np.float64)
    taxi[rng.rand(n) < 0.05] = np.nan
    logit += 0.15 * np.log(dist) + 0.03 * np.nan_to_num(taxi, nan=14.0)
    for j, v in enumerate((dist, dep_min, elapsed, taxi)):
        cols[:, len(EX_BLOCKS) + j] = off + j
        vals[:, len(EX_BLOCKS) + j] = v
    z = logit + rng.logistic(size=n)
    y = (z > np.quantile(z, 1.0 - EX_POSITIVE)).astype(np.float64)
    width = cols.shape[1]
    X = sps.csr_matrix((vals.ravel(), cols.ravel(), np.arange(0, n * width + 1, width)),
                       shape=(n, off + EX_NUMERIC))
    return X, y


def write_libsvm(path, X, y) -> None:
    """CSR rows as LibSVM text (0-based indices, explicit zeros and NaN
    written as stored); the cell's values are integers, so %.17g writes
    them exactly."""
    indptr, indices, data = X.indptr, X.indices, X.data
    with open(path, "w") as fh:
        for i in range(X.shape[0]):
            lo, hi = indptr[i], indptr[i + 1]
            fh.write("%d %s\n" % (y[i], " ".join(
                "%d:%.17g" % (j, v) for j, v in zip(indices[lo:hi], data[lo:hi]))))


def check_b1_site_q(hc, bins, gq, hq, mask, slot, tile, num_bins):
    """B1's int8 mode at a call site: kernel against plain version bit for
    bit, then the kernel's, the plain version's and index_add_'s times and
    the bound of this data."""
    args = (bins, gq, hq, mask, slot, 0, tile, num_bins)
    k = hc.histogram_multi_quantized(*args)
    same(k, hc.histogram_multi_quantized_plain(*args), f"B1 int8 (tile {tile})")
    ms = cuda_ms(lambda: hc.histogram_multi_quantized(*args))
    plain_ms = cuda_ms(lambda: hc.histogram_multi_quantized_plain(*args), iters=3, warmup=1)
    lib, rows = library_call(bins, (gq, hq), mask, slot, 0, tile, num_bins, torch.int32)
    library_ms = cuda_ms(lib)
    b_ms, b_by = bound(bins.shape[0], bins.shape[1], tile, num_bins, rows, 1, 4)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, rows=int(rows.numel()), tile=tile), k


def efb_kernels(ts, grad, hess, tile, tile_q, tile_w):
    """The kernels at the cell's bundled shapes, each against its plain
    version: B1 float (rounds tile) and int8 (int8 tile) over the (N, F_b)
    bundled matrix; the unbundling of both on the card against the CPU;
    at the windowed tile on a seeded split geometry of the feature bins,
    B2 (the partition) and B1's float window pass over the bundled matrix
    (bit for bit, then the kernel alone on the gathered window), each
    beside its bound and its library call (window_kernels)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops.histogram import unbundle_hists
    from lightgbm_tpu_torch.ops.treegrow import quantize_gradients

    bundled, gather, default = ts.efb_device_tables()
    b, f = ts.max_num_bins, ts.num_feature()
    n = bundled.shape[0]
    dev = bundled.device
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    slot = round_slots(n, tile, SEED + 18, dev)
    out["float"] = check_b1_site(hc, bundled, grad, hess, mask, slot, tile, b)
    gq, hq = quantize_gradients(grad, hess, mask, 4, False, None)[:2]
    out["int8"], hk_q = check_b1_site_q(hc, bundled, gq, hq, mask,
                                        round_slots(n, tile_q, SEED + 19, dev), tile_q, b)
    # unbundling: card against CPU (int32 bit for bit; f32 within the
    # float64 fill's rounding)
    hk = hc.histogram_multi(bundled, grad, hess, mask, slot, 0, tile, b,
                            shift=hc.fixed_shift_tensor(grad, hess))
    un = {}
    for name, h in (("float", hk), ("int8", hk_q)):
        card = unbundle_hists(h, gather, default, f, b).cpu()
        host = unbundle_hists(h.cpu(), gather.cpu(), default.cpu(), f, b)
        un[name] = (float((card.double() - host.double()).abs().max()),
                    bool(torch.equal(card, host)))
        scale = float(host.double().abs().max())
        if not (un[name][1] or (name == "float" and un[name][0] <= 1e-6 * scale)):
            raise AssertionError(f"unbundle {name}: card vs CPU max|d| {un[name][0]}")
        if float(card[:, 2].double().sum()) != f * float(h[:, 2, 0].double().sum()):
            raise AssertionError(f"unbundle {name}: counts do not add up")
    out["unbundle"] = un
    out["unbundle_ms"] = cuda_ms(lambda: unbundle_hists(hk, gather, default, f, b))
    del hk, hk_q
    out.update(window_kernels(ts, grad, hess, tile_w, SEED + 20, "Expo"))
    return out


def window_kernels(ts, grad, hess, tile_w, seed, what):
    """The windowed three-pass round's B2 and window pass on a bundled set,
    each against its plain version and beside its bound and library call:
    a seeded split geometry at the windowed tile on the feature bins (its
    thresholds drawn on the integer columns: a one-hot column's two bins
    would send every row one way), the window rows gathered from the
    bundled matrix.  Returns {"part": ..., "window": ...}."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.treegrow_windowed import _window_size

    bundled = ts.efb_device_tables()[0]
    b, n = ts.max_num_bins, bundled.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=bundled.device)
    out = {}
    shift = hc.fixed_shift_tensor(grad, hess)
    sp_ = split_case(ts.bins_device[:, -EX_NUMERIC:].contiguous(), b, tile_w, seed)
    pa = (sp_["order"], sp_["seg_start"], sp_["seg_len"], sp_["go"])
    new_order, n_left = pc.partition_segments(*pa)
    p_order, p_left = pc.partition_segments_plain(*pa)
    same(new_order, p_order, f"partition ({what})")
    same(n_left, p_left, f"partition left counts ({what})")
    in_seg = int(sp_["seg_len"].sum())
    lib = library_partition(*pa)
    if not torch.equal(lib(), new_order):
        raise AssertionError(f"the stable-sort yardstick disagrees ({what})")
    out["part"] = dict(ms=cuda_ms(lambda: pc.partition_segments(*pa)),
                       plain_ms=cuda_ms(lambda: pc.partition_segments_plain(*pa), iters=5,
                                        warmup=1),
                       library_ms=cuda_ms(lib), max_abs_err=0.0,
                       device_ms=partition_device_ms(lambda: pc.partition_segments(*pa))[0],
                       bound_ms=bound_of(partition_bytes(n, in_seg), 0)[0],
                       bound_by="bytes", in_seg=in_seg, T=tile_w)
    W = _window_size(int(sp_["win_cnt"].sum()), n)
    wa = (new_order, bundled, (grad, hess), mask, sp_["win_start"], sp_["win_cnt"], W,
          tile_w, b)
    same(rc.window_histograms(hc.histogram_multi, *wa, shift=shift),
         rc.window_histograms(hc.histogram_multi_plain, *wa, shift=shift),
         f"float window pass over the bundled matrix (T={tile_w}, {what})")
    wrows, wslot, valid = rc.window_rows(new_order, sp_["win_start"], sp_["win_cnt"], W)
    ga = (bundled.index_select(0, wrows), grad[wrows], hess[wrows], mask[wrows] & valid,
          wslot, 0, tile_w, b)
    lib_w, rows = library_call(ga[0], ga[1:3], ga[3], ga[4], 0, tile_w, b, torch.float32)
    bw = bound(W, ga[0].shape[1], tile_w, b, rows, 4, 4)
    out["window"] = dict(
        ms=cuda_ms(lambda: hc.histogram_multi(*ga, shift=shift)),
        plain_ms=cuda_ms(lambda: hc.histogram_multi_plain(*ga, shift=shift), iters=3,
                         warmup=1),
        library_ms=cuda_ms(lib_w), bound_ms=bw[0], bound_by=bw[1], max_abs_err=0.0,
        rows=int(rows.numel()), tile=tile_w, W=W,
        with_gather_ms=cuda_ms(lambda: rc.window_histograms(hc.histogram_multi, *wa,
                                                            shift=shift)))
    return out


def efb_phase(lgt, dev, counts, plain_total):
    """Phase 16 on the Expo-shaped cell (a CSR matrix, bundled by default):
    the rounds grower graph and eager in turns; the same data without the
    plan (a reading); the windowed grower (three-pass: EFB is outside the
    megakernel's envelope); int8; the file, two-round and bin-cache routes
    on the first EX_FILE_ROWS rows; the kernels at the bundled shapes; card
    against CPU; predict on CSR rows.  Returns the kernel line's entries."""
    import copy
    import tempfile

    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    t0 = time.perf_counter()
    X, y = expo_like(EX_N_TRAIN + EX_N_TEST, SEED + 16)
    Xtr, ytr, Xte, yte = X[:EX_N_TRAIN], y[:EX_N_TRAIN], X[EX_N_TRAIN:], y[EX_N_TRAIN:]
    t_gen = time.perf_counter() - t0
    base = {"objective": "binary", "num_leaves": EX_LEAVES, "learning_rate": 0.1,
            "max_bin": MAX_BIN, "min_sum_hessian_in_leaf": 100, "device_type": dev.type,
            "verbosity": -1, "seed": 7}
    ts = lgt.Dataset(Xtr, label=ytr, params=dict(base))
    ts.construct()
    t_bin = time.perf_counter() - t0 - t_gen
    efb, f = ts.efb, ts.num_feature()
    if efb is None or f != EX_FEAT or not efb.num_bundled <= 40:
        raise AssertionError(f"Expo bundles: F={f} plan {efb and efb.num_bundled}")
    tile = hc.recommended_leaf_tile(ts.max_num_bins, efb.num_bundled, EX_LEAVES)
    tile_q = hc.recommended_leaf_tile(ts.max_num_bins, efb.num_bundled, EX_LEAVES,
                                      quantized=True)
    tile_f = hc.recommended_leaf_tile(ts.binner.max_num_bins, f, EX_LEAVES)
    widths = sorted((int(w) for w in efb.bundled_num_bins), reverse=True)
    log(f"phase 16 data: {EX_N_TRAIN}+{EX_N_TEST} rows x {f} columns (CSR, "
        f"{X.nnz / X.shape[0]:.2f} stored values a row), positive share {ytr.mean():.4f}, "
        f"generated in {t_gen:.2f} s, binned and bundled in {t_bin:.2f} s; F={f} "
        f"F_b={efb.num_bundled} bundles of {sum(len(m) > 1 for m in efb.bundles)} "
        f"multi-member, widths {widths}, histogram width B={ts.max_num_bins}; leaf tile "
        f"{tile} float, {tile_q} int8 (from F_b; {tile_f} from F)")

    # ---- 1. the default path: bundled, rounds grower, graph and eager ----
    t0 = time.perf_counter()
    runs = train_turns(lgt, base, ts, EX_ROUNDS, MODEL_SHA["expo"], counts, plain_total,
                       turns=("graph", "eager"))
    for r in runs:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        if not (b1 == st["trees"] + st["rounds"] + st["captures"] and b1q == b2 == b3 == 0
                and st["host_syncs"] == 0 and st["trees"] == EX_ROUNDS):
            raise AssertionError(f"Expo {r['mode']} run: {st} launches {r['launches']}")
        log(turn_line("phase 16 expo", r))
    if len({r["sha"] for r in runs}) != 1:
        raise AssertionError(f"Expo graph and eager models differ: {[r['sha'] for r in runs]}")
    bst, st = runs[0]["bst"], runs[0]["st"]
    it_s1 = [r["it_s"] for r in runs]
    if bst._gbdt._leaf_tile != tile:
        raise AssertionError(f"Expo leaf tile {bst._gbdt._leaf_tile}, want {tile} from F_b")
    b1_e, per_replay_e = runs[0]["launches"][0], st["per_replay"].get("histogram_multi", 0)
    p = bst.predict(Xte)
    a = auc(yte, p)
    if not (p.shape == (EX_N_TEST,) and np.all(np.isfinite(p)) and a >= AUC_FLOOR_EXPO):
        raise AssertionError(f"Expo: AUC {a} (floor {AUC_FLOOR_EXPO})")
    prof = profile_rounds(lgt, base, ts, 2)
    log(profile_line("phase 16 profile graph (2 trees after a warm one)", prof))
    log(profile_line("phase 16 profile eager (2 trees after a warm one)", profile_rounds(
        lgt, {**base, "fused_training": False}, ts, 2)))
    log(f"phase 16 expo: ok {EX_ROUNDS} rounds auc={a:.5f} (floor {AUC_FLOOR_EXPO}) "
        f"it/s graph={runs[0]['it_s']:.4f} eager={runs[1]['it_s']:.4f} idle graph="
        f"{prof['idle']:.4f} device ms/tree={prof['busy_ms'] / 2:.2f} F={f} "
        f"F_b={efb.num_bundled} tile={tile} tree-rounds={st['rounds']} "
        f"replays/tree={st['replays'] / st['trees']:.2f} B1 launches={b1_e} "
        f"({b1_e / st['trees']:.2f}/tree) blocking reads/tree=0 graph == eager sha256 "
        f"{runs[0]['sha'][:8]} in {time.perf_counter() - t0:.2f} s")
    del runs

    # ---- 2. the same data without the plan (a reading) ----
    t0 = time.perf_counter()
    flat = copy.copy(ts)  # the bins construct() gives at enable_bundle=false
    flat.efb, flat._efb_device = None, None
    flat.max_num_bins = int(ts.binner.max_num_bins)
    (r2,) = train_turns(lgt, {**base, "enable_bundle": False}, flat, EX_ROUNDS, "",
                        counts, plain_total, turns=("ineligible",))
    a2 = auc(yte, r2["bst"].predict(Xte))
    log(turn_line("phase 16 expo unbundled (F x leaves > 100,000: eager)", r2))
    log(f"phase 16 expo unbundled: {EX_ROUNDS} rounds auc={a2:.5f} (bundled {a:.5f}) "
        f"it/s={r2['it_s']:.4f} (bundled: graph {it_s1[0]:.4f}, eager {it_s1[1]:.4f}) "
        f"tree-rounds={r2['st']['rounds']} (bundled {st['rounds']}) "
        f"tile={r2['bst']._gbdt._leaf_tile} (bundled {tile}) "
        f"in {time.perf_counter() - t0:.2f} s")
    del r2, flat

    # ---- 3. the windowed grower: the three-pass round with EFB ----
    t0 = time.perf_counter()
    wp = {**base, "windowed_growth": True}
    runs3 = train_turns(lgt, wp, ts, EX_ROUNDS_SHORT, MODEL_SHA["expo_windowed"], counts,
                        plain_total, turns=("graph", "eager"))
    for r in runs3:
        st3, (b1, b1q, b2, b3) = r["st"], r["launches"]
        per = st3["rounds"] + st3["captures"]  # a replay a round, a warm-up a capture
        fallbacks = st3["megakernel_fallbacks"]
        if not ((b1, b1q, b2, b3) == (per + st3["trees"], 0, per, 0)
                and st3["excluded"] == ["efb"] * EX_ROUNDS_SHORT
                and not any(st3["megakernel"]) and fallbacks == EX_ROUNDS_SHORT
                and st3["host_syncs"] == st3["trees"]):
            raise AssertionError(f"Expo windowed {r['mode']} run: {st3} launches "
                                 f"{r['launches']} fallbacks {fallbacks}")
        log(turn_line("phase 16 expo windowed", r))
    if len({r["sha"] for r in runs3}) != 1:
        raise AssertionError("Expo windowed graph and eager models differ")
    st_w = runs3[0]["st"]
    b1_w, b2_w = runs3[0]["launches"][0] - st_w["trees"], runs3[0]["launches"][2]
    per_replay_w = st_w["per_replay"]
    a3 = auc(yte, runs3[0]["bst"].predict(Xte))
    log(f"phase 16 expo windowed: ok {EX_ROUNDS_SHORT} rounds auc={a3:.5f} "
        f"megakernel_excluded=efb ({EX_ROUNDS_SHORT} fallbacks counted) it/s graph="
        f"{runs3[0]['it_s']:.4f} eager={runs3[1]['it_s']:.4f} window-pass B1 launches="
        f"{b1_w} B2 launches={b2_w} (graph run) retries={st_w['retries']} graph == eager "
        f"sha256 {runs3[0]['sha'][:8]} in {time.perf_counter() - t0:.2f} s")
    del runs3

    # ---- 4. int8, eager ----
    t0 = time.perf_counter()
    (r4,) = train_turns(lgt, {**base, "use_quantized_grad": True}, ts, EX_ROUNDS_SHORT,
                        MODEL_SHA["expo_int8"], counts, plain_total, turns=("ineligible",))
    st4, (b1, b1q, b2, b3) = r4["st"], r4["launches"]
    if not (b1q == st4["trees"] + st4["rounds"] and b1 == b2 == b3 == 0):
        raise AssertionError(f"Expo int8 run: {st4} launches {r4['launches']}")
    b1q_e = b1q
    a4 = auc(yte, r4["bst"].predict(Xte))
    log(turn_line("phase 16 expo int8 (fused_training=true, not eligible: eager)", r4))
    log(f"phase 16 expo int8: ok {EX_ROUNDS_SHORT} rounds auc={a4:.5f} tile={tile_q} "
        f"int8 B1 launches={b1q} sha256 {r4['sha'][:8]} in {time.perf_counter() - t0:.2f} s")
    del r4

    # ---- 5. the file, two-round and bin-cache routes ----
    t0 = time.perf_counter()
    n5 = EX_FILE_ROWS
    with tempfile.TemporaryDirectory() as tmp:
        path, cache = os.path.join(tmp, "expo.libsvm"), os.path.join(tmp, "expo.bin")
        write_libsvm(path, Xtr[:n5], ytr[:n5])
        t_write, file_bytes = time.perf_counter() - t0, os.path.getsize(path)
        mem = lgt.Dataset(Xtr[:n5], label=ytr[:n5], params=dict(base)).construct()
        tm = time.perf_counter()
        native.parse_file(path, "libsvm", False, 0)
        t_parse = time.perf_counter() - tm
        sets, secs = {}, {}
        for name, make in (("one-round", lambda: lgt.Dataset(path, params=dict(base))),
                           ("two-round", lambda: lgt.Dataset(
                               path, params={**base, "two_round": True})),
                           ("bin cache", lambda: lgt.Dataset(cache, params=dict(base)))):
            if name == "bin cache":
                tm = time.perf_counter()
                sets["one-round"].save_binary(cache)
                secs["cache write"] = time.perf_counter() - tm
            tm = time.perf_counter()
            sets[name] = make().construct()
            secs[name] = time.perf_counter() - tm
        for name, d in sets.items():
            if not (np.array_equal(d.bins, mem.bins) and np.array_equal(d.label, mem.label)
                    and d.efb.bundles == mem.efb.bundles):
                raise AssertionError(f"Expo {name} route: bins, labels or bundles differ "
                                     "from the in-memory CSR set's")
        texts = {name: lgt.train(base, d, EX_ROUNDS_SHORT).model_to_string()
                 for name, d in [("in-memory CSR", mem), *sets.items()]}
    if len(set(texts.values())) != 1:
        raise AssertionError(f"Expo routes train different models: "
                             f"{ {k: hashlib.sha256(v.encode()).hexdigest()[:8] for k, v in texts.items()} }")
    log(f"phase 16 expo file routes: ok {n5} rows as LibSVM (written in {t_write:.2f} s, "
        f"{file_bytes} B): native parse "
        f"{t_parse:.2f} s; Dataset(path) parse + bin + bundle {secs['one-round']:.2f} s, "
        f"two_round {secs['two-round']:.2f} s, save_binary {secs['cache write']:.2f} s, "
        f"Dataset(cache) {secs['bin cache']:.2f} s; bins, labels and bundles == the "
        f"in-memory CSR set's; {EX_ROUNDS_SHORT} rounds on each: one model text "
        f"(sha256 {hashlib.sha256(texts['one-round'].encode()).hexdigest()[:8]}) in "
        f"{time.perf_counter() - t0:.2f} s")
    del mem, sets, texts

    # ---- 6. kernels at the bundled shapes ----
    t0 = time.perf_counter()
    gb = bst._gbdt  # gradients of the model EX_ROUNDS trees in
    g, h = (v.contiguous() for v in gb.objective.get_gradients(gb._score, gb._label,
                                                               gb._weight))
    tile_w = gb._leaf_tile
    ek = efb_kernels(ts, g, h, tile, tile_q, tile_w)
    fb = efb.num_bundled
    log(b1_line(f"phase 16 kernel B1 expo float site N={EX_N_TRAIN} F_b={fb} "
                f"B={ts.max_num_bins}", ek["float"]))
    log(b1_line(f"phase 16 kernel B1 expo int8 site N={EX_N_TRAIN} F_b={fb} "
                f"B={ts.max_num_bins}", ek["int8"]))
    w, pt = ek["window"], ek["part"]
    log(b1_line(f"phase 16 kernel B1 expo window pass W={w['W']} F_b={fb} (kernel alone; "
                f"with the gather {w['with_gather_ms']:.4f} ms)", w))
    log(f"phase 16 kernel B2 expo three-pass geometry: N={EX_N_TRAIN} T={pt['T']} "
        f"in-segment={pt['in_seg']} ms={pt['ms']:.4f} (events, a Python call) device_ms="
        f"{pt['device_ms']:.4f} plain_ms={pt['plain_ms']:.4f} library_ms="
        f"{pt['library_ms']:.4f} bound_ms={pt['bound_ms']:.6f} (bytes) bitwise_plain=True")
    uf, uq = ek["unbundle"]["float"], ek["unbundle"]["int8"]
    log(f"phase 16 unbundle card vs CPU: float max|d|={uf[0]:.3g} bitwise={uf[1]}, int8 "
        f"bitwise={uq[1]}; (tile {tile}, 3, {fb}, B) -> (tile, 3, {f}, B) "
        f"ms={ek['unbundle_ms']:.4f} in {time.perf_counter() - t0:.2f} s")
    del g, h

    # ---- 7. card against CPU ----
    t0 = time.perf_counter()
    err = small_vs_cpu(lgt, {**base, "num_leaves": 15}, Xtr, ytr, Xte, n=EX_SMALL_ROWS)
    log(f"phase 16 expo card vs CPU: ok {EX_SMALL_ROWS} rows, 15 leaves, 3 rounds, "
        f"max|d|={err:.3g} in {time.perf_counter() - t0:.2f} s")

    # ---- 8. prediction on CSR rows, cached and uncached, at Expo width ----
    from lightgbm_tpu_torch.models.gbdt import _PINNED_MAX_BYTES

    t0 = time.perf_counter()
    lat = {(n, bump): timed_predicts(bst, Xte[:n], PRED_CALLS if n < 100_000
                                     else PRED_CALLS_BIG, bump)
           for n in (1, 100_000) for bump in (False, True)}
    pinned = bst._gbdt._pinned
    log(f"phase 16 expo predict on CSR rows ({bst.num_trees()} trees x {EX_LEAVES} "
        f"leaves, {EX_FEAT} columns): latency_ms " + " ".join(
            f"{n}: cached {lat[(n, False)] * 1e3:.3f} uncached {lat[(n, True)] * 1e3:.3f};"
            for n in (1, 100_000))
        + f" rows/s at 100000={100_000 / lat[(100_000, False)]:.0f}; pinned buffers "
        f"{pinned.nbytes() / 2**20:.3f} MiB: rungs "
        f"{sorted({k[0][0] for k in pinned.bufs if k[2] == 0})} and "
        f"{sum(k[2] > 0 for k in pinned.bufs)} chunk buffers (a rung over "
        f"{_PINNED_MAX_BYTES >> 20} MiB stages in chunks) in "
        f"{time.perf_counter() - t0:.2f} s")
    pr = per_replay_w
    entries = [b1_entry("histogram_multi_expo", ek["float"], b1_e, per_replay_e),
               b1_entry("histogram_multi_quantized_expo", ek["int8"], b1q_e, 0),
               b1_entry("histogram_multi_expo_window", w, b1_w,
                        pr.get("histogram_multi", 0)),
               {"name": "partition_segments_expo", "route": "cuda",
                "source": "lightgbm_tpu_torch/csrc/partition.cu",
                "replaces": "lightgbm_tpu/ops/partition_pallas.py:188",
                "launches": b2_w, "in_graph": pr.get("partition_segments", 0) > 0,
                "launches_per_replay": pr.get("partition_segments", 0),
                "max_abs_err": 0.0, "ms": pt["ms"], "plain_ms": pt["plain_ms"],
                "bound_ms": pt["bound_ms"], "bound_by": "bytes",
                "library_ms": pt["library_ms"], "device_ms": pt["device_ms"]}]
    del bst, gb, X, Xtr
    return entries, (ts, base, Xte, yte)


# ---------------------------------------------------------------------------
# phase 17: the rest of the feature envelope
# ---------------------------------------------------------------------------
def tree_paths(tree):
    """The split features on each root-to-leaf path of a host tree."""
    if tree.num_leaves <= 1:
        return [[]]
    out, stack = [], [(0, [])]
    while stack:
        nd, path = stack.pop()
        path = path + [int(tree.split_feature[nd])]
        for c in (tree.left_child[nd], tree.right_child[nd]):
            if c < 0:
                out.append(path)
            else:
                stack.append((int(c), path))
    return out


def check_monotone(bst, ts, X, cols, rows):
    """Along each column of ``cols``, swept over its bin thresholds (and one
    value below them) for ``rows`` held-out rows, the raw predictions never
    decrease.  Returns the number of sweeps checked."""
    x0 = np.asarray(X[:rows], np.float64)
    for j in cols:
        ups = np.asarray(ts.binner.mappers[j].upper_bounds[:-1], np.float64)
        vals = np.concatenate([[ups[0] - 1.0], ups, [ups[-1] + 1.0]])
        xs = np.repeat(x0, len(vals), axis=0)
        xs[:, j] = np.tile(vals, rows)
        p = bst.predict(xs, raw_score=True).reshape(rows, len(vals))
        if not np.all(np.diff(p, axis=1) >= 0):
            d = np.diff(p, axis=1)
            raise AssertionError(f"monotone column {j}: predictions fall by up to "
                                 f"{float(-d.min())} along its sweep")
    return rows * len(cols)


def env_run(lgt, params, ts, rounds, key, counts, plain_total, turns, Xte, yte, what):
    """One phase-17 training in ``turns``: the rounds drivers' counts, B1
    launches (the root pass a tree, one a round, one a warm-up before each
    capture; eager: no capture), graph == eager sha256, MODEL_SHA[key], the
    held-out AUC against its floor.  Returns (first run, auc)."""
    runs = train_turns(lgt, params, ts, rounds, MODEL_SHA[key], counts, plain_total,
                       turns=turns)
    for r in runs:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        per_tree = 31 if params.get("tree_growth_mode") == "strict" else None
        want = (st["trees"] * per_tree if per_tree
                else st["trees"] + st["rounds"] + st["captures"])
        if not (b1 == want and b1q == b2 == b3 == 0 and st["host_syncs"] == 0
                and st["trees"] == rounds):
            raise AssertionError(f"{what} {r['mode']} run: {st} launches {r['launches']}")
        log(turn_line(f"phase 17 {what}", r))
    if len({r["sha"] for r in runs}) != 1:
        raise AssertionError(f"{what}: the runs' models differ: {[r['sha'] for r in runs]}")
    p = runs[0]["bst"].predict(Xte)
    a = auc(yte, p)
    if not (np.all(np.isfinite(p)) and a >= AUC_FLOOR_ENV[key]):
        raise AssertionError(f"{what}: held-out AUC {a:.5f} < floor {AUC_FLOOR_ENV[key]}")
    return runs[0], a


def envelope_phase(lgt, dev, base, higgs, expo, counts, plain_total):
    """Phase 17: monotone constraints (basic; intermediate with
    monotone_penalty), interaction constraints, forced splits, extra_trees
    with feature_fraction_bynode, CEGB and linear trees on phase 3's Higgs
    set, and per-node sampling on the windowed grower over phase 16's
    bundled Expo set; each checked against what it promises, card against
    CPU on a small input, its sha256 pinned.  Returns the kernel line's
    entries: B1 at (a)'s site, B2 and the window pass at the windowed
    site."""
    import tempfile

    from lightgbm_tpu_torch.ops import hist_cuda as hc

    ts, Xtr, ytr, Xte, yte = higgs
    out = {}
    b1_env = per_replay_env = None
    gg = ("graph", "eager")
    mono = [1 if j in ENV_MONO_COLS else 0 for j in range(N_FEAT)]
    runs_a = {}

    # ---- (a) and (b): monotone, basic and intermediate ----
    for key, extra in (("mono", {"monotone_constraints": mono}),
                       ("mono_int", {"monotone_constraints": mono,
                                     "monotone_constraints_method": "intermediate",
                                     "monotone_penalty": 1.0})):
        t0 = time.perf_counter()
        params = {**base, **extra}
        r, a = env_run(lgt, params, ts, ENV_ROUNDS, key, counts, plain_total, gg, Xte,
                       yte, key)
        swept = check_monotone(r["bst"], ts, Xte, ENV_MONO_COLS, ENV_SWEEP_ROWS)
        err = small_vs_cpu(lgt, {**params, "num_leaves": 15}, Xtr, ytr, Xte)
        st = r["st"]
        log(f"phase 17 {key}: ok {ENV_ROUNDS} rounds auc={a:.5f} (floor "
            f"{AUC_FLOOR_ENV[key]}) it/s graph={r['it_s']:.4f} tree-rounds={st['rounds']} "
            f"replays={st['replays']} blocking reads/tree=0 graph == eager sha256 "
            f"{r['sha'][:8]}; {swept} sweeps non-decreasing on columns {ENV_MONO_COLS}; "
            f"small-vs-cpu max|d|={err:.3g} in {time.perf_counter() - t0:.2f} s")
        runs_a[key] = r
    r = runs_a["mono"]
    b1_env, per_replay_env = r["launches"][0], r["st"]["per_replay"].get("histogram_multi", 0)
    prof = profile_rounds(lgt, {**base, "monotone_constraints": mono}, ts, 3)
    log(profile_line("phase 17 profile mono graph (3 trees after a warm one)", prof))
    out["mono_prof"] = prof
    # B1 at (a)'s site: the gradients of the model 10 trees in, tile 8
    b10 = lgt.train({**base, "monotone_constraints": mono}, ts, 10)
    gb = b10._gbdt
    g, h = (v.contiguous() for v in gb.objective.get_gradients(gb._score, gb._label,
                                                               gb._weight))
    tile = gb._leaf_tile
    b1r = check_b1_site(hc, ts.bins_device, g, h,
                        torch.ones(N_TRAIN, dtype=torch.bool, device=dev),
                        round_slots(N_TRAIN, tile, SEED + 21, dev), tile, MAX_BIN)
    log(b1_line(f"phase 17 kernel B1 monotone site N={N_TRAIN} F={N_FEAT}", b1r))
    del runs_a, b10, gb, g, h

    # ---- (c): interaction constraints ----
    t0 = time.perf_counter()
    params = {**base, "interaction_constraints": ENV_SETS}
    r, a = env_run(lgt, params, ts, ENV_ROUNDS, "inter", counts, plain_total, gg, Xte,
                   yte, "inter")
    sets = [set(x) for x in ENV_SETS]
    paths = [p_ for t in r["bst"]._gbdt.models for p_ in tree_paths(t)]
    bad = [p_ for p_ in paths if not any(set(p_) <= s_ for s_ in sets)]
    if bad:
        raise AssertionError(f"inter: {len(bad)} paths leave every set, e.g. {bad[0]}")
    err = small_vs_cpu(lgt, {**params, "num_leaves": 15}, Xtr, ytr, Xte)
    log(f"phase 17 inter: ok {ENV_ROUNDS} rounds auc={a:.5f} it/s graph={r['it_s']:.4f} "
        f"{len(paths)} root-to-leaf paths each inside one of {len(sets)} sets; "
        f"graph == eager sha256 {r['sha'][:8]} small-vs-cpu max|d|={err:.3g} in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- (d): forced splits, rounds (graph and eager) and strict ----
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "forced.json")
        with open(path, "w") as fh:
            json.dump(ENV_FORCED, fh)
        thr = {c: ts.binner.mappers[c].bin_to_threshold(int(
            ts.binner.mappers[c].transform(np.asarray([1.0]))[0])) for c in (25, 0)}
        for key, mode, turns in (("forced", "rounds", gg),
                                 ("forced_strict", "strict", ("ineligible",))):
            t0 = time.perf_counter()
            params = {**base, "forcedsplits_filename": path, "tree_growth_mode": mode}
            rounds = ENV_ROUNDS if mode == "rounds" else ROUNDS_STRICT
            r, a = env_run(lgt, params, ts, rounds, key, counts, plain_total, turns,
                           Xte, yte, key)
            for t in r["bst"]._gbdt.models:
                lc = int(t.left_child[0])
                if not (t.num_leaves > 2 and int(t.split_feature[0]) == 25
                        and t.threshold[0] == thr[25] and lc > 0
                        and int(t.split_feature[lc]) == 0 and t.threshold[lc] == thr[0]):
                    raise AssertionError(f"{key}: a tree does not begin with the forced "
                                         f"splits: {t.split_feature[:3]} {t.threshold[:3]}")
            err = small_vs_cpu(lgt, {**params, "num_leaves": 15}, Xtr, ytr, Xte)
            log(f"phase 17 {key}: ok {rounds} rounds auc={a:.5f} it/s={r['it_s']:.4f} "
                f"every tree begins with column 25 at {thr[25]:.6g}, its left child "
                f"column 0 at {thr[0]:.6g}; sha256 {r['sha'][:8]} small-vs-cpu "
                f"max|d|={err:.3g} in {time.perf_counter() - t0:.2f} s")

    # ---- (e): extra_trees + bynode, rounds (eager by the gate) and strict ----
    node = {"extra_trees": True, "feature_fraction_bynode": 0.8}
    for key, mode in (("extra", "rounds"), ("extra_strict", "strict")):
        t0 = time.perf_counter()
        params = {**base, **node, "tree_growth_mode": mode}
        rounds = ENV_ROUNDS if mode == "rounds" else ROUNDS_STRICT
        r, a = env_run(lgt, params, ts, rounds, key, counts, plain_total,
                       ("ineligible", "ineligible"), Xte, yte, key)
        with card_draws(dev):  # the card's node draws on both sides
            err = small_vs_cpu(lgt, {**params, "num_leaves": 15}, Xtr, ytr, Xte)
        log(f"phase 17 {key}: ok {rounds} rounds auc={a:.5f} it/s={r['it_s']:.4f} "
            f"(eager: the fused gate excludes per-node sampling) twice the same sha256 "
            f"{r['sha'][:8]} small-vs-cpu max|d|={err:.3g} in "
            f"{time.perf_counter() - t0:.2f} s")

    # ---- (e, windowed): the three-pass round with per-node sampling ----
    t0 = time.perf_counter()
    ets, ebase, eXte, eyte = expo
    wp = {**ebase, **node, "windowed_growth": True}
    runs = train_turns(lgt, wp, ets, ENV_WIN_ROUNDS, MODEL_SHA["extra_windowed"], counts,
                       plain_total, turns=gg)
    for r in runs:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        per = st["rounds"] + st["captures"]
        if not ((b1, b1q, b2, b3) == (per + st["trees"], 0, per, 0)
                and st["excluded"] == ["efb"] * ENV_WIN_ROUNDS
                and not any(st["megakernel"]) and st["host_syncs"] == st["trees"]):
            raise AssertionError(f"windowed node-rng {r['mode']} run: {st} launches "
                                 f"{r['launches']}")
        log(turn_line("phase 17 extra windowed", r))
    if len({r["sha"] for r in runs}) != 1:
        raise AssertionError("windowed node-rng graph and eager models differ")
    st_w = runs[0]["st"]
    b1_w, b2_w = runs[0]["launches"][0] - st_w["trees"], runs[0]["launches"][2]
    per_w = st_w["per_replay"]
    gb = runs[0]["bst"]._gbdt
    g, h = (v.contiguous() for v in gb.objective.get_gradients(gb._score, gb._label,
                                                               gb._weight))
    wk = window_kernels(ets, g, h, gb._leaf_tile, SEED + 22, "Expo node-rng")
    a_w = auc(eyte, runs[0]["bst"].predict(eXte))
    if not a_w >= AUC_FLOOR_ENV["extra_windowed"]:
        raise AssertionError(f"windowed node-rng: held-out AUC {a_w:.5f} < floor "
                             f"{AUC_FLOOR_ENV['extra_windowed']}")
    log(f"phase 17 extra windowed: ok {ENV_WIN_ROUNDS} rounds on the bundled Expo set "
        f"auc={a_w:.5f} megakernel excluded (efb, node_rng) it/s graph="
        f"{runs[0]['it_s']:.4f} eager={runs[1]['it_s']:.4f} window-pass B1 launches="
        f"{b1_w} B2 launches={b2_w} graph == eager sha256 {runs[0]['sha'][:8]} in "
        f"{time.perf_counter() - t0:.2f} s")
    w, pt = wk["window"], wk["part"]
    log(b1_line(f"phase 17 kernel B1 node-rng window pass W={w['W']} (kernel alone; with "
                f"the gather {w['with_gather_ms']:.4f} ms)", w))
    log(f"phase 17 kernel B2 node-rng three-pass geometry: T={pt['T']} in-segment="
        f"{pt['in_seg']} ms={pt['ms']:.4f} device_ms={pt['device_ms']:.4f} plain_ms="
        f"{pt['plain_ms']:.4f} library_ms={pt['library_ms']:.4f} bound_ms="
        f"{pt['bound_ms']:.6f} (bytes) bitwise_plain=True")
    del runs, gb, g, h

    # ---- (f): CEGB split, coupled and lazy penalties (eager by the gate) ----
    t0 = time.perf_counter()
    params = {**base, **ENV_CEGB}
    r, a = env_run(lgt, params, ts, ENV_ROUNDS, "cegb", counts, plain_total,
                   ("ineligible", "ineligible"), Xte, yte, "cegb")
    used = sorted({int(f_) for t in r["bst"]._gbdt.models
                   for f_ in t.split_feature[:t.num_leaves - 1]})
    err = small_vs_cpu(lgt, {**params, "num_leaves": 15}, Xtr, ytr, Xte)
    prof = profile_rounds(lgt, params, ts, 3)
    log(profile_line("phase 17 profile cegb eager (3 trees after a warm one)", prof))
    log(f"phase 17 cegb: ok {ENV_ROUNDS} rounds auc={a:.5f} it/s={r['it_s']:.4f} features "
        f"used {used} sha256 {r['sha'][:8]} small-vs-cpu max|d|={err:.3g} in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- (g): linear trees (eager by the gate) ----
    t0 = time.perf_counter()
    params = {**base, "linear_tree": True, "linear_lambda": 0.01}
    r, a = env_run(lgt, params, ts, ENV_LINEAR_ROUNDS, "linear", counts, plain_total,
                   ("ineligible", "ineligible"), Xte, yte, "linear")
    bst = r["bst"]
    if not all(t.is_linear for t in bst._gbdt.models):
        raise AssertionError("linear: a tree without leaf models")
    xs = Xte[:ENV_LINEAR_ROWS]
    p_card = bst.predict(xs, raw_score=True)
    text = bst.model_to_string()
    p_cpu = lgt.Booster(model_str=text, params={"device_type": "cpu"}).predict(
        xs, raw_score=True)
    d_cpu = float(np.abs(p_card - p_cpu).max())
    if not d_cpu <= 1e-5 * max(1.0, float(np.abs(p_cpu).max())):
        raise AssertionError(f"linear: card and CPU predictions differ by {d_cpu}")
    if not np.array_equal(lgt.Booster(model_str=text).predict(xs, raw_score=True), p_card):
        raise AssertionError("linear: the reloaded model predicts differently")
    err = small_vs_cpu(lgt, {**params, "num_leaves": 15}, Xtr, ytr, Xte)
    prof = profile_rounds(lgt, params, ts, 3)
    log(profile_line("phase 17 profile linear eager (3 trees after a warm one)", prof))
    lat = {n: latency(bst, Xte, n, PRED_CALLS if n < 100_000 else PRED_CALLS_BIG)
           for n in PRED_BATCHES}
    log(f"phase 17 linear: ok {ENV_LINEAR_ROUNDS} rounds auc={a:.5f} it/s={r['it_s']:.4f} "
        f"card vs CPU on {ENV_LINEAR_ROWS} rows max|d|={d_cpu:.3g} reload=bitwise "
        f"sha256 {r['sha'][:8]} small-vs-cpu max|d|={err:.3g} predict latency_ms "
        + " ".join(f"{n}={lat[n] * 1e3:.3f}" for n in lat)
        + f" in {time.perf_counter() - t0:.2f} s")
    pr = per_w
    return [b1_entry("histogram_multi_monotone", b1r, b1_env, per_replay_env),
            b1_entry("histogram_multi_node_rng_window", w, b1_w,
                     pr.get("histogram_multi", 0)),
            {"name": "partition_segments_node_rng", "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/partition.cu",
             "replaces": "lightgbm_tpu/ops/partition_pallas.py:188",
             "launches": b2_w, "in_graph": pr.get("partition_segments", 0) > 0,
             "launches_per_replay": pr.get("partition_segments", 0),
             "max_abs_err": 0.0, "ms": pt["ms"], "plain_ms": pt["plain_ms"],
             "bound_ms": pt["bound_ms"], "bound_by": "bytes",
             "library_ms": pt["library_ms"], "device_ms": pt["device_ms"]}]


# ---------------------------------------------------------------------------
# phase 18: the runtime (snapshots and resume, the cached ensemble, serving)
# ---------------------------------------------------------------------------
RESUME_ROUNDS, SNAP_FREQ, TWS_ROUNDS = 10, 5, 5
SERVE_THREADS, SERVE_REQUESTS, SERVE_ROWS, SERVE_OFFSETS = 8, 200, (1, 7, 64, 300), 50
FLEET_THREADS, FLEET_REQUESTS = 4, 50


def timed_predicts(bst, x, calls, bump):
    """Median wall seconds of ``calls`` Booster.predict calls on ``x``, the
    pack version bumped before each when ``bump`` (so each call builds and
    uploads the ensemble: the uncached path; the model's pinned buffers
    stay); every output must equal the first call's, bitwise."""
    g = bst._gbdt
    want = bst.predict(x)
    times = []
    for _ in range(calls):
        if bump:
            g._invalidate_pred_cache("phase 18 uncached")
        t0 = time.perf_counter()
        got = bst.predict(x)
        times.append(time.perf_counter() - t0)
        if not np.array_equal(got, want):
            raise AssertionError(f"{'uncached' if bump else 'cached'} predict of "
                                 f"{len(x)} rows differs from the first call")
    return float(np.median(times))


def serve_request(i):
    """Request i of the serving traffic: (first held-out row, rows)."""
    return (i % SERVE_OFFSETS) * 300, SERVE_ROWS[i % len(SERVE_ROWS)]


def serve_traffic(rt, X, expect, threads, requests, midway=None):
    """``threads`` clients, each sending ``requests`` blocking requests
    through ``rt`` (rows from serve_request); every response must be
    bitwise one of ``expect[(offset, rows)]`` (Booster.predict of those rows
    under each model that may serve it).  ``midway()`` runs on this thread
    once half the requests are answered.  Returns (seconds, per-request
    latencies, answered, rows)."""
    import threading

    lat, errors = [], []
    lock = threading.Lock()
    half = threading.Event()
    answered = [0]

    def client(t):
        try:
            for j in range(requests):
                off, n = serve_request(t * requests + j)
                t0 = time.perf_counter()
                y = rt.predict(X[off:off + n], timeout=120)
                dt = time.perf_counter() - t0
                if not any(np.array_equal(y, w) for w in expect[(off, n)]):
                    raise AssertionError(f"request ({off}, {n}) answered with no "
                                         "model's Booster.predict")
                with lock:
                    lat.append(dt)
                    answered[0] += 1
                    if answered[0] * 2 >= threads * requests:
                        half.set()
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)
            half.set()

    ts = [threading.Thread(target=client, args=(t,), daemon=True) for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    if midway is not None:
        half.wait(300)
        midway()
    for t in ts:
        t.join(300)
    secs = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        raise AssertionError(f"serving traffic failed: {errors[:3]}")
    rows = sum(serve_request(i)[1] for i in range(threads * requests))
    return secs, np.asarray(lat), answered[0], rows


def runtime_phase(lgt, base, higgs, counts, plain_total):
    """Phase 18 on phase 3's Higgs set (nothing binned again): (a) resume,
    (b) cached against uncached prediction, (c) serving, (d) training while
    serving.  Prints its lines and its time."""
    import tempfile
    import threading

    from lightgbm_tpu_torch import engine
    from lightgbm_tpu_torch.obs import metrics as obs
    from lightgbm_tpu_torch.obs import trace as trc
    from lightgbm_tpu_torch.utils import faults as flt
    from lightgbm_tpu_torch.utils import sanitizer as san

    t_phase = time.perf_counter()
    h_set, _, _, h_Xte, _ = higgs
    tmp = tempfile.mkdtemp(prefix="lgbt_phase18_")
    try:
        # ---- (a) snapshots, a torn newest one, resume == uninterrupted ----
        t0 = time.perf_counter()
        out = os.path.join(tmp, "higgs.txt")
        run = {**base, "snapshot_freq": SNAP_FREQ, "output_model": out}
        trc.reset_trace()
        reset()
        first = lgt.train(run, h_set, RESUME_ROUNDS)
        b1_first = counts()[0]
        snap10 = f"{out}.snapshot_iter_{RESUME_ROUNDS}"
        text10 = Path(snap10).read_text()
        torn = f"{out}.snapshot_iter_{RESUME_ROUNDS + SNAP_FREQ}"
        Path(torn).write_text(text10[: len(text10) // 2])
        write_ms = [s["dur"] * 1e3 for s in trc.spans("checkpoint.snapshot")]
        load = {}
        seed_from = engine._seed_from

        def timed_seed(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            seed_from(*a)
            torch.cuda.synchronize()
            load["ms"] = (time.perf_counter() - t) * 1e3

        engine._seed_from = timed_seed
        try:
            reset()
            resumed = lgt.train(run, h_set, ROUNDS_FLOAT, resume="auto")
        finally:
            engine._seed_from = seed_from
        b1_resumed = counts()[0]
        sha = model_sha(resumed)
        if not (sha.startswith(MODEL_SHA["higgs_float"]) and "ms" in load
                and resumed.num_trees() == ROUNDS_FLOAT and b1_first > 0
                and b1_resumed > 0 and plain_total() == 0 and len(write_ms) == 2):
            raise AssertionError(f"resume: sha256 {sha} (want {MODEL_SHA['higgs_float']}), "
                                 f"{resumed.num_trees()} trees, B1 {b1_first}/{b1_resumed}, "
                                 f"{len(write_ms)} snapshots written, load {load}")
        log(f"phase 18 runtime resume: ok {RESUME_ROUNDS} rounds with snapshot_freq="
            f"{SNAP_FREQ} (snapshot write ms {' '.join(f'{v:.2f}' for v in write_ms)}), a "
            f"torn snapshot_iter_{RESUME_ROUNDS + SNAP_FREQ} skipped (checkpoint_torn_total "
            f"{obs.counter('checkpoint_torn_total').value}), resume=auto from "
            f"iteration {RESUME_ROUNDS} (snapshot load + score replay ms={load['ms']:.2f}) "
            f"to {ROUNDS_FLOAT}: model_sha256={sha} == the uninterrupted Higgs float pin; "
            f"B1 launches {b1_first} + {b1_resumed} in {time.perf_counter() - t0:.2f} s")
        bst = resumed
        bst10 = lgt.Booster(model_file=snap10, params={"device_type": base["device_type"]})
        del first, resumed
        # the torn snapshot was seen (checkpoint_torn_total), which marks the
        # process unhealthy for /healthz and so for the runtime's shedding:
        # a fresh registry for the serving below
        torn_seen = obs.counter("checkpoint_torn_total").value
        if torn_seen < 1:
            raise AssertionError("the torn snapshot went unseen")
        obs.reset()

        # ---- (b) prediction, cached against uncached ----
        t0 = time.perf_counter()
        parts = []
        for n in PRED_BATCHES:
            x = np.ascontiguousarray(h_Xte[:n])
            calls = PRED_CALLS if n < 100_000 else PRED_CALLS_BIG
            cached = timed_predicts(bst, x, calls, bump=False)
            uncached = timed_predicts(bst, x, calls, bump=True)
            parts.append(f"{n}: cached {cached * 1e3:.3f} uncached {uncached * 1e3:.3f}")
        x = np.ascontiguousarray(h_Xte[:1024])
        with san.DispatchCounter() as c:
            bst.predict(x)
        if not (c.host_syncs == 1 and c.predicts == 1):
            raise AssertionError(f"a warm predict made {c.host_syncs} blocking reads "
                                 f"and {c.predicts} traversals")
        g = bst._gbdt
        prof = {mode: predict_profile(bst, h_Xte[:100_000], before=(
            (lambda: g._invalidate_pred_cache("phase 18 uncached")) if mode == "uncached"
            else None)) for mode in ("cached", "uncached")}
        log(f"phase 18 runtime predict: ok latency_ms (median of {PRED_CALLS}, "
            f"{PRED_CALLS_BIG} at 100000 rows) " + "; ".join(parts)
            + f"; outputs bitwise equal; pinned buffers {g._pinned.nbytes() / 2**20:.3f} "
            "MiB; blocking reads a warm call=1; profiled at "
            "100000 rows: " + "; ".join(
                f"{m} device_ms={b:.3f} wall_ms={w:.3f} idle_share={1 - b / w:.4f} "
                f"launches a call={n:.0f}" for m, (b, w, n) in prof.items())
            + f" in {time.perf_counter() - t0:.2f} s")

        # ---- (c) serving: coalesced traffic, a hot swap, a 2-replica fleet ----
        t0 = time.perf_counter()
        keys = {serve_request(i) for i in range(SERVE_THREADS * SERVE_REQUESTS)}
        expect = {(o, n): [bst.predict(h_Xte[o:o + n]), bst10.predict(h_Xte[o:o + n])]
                  for o, n in keys}
        rt = lgt.serve(bst, {"serve_max_wait_ms": 2, "device_type": base["device_type"]})
        try:
            rt.predict(h_Xte[:8], timeout=120)
            c0 = {k: obs.counter(k).value for k in ("serve_batches_total",
                                                   "serve_coalesced_rows_total")}
            reset()
            with san.DispatchCounter() as c:
                secs, lat, answered, rows = serve_traffic(
                    rt, h_Xte, expect, SERVE_THREADS, SERVE_REQUESTS,
                    midway=lambda: rt.swap_model("default", bst10))
            reads, traversals = c.host_syncs, c.predicts
            phases = {ph: obs.histogram(obs.labeled("serve_phase_ms", phase=ph))
                      .percentile(50) for ph in ("queue", "coalesce", "staging",
                                                 "dispatch", "sliceout")}
            batches = obs.counter("serve_batches_total").value - c0["serve_batches_total"]
            brows = (obs.counter("serve_coalesced_rows_total").value
                     - c0["serve_coalesced_rows_total"])
            if not (answered == SERVE_THREADS * SERVE_REQUESTS and batches > 0
                    and reads == batches == traversals and brows == rows
                    and counts() == (0, 0, 0, 0) and plain_total() == 0):
                raise AssertionError(f"serving: {answered} answered, {batches} batches, "
                                     f"{reads} reads, {traversals} traversals, "
                                     f"{brows} of {rows} rows, launches {counts()}")
            from torch.profiler import ProfilerActivity, profile

            b0 = obs.counter("serve_batches_total").value
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                serve_traffic(rt, h_Xte, expect, SERVE_THREADS, 10)
            launches = sum(e.count for e in p.key_averages() if e.key in RUNTIME_LAUNCHES
                           and not str(getattr(e, "device_type", "")).endswith("CUDA"))
            per_batch = launches / max(obs.counter("serve_batches_total").value - b0, 1)
            log(f"phase 18 runtime serve: ok {SERVE_THREADS} clients x {SERVE_REQUESTS} "
                f"requests of {'/'.join(map(str, SERVE_ROWS))} rows, serve_max_wait_ms=2, "
                f"hot swap to the {RESUME_ROUNDS}-round snapshot midway: requests/s="
                f"{answered / secs:.1f} rows/s={rows / secs:.0f} latency_ms p50="
                f"{np.percentile(lat, 50) * 1e3:.3f} p99={np.percentile(lat, 99) * 1e3:.3f} "
                f"batches={batches} mean rows a batch={rows / batches:.1f} blocking reads "
                f"a batch={reads / batches:.2f} traversals a batch="
                f"{traversals / batches:.2f} kernel launches a batch={per_batch:.1f} "
                f"(profiled window); request phases p50 ms "
                + " ".join(f"{k}={v:.3f}" for k, v in phases.items())
                + "; every response bitwise its model's Booster.predict, "
                f"no failure in {time.perf_counter() - t0:.2f} s")

            t1 = time.perf_counter()
            fl = lgt.ServingFleet(bst10, replicas=2, max_wait_ms=2, hedge_ms=0,
                                  hang_timeout_ms=30_000, restart_backoff_ms=50,
                                  shed_unhealthy=False)
            try:
                fl.predict(h_Xte[:8], timeout=120)
                d0 = obs.counter("serve_replica_deaths_total").value
                os.environ["LGBMTPU_FAULT"] = "replica_death:3"
                flt.reset()
                only10 = {k: v[1:] for k, v in expect.items()}
                secs_f, _, answered_f, _ = serve_traffic(fl, h_Xte, only10, FLEET_THREADS,
                                                         FLEET_REQUESTS)
                deaths = obs.counter("serve_replica_deaths_total").value - d0
            finally:
                os.environ.pop("LGBMTPU_FAULT", None)
                flt.reset()
                fl.stop()
            if not (answered_f == FLEET_THREADS * FLEET_REQUESTS and deaths == 1):
                raise AssertionError(f"fleet: {answered_f} answered, {deaths} deaths")
            log(f"phase 18 runtime fleet: ok 2 replicas, LGBMTPU_FAULT=replica_death:3, "
                f"{FLEET_THREADS} clients x {FLEET_REQUESTS} requests: {answered_f} answered "
                f"(0 lost), {deaths} replica death, every response bitwise, requests/s="
                f"{answered_f / secs_f:.1f} in {time.perf_counter() - t1:.2f} s")

            # ---- (d) training while the runtime serves ----
            t1 = time.perf_counter()
            stop = threading.Event()
            served, errors = [0], []

            def keep_serving():
                i = 0
                try:
                    while not stop.is_set():
                        off, n = serve_request(i)
                        y = rt.predict(h_Xte[off:off + n], timeout=120)
                        if not np.array_equal(y, expect[(off, n)][1]):
                            raise AssertionError(f"request ({off}, {n}) differs")
                        served[0] += 1
                        i += 1
                except BaseException as e:  # noqa: BLE001 (reported below)
                    errors.append(e)

            clients = [threading.Thread(target=keep_serving, daemon=True) for _ in range(4)]
            for t in clients:
                t.start()
            reset()
            try:
                tws = lgt.train(base, h_set, TWS_ROUNDS)
            finally:
                stop.set()
                for t in clients:
                    t.join(120)
            b1_tws = counts()[0]
            st = tree_stats(tws)
            alone = lgt.train(base, h_set, TWS_ROUNDS)
            if not (not errors and served[0] > 0 and st["captures"] >= 1
                    and st["replays"] == st["rounds"] and b1_tws > 0
                    and tws.model_to_string() == alone.model_to_string()):
                raise AssertionError(f"train while serving: {errors[:2]}, {served[0]} "
                                     f"served, {st}, B1 {b1_tws}")
            log(f"phase 18 runtime train while serving: ok {TWS_ROUNDS} rounds in graph "
                f"mode ({st['captures']} captures, {st['replays']} replays, B1 launches "
                f"{b1_tws}, capture_error_mode=thread_local) while 4 clients sent "
                f"{served[0]} requests, all bitwise; model text == a {TWS_ROUNDS}-round "
                f"run alone in {time.perf_counter() - t1:.2f} s")
        finally:
            rt.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"phase 18 runtime: ok in {secs:.2f} s (limit 60)")
    if secs > 60:
        raise AssertionError(f"phase 18 took {secs:.2f} s, over its 60 s")


# ---------------------------------------------------------------------------
# phases 19-21: the booster fleet, out-of-core training, continual training,
# on phase 3's binned Higgs set (nothing binned again)
# ---------------------------------------------------------------------------
FLEET_LANES, FLEET_ROUNDS, FLEET_ROUNDS_INT8 = 16, 10, 5
FLEET_SHORT = 5  # rounds of lanes 12-15
FLEET_PARITY = (0, 5, 10, 15)
# lane 0's held-out AUC: the card read 0.83696 (PERF.md); the floor is 0.01 under
AUC_FLOOR_FLEET = 0.826
FLEET_W = 131_072  # positions a lane in the lane kernels' check
OOC_CHUNKS, OOC_SPILL_CAP, OOC_SPILL_ROUNDS = (131_072, 65_536), 262_144, 5
OOC_APPEND_ROWS = 65_536
CONT_EVERY, CONT_APPEND, CONT_CHUNK, CONT_CHUNKS, CONT_CLIENTS = 131_072, 2, 65_536, 4, 8
PHASE_LIMIT_S = 60.0


def phase_time(name, t_phase):
    secs = time.perf_counter() - t_phase
    if secs > PHASE_LIMIT_S:
        raise AssertionError(f"phase {name} took {secs:.2f} s, over its "
                             f"{PHASE_LIMIT_S:.0f} s limit")
    return secs


def fleet_labels(ytr):
    """Phase 19's lanes: lane b's labels are the Higgs labels with 5% of
    rows flipped by RandomState(SEED + b); lanes 8-15 weigh a seeded 20% of
    the rows (one tenant's) 0; lanes 12-15 take FLEET_SHORT rounds."""
    n = len(ytr)
    labels = np.empty((FLEET_LANES, n))
    for b in range(FLEET_LANES):
        flip = np.random.RandomState(SEED + b).rand(n) < 0.05
        labels[b] = np.where(flip, 1.0 - ytr, ytr)
    weights = np.ones((FLEET_LANES, n))
    weights[8:, np.random.RandomState(SEED + 100).rand(n) < 0.2] = 0.0
    return labels, weights


def lane_kernel_case(hc, bins, num_bins, tile, dev, quantized):
    """B1's lane mode at L = FLEET_LANES, W = FLEET_W a lane on the real
    bins: windows of distinct rows (a permutation's prefix, slots in
    ranges, 5% padding), kernel against its plain version on the card
    (bitwise), times, bound and the index_add_ yardstick."""
    n, f = bins.shape
    L, W = FLEET_LANES, FLEET_W
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 19)
    rows = torch.stack([torch.randperm(n, generator=g, device=dev)[:W]
                        for _ in range(L)]).to(torch.int32)
    slot = (torch.arange(W, device=dev) * tile // W).to(torch.int32).repeat(L, 1)
    slot[:, int(W * 0.95):] = -1
    mask = torch.rand(L, n, generator=g, device=dev) < 0.9
    if quantized:
        gv = torch.randint(-8, 9, (L, n), generator=g, device=dev, dtype=torch.int8)
        hv = torch.randint(0, 17, (L, n), generator=g, device=dev, dtype=torch.int8)
        args = (bins, gv, hv, mask, rows, slot, tile, num_bins)
        kern, plain = hc.histogram_multi_quantized_lanes, hc.histogram_multi_quantized_lanes_plain
        dt, vb = torch.int32, 1
    else:
        gv = torch.randn(L, n, generator=g, device=dev)
        hv = torch.rand(L, n, generator=g, device=dev) * 0.25
        shift = torch.stack([hc.fixed_shift_tensor(gv[l], hv[l]) for l in range(L)])
        args = (bins, gv, hv, mask, rows, slot, shift, tile, num_bins)
        kern, plain = hc.histogram_multi_lanes, hc.histogram_multi_lanes_plain
        dt, vb = torch.float32, 4
    k1, k2, p = kern(*args), kern(*args), plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(k1, k2) and torch.equal(k1, p)):
        raise AssertionError(f"lane-mode B1 ({'int8' if quantized else 'float'}) differs "
                             "from its plain version or between launches")
    ms = cuda_ms(lambda: kern(*args))
    plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
    # the yardstick: one index_add_ over flat (lane, slot, feature, bin) cells
    lane_i, pos = torch.nonzero((slot >= 0) & torch.gather(mask, 1, rows.long()),
                                as_tuple=True)
    r = rows[lane_i, pos].long()
    s_ = slot[lane_i, pos].long()
    feat = torch.arange(f, device=dev)
    idx = (((lane_i * tile + s_)[:, None] * f + feat) * num_bins
           + bins[r].long()).reshape(-1)
    v = torch.stack([gv[lane_i, r].to(dt), hv[lane_i, r].to(dt),
                     torch.ones_like(r, dtype=dt)], 1)[:, None, :].expand(-1, f, -1)
    v = v.reshape(-1, 3).contiguous()
    acc = torch.zeros((L * tile * f * num_bins, 3), dtype=dt, device=dev)

    def lib():
        acc.zero_()
        acc.index_add_(0, idx, v)

    library_ms = cuda_ms(lib)
    nbytes = (L * W * 8 + int(r.numel()) * (1 + 2 * vb) + sector_bytes(r, f * 2)
              + L * tile * 3 * f * num_bins * 4)
    b_ms, b_by = bound_of(nbytes, int(r.numel()) * f * 3)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, tile=tile, rows=int(r.numel()))


def partition_lanes_case(pc, n, dev):
    """B2's lane mode at L = FLEET_LANES lanes of n positions, 8 segments
    a lane covering about a third of them, against its plain version on
    the card (bitwise), times, bound and a stable sort as the yardstick."""
    L, S = FLEET_LANES, 8
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)
    order = torch.stack([torch.randperm(n, generator=g, device=dev)
                         for _ in range(L)]).to(torch.int32)
    base_st = torch.arange(S, device=dev) * (n // S)
    seg_start = (base_st + torch.randint(0, n // (3 * S), (L, S), generator=g,
                                         device=dev)).to(torch.int32)
    seg_len = torch.randint(n // (6 * S), n // (3 * S), (L, S), generator=g,
                            device=dev).to(torch.int32)
    go = torch.rand(L, n, generator=g, device=dev) < 0.4
    args = (order, seg_start, seg_len, go)
    k1, k2 = pc.partition_segments_lanes(*args), pc.partition_segments_lanes(*args)
    p = pc.partition_segments_lanes_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(k1, k2, p)):
        raise AssertionError("lane-mode B2 differs from its plain version or between "
                             "launches")
    # a fleet wider than one lane group (1024 // S lanes): 160 lanes of
    # 100,000 positions take two groups in the one launch
    wl, wn = 160, 100_000
    wide = (torch.argsort(torch.rand(wl, wn, generator=g, device=dev), 1).to(torch.int32),
            (torch.arange(S, device=dev) * (wn // S) + torch.randint(
                0, wn // (2 * S), (wl, S), generator=g, device=dev)).to(torch.int32),
            torch.randint(0, wn // (3 * S), (wl, S), generator=g, device=dev).to(
                torch.int32),
            torch.rand(wl, wn, generator=g, device=dev) < 0.4)
    if not all(torch.equal(a, b) for a, b in zip(pc.partition_segments_lanes(*wide),
                                                 pc.partition_segments_lanes_plain(*wide))):
        raise AssertionError("lane-mode B2 over two lane groups differs from its plain "
                             "version")
    ms = cuda_ms(lambda: pc.partition_segments_lanes(*args))
    plain_ms = cuda_ms(lambda: pc.partition_segments_lanes_plain(*args), iters=3, warmup=1)
    # the yardstick: one stable sort of every lane's in-segment positions by
    # (lane, segment start, goes right)
    from lightgbm_tpu_torch.ops.partition import segment_ids

    sid = torch.stack([segment_ids(seg_start[l], seg_len[l], n) for l in range(L)]).long()
    in_seg = sid >= 0
    lane = torch.arange(L, device=dev)[:, None]
    start = torch.gather(seg_start.long(), 1, sid.clamp_min(0))
    key = ((lane * n + start) * 2 + (~go).long())[in_seg]
    flat = order.reshape(-1)
    pos = torch.nonzero(in_seg.reshape(-1)).squeeze(1)

    def lib():
        perm = torch.sort(key, stable=True).indices
        out = flat.clone()
        out[pos] = flat[pos[perm]]
        return out

    library_ms = cuda_ms(lib)
    in_seg_n = int(in_seg.sum())
    b_ms, b_by = bound_of(partition_bytes(L * n, in_seg_n), 0)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, in_seg=in_seg_n)


def fleet_phase(lgt, base, higgs):
    """Phase 19: 16 lanes over phase 3's Higgs bins (module docstring).
    Returns its kernel entries."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc

    t_phase = time.perf_counter()
    h_set, Xtr, ytr, Xte, yte = higgs
    # the fleet and the solo runs set lane labels and weights on the set
    kept = (h_set.label, h_set.weight, dict(h_set.params or {}))
    labels, weights = fleet_labels(ytr)
    entries, launches = [], {}
    split = {"setup": time.perf_counter() - t_phase, "fleet": 0.0, "solo": 0.0,
             "checks": 0.0}
    try:
        for name, extra, R, modes in (
                ("float", {}, FLEET_ROUNDS, ("graph", "eager")),
                ("int8", {"use_quantized_grad": True, "num_grad_quant_bins": 16},
                 FLEET_ROUNDS_INT8, ("graph",))):
            rounds = [R] * 12 + [min(R, FLEET_SHORT)] * 4
            for mode in modes:
                p = {**base, **extra, "fused_training": mode == "graph"}
                reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fb = lgt.train_fleet(p, h_set, labels, num_boost_round=R, weights=weights,
                                     rounds=rounds)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                split["fleet"] += secs
                t_checks = time.perf_counter()
                st = fb.round_stats
                tree_rounds = sum(s["rounds"] for s in st)
                warm = sum(s["captures"] for s in st)
                replays = sum(s["replays"] for s in st)
                b1 = hc.launches["histogram_multi_quantized_lanes" if extra
                                 else "histogram_multi_lanes"]
                b2 = pc.launches["partition_segments_lanes"]
                graphs = mode == "graph" and h_set.bins_device.is_cuda
                if not (b1 == b2 == tree_rounds + warm and plain_total() == 0
                        and replays == (tree_rounds if graphs else 0)):
                    raise AssertionError(f"fleet {name} {mode}: lane B1 {b1}, lane B2 {b2}, "
                                         f"rounds {tree_rounds}, warm-ups {warm}, replays "
                                         f"{replays}, plain {plain_total()}")
                if name == "float" and mode == "graph":
                    launches = {"histogram_multi_lanes": b1, "partition_segments_lanes": b2}
                shas = {b: model_sha(fb.booster(b))[:8] for b in FLEET_PARITY}
                t1 = time.perf_counter()
                split["checks"] += t1 - t_checks
                for b in FLEET_PARITY:
                    # the port's solo run: train() on the three-pass windowed grower
                    h_set.set_field("label", labels[b]).set_field("weight", weights[b])
                    solo = lgt.train({**p, "tree_growth_mode": "windowed",
                                      "megakernel": "0"}, h_set, rounds[b])
                    if model_sha(solo)[:8] != shas[b]:
                        raise AssertionError(f"fleet {name} {mode}: lane {b} is not its "
                                             "solo windowed run")
                torch.cuda.synchronize()
                solo_secs = time.perf_counter() - t1
                split["solo"] += solo_secs
                t_checks = time.perf_counter()
                solo_rounds = sum(rounds[b] for b in FLEET_PARITY)
                a0 = auc(yte, fb.booster(0).predict(Xte))
                if name == "float" and not a0 >= AUC_FLOOR_FLEET:
                    raise AssertionError(f"fleet lane 0 held-out AUC {a0:.5f} < floor "
                                         f"{AUC_FLOOR_FLEET}")
                log(f"phase 19 fleet {name} {mode}: {FLEET_LANES} lanes x {R} rounds "
                    f"(lanes 12-15: {rounds[-1]}) in {secs:.3f} s = "
                    f"{sum(rounds) / secs:.2f} model-rounds/s; four solo windowed runs "
                    f"{solo_rounds / solo_secs:.2f} model-rounds/s; tree-rounds="
                    f"{tree_rounds} replays={replays} warm-ups={warm} lane B1 launches={b1} "
                    f"lane B2 launches={b2} (one each a fleet round) lanes "
                    f"{list(FLEET_PARITY)} bitwise their solo runs {shas} lane 0 "
                    f"auc={a0:.5f}")
                del fb
                split["checks"] += time.perf_counter() - t_checks
        # the device's idle share over a profiled 1-round float fleet (device
        # activity only: a fleet round's tens of thousands of host ops took
        # 31 s to process; its 2-round device record still 19.7 s)
        t_prof = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lgt.train_fleet(dict(base), h_set, labels, num_boost_round=1, weights=weights)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(dev_us(e) for e in device_events(prof)) / 1e3
        split["profile"] = time.perf_counter() - t_prof
        log(f"phase 19 fleet profile (1 round, graph, its capture included): wall_ms="
            f"{wall:.2f} device_busy_ms={busy:.2f} idle_share="
            f"{(1 - busy / wall) if busy > 0 else float('nan'):.4f}")
    finally:
        h_set.set_field("label", kept[0]).set_field("weight", kept[1])
        h_set.params = kept[2]
    dev = h_set.bins_device.device
    t_k = time.perf_counter()
    tile = hc.recommended_leaf_tile(h_set.max_num_bins, N_FEAT, NUM_LEAVES)
    tile_q = hc.recommended_leaf_tile(h_set.max_num_bins, N_FEAT, NUM_LEAVES, quantized=True)
    lf = lane_kernel_case(hc, h_set.bins_device, h_set.max_num_bins, tile, dev, False)
    lq = lane_kernel_case(hc, h_set.bins_device, h_set.max_num_bins, tile_q, dev, True)
    l2 = partition_lanes_case(pc, N_TRAIN, dev)
    for what, r in (("B1 lane float", lf), ("B1 lane int8", lq)):
        log(f"phase 19 kernel {what}: L={FLEET_LANES} W={FLEET_W} F={N_FEAT} "
            f"tile={r['tile']} rows={r['rows']} ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} bound_ms="
            f"{r['bound_ms']:.4f} ({r['bound_by']}) bitwise_plain=True")
    log(f"phase 19 kernel B2 lane: L={FLEET_LANES} N={N_TRAIN} S=8 a lane in-segment="
        f"{l2['in_seg']} ms={l2['ms']:.4f} plain_ms={l2['plain_ms']:.4f} library_ms="
        f"{l2['library_ms']:.4f} bound_ms={l2['bound_ms']:.4f} ({l2['bound_by']}) "
        "bitwise_plain=True")
    entries.append({"name": "histogram_multi_lanes", "route": "cuda",
                    "source": "lightgbm_tpu_torch/csrc/hist.cu",
                    "replaces": "lightgbm_tpu/ops/hist_pallas.py:120",
                    "launches": launches["histogram_multi_lanes"], "in_graph": True,
                    **{k: lf[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}})
    entries.append({"name": "partition_segments_lanes", "route": "cuda",
                    "source": "lightgbm_tpu_torch/csrc/partition.cu",
                    "replaces": "lightgbm_tpu/ops/partition_pallas.py:188",
                    "launches": launches["partition_segments_lanes"], "in_graph": True,
                    **{k: l2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}})
    split["kernels"] = time.perf_counter() - t_k
    log("phase 19 time split (s): " + " ".join(f"{k} {v:.2f}" for k, v in split.items()))
    log(f"phase 19 fleet: ok in {phase_time('19', t_phase):.2f} s")
    return entries


def carry_kernel_case(hc, bins, num_bins, chunk, dev):
    """B1's carried mode at the spill grower's chunk: a sweep of the first
    4 chunks added into one accumulator equals one call over their rows
    with the same exponents (bitwise), and equals the plain version on
    the card; times of one chunk's call, bound, and one index_add_ into an
    int64 accumulator as the yardstick."""
    n, f = 4 * chunk, bins.shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 21)
    grad = torch.randn(n, generator=g, device=dev)
    hess = torch.rand(n, generator=g, device=dev) * 0.25
    mask = torch.rand(n, generator=g, device=dev) < 0.5
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    shift = hc.fixed_shift_tensor(grad, hess)
    b = bins[:n]
    one = hc.histogram_multi(b, grad, hess, mask, slot, 0, 1, num_bins, shift=shift)
    for fn in (hc.histogram_multi_carry, hc.histogram_multi_carry_plain):
        acc = hc.CarryAccumulator(1, f, num_bins, shift, dev)
        for lo in range(0, n, chunk):
            out = fn(b[lo:lo + chunk], grad[lo:lo + chunk], hess[lo:lo + chunk],
                     mask[lo:lo + chunk], slot[lo:lo + chunk], 0, acc,
                     finalize=lo + chunk == n)
        torch.cuda.synchronize()
        if not torch.equal(out, one):
            raise AssertionError(f"carried B1 ({fn.__name__}) differs from the one call")
    c = (b[:chunk], grad[:chunk], hess[:chunk], mask[:chunk], slot[:chunk], 0)
    acc = hc.CarryAccumulator(1, f, num_bins, shift, dev)
    ms = cuda_ms(lambda: hc.histogram_multi_carry(*c, acc))
    plain_ms = cuda_ms(lambda: hc.histogram_multi_carry_plain(*c, acc), iters=5, warmup=1)
    rows = torch.nonzero(mask[:chunk]).squeeze(1)
    feat = torch.arange(f, device=dev)
    idx = (feat * num_bins + b[rows].long()).reshape(-1)
    fix = torch.stack([torch.round(grad[rows].double() * 2.0 ** int(shift[0])).long(),
                       torch.round(hess[rows].double() * 2.0 ** int(shift[1])).long(),
                       torch.ones_like(rows)], 1)[:, None, :].expand(-1, f, -1)
    fix = fix.reshape(-1, 3).contiguous()
    acc64 = torch.zeros((f * num_bins, 3), dtype=torch.int64, device=dev)
    library_ms = cuda_ms(lambda: acc64.index_add_(0, idx, fix))
    nbytes = (chunk * 5 + sector_bytes(rows, f * 2) + 2 * sector_bytes(rows, 4)
              + 2 * f * num_bins * (16 + 4))
    b_ms, b_by = bound_of(nbytes, int(rows.numel()) * f * 3)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, rows=int(rows.numel()))


def ooc_phase(lgt, base, higgs, tmp):
    """Phase 20: phase 3's bins as a stored bin cache; (a) resident, (b)
    spill, (c) an appended segment, compacted.  Returns its kernel entry."""
    from lightgbm_tpu_torch.io import stream as stm
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    t_phase = time.perf_counter()
    h_set, Xtr, ytr, Xte, yte = higgs
    path = os.path.join(tmp, "higgs.bin")
    t0 = time.perf_counter()
    stm.create_bin_cache(path, h_set.bins, h_set.binner.mappers, label=ytr,
                         feature_names=h_set.feature_names, compress=False)
    mb = os.path.getsize(path) / 2 ** 20
    log(f"phase 20 cache: {N_TRAIN} x {N_FEAT} {h_set.bins.dtype} stored, {mb:.1f} MiB "
        f"written in {time.perf_counter() - t0:.2f} s")
    # (a) resident: the chunks assemble the device matrix; phase 3's model
    p = {**base, "out_of_core": True, "out_of_core_chunk_rows": OOC_CHUNKS[0]}
    t0 = time.perf_counter()
    ds = lgt.Dataset(path, params=p).construct()
    torch.cuda.synchronize()
    ingest = time.perf_counter() - t0
    if not (ds.bins is None and not ds.ooc_spill
            and torch.equal(ds.bins_device, h_set.bins_device)):
        raise AssertionError("resident out-of-core: the assembled matrix differs")
    bst = lgt.train(p, ds, ROUNDS_FLOAT)
    if model_sha(bst)[:8] != MODEL_SHA["higgs_float"]:
        raise AssertionError("resident out-of-core training is not phase 3's model")
    log(f"phase 20 ooc resident: chunk {OOC_CHUNKS[0]} streamed {N_TRAIN} rows in "
        f"{ingest:.3f} s ({N_TRAIN / ingest:.0f} rows/s, "
        f"{N_TRAIN * N_FEAT * 2 / ingest / 1e9:.3f} GB/s to the card, the cache read "
        f"and the staging copy included), {ROUNDS_FLOAT} rounds sha256 "
        f"{MODEL_SHA['higgs_float']} (phase 3's)")
    del ds, bst
    # (b) spill: the chunk-streamed grower, bitwise phase 10's strict model
    entry = None
    for chunk in OOC_CHUNKS:
        q = {**base, "out_of_core": True, "max_rows_in_hbm": OOC_SPILL_CAP,
             "out_of_core_chunk_rows": chunk}
        ds = lgt.Dataset(path, params=q).construct()
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lgt.train(q, ds, OOC_SPILL_ROUNDS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = bst._gbdt.round_stats
        passes, chunks = sum(s["passes"] for s in st), sum(s["chunks"] for s in st)
        splits, reads = sum(s["splits"] for s in st), sum(s["host_syncs"] for s in st)
        carry = hc.launches["histogram_multi_carry"]
        if not (ds.ooc_spill and ds.bins_device is None and carry == chunks
                and plain_total() == 0 and reads <= splits + len(st)
                and model_sha(bst)[:8] == MODEL_SHA["higgs_strict"]):
            raise AssertionError(f"spill chunk {chunk}: sha {model_sha(bst)[:8]} carried "
                                 f"launches {carry} chunks {chunks} reads {reads} splits "
                                 f"{splits}")
        rows = passes * N_TRAIN
        log(f"phase 20 ooc spill chunk {chunk}: max_rows_in_hbm={OOC_SPILL_CAP} "
            f"{OOC_SPILL_ROUNDS} rounds in {secs:.3f} s, {rows / secs:.0f} streamed rows/s "
            f"({rows * N_FEAT * 2 / secs / 1e9:.3f} GB/s to the card), "
            f"{chunks / len(st):.1f} chunk launches a tree ({passes / len(st):.1f} passes), "
            f"blocking reads a split={reads / splits:.3f}, carried B1 launches={carry} "
            f"sha256 {MODEL_SHA['higgs_strict']} (phase 10's strict model)")
        if chunk == OOC_CHUNKS[0]:
            entry = carry
        del ds, bst
    r = carry_kernel_case(hc, h_set.bins_device, h_set.max_num_bins, OOC_CHUNKS[0],
                          h_set.bins_device.device)
    log(f"phase 20 kernel B1 carried: chunk {OOC_CHUNKS[0]} x {N_FEAT} rows={r['rows']} "
        f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) sweep == one call bitwise, "
        "== plain bitwise")
    # (c) an appended segment: read back bitwise, then compacted
    t0 = time.perf_counter()
    new = h_set.binner.transform(Xte[:OOC_APPEND_ROWS])
    stm.append_rows(path, new, label=yte[:OOC_APPEND_ROWS], segment_threshold=4)
    seg = stm.BinCacheStream(path)
    back = stm.read_bin_cache(path)
    want = np.concatenate([h_set.bins, new])
    if not (len(seg.segments) == 1 and np.array_equal(back["bins"], want)
            and np.array_equal(back["label"], np.concatenate([ytr, yte[:OOC_APPEND_ROWS]]))):
        raise AssertionError("appended segment: the cache does not read back bitwise")
    stm.compact_bin_cache(path)
    if stm.BinCacheStream(path).segments or not np.array_equal(
            stm.read_bin_cache(path)["bins"], want):
        raise AssertionError("compaction changed the cache")
    log(f"phase 20 ooc append: {OOC_APPEND_ROWS} rows as segment "
        f"{seg.segments[0][0]}, read back bitwise, compacted (watermark "
        f"{stm.BinCacheStream(path).seg_watermark}) in {time.perf_counter() - t0:.2f} s")
    os.remove(path)
    log(f"phase 20 ooc: ok in {phase_time('20', t_phase):.2f} s")
    return [{"name": "histogram_multi_carry", "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/hist.cu",
             "replaces": "lightgbm_tpu/ops/hist_pallas.py:120", "launches": entry,
             "in_graph": False,
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}}]


def continual_phase(lgt, base, higgs, text, tmp):
    """Phase 21: phase 3's 20-tree model behind lgb.serve, 8 clients,
    4 ingested chunks, a refit rollover and an append rollover."""
    import threading

    from lightgbm_tpu_torch.continual import ContinualRunner, refit_leaves
    from lightgbm_tpu_torch.obs import metrics as obs

    t_phase = time.perf_counter()
    h_set, _, _, Xte, _ = higgs
    on = {"device_type": base["device_type"]}
    live = lgt.Booster(params=on, model_str=text)
    rt = lgt.serve(live, {**on, "serve_max_wait_ms": 2})
    X, y = higgs_like(CONT_CHUNK * CONT_CHUNKS, SEED + 21)
    stop = threading.Event()
    got, errors = [], []

    def client(t):
        i = t
        try:
            while not stop.is_set():
                off, n = serve_request(i)
                t0 = time.perf_counter()
                out = rt.predict(Xte[off:off + n], timeout=120)
                got.append((off, n, out, time.perf_counter() - t0))
                i += CONT_CLIENTS
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    cr = ContinualRunner(live, runtime=rt, reference=h_set,
                         state_dir=os.path.join(tmp, "continual"),
                         update_every_rows=CONT_EVERY, append_trees=CONT_APPEND,
                         window_rows=CONT_CHUNK * CONT_CHUNKS)
    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(CONT_CLIENTS)]
    for t in threads:
        t.start()
    models, ingest_s, times = [live], 0.0, {}
    try:
        for k, kind in ((2, "refit"), (4, "append")):
            for c in range(k - 2, k):
                t0 = time.perf_counter()
                cr.ingest(X[c * CONT_CHUNK:(c + 1) * CONT_CHUNK],
                          y[c * CONT_CHUNK:(c + 1) * CONT_CHUNK])
                ingest_s += time.perf_counter() - t0
            if obs.snapshot()["gauges"]["model_staleness_rows"] != 2 * CONT_CHUNK:
                raise AssertionError("staleness gauge does not count the pending rows")
            before = cr.booster
            t0 = time.perf_counter()
            if cr.update(kind) != kind:
                raise AssertionError(f"the {kind} rollover did not run")
            times[kind] = (time.perf_counter() - t0) * 1e3
            g = obs.snapshot()["gauges"]
            if g["model_staleness_rows"] != 0 or g["model_staleness_s"] != 0:
                raise AssertionError(f"staleness gauges after the {kind} rollover: {g}")
            Xw, yw = X[:k * CONT_CHUNK], y[:k * CONT_CHUNK]
            if kind == "refit":
                offline = lgt.Booster(params=on, model_str=before.model_to_string())
                offline._gbdt.cfg = before._gbdt.cfg
                refit_leaves(offline._gbdt, Xw, yw)
                cpu = lgt.Booster(params={"device_type": "cpu"},
                                  model_str=before.model_to_string())
                cpu._gbdt.cfg = before._gbdt.cfg
                refit_leaves(cpu._gbdt, Xw, yw)
                gap = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                          for a, b in zip(cr.booster._gbdt.models, cpu._gbdt.models))
                if not gap <= 1e-6:
                    raise AssertionError(f"card refit vs CPU refit: max|d| {gap}")
            else:
                offline = lgt.train(cr._train_params(), lgt.Dataset(
                    Xw, label=yw, reference=h_set, params={"verbosity": -1, **on}),
                    CONT_APPEND, init_model=before)
            if model_sha(offline) != model_sha(cr.booster):
                raise AssertionError(f"the {kind} rollover is not its offline application")
            models.append(cr.booster)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        rt.stop()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving during the rollovers failed: {errors[:3]}")
    want = {}
    for off, n, out, _ in got:
        if (off, n) not in want:
            want[(off, n)] = [m.predict(Xte[off:off + n]) for m in models]
        if not any(np.array_equal(out, w) for w in want[(off, n)]):
            raise AssertionError(f"a response ({off}, {n}) is no version's Booster.predict")
    lat = np.asarray([d for *_, d in got]) * 1e3
    log(f"phase 21 continual: {CONT_CHUNKS} x {CONT_CHUNK} rows ingested at "
        f"{CONT_CHUNKS * CONT_CHUNK / ingest_s:.0f} rows/s, refit rollover "
        f"{times['refit']:.2f} ms (card vs CPU refit max|d|={gap:.3g}), append rollover "
        f"({CONT_APPEND} trees) {times['append']:.2f} ms, each bitwise its offline "
        f"application, staleness gauges 0 after each; {len(got)} responses from "
        f"{CONT_CLIENTS} clients across the rollovers, each bitwise one version's "
        f"predict, p50={np.median(lat):.3f} ms p99={np.percentile(lat, 99):.3f} ms; "
        f"ok in {phase_time('21', t_phase):.2f} s")


def serial_sha(text: str) -> str:
    """sha256 of a distributed model's text read as the serial run's: the
    parameter record [tree_learner: ...] (the only line in which the two
    texts may differ) set to serial."""
    return hashlib.sha256(re.sub(r"\[tree_learner: [a-z0-9]+\]", "[tree_learner: serial]",
                                 text).encode()).hexdigest()


def distributed_epsilon(ts, grad, hess, split_params, tile, score, label):
    """Phase 23b: world size 1 over NCCL.  grow_tree_windowed_data_parallel
    on the Epsilon set with the megakernel on (B3 unfused, the exact int64
    all-reduce, then the torch search), merge psum and scatter (the owned-
    feature search and election), against the serial windowed tree (the
    fused megakernel), for 2 trees: phase 7's gradients and those after
    the first tree.  Returns the numbers of the phase line."""
    import tempfile

    import torch.distributed as dist

    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed
    from lightgbm_tpu_torch.parallel import data_parallel as dpar
    from lightgbm_tpu_torch.parallel.mesh import make_mesh

    bins, nbpf, mbpf = ts.bins_device, ts.num_bins_pf_device, ts.missing_bin_pf_device
    n, f = bins.shape
    dev = bins.device
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    sw = torch.ones(n, dtype=torch.float32, device=dev)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    common = dict(num_leaves=EPS_LEAVES, num_bins=ts.max_num_bins, params=split_params,
                  leaf_tile=tile)
    obj = create_objective(Config.from_dict({"objective": "binary"}))
    tmp = tempfile.mkdtemp(prefix="lgbt_phase23_")
    out = {"launches": 0, "trees": 0, "rounds": 0}
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        sd = dpar.ShardedData(mesh, bins, nbpf, mbpf)
        g, h = grad, hess
        for t in range(2):
            st: dict = {}
            t0 = time.perf_counter()
            ser, ser_leaf = grow_tree_windowed(bins, g, h, mask, sw, fmask, nbpf, mbpf,
                                               stats=st, **common)
            torch.cuda.synchronize()
            out[f"serial_s_{t}"] = time.perf_counter() - t0
            if not all([st["megakernel"]]):
                raise AssertionError(f"phase 23b: the serial tree took no megakernel: {st}")
            for merge in ("psum", "scatter"):
                reset()
                mesh.reset_stats()
                sst: dict = {}
                t0 = time.perf_counter()
                tree, leaf = dpar.grow_tree_windowed_data_parallel(
                    sd, g, h, mask, sw, fmask, merge=merge, stats=sst, **common)
                torch.cuda.synchronize()
                out[f"{merge}_s_{t}"] = time.perf_counter() - t0
                for name, a, b_ in zip(tree._fields, tree, ser):
                    if (a is None) != (b_ is None) or (a is not None and not torch.equal(a, b_)):
                        raise AssertionError(f"phase 23b {merge} tree {t}: {name} differs "
                                             "from the serial windowed tree")
                if not torch.equal(leaf, ser_leaf):
                    raise AssertionError(f"phase 23b {merge} tree {t}: leaf ids differ")
                k = rc.launches["round_megakernel_unfused"]
                if not (sst["megakernel"] and k == sst["rounds"] and plain_total() == 0
                        and rc.launches["round_megakernel"] == 0):
                    raise AssertionError(f"phase 23b {merge} tree {t}: {k} unfused launches "
                                         f"over {sst['rounds']} rounds, fused "
                                         f"{rc.launches['round_megakernel']}, plain "
                                         f"{plain_total()}")
                out["launches"] += k
                out["rounds"] += sst["rounds"]
                out[f"{merge}_merges_{t}"] = mesh.stats["merges"]
                out[f"{merge}_bytes"] = mesh.stats["merge_bytes"] / max(mesh.stats["merges"], 1)
            out["trees"] += 1
            out[f"leaves_{t}"] = int(ser.num_leaves)
            # the next tree's gradients: the score after this tree
            score = score + 0.1 * ser.leaf_value[ser_leaf.long()]
            g, h = (v.contiguous() for v in obj.get_gradients(score, label, None))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def distributed_phase(lgt, base, higgs):
    """Phase 23c: two ranks on the one card, gloo over CUDA tensors (NCCL
    refuses two ranks of one communicator on one GPU), through
    parallel/launcher.py::train_distributed on the Higgs cell split in two:
    tree_learner=data on the rounds grower (20 float rounds, 5 int8: the
    serial pins), feature on the strict grower (5 rounds: phase 10's pin),
    voting (5 rounds: held-out AUC over its floor).  The data float launch
    is phase 24b's recovery run: fleet snapshots every RESUME_FREQ rounds,
    rank 1 killed at the start of iteration RESUME_DEATH, max_restarts 1
    (the uninterrupted run and the resumed one end on the same pin, so one
    launch holds both).  The four launches run three at a time, the
    longest first (a launch is mostly its workers' start-up).  Each run:
    its sha256 read as serial, both ranks' texts equal, merges a tree,
    bytes a merge, wall time.  Returns the recovery run's (wall s, model
    texts, fleet events)."""
    from concurrent.futures import ThreadPoolExecutor

    from lightgbm_tpu_torch.parallel.launcher import train_distributed

    _, Xtr, ytr, Xte, yte = higgs
    gloo = {**base, "dist_backend": "gloo"}
    recovery = dict(max_restarts=1, restart_backoff_s=0.5,
                    env_extra={"LGBMTPU_FAULT": f"worker_death:1:{RESUME_DEATH}"})
    cases = (("data float", {**gloo, "tree_learner": "data", "snapshot_freq": RESUME_FREQ},
              ROUNDS_FLOAT, MODEL_SHA["higgs_float"], recovery),
             ("data int8", {**gloo, "tree_learner": "data", "use_quantized_grad": True},
              ROUNDS_INT8, MODEL_SHA["higgs_int8"], {}),
             ("feature strict", {**gloo, "tree_learner": "feature",
                                 "tree_growth_mode": "strict"}, ROUNDS_STRICT,
              MODEL_SHA["higgs_strict"], {}),
             # top_k 5: 10 of the 28 features elected a leaf (the default 20
             # would elect all 28, and voting would be data-parallel)
             ("voting", {**gloo, "tree_learner": "voting", "top_k": DIST_TOP_K},
              DIST_ROUNDS_VOTING, None, {}))

    def launch(case):
        what, params, rounds, pin, kw = case
        t0 = time.perf_counter()
        bst, paths = train_distributed(params, Xtr, ytr, rounds, num_machines=DIST_RANKS,
                                       timeout_s=300, **kw)
        return bst, [Path(p).read_text() for p in paths], time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        results = list(pool.map(launch, cases))
    bst, texts, wall = results[0]
    with open(bst._fleet_events, encoding="utf-8") as fh:
        resumed = (wall, texts, [json.loads(line) for line in fh if line.strip()])
    for (what, params, rounds, pin, kw), (bst, texts, wall) in zip(cases, results):
        if len(set(texts)) != 1:
            raise AssertionError(f"phase 23c {what}: the ranks' models differ")
        sha = serial_sha(texts[0])
        if pin is not None and not sha.startswith(pin):
            raise AssertionError(f"phase 23c {what}: sha256 {sha[:8]} is not the serial "
                                 f"pin {pin}")
        meta = bst._distributed_meta
        ms = meta.get("mesh_stats", {})
        trees = max(len(meta.get("round_stats", [])), 1)
        rounds_run = sum(int(s.get("rounds", 0)) for s in meta.get("round_stats", []))
        extra = ""
        if what == "voting":
            a = auc(yte, bst.predict(Xte))
            if not a >= AUC_FLOOR_VOTING:
                raise AssertionError(f"phase 23c voting: AUC {a:.5f} < floor {AUC_FLOOR_VOTING}")
            extra = f" auc={a:.5f} (floor {AUC_FLOOR_VOTING})"
        log(f"phase 23c {what}: ok {DIST_RANKS} ranks on cuda:0 (gloo), {rounds} rounds "
            f"in {wall:.2f} s (worker start-up included, three launches at a time"
            + (", rank 1 killed and the fleet relaunched: phase 24b" if kw else "")
            + ") sha256 "
            f"{sha[:8]}" + (f" == serial pin {pin}" if pin else "")
            + f"; ranks' texts equal; merges/tree={ms.get('merges', 0) / trees:.2f} "
            f"bytes/merge={ms.get('merge_bytes', 0) / max(ms.get('merges', 0), 1):.0f} "
            f"other collectives/tree={ms.get('collectives', 0) / trees:.1f} "
            f"grower rounds/tree={rounds_run / trees:.2f}{extra}")
    return resumed


# phase 24: the 2-D and hierarchical meshes at Epsilon width (a 100,000-row
# slice of phase 5's set through a save_binary cache), the fleet's recovery
# on the Higgs cell, and prediction over a device mesh
# Depth cuts, so that phase 24's own time (its set-up and its launch after
# 23c, alone) fits its 45 s on a slow host: one tree a configuration, and
# the hierarchical trees at 63 leaves.  A round's merge moves every
# window's F x B cells, so a tree's gloo bytes follow its splits: at 255
# leaves the hierarchical trees moved 5.9 and 3.1 GB a rank (ici and dcn)
# in 14.4 and 8.4 s beside the 2-D trees' 6.8 and 4.4 s, and the phase took
# 60.08 s; at 127 leaves 4.5 and 3.7 s on a faster host, the phase 32.24 s
# (H100 80GB HBM3, 700 W).  The launch's ~13 s of rank start-up is fixed.
MESH_ROWS, MESH_TREES, MESH_TOP_K, MESH_HIER_LEAVES = 100_000, 1, 32, 63
RESUME_FREQ, RESUME_DEATH = 5, 12
PHASE23_LIMIT_S, PHASE24_LIMIT_S = 60.0, 45.0
# name, mesh, int8, merge inside the mesh, top_k_features, leaves
MESH_CONFIGS = (("2d_float", "2d", 0, "psum", 0, EPS_LEAVES),
                ("2d_int8", "2d", 1, "psum", 0, EPS_LEAVES),
                ("hier_full_psum", "hier", 0, "psum", EPS_FEAT, MESH_HIER_LEAVES),
                ("hier_k32_scatter", "hier", 0, "scatter", MESH_TOP_K, MESH_HIER_LEAVES))
# the ranks of the phase 24a launch (4 gloo ranks on cuda:0): the 2 x 2
# (data, feature) mesh holds row blocks of 50,000 rows, the 2 x 2 (dcn,
# ici) mesh row blocks of 25,000, each inside its rank's 2-D block
MESH_SCRIPT = r'''
import json, os, time
import numpy as np, torch
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops import hist_cuda, partition_cuda, round_cuda
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.parallel.feature2d import Sharded2DData, grow_tree_windowed_feature2d
from lightgbm_tpu_torch.parallel.hierarchy import SlicedData, grow_tree_windowed_hierarchical
from lightgbm_tpu_torch.parallel.mesh import make_mesh_2d, make_mesh_hierarchical

t_start = time.perf_counter()
torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))  # the ranks share the host
cfg = json.load(open(os.path.join(WORKDIR, "mesh.json")))
dev = torch.device(cfg["device"])
grads = np.load(os.path.join(WORKDIR, "grads.npz"))
n = cfg["rows"]
m2, mh = make_mesh_2d(2, 2), make_mesh_hierarchical(2)
lo, hi = m2.coords[0] * n // 2, (m2.coords[0] + 1) * n // 2
ds = lgb.Dataset(os.path.join(WORKDIR, "eps.bin"),
                 params={"device_type": dev.type, "verbosity": -1,
                         "bin_cache_shard": (lo, hi)}).construct()
bins, nbpf, mbpf = ds.bins_device, ds.num_bins_pf_device, ds.missing_bin_pf_device
sd = Sharded2DData(m2, bins, nbpf, mbpf)
h_lo = RANK * n // 4
sl = SlicedData(mh, bins[h_lo - lo:h_lo - lo + n // 4], nbpf, mbpf)
params = SplitParams(**cfg["split"])
t_setup = time.perf_counter() - t_start
out = {"setup_s": t_setup}
for name, kind, quant, merge, k, leaves in cfg["configs"]:
    mesh = m2 if kind == "2d" else mh
    a, b = (lo, hi) if kind == "2d" else (h_lo, h_lo + n // 4)
    rows = b - a
    ones = (torch.ones(rows, dtype=torch.bool, device=dev), torch.ones(rows, device=dev),
            torch.ones(nbpf.shape[0], dtype=torch.bool, device=dev))
    for t in range(cfg["trees"]):
        g = torch.as_tensor(grads[f"g{t}"][a:b], device=dev)
        h = torch.as_tensor(grads[f"h{t}"][a:b], device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg["seed"] + t)
        for m in (hist_cuda, partition_cuda, round_cuda):
            m.reset_counts()
        mesh.reset_stats()
        st = {}
        common = dict(generator=gen, num_leaves=leaves, num_bins=cfg["bins"],
                      params=params, leaf_tile=cfg["tile_q" if quant else "tile"],
                      quantize_bins=cfg["quant_bins"] if quant else 0,
                      quant_renew=False, stats=st)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "2d":
            tree, leaf = grow_tree_windowed_feature2d(sd, g, h, *ones, **common)
        else:
            tree, leaf = grow_tree_windowed_hierarchical(sl, g, h, *ones, merge=merge,
                                                         top_k_features=k, **common)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        np.savez(os.path.join(WORKDIR, f"{name}_{t}_r{RANK}.npz"), leaf=leaf.cpu().numpy(),
                 **{kk: v.cpu().numpy() for kk, v in tree._asdict().items() if v is not None})
        out[f"{name}_{t}"] = dict(
            wall_s=wall, rounds=st["rounds"], megakernel=bool(st["megakernel"]),
            tile=common["leaf_tile"], bins=cfg["bins"], features=int(nbpf.shape[0]),
            stats=json.loads(json.dumps(mesh.stats)),
            b1=sum(hist_cuda.launches.values()), b2=sum(partition_cuda.launches.values()),
            b3=sum(round_cuda.launches.values()),
            plain=sum(sum(m.plain_calls.values())
                      for m in (hist_cuda, partition_cuda, round_cuda)))
json.dump(out, open(os.path.join(WORKDIR, f"mesh_r{RANK}.json"), "w"))
'''


def _serial_key(quant: int, leaves: int, t: int) -> str:
    return f"{'int8' if quant else 'float'}_{leaves}_{t}"


def mesh_prep(lgt, eps, eps_set, Xtr, ytr, gb, g_eps, h_eps, tiles, tmp):
    """Phase 24a's set-up, while the Epsilon set is on the card: a bin
    cache in save_binary's format of its first MESH_ROWS rows (binned with
    phase 5's boundaries), stored uncompressed (io/stream.py::
    create_bin_cache; zlib took 6.91 s of 8.44 on the card), each tree's
    gradients (phase 7's, and those after the first serial float tree) and
    the serial windowed trees of the same rows at each configuration's
    leaves, float and int8, three-pass (the megakernel stays off on the
    meshes, as in the JAX package).  Returns (workdir, serial trees by name, the plain
    replay's inputs (bins, gradients and tables on the card), seconds a
    part)."""
    from lightgbm_tpu_torch.io.stream import create_bin_cache
    from lightgbm_tpu_torch.ops.treegrow_windowed import grow_tree_windowed

    t0 = time.perf_counter()
    parts = {}
    wd = os.path.join(tmp, "mesh")
    os.makedirs(wd, exist_ok=True)
    sub = lgt.Dataset(Xtr[:MESH_ROWS], label=ytr[:MESH_ROWS], params=dict(eps),
                      reference=eps_set)
    sub.construct()
    parts["bin"] = time.perf_counter() - t0
    create_bin_cache(os.path.join(wd, "eps.bin"), sub._host_bins("save_binary"),
                     sub.binner.mappers, label=sub.label, compress=False)
    parts["save"] = time.perf_counter() - t0 - parts["bin"]
    bins, nbpf, mbpf = sub.bins_device, sub.num_bins_pf_device, sub.missing_bin_pf_device
    dev = bins.device
    n, f = bins.shape
    ones = (torch.ones(n, dtype=torch.bool, device=dev), torch.ones(n, device=dev),
            torch.ones(f, dtype=torch.bool, device=dev))
    grads = {"g0": g_eps[:MESH_ROWS].contiguous(), "h0": h_eps[:MESH_ROWS].contiguous()}
    cfg = dict(rows=MESH_ROWS, trees=MESH_TREES, device=str(dev),
               bins=sub.max_num_bins, tile=tiles[0], tile_q=tiles[1],
               quant_bins=int(gb.cfg.num_grad_quant_bins), seed=SEED + 24,
               split=gb._split_params._asdict(),
               configs=[list(c) for c in MESH_CONFIGS])
    serial = {}
    wanted = sorted({(q, lv) for _n, kind, q, _m, k, lv in MESH_CONFIGS
                     if kind == "2d" or k >= EPS_FEAT})
    for t in range(MESH_TREES):
        for quant, leaves in wanted:
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg["seed"] + t)
            tree, leaf = grow_tree_windowed(
                bins, grads[f"g{t}"], grads[f"h{t}"], *ones, nbpf, mbpf,
                num_leaves=leaves, num_bins=cfg["bins"], params=gb._split_params,
                leaf_tile=tiles[quant], quantize_bins=cfg["quant_bins"] if quant else 0,
                quant_renew=False, generator=gen, megakernel_opt="0")
            serial[_serial_key(quant, leaves, t)] = (
                {k: v.cpu().numpy() for k, v in tree._asdict().items() if v is not None},
                leaf.cpu().numpy())
            if quant == 0 and leaves == EPS_LEAVES and t + 1 < MESH_TREES:
                # the next tree's gradients
                score = gb._score[:MESH_ROWS] + 0.1 * tree.leaf_value[leaf.long()]
                g, h = gb.objective.get_gradients(score, gb._label[:MESH_ROWS], None)
                grads[f"g{t + 1}"], grads[f"h{t + 1}"] = g.contiguous(), h.contiguous()
    np.savez(os.path.join(wd, "grads.npz"), **{k: v.cpu().numpy() for k, v in grads.items()})
    with open(os.path.join(wd, "mesh.json"), "w") as fh:
        json.dump(cfg, fh)
    ref = dict(bins=bins, grads=grads, nbpf=nbpf, mbpf=mbpf, params=gb._split_params,
               num_bins=cfg["bins"])
    del sub
    torch.cuda.synchronize()
    parts["total"] = time.perf_counter() - t0
    parts["trees"] = parts["total"] - parts["bin"] - parts["save"]
    return wd, serial, ref, parts


def mesh_launch(wd):
    """Phase 24a's one launch: 4 gloo ranks on cuda:0 (parallel/launcher.py::
    run_spmd) growing MESH_CONFIGS' trees.  Returns (wall s, its end on
    time.perf_counter(), the ranks' records)."""
    from lightgbm_tpu_torch.parallel.launcher import run_spmd

    on_card = json.loads(Path(wd, "mesh.json").read_text())["device"].startswith("cuda")
    t0 = time.perf_counter()
    run_spmd(MESH_SCRIPT, 4, wd, timeout_s=300, cuda=on_card)
    end = time.perf_counter()
    return end - t0, end, [json.loads(Path(wd, f"mesh_r{r}.json").read_text())
                           for r in range(4)]


def pv_tree_replay(bins, grad, hess, tree, leaf, nbpf, mbpf, params, *, slices: int,
                   blocks: int, top_k: int, num_bins: int) -> dict:
    """A plain reference of the hierarchical (PV-Tree) split search, held
    to a grown tree node by node.  Each internal node's rows (the rows of
    the leaves under it) are histogrammed from scratch in B1's fixed point
    (each gradient rounded to a multiple of 2^-s, int64 sums, one
    conversion), per slice (``slices`` consecutive row blocks) and per
    feature block (``blocks`` owners inside a slice, the reduce_scatter's).
    Each slice votes its ``top_k`` features by slice-local gain; the votes
    are summed, ties go to the lower id and the elected ids are sorted; the
    elected features' global histograms are searched with the node's
    global sums, and the blocks' winners are elected by gain (ties to the
    lower block).  Returns the nodes replayed, those whose feature,
    threshold or direction differ (and the first), the leaves whose count
    differs and the largest leaf-value gap."""
    from lightgbm_tpu_torch.ops.hist_cuda import fixed_shift_tensor
    from lightgbm_tpu_torch.ops.split import (KMIN_SCORE, find_best_split, gain_plane,
                                              leaf_output, reduce_plane_per_feature)
    from lightgbm_tpu_torch.ops.treegrow import serial_totals

    dev = bins.device
    n, f = bins.shape
    nb_ = int(num_bins)
    sh = [int(v) for v in fixed_shift_tensor(grad, hess).cpu()]
    fixed = [torch.round(v.float().double() * 2.0 ** s).long() for v, s in zip((grad, hess), sh)]
    slice_of = torch.arange(n, device=dev) * slices // n
    kb = -(-f // blocks)
    pad = kb * blocks - f

    def padded(v, fill):
        return torch.cat([v, torch.full((pad,), fill, dtype=v.dtype, device=dev)])

    tabs = (padded(nbpf.to(dev), 1), padded(mbpf.to(dev), -1),
            padded(torch.ones(f, dtype=torch.bool, device=dev), False))

    def conv(acc):  # (..., 3, k, B) int64 -> f32, as B1 converts
        return torch.stack([(acc[..., 0, :, :].double() * 2.0 ** -sh[0]).float(),
                            (acc[..., 1, :, :].double() * 2.0 ** -sh[1]).float(),
                            acc[..., 2, :, :].float()], dim=-3)

    def hists(rows, f0):  # (slices, 3, kb, B) int64 sums of features [f0, f0 + kb)
        k = min(kb, f - f0)
        b = bins[rows, f0:f0 + k].long()
        idx = ((slice_of[rows][:, None] * kb + torch.arange(k, device=dev)) * nb_
               + b).reshape(-1)
        out = torch.zeros((3, slices * kb * nb_), dtype=torch.int64, device=dev)
        for c, v in enumerate((fixed[0][rows], fixed[1][rows], torch.ones_like(rows))):
            out[c].index_add_(0, idx, v[:, None].expand(-1, k).reshape(-1))
        return out.view(3, slices, kb, nb_).transpose(0, 1)

    m = int(tree["num_leaves"]) - 1
    lc, rc = np.asarray(tree["left_child"]), np.asarray(tree["right_child"])
    under = {}

    def leaves(c):
        if c < 0:
            return [~c]
        if c not in under:
            under[c] = leaves(int(lc[c])) + leaves(int(rc[c]))
        return under[c]

    leaf_t = torch.as_tensor(np.asarray(leaf), device=dev).long()
    col = hists(torch.arange(n, device=dev), 0).sum(0)[:, 0, :]  # global feature 0
    tot = serial_totals(conv(col[:, None, :])[:, 0, :], f)
    pend = {0: (tot[0], tot[1], tot[2])}
    bad, first, count_bad, gap = 0, None, 0, 0.0
    for s in range(m):
        rows = torch.nonzero(torch.isin(leaf_t, torch.as_tensor(
            leaves(s), device=dev)))[:, 0]
        pg, ph, pc = pend[s]
        po = leaf_output(pg, ph, params)
        best = None
        for blk in range(blocks):
            f0 = blk * kb
            nbb, mbb, fmb = (t[f0:f0 + kb] for t in tabs)
            h = hists(rows, f0)
            loc = conv(h)
            k = max(1, min(int(top_k), kb))
            score = torch.zeros(kb, dtype=torch.float32, device=dev)
            for sl in range(slices):
                lh = loc[sl][None]
                lt = lh[:, :, 0, :].sum(dim=2)
                gain, ctx = gain_plane(lh, lt[:, 0], lt[:, 1], lt[:, 2], nbb, mbb, params,
                                       feature_mask=fmb, parent_output=po[None])
                pf = reduce_plane_per_feature(gain, ctx).gain[0]
                v, i = torch.sort(pf, descending=True, stable=True)
                score.scatter_add_(0, i[:k], torch.where(v[:k] > KMIN_SCORE / 2, v[:k], 0.0))
            el = torch.sort(torch.sort(score, descending=True, stable=True)[1][:k]).values
            bb = find_best_split(conv(h.sum(0)[None])[:, :, el, :], pg[None], ph[None],
                                 pc[None], nbb[el], mbb[el], params,
                                 feature_mask=fmb[el], parent_output=po[None])
            feat = f0 + int(el[int(bb.feature[0])])
            if best is None or float(bb.gain[0]) > float(best[0].gain[0]):
                best = (bb, feat)
        bb, feat = best
        if (feat != int(tree["split_feature"][s])
                or int(bb.threshold_bin[0]) != int(tree["threshold_bin"][s])
                or bool(bb.default_left[0]) != bool(tree["default_left"][s])):
            bad += 1
            first = s if first is None else first
        for child, sums in ((int(lc[s]), (bb.left_sum_g[0], bb.left_sum_h[0],
                                          bb.left_count[0])),
                            (int(rc[s]), (bb.right_sum_g[0], bb.right_sum_h[0],
                                          bb.right_count[0]))):
            if child >= 0:
                pend[child] = sums
                continue
            want = float(leaf_output(sums[0], sums[1], params))
            gap = max(gap, abs(want - float(tree["leaf_value"][~child])))
            count_bad += int(float(sums[2]) != float(tree["leaf_count"][~child]))
    return {"nodes": m, "split_mismatch": bad, "first": first, "count_mismatch": count_bad,
            "leaf_gap": gap}


def mesh_check(wd, serial, recs, ref):
    """Phase 24a's trees against the serial ones: the 2-D trees (float and
    int8) and the hierarchical tree at top-k = F bitwise, the rows' leaf
    ids too; the top-k 32 tree against the plain PV-Tree replay
    (pv_tree_replay) at every node: the same features, thresholds,
    directions and leaf counts, leaf values bitwise.  Returns the phase
    line's numbers."""
    res = {}
    on_card = json.loads(Path(wd, "mesh.json").read_text())["device"].startswith("cuda")
    for name, kind, quant, merge, k, leaves in MESH_CONFIGS:
        for t in range(MESH_TREES):
            ranks = [dict(np.load(os.path.join(wd, f"{name}_{t}_r{r}.npz")))
                     for r in range(4)]
            for r in ranks[1:]:
                for key, v in ranks[0].items():
                    if key != "leaf" and not np.array_equal(r[key], v):
                        raise AssertionError(f"phase 24a {name} tree {t}: ranks differ "
                                             f"in {key}")
            tree = ranks[0]
            leaf = (np.concatenate([ranks[0]["leaf"], ranks[2]["leaf"]]) if kind == "2d"
                    else np.concatenate([r["leaf"] for r in ranks]))
            rec = recs[0][f"{name}_{t}"]
            if rec["megakernel"] or (on_card and (rec["plain"] or not rec["b1"]
                                                  or not rec["b2"])):
                raise AssertionError(f"phase 24a {name}: megakernel {rec['megakernel']} "
                                     f"plain calls {rec['plain']}")
            if kind == "2d" or k >= EPS_FEAT:
                want, want_leaf = serial[_serial_key(quant, leaves, t)]
                for key in want:
                    if not np.array_equal(tree[key], want[key]):
                        raise AssertionError(f"phase 24a {name} tree {t}: {key} differs "
                                             "from the serial windowed tree")
                if not np.array_equal(leaf, want_leaf):
                    raise AssertionError(f"phase 24a {name} tree {t}: leaf ids differ")
                res[f"{name}_bitwise"] = True
            else:
                if not (int(tree["num_leaves"]) > 1 and leaf.min() >= 0
                        and leaf.max() < int(tree["num_leaves"])):
                    raise AssertionError(f"phase 24a {name} tree {t}: not a valid tree")
                t0 = time.perf_counter()
                rp = pv_tree_replay(ref["bins"], ref["grads"][f"g{t}"],
                                    ref["grads"][f"h{t}"], tree, leaf, ref["nbpf"],
                                    ref["mbpf"], ref["params"], slices=2,
                                    blocks=2 if merge == "scatter" else 1, top_k=k,
                                    num_bins=ref["num_bins"])
                rp["s"] = time.perf_counter() - t0
                if (rp["split_mismatch"], rp["count_mismatch"], rp["leaf_gap"]) != (0, 0, 0.0):
                    raise AssertionError(f"phase 24a {name} tree {t}: the plain PV-Tree "
                                         f"replay differs: {rp}")
                res[f"{name}_replay_{t}"] = rp
            res[f"{name}_leaves_{t}"] = int(tree["num_leaves"])
    return res


def mesh_line(recs, res, wall, setup_s):
    """The phase 24a lines: per configuration its wall a tree (rank 0),
    rounds, launches and bytes a tree by axis, beside what a flat merge
    (every rank's full-F histograms over one all_reduce) would move."""
    lines = []
    for name, kind, quant, merge, k, _leaves in MESH_CONFIGS:
        rs = [recs[0][f"{name}_{t}"] for t in range(MESH_TREES)]
        walls = "/".join(f"{r['wall_s']:.3f}" for r in rs)
        rounds = sum(r["rounds"] for r in rs)
        axes = {}
        for r in rs:
            for ax, s in r["stats"].items():
                a = axes.setdefault(ax, [0, 0])
                a[0] += s["merge_bytes"]
                a[1] += s["bytes"]
        cell = 12 if quant else 20  # int32 (g, h, count) or int64 g, h + int32 count
        flat = sum((1 + r["rounds"] * r["tile"]) * r["features"] * r["bins"] * cell
                   for r in rs)
        by_axis = " ".join(f"{ax} {m / MESH_TREES / 1e6:.2f}/{b / MESH_TREES / 1e6:.2f}"
                           for ax, (m, b) in sorted(axes.items()))
        leaves = "/".join(str(res[f"{name}_leaves_{t}"]) for t in range(MESH_TREES))
        replays = [res[f"{name}_replay_{t}"] for t in range(MESH_TREES)
                   if f"{name}_replay_{t}" in res]
        extra = (f" leaves {leaves}"
                 + (" bitwise the serial trees and leaf ids" if f"{name}_bitwise" in res
                    else f" each node's split, leaf counts and values bitwise the plain "
                    f"PV-Tree replay ({sum(r['nodes'] for r in replays)} nodes, "
                    f"{sum(r['s'] for r in replays):.2f} s)"))
        lines.append(
            f"phase 24a {name}: ok {MESH_TREES} tree(s){extra}, s a tree {walls}, tree-rounds "
            f"{rounds}, launches a tree B1 {sum(r['b1'] for r in rs) / MESH_TREES:.1f} "
            f"B2 {sum(r['b2'] for r in rs) / MESH_TREES:.1f} B3 "
            f"{sum(r['b3'] for r in rs)}; MB a tree merged/moved by axis {by_axis}; "
            f"a flat all_reduce of the same rounds {flat / MESH_TREES / 1e6:.2f} MB")
    lines.append(f"phase 24a launch: 4 gloo ranks on cuda:0 in {wall:.2f} s (rank set-up "
                 f"{max(r['setup_s'] for r in recs):.2f} s: the cache shard read and the "
                 f"meshes; main-process set-up {setup_s['total']:.2f} s at phase 7: "
                 f"binning {setup_s['bin']:.2f} s, the uncompressed cache {setup_s['save']:.2f} s, "
                 f"gradients and serial trees {setup_s['trees']:.2f} s)")
    return lines


def resume_check(texts, events) -> dict:
    if len(set(texts)) != 1:
        raise AssertionError("phase 24b: the ranks' models differ")
    sha = serial_sha(texts[0])
    if not sha.startswith(MODEL_SHA["higgs_float"]):
        raise AssertionError(f"phase 24b: sha256 {sha[:8]} is not the serial pin "
                             f"{MODEL_SHA['higgs_float']}")
    kinds = [e["kind"] for e in events]
    resumes = sorted({e.get("round") for e in events if e["kind"] == "fleet_resume"})
    want = RESUME_DEATH - 1 - (RESUME_DEATH - 1) % RESUME_FREQ
    if kinds.count("worker_death") != 1 or kinds.count("fleet_relaunch") != 1 \
            or resumes != [want]:
        raise AssertionError(f"phase 24b: deaths {kinds.count('worker_death')} "
                             f"relaunches {kinds.count('fleet_relaunch')} resume rounds "
                             f"{resumes} (want [{want}])")
    return {"sha": sha[:8], "round": want}


def mesh_predict(lgt, text, X, calls=5):
    """Phase 24c: predict(mesh=make_device_mesh([cuda:0, cuda:0])) of the
    Higgs float model at X's rows, bitwise predict; warm latency of each
    (ms, host clock around the call, which ends in its read)."""
    from lightgbm_tpu_torch.parallel.mesh import make_device_mesh

    bst = lgt.Booster(model_str=text)
    mesh = make_device_mesh([torch.device("cuda", 0)] * 2)
    want, got = bst.predict(X), bst.predict(X, mesh=mesh)
    if not np.array_equal(want, got):
        raise AssertionError("phase 24c: predict(mesh=) differs from predict")
    lat = {}
    for name, kw in (("single", {}), ("mesh", {"mesh": mesh}), ("single", {}),
                     ("mesh", {"mesh": mesh})):
        for _ in range(calls):
            t0 = time.perf_counter()
            bst.predict(X, **kw)
            lat.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in lat.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--variants"]:
        return variants(sys.argv[2] if len(sys.argv) > 2 else None)
    if sys.argv[1:2] == ["--turns"] and len(sys.argv) > 2:
        return turns(sys.argv[2])
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc

    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        raise AssertionError("the port pulled in JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build ----
    t0 = time.perf_counter()
    libs = (hc.LIBRARY, pc.LIBRARY, rc.LIBRARY)
    sos = cuda_build.build_all(libs, force=True)
    for lib in libs:
        lib.lib()
        for line in lib.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                log(f"ptxas {lib.src.name}: " + line.strip())
    for so in sos:
        log(f"phase 1 sass {so.name}: {sass_summary(so, cuda_build.nvcc())}")
    log(f"phase 1 build: ok {' '.join(so.name for so in sos)} in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 2. kernels vs plain versions ----
    t0 = time.perf_counter()
    # the leaf tiles the training path uses at this shape (8 float, 20 int8)
    tile_f = hc.recommended_leaf_tile(MAX_BIN, N_FEAT, NUM_LEAVES)
    tile_q = hc.recommended_leaf_tile(MAX_BIN, N_FEAT, NUM_LEAVES, quantized=True)
    main_case = check_kernel_case(hc, N_TRAIN, N_FEAT, MAX_BIN, tile_f, tile_q,
                                  0, dev, SEED, True)
    ragged = check_kernel_case(hc, 200_003, 130, MAX_BIN, tile_f, tile_q, 3,
                               dev, SEED + 1, False)
    for name in ("float", "int8"):
        r = main_case[name]
        log(f"phase 2 kernel {name}: N={N_TRAIN} F={N_FEAT} B={MAX_BIN} "
            f"tile={r['tile']} rows={r['rows']} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g} bitwise_plain={r['bitwise_plain']} "
            f"ragged(N=200003,F=130) max_abs_err={ragged[name]['max_abs_err']:.3g}")
    log(f"phase 2 kernels: ok in {time.perf_counter() - t0:.2f} s")

    counted = (hc, pc, rc)

    # ---- 3. train, float: graph mode and eager mode in turns ----
    t0 = time.perf_counter()
    base, (train_set, Xtr, ytr, Xte, yte) = higgs_cell(lgt)
    log(f"phase 3 data: {N_TRAIN}+{N_TEST} rows x {N_FEAT} binned in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    runs3 = train_turns(lgt, base, train_set, ROUNDS_FLOAT, MODEL_SHA["higgs_float"],
                        counts, plain_total)
    for r in runs3:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        # B1: the root pass a tree (eager), one a round, one a warm-up round
        # before each capture; the rounds grower makes no blocking read
        if not (b1 == st["trees"] + st["rounds"] + st["captures"] and b1q == b2 == b3 == 0
                and st["host_syncs"] == 0 and st["trees"] == ROUNDS_FLOAT):
            raise AssertionError(f"Higgs float {r['mode']} run: {st} launches {r['launches']}")
        log(turn_line("phase 3 train float", r))
    bst, b1_h, per_replay_h = runs3[0]["bst"], runs3[0]["launches"][0], runs3[0]["st"]["per_replay"]
    p = bst.predict(Xte)
    if p.shape != (N_TEST,) or not np.all(np.isfinite(p)):
        raise AssertionError("predictions are not finite (N,) values")
    a = auc(yte, p)
    if not a >= AUC_FLOOR:
        raise AssertionError(f"held-out AUC {a:.5f} < floor {AUC_FLOOR}")
    text = bst.model_to_string()
    p2 = lgt.Booster(model_str=text).predict(Xte)
    if not np.array_equal(p, p2):
        raise AssertionError("reloaded model predicts differently")
    small_err = small_vs_cpu(lgt, {**base, "num_leaves": 15}, Xtr, ytr, Xte)
    st = runs3[0]["st"]
    log(f"phase 3 train float: ok {ROUNDS_FLOAT} rounds auc={a:.5f} (floor {AUC_FLOOR}) "
        f"B1 launches={b1_h} = {st['trees']} root passes + "
        f"{st['rounds']} tree-rounds (each the last a no-op the one-behind read "
        f"launches) + {st['captures']} warm-up before the capture; plain_calls=0 "
        f"reload=bitwise small-vs-cpu max|d|={small_err:.3g} graph == eager sha256 "
        f"in {time.perf_counter() - t0:.2f} s")
    # telemetry's cost: graph runs with telemetry=false and the default in
    # turns (the same model either way)
    from lightgbm_tpu_torch.obs import metrics as obs

    tele = {False: [], True: []}
    for on in (False, True, False, True):
        (r,) = train_turns(lgt, base if on else {**base, "telemetry": False}, train_set,
                           ROUNDS_FLOAT, MODEL_SHA["higgs_float"], counts, plain_total,
                           turns=("graph",))
        tele[on].append(r["it_s"])
    obs.set_enabled(True)
    log(f"phase 3 telemetry cost (graph, {ROUNDS_FLOAT} rounds, in turns): it/s "
        f"telemetry=false {' '.join(f'{v:.4f}' for v in tele[False])} default (on) "
        f"{' '.join(f'{v:.4f}' for v in tele[True])}; model_sha256 equal")
    for mode in ("graph", "eager", "graph", "eager"):
        log(profile_line(f"phase 3 profile {mode} (5 rounds after a warm one)", profile_rounds(
            lgt, {**base, "fused_training": mode == "graph"}, train_set, 5)))

    # ---- 4. train, int8 (eager in both packages) ----
    t0 = time.perf_counter()
    qparams = {**base, "use_quantized_grad": True}
    (r4,) = train_turns(lgt, qparams, train_set, ROUNDS_INT8, MODEL_SHA["higgs_int8"],
                        counts, plain_total, turns=("ineligible",))
    bst_q, b1q_h = r4["bst"], r4["launches"][1]
    if b1q_h < ROUNDS_INT8 or not bst_q._gbdt.cfg.fused_training:
        raise AssertionError(f"int8 run: launches {r4['launches']}")
    pq = bst_q.predict(Xte)
    aq = auc(yte, pq)
    if not (np.all(np.isfinite(pq)) and aq >= AUC_FLOOR_INT8):
        raise AssertionError(f"int8 run: held-out AUC {aq} < floor {AUC_FLOOR_INT8}")
    # deterministic rounding, so the CPU run quantizes the same gradients
    small_err_q = small_vs_cpu(
        lgt, {**qparams, "num_leaves": 15, "stochastic_rounding": False},
        Xtr, ytr, Xte)
    log(turn_line("phase 4 train int8 (fused_training=true, not eligible: eager)", r4))
    log(f"phase 4 train int8: ok {ROUNDS_INT8} rounds auc={aq:.5f} (floor "
        f"{AUC_FLOOR_INT8}) int8 launches={b1q_h} ({b1q_h / ROUNDS_INT8:.2f}/round) "
        f"small-vs-cpu max|d|={small_err_q:.3g} in {time.perf_counter() - t0:.2f} s")
    del runs3, r4

    # the Higgs set stays for phase 10
    h_set, h_Xtr, h_ytr, h_Xte, h_yte = train_set, Xtr, ytr, Xte, yte

    # ---- 5. the Epsilon-shaped set ----
    t0 = time.perf_counter()
    X, y = epsilon_like(EPS_N_TRAIN + EPS_N_TEST, SEED + 2)
    Xtr, ytr, Xte, yte = (X[:EPS_N_TRAIN], y[:EPS_N_TRAIN], X[EPS_N_TRAIN:],
                          y[EPS_N_TRAIN:])
    t_gen = time.perf_counter() - t0
    eps = {"objective": "binary", "max_bin": MAX_BIN, "num_leaves": EPS_LEAVES,
           "learning_rate": 0.1, "device_type": "cuda", "verbosity": -1, "seed": 7,
           "windowed_growth": True, "bin_construct_sample_cnt": EPS_BIN_SAMPLE}
    eps_set = lgt.Dataset(Xtr, label=ytr, params=dict(eps))
    eps_set.construct()
    tile_w = hc.recommended_leaf_tile(eps_set.max_num_bins, EPS_FEAT, EPS_LEAVES)
    tile_wq = hc.recommended_leaf_tile(eps_set.max_num_bins, EPS_FEAT, EPS_LEAVES,
                                       quantized=True)
    log(f"phase 5 epsilon data: {EPS_N_TRAIN}+{EPS_N_TEST} rows x {EPS_FEAT}, "
        f"{eps_set.max_num_bins} bins max, generated in {t_gen:.2f} s, binned in "
        f"{time.perf_counter() - t0 - t_gen:.2f} s; leaf tile {tile_w} float, "
        f"{tile_wq} int8")

    # ---- 6. windowed training, float: the round megakernel, in turns ----
    t0 = time.perf_counter()
    runs6 = train_turns(lgt, eps, eps_set, EPS_ROUNDS_FLOAT, MODEL_SHA["eps_float"],
                        counts, plain_total)
    for r in runs6:
        st, (b1, b1q, b2, b3) = r["st"], r["launches"]
        # B3 a round (a replay in graph mode) plus the warm-up before each
        # capture; B1 the root pass a tree; one blocking read a tree
        if not (all(st["megakernel"]) and b3 == st["rounds"] + st["captures"]
                and b2 == b1q == 0 and b1 == st["trees"] == EPS_ROUNDS_FLOAT
                and st["host_syncs"] == st["trees"]):
            raise AssertionError(f"windowed float {r['mode']} run: {st} launches "
                                 f"(B1 float, B1 int8, B2, B3) {r['launches']}")
        log(turn_line("phase 6 windowed float", r))
    bst_w, st_w = runs6[0]["bst"], runs6[0]["st"]
    b1_w, mk_launches = runs6[0]["launches"][0], runs6[0]["launches"][3]
    pw = bst_w.predict(Xte)
    if pw.shape != (EPS_N_TEST,) or not np.all(np.isfinite(pw)):
        raise AssertionError("windowed predictions are not finite (N,) values")
    a_w = auc(yte, pw)
    if not a_w >= AUC_FLOOR_EPS:
        raise AssertionError(f"windowed held-out AUC {a_w:.5f} < floor {AUC_FLOOR_EPS}")
    if not np.array_equal(pw, lgt.Booster(model_str=bst_w.model_to_string()).predict(Xte)):
        raise AssertionError("reloaded windowed model predicts differently")
    log(f"phase 6 windowed float: ok {EPS_ROUNDS_FLOAT} rounds auc={a_w:.5f} (floor "
        f"{AUC_FLOOR_EPS}) tree-rounds={st_w['rounds']} round-kernel launches="
        f"{mk_launches} ({st_w['replays']} replays + {st_w['captures']} warm-ups) float "
        f"histogram launches={b1_w} (the root pass, 1/tree) partition launches=0 "
        f"plain_calls=0 retries={st_w['retries']} windows={st_w['windows']} "
        f"blocking host reads/tree={st_w['host_syncs'] / st_w['trees']:.2f} "
        f"(the gradients' maxima, before round 1) async resolves={st_w['resolves']} "
        f"reload=bitwise graph == eager sha256 in {time.perf_counter() - t0:.2f} s")
    prof6 = {}
    for mode in ("graph", "eager"):
        prof6[mode] = profile_rounds(lgt, {**eps, "fused_training": mode == "graph"},
                                     eps_set, 2)
        log(profile_line(f"phase 6 profile {mode} (2 trees after a warm one)",
                         prof6[mode]))
    del runs6
    torch.cuda.empty_cache()

    # ---- 7. the windowed path's kernels vs plain versions ----
    t0 = time.perf_counter()
    gb = bst_w._gbdt  # gradients of the model 5 trees in
    g_eps, h_eps = (v.contiguous() for v in gb.objective.get_gradients(
        gb._score, gb._label, gb._weight))
    ek = r = check_epsilon_kernels(eps_set, g_eps, h_eps, gb._split_params, tile_w,
                                   tile_wq)
    log(f"phase 7 kernel histogram: root pass N={EPS_N_TRAIN} F={EPS_FEAT} tile 1 "
        f"explicit exponents {r['shift']} ms={r['root_ms']:.4f} "
        f"plain_ms={r['root_plain_ms']:.4f} library_ms={r['root_library_ms']:.4f} "
        f"bound_ms={r['root_bound_ms']:.4f} ({r['root_bound_by']}) bitwise_plain=True; "
        f"float window pass T={r['T']} W={r['W']} bitwise_plain=True; int8 window "
        f"pass T={r['Tq']} W={r['Wq']} ms={r['int8_window_ms']:.4f} (gather included), "
        f"kernel alone ms={r['int8_hist_ms']:.4f} plain_ms={r['int8_hist_plain_ms']:.4f} "
        f"library_ms={r['int8_hist_library_ms']:.4f} bound_ms={r['int8_hist_bound_ms']:.4f} "
        f"({r['int8_hist_bound_by']}) bitwise_plain=True")
    log(f"phase 7 kernel partition: N={EPS_N_TRAIN} T={r['T']} in-segment={r['in_seg']} "
        f"ms={r['part_ms']:.4f} (events, a Python call) device_ms={r['part_device_ms']:.4f} "
        f"(torch.profiler, {r['part_seen']} calls seen) floor_ms={r['part_floor_ms']:.4f} "
        f"(one launch from Python) plain_ms={r['part_plain_ms']:.4f} "
        f"library_ms={r['part_library_ms']:.4f} bound_ms={r['part_bound_ms']:.6f} "
        f"(bytes) bitwise_plain=True (T={r['Tq']}, ragged and {r['edges']} edge geometries "
        f"too)")
    log(f"phase 7 kernel round: N={EPS_N_TRAIN} F={EPS_FEAT} B={eps_set.max_num_bins} "
        f"T={r['T']} W={r['W']} window_rows={r['window_rows']} ms={r['round_ms']:.4f} "
        f"plain_ms={r['round_plain_ms']:.4f} bound_ms={r['round_bound_ms']:.4f} "
        f"({r['round_bound_by']}) order, left/right and per-feature bests bitwise "
        f"(training parameters, all split options, ragged) "
        f"in {time.perf_counter() - t0:.2f} s")
    log(f"phase 7 kernel round categorical: {EPS_CAT_COLS} of {EPS_FEAT} columns "
        f"categorical, T={r['T']} W={r['W']} ms={r['round_cat_ms']:.4f} "
        f"plain_ms={r['round_cat_plain_ms']:.4f} bound_ms={r['round_cat_bound_ms']:.4f} "
        f"({r['round_cat_bound_by']}) order, left/right and per-feature bests with "
        f"variants bitwise (categorical, feature_contri, both under all split options)")
    ph, pb = r["round_phases"], r["round_phase_bounds"]
    seen = ph.pop("calls")
    log(f"phase 7 kernel round phases (torch.profiler, {seen} calls seen, ms a call): "
        + "; ".join(f"{k} {ph[k]:.4f} (bound {pb[k][0]:.4f}, {pb[k][1]})"
                    for k, _ in ROUND_PHASES)
        + f"; other {ph['other']:.4f}; sum {sum(ph.values()):.4f}")
    per_replay_w = st_w["per_replay"]
    t0 = time.perf_counter()
    d23 = distributed_epsilon(eps_set, g_eps, h_eps, gb._split_params, tile_w, gb._score,
                              gb._label)
    t_23b = time.perf_counter() - t0
    log(f"phase 23a kernel round unfused: N={EPS_N_TRAIN} F={EPS_FEAT} "
        f"B={eps_set.max_num_bins} T={r['T']} W={r['W']} window_rows={r['window_rows']} "
        f"ms={r['unfused_ms']:.4f} plain_ms={r['unfused_plain_ms']:.4f} "
        f"bound_ms={r['unfused_bound_ms']:.4f} ({r['unfused_bound_by']}) library: none "
        f"(no one PyTorch call partitions and histograms a window); order, int64 and "
        f"int32 sums bitwise the plain version; launches on phase 23b's path="
        f"{d23['launches']}")
    log(f"phase 23b nccl world 1: ok 2 trees ({d23['leaves_0']}, {d23['leaves_1']} "
        f"leaves) psum and scatter each bitwise the serial windowed tree (fused "
        f"megakernel); B3 unfused launches={d23['launches']} over {d23['rounds']} "
        f"tree-rounds (one a round); merges a tree psum {d23['psum_merges_0']}, "
        f"{d23['psum_merges_1']} scatter {d23['scatter_merges_0']}, "
        f"{d23['scatter_merges_1']}; bytes a merge psum {d23['psum_bytes']:.0f} "
        f"scatter {d23['scatter_bytes']:.0f} (int64 grad/hess + int32 counts); s a tree "
        f"serial {d23['serial_s_0']:.3f}/{d23['serial_s_1']:.3f} psum "
        f"{d23['psum_s_0']:.3f}/{d23['psum_s_1']:.3f} scatter {d23['scatter_s_0']:.3f}/"
        f"{d23['scatter_s_1']:.3f} (eager) in {t_23b:.2f} s")
    # ---- 24a set-up: the mesh cells' cache, gradients and serial trees ----
    import tempfile

    tmp24 = tempfile.mkdtemp(prefix="lgbt_phase24_")
    mesh_wd, mesh_serial, mesh_ref, t_24prep = mesh_prep(
        lgt, eps, eps_set, Xtr, ytr, gb, g_eps, h_eps, (tile_w, tile_wq), tmp24)
    del gb, g_eps, h_eps, bst_w
    torch.cuda.empty_cache()

    # ---- 8. windowed training, int8: the three-pass round, in turns ----
    t0 = time.perf_counter()
    eps_q = {**eps, "use_quantized_grad": True}
    runs8 = train_turns(lgt, eps_q, eps_set, EPS_ROUNDS_INT8, MODEL_SHA["eps_int8"],
                        counts, plain_total, turns=("graph", "eager"))
    for r in runs8:
        st, l_q = r["st"], r["launches"]
        per = st["rounds"] + st["captures"]  # a replay a round, a warm-up a capture
        if not (l_q == (0, per + st["trees"], per, 0) and st["host_syncs"] == st["trees"]
                and st["excluded"] == ["quantized"] * EPS_ROUNDS_INT8):
            raise AssertionError(f"windowed int8 {r['mode']} run: {st} launches (B1 "
                                 f"float, B1 int8, B2, B3) {l_q}")
        log(turn_line("phase 8 windowed int8", r))
    bst_q8, st_q = runs8[0]["bst"], runs8[0]["st"]
    _, i8_launches, part_launches, _ = runs8[0]["launches"]
    a_q8 = auc(yte, bst_q8.predict(Xte))
    if not a_q8 >= AUC_FLOOR_EPS_INT8:
        raise AssertionError(f"windowed int8 AUC {a_q8:.5f} < floor {AUC_FLOOR_EPS_INT8}")
    log(f"phase 8 windowed int8: ok {EPS_ROUNDS_INT8} rounds auc={a_q8:.5f} (floor "
        f"{AUC_FLOOR_EPS_INT8}) tree-rounds={st_q['rounds']} partition launches="
        f"{part_launches} int8 histogram launches={i8_launches} (window passes + "
        f"warm-ups + roots) round-kernel launches=0 megakernel excluded: quantized "
        f"retries={st_q['retries']} graph == eager sha256 "
        f"in {time.perf_counter() - t0:.2f} s")
    for mode in ("graph", "eager"):
        log(profile_line(f"phase 8 profile {mode} (2 trees after a warm one)", profile_rounds(
            lgt, {**eps_q, "fused_training": mode == "graph"}, eps_set, 2)))
    per_replay_q = st_q["per_replay"]
    del runs8, bst_q8
    torch.cuda.empty_cache()

    # ---- 9. megakernel against the three-pass round ----
    t0 = time.perf_counter()
    small = lgt.Dataset(Xtr[:EPS_PARITY_ROWS], label=ytr[:EPS_PARITY_ROWS],
                        params=dict(eps), reference=eps_set)
    small.construct()
    reset()
    b_mk = lgt.train(eps, small, 2)
    torch.cuda.synchronize()
    st_mk, l_mk = tree_stats(b_mk), counts()
    # counted from replays: one a round, plus the warm-up round before each capture
    if not (all(st_mk["megakernel"]) and plain_total() == 0
            and st_mk["replays"] == st_mk["rounds"]
            and l_mk == (st_mk["trees"], 0, 0, st_mk["rounds"] + st_mk["captures"])):
        raise AssertionError(f"parity, megakernel: {st_mk} launches {l_mk}")
    reset()
    b_3p = lgt.train({**eps, "megakernel": "0"}, small, 2)
    torch.cuda.synchronize()
    st_3p, l_3p = tree_stats(b_3p), counts()
    per = st_3p["rounds"] + st_3p["captures"]
    if not (not any(st_3p["megakernel"]) and plain_total() == 0
            and st_3p["replays"] == st_3p["rounds"]
            and l_3p == (per + st_3p["trees"], 0, per, 0)):
        raise AssertionError(f"parity, three-pass: {st_3p} launches (B1 float, B1 "
                             f"int8, B2, B3) {l_3p} plain "
                             f"{[m.plain_calls for m in counted]}")
    gap = trees_agree(b_mk, b_3p)
    log(f"phase 9 megakernel vs three-pass: ok {EPS_PARITY_ROWS} rows, 2 trees, "
        f"nodes equal, leaf counts equal, leaf values max rel gap {gap:.3g}; "
        f"launches (B1 float, B1 int8, B2, B3) megakernel {l_mk}, three-pass {l_3p} "
        f"over {st_mk['rounds']} / {st_3p['rounds']} tree-rounds (replays) and "
        f"{st_mk['captures']} / {st_3p['captures']} captures (a warm-up round each), "
        f"plain_calls=0 in {time.perf_counter() - t0:.2f} s")
    del small, b_mk, b_3p
    mk_cat_launches, st_mkc = eps_categorical_parity(lgt, eps, eps_set, Xtr, ytr)

    del eps_set, X, y, Xtr, ytr, Xte, yte
    torch.cuda.empty_cache()
    new_kernels, rank_model = new_phases(lgt, dev, base, (h_set, h_Xtr, h_ytr, h_Xte,
                                                          h_yte), counts, plain_total)
    torch.cuda.empty_cache()

    # ---- 13. the boosting modes, init_model and cv ----
    t0 = time.perf_counter()
    new_kernels += mode_phases(lgt, dev, base, (h_set, h_Xtr, h_ytr, h_Xte, h_yte),
                               counts, plain_total)
    torch.cuda.empty_cache()
    log(f"phase 13 modes: ok in {time.perf_counter() - t0:.2f} s")

    # ---- 14. the prediction surface ----
    t0 = time.perf_counter()
    predict_phase(lgt, {"higgs": (text, h_Xte, h_yte), "lambdarank": rank_model})
    log(f"phase 14 predict: ok in {time.perf_counter() - t0:.2f} s")
    del rank_model
    torch.cuda.empty_cache()

    # ---- 15. categorical features on the Criteo-shaped cell ----
    t0 = time.perf_counter()
    new_kernels += categorical_phase(lgt, dev, counts, plain_total)
    torch.cuda.empty_cache()
    log(f"phase 15 categorical: ok in {time.perf_counter() - t0:.2f} s")

    # ---- 16. EFB and the data-input routes on the Expo-shaped cell ----
    t0 = time.perf_counter()
    entries, expo = efb_phase(lgt, dev, counts, plain_total)
    new_kernels += entries
    torch.cuda.empty_cache()
    log(f"phase 16 efb: ok in {time.perf_counter() - t0:.2f} s")

    # ---- 17. the rest of the feature envelope ----
    t0 = time.perf_counter()
    new_kernels += envelope_phase(lgt, dev, base, (h_set, h_Xtr, h_ytr, h_Xte, h_yte),
                                  expo, counts, plain_total)
    del expo
    torch.cuda.empty_cache()
    log(f"phase 17 envelope: ok in {time.perf_counter() - t0:.2f} s")

    # ---- 18. the runtime: resume, the cached ensemble, serving ----
    runtime_phase(lgt, base, (h_set, h_Xtr, h_ytr, h_Xte, h_yte), counts, plain_total)
    torch.cuda.empty_cache()

    # ---- 19-21. the booster fleet, out of core, continual training ----
    higgs = (h_set, h_Xtr, h_ytr, h_Xte, h_yte)
    new_kernels += fleet_phase(lgt, base, higgs)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="lgbt_phase20_")
    try:
        new_kernels += ooc_phase(lgt, base, higgs, tmp)
        torch.cuda.empty_cache()
        continual_phase(lgt, base, higgs, text, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # ---- 23c. two ranks on the one card (its data float launch: 24b) ----
    t0 = time.perf_counter()
    res_wall, res_texts, res_events = distributed_phase(lgt, base, higgs)
    t_23c = time.perf_counter() - t0
    log(f"phase 23 distributed: ok in {t_23b + t_23c:.2f} s (23b {t_23b:.2f} s, "
        f"23c {t_23c:.2f} s with phase 24b's recovery run; limit {PHASE23_LIMIT_S:.0f})")
    if t_23b + t_23c > PHASE23_LIMIT_S:
        raise AssertionError(f"phase 23 took {t_23b + t_23c:.2f} s, over its "
                             f"{PHASE23_LIMIT_S:.0f} s limit")
    # ---- 24. the 2-D and hierarchical meshes, recovery, sharded predict ----
    # after 23c, alone: what the phase adds to the script is its set-up at
    # phase 7 and its own wall here (24b's run is 23c's data float launch)
    t0 = time.perf_counter()
    try:
        mesh_wall, _, mesh_recs = mesh_launch(mesh_wd)
        mesh_res = mesh_check(mesh_wd, mesh_serial, mesh_recs, mesh_ref)
        for line in mesh_line(mesh_recs, mesh_res, mesh_wall, t_24prep):
            log(line)
    finally:
        shutil.rmtree(tmp24, ignore_errors=True)
    del mesh_ref
    rr = resume_check(res_texts, res_events)
    log(f"phase 24b resume: ok {DIST_RANKS} ranks on cuda:0 (gloo), {ROUNDS_FLOAT} float "
        f"rounds, fleet snapshots every {RESUME_FREQ}, rank 1 killed at iteration "
        f"{RESUME_DEATH}: relaunched from fleet-valid round {rr['round']}, "
        f"sha256 {rr['sha']} == serial pin "
        f"{MODEL_SHA['higgs_float']}, ranks' texts equal, in {res_wall:.2f} s (with "
        f"the relaunch and its back-off; phase 23c's data float launch)")
    t1 = time.perf_counter()
    lat = mesh_predict(lgt, text, h_Xte)
    t_24c = time.perf_counter() - t1
    log(f"phase 24c predict(mesh=2 x cuda:0): ok {len(h_Xte)} rows bitwise predict; "
        f"warm ms (median of 10) predict {lat['single']:.3f} mesh {lat['mesh']:.3f} in "
        f"{t_24c:.2f} s")
    t_run = time.perf_counter() - t0
    t_24 = t_24prep["total"] + t_run
    log(f"phase 24 meshes: ok in {t_24:.2f} s (limit {PHASE24_LIMIT_S:.0f}: set-up "
        f"{t_24prep['total']:.2f} s at phase 7 + {t_run:.2f} s after 23c: 24a "
        f"{mesh_wall:.2f} s and its checks, 24c {t_24c:.2f} s)")
    if t_24 > PHASE24_LIMIT_S:
        raise AssertionError(f"phase 24 took {t_24:.2f} s, over its "
                             f"{PHASE24_LIMIT_S:.0f} s limit")
    del h_set, higgs
    torch.cuda.empty_cache()

    # ---- 22. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise AssertionError(f"nvidia-smi failed: {smi.stderr}")
    log(f"phase 22 device: ok total {time.perf_counter() - t_all:.2f} s")
    log(smi.stdout.strip().splitlines()[0])

    src, tpu = "lightgbm_tpu_torch/csrc/hist.cu", "lightgbm_tpu/ops/hist_pallas.py:120"
    kernels = []
    for name, key, launches, per_replay in (
            ("histogram_multi", "float", b1_h, per_replay_h.get("histogram_multi", 0)),
            ("histogram_multi_quantized", "int8", b1q_h, 0)):
        r = main_case[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "in_graph": per_replay > 0,
            "launches_per_replay": per_replay,
            "max_abs_err": max(r["max_abs_err"], ragged[key]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    r = ek
    for name, pre, launches, per_replay in (
            ("histogram_multi_epsilon_root", "root", b1_w, 0),
            ("histogram_multi_quantized_epsilon_window", "int8_hist",
             i8_launches - st_q["trees"], per_replay_q.get("histogram_multi_quantized", 0))):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "in_graph": per_replay > 0,
            "launches_per_replay": per_replay, "max_abs_err": 0.0, "ms": r[f"{pre}_ms"],
            "plain_ms": r[f"{pre}_plain_ms"], "bound_ms": r[f"{pre}_bound_ms"],
            "bound_by": r[f"{pre}_bound_by"], "library_ms": r[f"{pre}_library_ms"]})
    per_replay = per_replay_q.get("partition_segments", 0)
    kernels.append({
        "name": "partition_segments", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/partition_pallas.py:188",
        "launches": part_launches, "in_graph": per_replay > 0,
        "launches_per_replay": per_replay, "max_abs_err": 0.0, "ms": r["part_ms"],
        "plain_ms": r["part_plain_ms"], "bound_ms": r["part_bound_ms"],
        "bound_by": "bytes", "library_ms": r["part_library_ms"],
        "device_ms": r["part_device_ms"], "floor_ms": r["part_floor_ms"]})
    per_replay = per_replay_w.get("round_megakernel", 0)
    kernels.append({
        "name": "round_megakernel", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/round.cu",
        "replaces": "lightgbm_tpu/ops/round_pallas.py:107",
        "launches": mk_launches, "in_graph": per_replay > 0,
        "launches_per_replay": per_replay,
        "max_abs_err": 0.0,
        "ms": r["round_ms"], "plain_ms": r["round_plain_ms"],
        "bound_ms": r["round_bound_ms"], "bound_by": r["round_bound_by"],
        "library_ms": None})
    per_replay = st_mkc["per_replay"].get("round_megakernel", 0)
    kernels.append({
        "name": "round_megakernel_categorical", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/round.cu",
        "replaces": "lightgbm_tpu/ops/round_pallas.py:107",
        "launches": mk_cat_launches, "in_graph": per_replay > 0,
        "launches_per_replay": per_replay, "max_abs_err": 0.0,
        "ms": r["round_cat_ms"], "plain_ms": r["round_cat_plain_ms"],
        "bound_ms": r["round_cat_bound_ms"], "bound_by": r["round_cat_bound_by"],
        "library_ms": None})
    kernels.append({
        "name": "round_megakernel_unfused", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/round.cu",
        "replaces": "lightgbm_tpu/ops/round_pallas.py:107",
        "launches": d23["launches"], "in_graph": False, "launches_per_replay": 0,
        "max_abs_err": 0.0, "ms": r["unfused_ms"], "plain_ms": r["unfused_plain_ms"],
        "bound_ms": r["unfused_bound_ms"], "bound_by": r["unfused_bound_by"],
        "library_ms": None})
    kernels += new_kernels
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
