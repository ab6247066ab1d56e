"""Smoke run of the PyTorch port (deep_recommenders_torch) on one CUDA card.

    python3 chip_smoke.py

In order:
1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel under deep_recommenders_torch/csrc with nvcc;
3. builds the data: MovieLens-shaped ratings (synthetic, seed 42, 200k
   ratings) encoded into the six CTR features, and SyntheticImdb rows
   (vocab 8000, length 512, seed 42) for the Transformer;
4. kernel phase: calls each kernel's wrapper on the card at the shapes the
   main paths give it (K1 on a train batch's, skewed and uniform ids and
   into a table of 10^6 rows, held bit for bit to its summation order run
   with plain ops on the CPU, three calls each, "bitwise_equal" and
   "deterministic", and to its plain version within the fp32 summation
   bound, and on ids out of range; K1 at ESMM's row width C = 16 on the
   same batch's ids, checked the same way; K1 on bf16 g at the batch's,
   skewed and uniform ids and into 10^6 rows, bit for bit its order's fp32
   sums rounded once to bf16; K1's large-table plan (on bf16 g into a
   table past the crossover) into 10^6 and 4 x 10^6 rows and on a batch
   of two rounds, bit for bit, beside the cluster plan's time in the same
   run, with a row summed out of segment order rejected; K2 on fp32 and
   bf16 embeddings; K3 forward and backward at xDeepFM's
   flagship shapes; K4 forward and backward at H = 6 and H = 128; K5 and
   K6 at the Transformer's (2048, 512, 16), non-causal and causal), holds
   the result against its plain PyTorch version with the tolerance stated
   below for K1 and K2, in deep_recommenders_torch/ops/cin_tolerances.py
   for K3 and K4 and in ops/attention_tolerances.py for K5 and K6 (each
   backward on the same saved residuals and incoming gradients as its plain
   backward; each weight or input gradient also as a whole, and shown to
   reject planted faults; K3 and K4, forward and backward, which round as
   the TPU kernels do, against their bf16 emulations and against fp64, and
   shown to reject the fp32 function, an output missing one f-slice, K3's
   z1 left unrounded before layer 2 or its W scaled by 1 + 1e-3, or a
   weight gradient scaled by 1 + 1e-3 or missing one chunk of rows; the
   fp32 K5 and K6, which form every product in three TF32 passes, shown
   to reject the same function with single-pass TF32 products at least
   ten times over their limits, and dk less one query tile), reports each
   output's error and share of its tolerance, and times kernel, plain
   version and one library call where there is one (for K4's forward also
   that call on bf16 operands; for K6 the backward of the SDPA call, with
   the kernels each SDPA call ran), with CUDA events (device time from
   CUDA-graph replays, and the eager call's time; K5's and K6's bounds
   those of their 3xTF32 design: bytes, three TF32 passes of their
   products, or the exponentials, whichever is largest); then the bf16 K5
   and K6 at the same shapes on bf16 q, k, v, g (at D = 16 those of
   csrc/flash_attention_tma_bf16.cu: TMA under warp specialisation, K5's
   consumer warps on mma.sync, K6 on wgmma and scored once a pair), held
   against their fp64 and bf16 plain versions (``check_forward_bf16``,
   ``check_backward_bf16``), shown to reject dk less one query tile and dq
   less one key tile, timed beside the bf16 SDPA call and the mma.sync
   kernels of csrc/flash_attention_bf16.cu (through their C functions),
   with the exp floors beside their bounds, their SASS (TMA loads; wgmma
   in K6) and ptxas summary, and the checks on planted extreme scores
   beside those mma.sync kernels (exp2f, where the new ones take
   ex2.approx.ftz) and the bf16 plain version;
   then K5 and K6 at D = 256 and at D = 512, fp32 and bf16
   (``wide_attention_phase``: the fp32 K5 and K6 and the bf16 K6 at 256
   are csrc/flash_attention_wide(_bf16).cu's, the bf16 K5 and the bf16 K6
   above 256 csrc/flash_attention_cluster_bf16.cu's; every K5 and K6
   above 256 on clusters that split D), at (256, 512, 256) and
   (128, 512, 512) on one SyntheticImdb batch's key masks, held and timed
   as those at D = 16, beside the library's SDPA where it takes the shape
   ("refused" where not); at D = 512 the forward and backward checks must
   also reject the function that loses a block's partial scores, and the
   cluster kernels must show Hopper's wgmma and TMA instructions in their
   SASS and no mma.sync; the bf16 K6 at (64, 512, 1024), clusters of 4
   blocks that pull, is held the same way and must give the same bits on
   two calls;
   then the bf16 K5 and K6 at (2048, 512, 64) and (2048, 512, 128)
   (``narrow_attention_phase``: K6 at both and K5 at 128 the one-block
   kernels of csrc/flash_attention_cluster_bf16.cu, K5 at 64
   csrc/flash_attention_tma_bf16.cu's), held and timed as those at D = 16,
   beside the mma.sync kernels, with two calls bit for bit and their
   instances' ptxas and SASS;
   then the bf16 K5 above 2048 (``reduce_scatter_attention_phase``:
   clusters of ceil(D / 256) blocks, 9-16, a non-portable size, that
   reduce-scatter their partial scores, as those of 3-8 blocks do but
   for D = 576's, which pull): the placement line (how many clusters of
   2-16 blocks the card holds at once), K5 and the streamed
   K6 at (32, 512, 2304) held and timed as those at D = 512 (the forward
   less the last of 9 blocks' partial scores rejected), K5 at (16, 512,
   4096) held with the same fault and timed, two calls bit for bit at
   both, the instance's ptxas and SASS;
   then the bf16 K6 of csrc/flash_attention_tma_bf16.cu over query ranges
   (``long_attention_phase``): at BH = 132 on each side of the most rows
   an item holds (2176 and 2177 at D = 16, 768 and 769 at 32) and at
   BH = 131 and 132 (Sq 512, 256), non-causal and causal, its range plan,
   two calls bit for bit, checked on 8 (bh) rows with the planted faults
   and, over more than one range, the partials of its range of the most
   rows lost rejected, each side timed; then at the long path's
   (64, 4096, 16) with
   its key masks (entry ``flash_attention_bf16.bwd.long``): checked on
   every row in chunks, each range's partials lost in turn rejected, timed
   beside the mma.sync kernels of csrc/flash_attention_bf16.cu (in the
   order mma.sync, routed, routed, mma.sync), the plain version on the
   chunks and cuDNN's backward, with its bounds and exp floors;
   then the head widths no kernel is built for
   (``head_width_phase``): attention() over the budget at D = 8 and
   FlashAttention at D = 24, fp32 and bf16, through K5 and K6 padded to
   the next kernel width and held to the same checks at the true D;
5. twenty-one train paths (and those of 11-13), each with every launch
   counter set to 0 just before it and read just after, each checked for
   a finite, falling loss
   (the examples: finite) and the exact launches it must make:
   - DeepFM at the bench width (D=16, hidden (256, 32)), 2 epochs: one K1
     per train step;
   - attention() over the budget at D = 200 and at D = 257, (160, 1024),
     in fp32 and then bf16, forward and backward
     (``attention_width_path``): no warning, one launch of each of the
     four K5/K6 kernels (padded to D = 256 and to D = 320: all four on
     clusters of two blocks at 320), held to the plain versions at the
     true D on 64 rows; and at D = 128 as it is; and in bf16 alone at
     D = 2300 (``attention_d2304``: padded to 2304, the bf16 K5 on
     clusters of 9 blocks and the streamed bf16 K6, once each);
   - xDeepFM's flagship (maps (128, 128) relu, hidden (256, 128)), 2 epochs:
     two K1, one K3 forward and one K3 backward per train step, one K3
     forward per eval batch;
   - xDeepFM with maps (128, 128, 128), the layered CIN, 1 epoch: two K1,
     three K4 forwards and three K4 backwards (both bf16 on the tensor
     cores) per train step, three K4 forwards per eval batch;
   (these three with Adam 1e-3 and batch 8192 through Trainer.fit_device,
   each with an AUC above 0.5; the trained DeepFM's and flagship xDeepFM's
   logits on the card must match the plain CPU path on the same weights,
   the flagship's with K3's forward as its bf16 emulation);
   - the rest of the CTR family at the zoo's widths, 2 epochs each: FM
     (Adam 1e-2), FNN (256, 32) warm-started from the FM's weights through
     save_checkpoint, restore_checkpoint and warm_start_from, Wide & Deep
     (256, 128, 64) with the example's three crosses under FTRL (L1 0.5)
     and Adam, and DCN (3 cross layers, (256, 128)): one fp32 K1 per train
     step each; DeepFM in bf16 (``compute_dtype=torch.bfloat16``): one bf16
     K1 per train step; the flagship xDeepFM in bf16: one bf16 K1
     (embeddings), one fp32 K1 (linear terms), K3 as in fp32; each with an
     AUC above 0.5 and its logits on the card against the plain CPU path
     (fp32: rtol 1e-4; bf16: nearer the CPU's bf16 logits than those lie
     to its fp32 ones);
   - a table stored in bf16 (``bf16_table_phase``): DeepFM's composition
     over ``EmbeddingCollection(param_dtype=torch.bfloat16)`` (D 16,
     hidden (256, 32), no compute dtype), 1 epoch (19 steps) with the
     port's Adam 1e-3 (optax's order on the bf16 table), evaluated with
     ``BinaryCTREval(model, auc=AUC(num_thresholds=500))``: one bf16 K1 a
     step and no fp32 K1, an AUC above 0.5; then K1 on one step's real
     bf16 gradient bit for bit its order model (``check_scatter``) and
     timed, the table and its Adam moments still bf16, a checkpoint round
     trip bit for bit with no dtype cast, the logits on the card against
     the plain CPU path (nearer the CPU's bf16 logits than those lie to
     the same weights in fp32), ``AUC(from_logits=True)`` on raw logits
     equal to ``AUC()`` on their sigmoid, and the ms of a train step; one
     ``bf16_table {...}`` line, and its K1 fields in the bf16 K1 entry's
     ``"bf16_table"``; then the same over user_id and movie_id hashed
     into 2^19 buckets each (``bf16_table_large``, a table of 1,048,628
     rows): 19 bf16 K1, each on the large-table plan;
   - ESMM at the zoo's config (the six features through the shared
     embedding collection, D 16, towers (256, 128)), 2 epochs on the same
     data with ctcvr = ctr x a seeded Bernoulli(0.3): one fp32 K1 (C = 16)
     per train step, the ctr AUC above 0.5, its three probabilities on the
     card against the plain CPU path;
   - DIN at the zoo's config (B 8192, T 32, D 32, 36 attention units,
     hidden (200, 80), Dice) on the DIN example's task at 200k examples, 2
     epochs, in fp32 and in bf16: no launch (JAX's DIN reaches no Pallas
     kernel), an AUC above 0.5, the logits against the plain CPU path;
   - the ported DIN example at its defaults, 3 epochs: no launch;
   - the ported MMoE example at its defaults (512,000 x 256, batch 512, 1
     epoch) with a checkpoint directory, then with --epochs 2 on it: it
     resumes at epoch 1 and trains that epoch alone; no launch, each
     task's eval MSE below the variance of its labels;
   - two-tower retrieval at the zoo's config (query tower user_id and
     demographics, candidate tower movie_id and genres, D 32, hidden (64,),
     output 32, L2-normalised; the in-batch softmax loss, batch 4096, Adam
     1e-3) on the positive pairs of the rank-power corpus (200k ratings), 2
     epochs, in fp32 and with the bf16 score product: two fp32 K1 (C = 32)
     per train step, none per eval batch; the towers' embeddings and the
     loss on the card against the plain CPU path (fp32: rtol 1e-4; bf16:
     each row's loss nearer the CPU's bf16 one than that lies to fp32);
     then the exact indexes over the distinct test movies: BruteForce's
     top 100 against Streaming's, InMemoryStreaming's and its own after
     save_index/load_index, and FactorizedTopK with the index against
     FactorizedTopK with the candidates;
   - the ported two-tower example at its defaults (1,000,209 ratings, batch
     1024, 5 epochs, Adagrad, log-Q correction, accidental negatives
     removed, then FactorizedTopK over the full corpus of distinct test
     movies): two K1 per train step and none else, val_loss lower after the
     last epoch than after the first, top-100 accuracy above twice the
     chance rate 100 / N;
   - the Transformer seq2seq slice (the zoo's width at S = 512, batch 256),
     2 epochs of a copy task through Transformer.loss: six K5 and six K6 per
     train step, six K5 per held-out batch, and a held-out loss that falls;
     its trained logits through K5 must match the plain CPU path;
   - the same in bf16 (``compute_dtype=torch.bfloat16``): six bf16 K5 and
     six bf16 K6 per train step, six bf16 K5 per held-out batch, no fp32
     launch; its logits through the bf16 K5 nearer the CPU's bf16 plain
     path than that path is to fp32;
   - the same bf16 run at the zoo's 2 x 64 heads (batch 512: over the
     budget, so K5 and K6 at D = 64), checked the same way;
   - the bf16 run at the zoo's 8 x 16 heads trained at S = 4096, batch 8
     (``transformer_seq2seq_bf16_long``; rows of SyntheticImdb at length
     4096): 30 steps, 2 held-out batches, six bf16 K5 and six bf16 K6 a
     step, every K6 on csrc/flash_attention_tma_bf16.cu over query ranges
     and none elsewhere (launches by source), the held-out loss
     falling, the logits of 2 rows against the CPU as above;
   - the ported IMDB example at its defaults, 3 epochs: dense attention,
     no kernel launch;
6. profiles ten more train steps of every CTR, DIN, multitask and
   two-tower path and the Transformer in fp32 and bf16 (torch.profiler):
   wall time per step, device busy time, idle share and the kernels that
   take the most time;
7. serving (``serving_phase``): exports with ``serving.export_model`` and
   loads with ``load_serving_module`` the trained DeepFM, the flagship
   xDeepFM and the layered one (seeded) with a polymorphic batch, served at
   8192 and 1000 test rows, and the Transformer seq2seq in fp32 and bf16
   (the zoo's width, seeded) at its batch of 256 x 512, whose polymorphic
   export must raise ValueError (its attention's dispatch reads the batch
   size); each program must call its kernel's op (none for DeepFM, K3's
   pooled forward, K4's, K5's fp32 or bf16), each served batch must launch
   exactly one K3, three K4 or six K5 (counters set to 0 just before it),
   its output must equal the eager model's on the card bit for bit (the
   flagship within 1e-6: K3 pools with atomic adds) and the plain CPU
   path's at the train paths' logit tolerances; one flagship batch is
   served under ``training.profiler.trace``, whose trace must name K3's
   CUDA kernel;
8. model artifacts (``model_io_phase``): ``save_model`` and ``load_model``
   on the card for the 13 zoo cases of tests/test_model_io.py, configs
   equal and predictions equal;
9. the indexes at the zoo's index config (``index_phase``: 100,000 x 64
   N(0, 1) candidates, 4096 queries, top 100): ApproxTopK and IVF(128, 128)
   against BruteForce, IVF(128, 8)'s recall@100, kmeans on the card
   against the CPU, both index files through save_index/load_index, and
   the queries/s of BruteForce, InMemoryStreaming(16384), ApproxTopK and
   IVF(128, 8) with IVF's bucket cap, gather bytes and peak memory;
10. GCN (``gcn_phase``): the ported example at its defaults, dense and
   with --sparse-adjacency, test accuracy above 0.95; dense against sparse
   logits on the trained weights; one Adam step on the card against the
   CPU;
11. the native ETL (``native_phase``): the port's library built with g++
   here (the run fails if it cannot be), ``crc32_bucket`` and
   ``pack_bags`` equal to their Python loops on the corpus's 200,000
   user ids and genre bags, and DeepFM at the bench width fed by
   ``NativeStreamLoader`` (``shuffle=False``) through ``Trainer.fit`` for
   an epoch: each batch the split's rows at its step, one K1 a step, a
   finite, falling loss;
12. the mesh on one rank (``mesh_one_rank_phase``): a process group of
   one on NCCL, a (data=1, model=1) mesh, DeepFM at the bench width
   through ``Trainer(mesh=).fit_device`` over
   ``DeviceData.from_numpy(mesh=)`` for an epoch: one K1 and exactly
   three NCCL all-reduces a step (the rows over "model", the linear
   weights' gradient over "model", the gradients and the loss over
   "data"), per-step losses equal to the unmeshed run's from the same
   weights (rtol MESH_ONE_RANK_RTOL; equal bits expected);
13. the mesh on two ranks on the one card (``mesh_two_rank_phase``): two
   processes of this script (``--mesh-rank``) with gloo on CUDA tensors,
   the meshes (data=1, model=2) and (data=2, model=1), DeepFM and the
   flagship xDeepFM at the bench width for MESH_STEPS steps of the global
   batch: each rank one K1 a step on its table (half the fused table at
   model = 2; xDeepFM one more on its replicated linear terms), xDeepFM
   one K3 forward and one K3 backward a step on its rows; the first
   step's loss and gradients (the shards put back together) within
   MESH_FIRST_STEP_RTOL of the unmeshed run on the card from the same
   weights, every loss within MESH_LOSSES_RTOL; each rank's step time and
   K1's device time on its shard printed (nothing is claimed from them);
   at both meshes, the two-tower at the zoo's width with
   ``Retrieval(axis_name="data", mesh=)`` for MESH_STEPS steps of 4096
   pairs (two K1 a step a rank, on its towers' table shards), held as
   DeepFM is, and one step with the log-Q correction and accidental-
   negative removal; at (1, 2), ShardedBruteForce over the index corpus
   against BruteForce (scores within SHARDED_SCORES_RTOL, ids equal on
   tie-free rows) and a load_index(mesh=) round trip, expert-parallel
   MMoE at its example's defaults against the replicated run
   (MESH_FIRST_STEP_RTOL), DeepFM's CKPT_EPOCHS epochs through a sharded
   checkpoint resumed by a fresh model (the step losses of an
   uninterrupted run, bit for bit), load_model(mesh=) of an unmeshed
   artifact (logits within LOAD_MODEL_RTOL); at (2, 1), that checkpoint
   restored equal to its shards joined, Adam's moments included;
14. prints one JSON line with every kernel's numbers (with each forward
   kernel's launches a served batch, and each path's launches), then, as
   the last line, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --ctr-only

builds the kernels, times K1 (a train batch's, skewed and uniform ids, and
uniform ids into 10^6 rows) and K2
(fp32) at the kernel phase's inputs (no checks), runs the DeepFM and the
two xDeepFM train paths with their launch checks, AUCs and profiles, and
prints them as its last line, one JSON object (not the full run's "ok"
line). Like the next
mode, it calls only what every tree of the port with K3's bf16 forward has
(the flagship's logit check expects it), so a copy of this script in a
parent's tree measures the parent, to set a change beside it in one call.

    python3 chip_smoke.py --attention-fp32-only

builds the kernels, times the fp32 K5 and K6 at the kernel phase's shapes
(no checks) and runs the fp32 Transformer path with its launch checks and
profile, and prints them as its last line, one JSON object. It calls only
what every tree of the port since K5 and K6 has, so a copy of this script
in a parent's tree measures the parent.

    python3 chip_smoke.py --attention-times

builds the kernels and times the fp32 and the bf16 K5 and K6 at the
Transformer's shapes (D = 16), the bf16 ones also at its (BH, S) and
D = 32, 64 and 128, at D = 256 and 512 (the wide phase's inputs), at
D = 1024, (64, 512, 1024) (K5 and the bf16 K6 on clusters of 4 blocks),
at D = 2304, (32, 512, 2304), and at D = 4096, (16, 512, 4096) (the bf16
K5 on clusters of 9 and 16 blocks, the rest past the clusters); device
and eager ms, K6's split between its two kernels, and at the bf16 widths
that no entry of the full run times (32, 64, 128, 1024, 2304 and 4096)
their bounds and library calls; no checks; and
prints them as its last line, one JSON object (no "ok" line). It calls
only what every tree since the D > 256 instances has, so a copy of this
script in a parent's tree measures the parent.

    python3 chip_smoke.py --wrapper-host-us

builds the kernels and times only the host's us a call of the K3, K4 and
K5 forward wrappers at the main paths' shapes, and prints them as its last
line (no "ok" line). It calls only what every tree since K5's bf16
instance has, so a copy of this script in a parent's tree times the
parent's wrappers.

Any failure raises and exits non-zero; with no CUDA device it exits 1
before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch
import torch.distributed as dist

from deep_recommenders_torch import convert, native, parallel
from deep_recommenders_torch.datasets import MovielensRanking, SyntheticImdb
from deep_recommenders_torch.datasets.movielens import (
    GENRES_VOCAB,
    MAX_GENRES,
    default_movielens_features,
    synthesize_ml1m,
)
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.embedding.engine import (
    SMALL_VOCAB_MAX,
    EmbeddingCollection,
    LinearTerms,
    fused_embedding_linear,
)
from deep_recommenders_torch.examples import train_transformer_on_imdb
from deep_recommenders_torch.models.nlp import (
    MultiHeadAttention,
    Transformer,
    noam_schedule,
)
from deep_recommenders_torch.models.common import MLP
from deep_recommenders_torch.models.ranking import DeepFM, XDeepFM
from deep_recommenders_torch.ops import _build
from deep_recommenders_torch.ops import attention as att
from deep_recommenders_torch.ops import attention_tolerances as at
from deep_recommenders_torch.ops import cin_kernels as ck
from deep_recommenders_torch.ops import cin_tolerances as ct
from deep_recommenders_torch.ops.embedding_kernels import (
    scatter_add_rows,
    scatter_add_rows_reference,
)
from deep_recommenders_torch.ops.fm import fm_interaction, fm_interaction_fused
from deep_recommenders_torch.parallel.sharding import all_reduce
from deep_recommenders_torch.training import DeviceData, Trainer, bce_loss

# The bench configuration (bench.py's DeepFM) and the smoke run's length.
BATCH = 8192
EMBED_DIM = 16
HIDDEN = (256, 32)
LEARNING_RATE = 1e-3
NUM_RATINGS = 200_000
# K1's timed table of hashed ids (the table of a Criteo-scale ranking model).
LARGE_TABLE_ROWS = 1_000_000
# K1's large-table plan is also held at 4 x 10^6 rows and on a batch of two
# rounds (131072 ids) into 10^6 rows; the bf16_table_large path hashes
# user_id and movie_id into 2^19 buckets each (a table of 1,048,628 rows).
LARGE_TABLE_ROWS_4M = 4_000_000
TWO_ROUND_IDS = 131_072
# Ids of the bf16 K1's key-edge checks (three segments of 2048 at C = 17).
KEY_EDGE_IDS = 6000
LARGE_TABLE_BUCKETS = 2**19
EPOCHS = 2
SEED = 42
# The bf16-stored table's path: one epoch, 19 steps at NUM_RATINGS.
BF16_TABLE_EPOCHS = 1
# xDeepFM's flagship (benchmarks/run_models.py:164-169), and the first
# configuration that XDeepFM sends to the layered CIN.
XDEEPFM_MAPS = (128, 128)
XDEEPFM_HIDDEN = (256, 128)
LAYERED_MAPS = (128, 128, 128)
LAYERED_EPOCHS = 1
# The rest of the CTR family at the zoo's widths (benchmarks/run_models.py:
# 141-161): FM at the FM example's learning rate, FNN (256, 32), Wide &
# Deep (256, 128, 64), DCN with 3 cross layers and (256, 128).
FM_LEARNING_RATE = 1e-2
FNN_HIDDEN = (256, 32)
WDL_HIDDEN = (256, 128, 64)
DCN_CROSS_LAYERS, DCN_HIDDEN = 3, (256, 128)
# The Transformer slice: the zoo's width (benchmarks/run_models.py:307-318:
# vocab 8000, d 128, 8 heads, 2 + 2 layers, FFN 512, dropout 0, batch 256)
# at S = 512, the shortest power-of-two length at which the dispatch rule
# sends its attention to K5 and K6 (2048 x 512 x 512 x 4 B x 3 = 6.4 GB of
# dense score tensors, above the 2 GB budget). A copy task on
# SyntheticImdb rows: 15 train steps per epoch, 3 held-out batches.
TX_VOCAB, TX_DIM, TX_HEADS, TX_LAYERS, TX_FFN = 8000, 128, 8, 2, 512
TX_BATCH, TX_LEN, TX_EPOCHS, TX_EPSILON = 256, 512, 2, 0.1
# Noam warmup: the learning rate rises to 2.7e-3 over the 30 steps (the
# zoo's 4000 would keep it below 1.1e-5, too small to move the loss).
TX_WARMUP = 100
# The bf16 Transformer at the JAX zoo's lane-aligned head shape
# (benchmarks/run_models.py:341-346: the same width, 2 heads of 64) at
# S = TX_LEN and batch 512: (BH, S) = (1024, 512), 3.2 GB of dense score
# tensors, over the budget, so its attention takes the bf16 K5 at D = 64
# (csrc/flash_attention_tma_bf16.cu) and K6 at D = 64
# (csrc/flash_attention_cluster_bf16.cu); at batch 256 (1.6 GB) it would
# stay dense. 7 train steps an epoch, 1 held-out batch.
TX2_HEADS, TX2_BATCH = 2, 512
# The bf16 Transformer at the zoo's width (8 heads of 16) trained at
# S = 4096, as long documents and behaviour sequences train, at the small
# batch memory forces: batch 8, (BH, Sq) = (64, 4096), 12.9 GB of dense
# score tensors, so its attention takes the bf16 K5 and K6 of
# csrc/flash_attention_tma_bf16.cu, K6 over query ranges (past the most
# rows an item holds at D = 16, and 64 (bh) under the card's SMs): two of
# 2048 rows, causal three longer at the start. TXL_STEPS train steps,
# TXL_EVALS held-out batches, the trained logits of TXL_ROWS rows against
# the CPU.
TXL_LEN, TXL_BATCH, TXL_STEPS, TXL_EVALS, TXL_ROWS = 4096, 8, 30, 2, 2
# The bf16 K6 of csrc/flash_attention_tma_bf16.cu on each side of the edges
# of one query range, (BH, Sq, D): Sq the most rows an item holds, and one
# more, at BH = 132; BH = 131 and 132 at a shorter Sq; each checked on
# every (bh) row, in chunks of LONG_CHECK_ROWS, and timed.
LONG_EDGES = ((132, 2176, 16), (132, 2177, 16), (131, 512, 16),
              (132, 512, 16), (132, 768, 32), (132, 769, 32),
              (131, 256, 32), (132, 256, 32))
LONG_CHECK_ROWS = 8
# The path's K6 is held on chunks of LONG_CHUNK (bh) rows (fp64 scores of
# 4 x 4096 x 4096 take 0.5 GB a tensor); its plain version timed on them.
LONG_CHUNK = 4
# DIN at the zoo's config (benchmarks/run_models.py:171-204: B 8192, T 32,
# D 32, attention units 36, hidden (200, 80), Dice, Adam 1e-3) on the DIN
# example's task (make_data: 500 items) at 200k examples, split 80/20: 19
# train steps an epoch, 4 eval batches.
DIN_EXAMPLES, DIN_ITEMS, DIN_LEN, DIN_DIM = 200_000, 500, 32, 32
DIN_UNITS, DIN_HIDDEN = 36, (200, 80)
# ESMM at the zoo's config (benchmarks/run_models.py:231-260): the six
# MovieLens features at D 16, towers (256, 128), cvr drawn Bernoulli(0.3).
ESMM_HIDDEN, ESMM_CVR_RATE = (256, 128), 0.3
# Two-tower retrieval at the zoo's config (benchmarks/run_models.py:262-290:
# query tower user_id, user_gender, user_age, user_occupation; candidate
# tower movie_id, movie_genres; embedding_dim 32, hidden (64,), output_dim
# 32, L2-normalised; in-batch softmax CE, SUM, batch 4096, Adam 1e-3) on the
# positive pairs of the rank-power corpus at NUM_RATINGS: 22 train steps an
# epoch, 5 eval batches. The exact indexes hold the candidate tower's
# embeddings of the distinct test movies and answer TT_QUERIES test queries
# for the top TT_K; Streaming takes TT_STREAM candidates a batch and
# InMemoryStreaming chunks of TT_CHUNK.
TT_BATCH, TT_DIM, TT_HIDDEN = 4096, 32, (64,)
TT_QUERIES, TT_K, TT_STREAM, TT_CHUNK = 4096, 100, 1000, 1024
# Flash attention's kernel phase: fp64 checks over BH rows in chunks.
ATT_CHUNK = 256
# A planted fault in dk: the contribution of the first query tile dropped;
# in the bf16 dq: the contribution of the first key tile (of the one-pass
# K6's 128).
ATT_PLANTED_ROWS = 64
ATT_PLANTED_KEYS = 128
# Head widths without a kernel: the IMDB example's --model-dim 32
# --max-len 1024 (batch 64 x 4 heads, D = 8; 256 x 1024^2 x 4 B x 3 = 3.2 GB
# of dense score tensors, over the 2 GB budget), checked in chunks of rows;
# and D = 200 (the D = 256 kernels, padded) and D = 257 (the D = 320
# kernels, padded) over the budget (160 x 1024^2 x 4 B x 3 = 2.01 GB).
HW_BH, HW_LEN, HW_CHUNK, HW_WIDE_BH = 256, 1024, 64, 160
# The D = 256 instances of K5 and K6, and those above 256 at D = 512: one
# SyntheticImdb batch's key masks, one head an example, at the
# Transformer's S; (BH, D) of each.
WIDE_SHAPES = {"d256": (256, 256), "d512": (128, 512)}
# --attention-times also takes D = 1024 (K5 and the bf16 K6 on clusters of
# 4 blocks), BH halved again: how the clusters' exchange grows with their
# size; and D = 2304 and 4096, past the portable clusters (the bf16 K5 on
# clusters of 9 and 16 blocks that reduce-scatter, the bf16 K6 of
# csrc/flash_attention_wide_bf16.cu, the fp32 ones in grid columns of
# clusters).
TIMED_SHAPES = {**WIDE_SHAPES, "d1024": (64, 1024), "d2304": (32, 2304),
                "d4096": (16, 4096)}
# And the other head widths up to 128 of the bf16 K5 and K6 at the
# Transformer slice's (BH, S) and key masks.
NARROW_TIMED = (32, 64, 128)
# The widths of the one-block instances of csrc/flash_attention_cluster_bf16.cu
# (K5 at 128, K6 at 64 and 128), held and timed at the Transformer slice's
# (BH, S) and key masks: entries ``*.d64`` and ``*.d128``.
NARROW_HELD = (64, 128)

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, fp32
# outside the tensor cores, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# Dense TF32 on the tensor cores: the fp32 K5 and K6 take three passes.
TF32_OPS_PER_S = 495e12
TF32_PASSES = 3
U32 = 2.0**-24  # unit roundoff of float32
U_BF16 = 2.0**-8  # unit roundoff of bfloat16
# The H100's special-function units: 16 exponentials a clock on each of its
# 132 SMs (a floor of the attention kernels at D = 16).
SMS, EXP_PER_SM_CLOCK = 132, 16
# Tile of the attention kernels (keys, and query rows of a block).
ATT_TILE = 64
# CUDA-graph timing of the CIN kernels: each call is milliseconds.
CIN_ITERS, CIN_REPLAYS = 5, 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi ``clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean time of one eager call, from CUDA events around ``iters``
    back-to-back calls: the host's launch cost shows where it is the
    larger."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, replays: int = 10) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so no host launch cost
    is counted. Inputs stay in the 50 MB L2 from call to call, as they do
    between the main path's neighbouring ops at these sizes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def timings(kernel, plain, library, iters: int = 50, replays: int = 10,
            eager_iters: int = 100) -> dict:
    return {
        "ms": graph_ms(kernel, iters, replays),
        "eager_ms": time_ms(kernel, eager_iters),
        "plain_ms": graph_ms(plain, iters, replays),
        "library_ms": (graph_ms(library, iters, replays)
                       if library is not None else None),
    }


def host_us(fn, calls: int = 20) -> float:
    """The host's wall time per call of a wrapper (us): ``calls`` calls
    queued after a warm one, with no synchronisation between them, so the
    card runs them later and the host's own work is what is timed."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def cin_timings(kernel, plain, library=None) -> dict:
    return {**timings(kernel, plain, library, CIN_ITERS, CIN_REPLAYS,
                      eager_iters=20),
            "host_us": host_us(kernel)}


def bound(num_bytes: float, num_ops: float,
          ops_per_s: float = FP32_OPS_PER_S):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over their rate, fp32 by default (ms, which
    one)."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = num_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_fields(num_bytes: float, num_ops: float, bf16: bool = False,
                 scalar_ops: float = 0.0) -> dict:
    """``bound`` at the rate of the kernel's arithmetic: fp32 on the CUDA
    cores, or with ``bf16`` bf16 on the tensor cores. Also both bounds by
    name: ``bound_fp32_ms``, and ``bound_bf16_ms``, the precision the TPU
    kernels ran at. ``scalar_ops`` are fp32 operations outside the
    products (a backward's folds of t_f): at the fp32 rate in both, beside
    the products on the tensor cores in the bf16 bound (the two units run
    at once)."""
    fp32_ms, fp32_by = bound(num_bytes, num_ops + scalar_ops)
    bf16_ms, bf16_by = bound(num_bytes, num_ops, BF16_OPS_PER_S)
    scalar_ms = scalar_ops / FP32_OPS_PER_S * 1e3
    if scalar_ms > bf16_ms:
        bf16_ms, bf16_by = scalar_ms, "operations"
    ms, by = (bf16_ms, bf16_by) if bf16 else (fp32_ms, fp32_by)
    return {"bound_ms": ms, "bound_us": ms * 1e3, "bound_by": by,
            "bound_fp32_ms": fp32_ms, "bound_bf16_ms": bf16_ms,
            "gflop": (num_ops + scalar_ops) / 1e9}


def check_scatter(g, ids, num_rows, calls: int = 3) -> dict:
    """K1 on ``calls`` calls against, on copies of g and ids on the CPU,
    (a) its summation order run with plain ops
    (``scatter_add_rows_in_segments``; on bf16 g, on g.float(), each row
    then rounded once to bf16): equal bit for bit (``torch.equal`` on the
    integer views), so also from call to call; and (b) its plain version
    (``index_add_``, each row in index order, in fp32): both are fp32 sums
    of the same L terms of a row, each within (L - 1) u sum|g| of the exact
    sum, so they may differ by 2 L u sum|g| (the tolerance, element-wise),
    and on bf16 g each is then rounded once (u_bf16 of each side more).
    Also the most updates a row takes, and the most it takes in one
    segment: the longest chain of dependent adds."""
    # Imported here: --ctr-only also runs in a parent's tree, which has no
    # summation-order model.
    from deep_recommenders_torch.ops.embedding_kernels import (
        scatter_add_rows_in_segments,
        segment_length,
    )
    g_cpu, ids_cpu = g.cpu(), ids.cpu()
    want = scatter_add_rows_in_segments(g_cpu.float(), ids_cpu,
                                        num_rows).to(g.dtype)
    plain = scatter_add_rows_reference(g_cpu, ids_cpu, num_rows)
    runs = [scatter_add_rows(g, ids, num_rows).cpu() for _ in range(calls)]
    view = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
    bits = [t.view(view) for t in runs]
    bitwise = all(torch.equal(b, want.view(view)) for b in bits)
    deterministic = all(torch.equal(b, bits[0]) for b in bits[1:])
    rows = ids_cpu.long()
    kept = (rows >= -num_rows) & (rows < num_rows)
    rows = rows % num_rows
    updates = torch.bincount(rows[kept], minlength=num_rows).double()
    magnitude = scatter_add_rows_reference(g_cpu.abs().double(), ids_cpu,
                                           num_rows)
    tol = 2.0 * updates[:, None] * U32 * magnitude
    if g.dtype == torch.bfloat16:
        tol = tol + U_BF16 * (runs[0].double().abs() + plain.double().abs())
    err = (runs[0].double() - plain.double()).abs()
    within = bool((err <= tol).all())
    if not (bitwise and deterministic and within):
        raise AssertionError(
            f"scatter_add_rows: bitwise_equal {bitwise}, deterministic "
            f"{deterministic}, within the summation bound {within}, max "
            f"err {err.max().item():.3g}")
    segment = segment_length(g.shape[1])
    nseg = -(-ids.shape[0] // segment)
    chain = rows * nseg + torch.arange(ids.shape[0]) // segment
    return {"max_abs_err": err.max().item(), "tolerance": tol.max().item(),
            "max_err_over_tolerance": (err / tol.clamp_min(1e-300)).max()
            .item(),
            "bitwise_equal": bitwise, "deterministic": deterministic,
            "segment": segment,
            "max_row_updates": int(updates.max().item()),
            "longest_chain": int(torch.unique(chain[kept],
                                              return_counts=True)[1].max())}


def esmm_scatter_fields(ids, num_rows, gen, device) -> dict:
    """K1 at ESMM's row width C = 16 (its shared (V, 16) table; DeepFM's
    fused table is C = 17, and ``segment_length(C)`` depends on C) on one
    ESMM train batch's ids: ESMM embeds the same six features as DeepFM,
    so its collection's offsets and ids are DeepFM's. g (16384, 16) seeded
    normals. :func:`check_scatter` on three calls (bit for bit its
    summation order, the same bits each call, within the fp32 summation
    bound of the plain version), device, eager, plain and library ms
    (``index_add_`` into ``torch.zeros``), and the bound: g, ids and the
    output once each."""
    n, c = ids.shape[0], EMBED_DIM
    g = torch.randn(n, c, device=device, generator=gen)
    ids_long = ids.long()
    bound_ms, bound_by = bound(n * c * 4 + n * 4 + num_rows * c * 4, n * c)
    return {
        "shape": {"g": [n, c], "num_rows": num_rows},
        "ids": "one ESMM train batch's user_id and movie_id",
        **check_scatter(g, ids, num_rows),
        **timings(
            lambda: scatter_add_rows(g, ids, num_rows),
            lambda: scatter_add_rows_reference(g, ids, num_rows),
            lambda: torch.zeros(num_rows, c, device=device).index_add_(
                0, ids_long, g)),
        "host_us": host_us(lambda: scatter_add_rows(g, ids, num_rows)),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def two_tower_scatter_fields(tt: dict, device) -> dict:
    """K1 at the two-tower's row width C = 32 (segments of 1024 ids: 2048 x
    32 floats do not fit its stage) on one two-tower train batch's ids: the
    user_id ids (4096) into the query tower's table and the movie_id ids
    into the candidate tower's, each at offset 0 of its table. g (4096, 32)
    seeded normals. For each: :func:`check_scatter` on three calls (bit for
    bit its summation order, the same bits each call, within the fp32
    summation bound of the plain version), device, eager, plain and
    library ms (``index_add_`` into ``torch.zeros``), and the bound: g, ids
    and the output once each."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    (user, item, _), model = tt["train"], tt["model"]
    fields = {}
    for tower, ids in (("query", user["user_id"]),
                       ("candidate", item["movie_id"])):
        table = getattr(model, f"{tower}_tower").embeddings.table
        num_rows, c = table.shape
        ids = torch.from_numpy(ids[:TT_BATCH]).to(device)
        n = ids.shape[0]
        g = torch.randn(n, c, device=device, generator=gen)
        ids_long = ids.long()
        bound_ms, bound_by = bound(n * c * 4 + n * 4 + num_rows * c * 4,
                                   n * c)
        fields[tower] = {
            "shape": {"g": [n, c], "num_rows": num_rows},
            "ids": f"one two-tower train batch's "
                   f"{'user_id' if tower == 'query' else 'movie_id'}",
            **check_scatter(g, ids, num_rows),
            **timings(
                lambda: scatter_add_rows(g, ids, num_rows),
                lambda: scatter_add_rows_reference(g, ids, num_rows),
                lambda: torch.zeros(num_rows, c, device=device).index_add_(
                    0, ids_long, g)),
            "host_us": host_us(lambda: scatter_add_rows(g, ids, num_rows)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        print(f"K1 at C = {c}, {tower} tower: " + json.dumps(fields[tower]))
    return fields


def scatter_bf16_entry(g, ids, skewed, spread, num_rows, device,
                       large_ids) -> dict:
    """K1 on bf16 g (the bf16 models' table gradient) on the train batch's,
    skewed and uniform ids, and on uniform ids into LARGE_TABLE_ROWS rows:
    :func:`check_scatter` (bit for bit its order's fp32 sums rounded once),
    device, eager and plain ms, and the library call: ``index_add_`` of
    g.float() into fp32 ``torch.zeros``, then the cast to bf16. Bound: bf16
    g, the ids and the bf16 output once each."""
    n, c = g.shape
    bound_ms, bound_by = bound(n * c * 2 + n * 4 + num_rows * c * 2, n * c)
    fields = {}
    for name, rows, v in (("batch", ids, num_rows),
                          ("skewed", skewed, num_rows),
                          ("uniform", spread, num_rows),
                          ("large_table", large_ids, LARGE_TABLE_ROWS)):
        rows_long = rows.long()
        fields[name] = {
            **check_scatter(g, rows, v,
                            calls=2 if name == "large_table" else 3),
            **timings(
                lambda: scatter_add_rows(g, rows, v),
                lambda: scatter_add_rows_reference(g, rows, v),
                lambda: torch.zeros(v, c, device=device).index_add_(
                    0, rows_long, g.float()).to(torch.bfloat16)),
            "host_us": host_us(lambda: scatter_add_rows(g, rows, v)),
        }
    large_bound, large_by = bound(n * c * 2 + n * 4 + LARGE_TABLE_ROWS * c * 2,
                                  n * c)
    fields["large_table"].update(num_rows=LARGE_TABLE_ROWS,
                                 bound_ms=large_bound, bound_by=large_by)
    return {
        "name": "scatter_add_rows.bf16",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/scatter_add_rows.cu",
        "replaces": "deep_recommenders_tpu/ops/embedding_kernels.py:90",
        "shape": {"g": [n, c], "dtype": "bfloat16", "num_rows": num_rows},
        "ids": "one train batch's user_id and movie_id",
        **fields["batch"],
        "skewed": fields["skewed"],
        "uniform": fields["uniform"],
        "large_table": fields["large_table"],
        "library": "index_add_ of g.float() into fp32 torch.zeros, then "
                   ".to(torch.bfloat16)",
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
    }


def scatter_bf16_large_entry(g, large_ids, gen, device) -> dict:
    """K1's large-table plan on bf16 g (csrc/scatter_add_rows.cu:
    ``segment_runs``, then ``row_ranges``, where ``large_table_plan``
    routes a large table): the train
    batch's g into LARGE_TABLE_ROWS rows on uniform ids (the bf16 K1
    entry's "large_table"), into LARGE_TABLE_ROWS_4M, and a batch of two
    rounds (TWO_ROUND_IDS seeded normals, a quarter of the ids on one row,
    so that it recurs in every segment) into LARGE_TABLE_ROWS. Each:
    :func:`check_scatter` (bit for bit its order's fp32 sums rounded
    once), device, eager and plain ms, the library call (``index_add_`` of
    g.float() into fp32 zeros, then the cast to bf16), the cluster plan's
    ms in the same run ("cluster_plan_ms": ``large_table_plan`` forced
    false), the two kernels' device ms (``kernel_split``) and the bound
    (bf16 g, ids and bf16 output once each). The planted fault: on the
    two-round batch, the order model with each row's segment sums added
    last segment first must differ from the kernel's bits; the batch holds
    one row whose three updates, one in each of the first three segments,
    are 2^24, -2^24 and 0.5 (in segment order 0.5, backwards 0), so that
    the fault shows through the rounding to bf16. The key edges:
    KEY_EDGE_IDS seeded normal rows into 2^21 - 1, 2^21 and 2^21 + 1 rows
    (32-bit sort keys below 2^21 rows, 64-bit from there) with row V - 1
    at the last place of the first two segments (directly and as -1), the
    largest key each table gives: :func:`check_scatter`, bit for bit."""
    from deep_recommenders_torch.ops import embedding_kernels as ek

    n, c = g.shape
    two_g = torch.randn(TWO_ROUND_IDS, c, device=device,
                        generator=gen).to(torch.bfloat16)
    two_ids = torch.randint(0, LARGE_TABLE_ROWS, (TWO_ROUND_IDS,),
                            device=device, generator=gen, dtype=torch.int32)
    hot = torch.rand(TWO_ROUND_IDS, device=device, generator=gen) < 0.25
    two_ids[hot] = LARGE_TABLE_ROWS // 3
    segment = ek.segment_length(c)
    fault_row = LARGE_TABLE_ROWS // 3 + 1
    two_ids[two_ids == fault_row] = fault_row + 1
    for k, value in enumerate((2.0**24, -2.0**24, 0.5)):
        two_ids[k * segment] = fault_row
        two_g[k * segment] = value
    cases = {
        "large_table": (g, large_ids, LARGE_TABLE_ROWS),
        "rows_4m": (g, torch.randint(0, LARGE_TABLE_ROWS_4M, (n,),
                                     device=device, generator=gen,
                                     dtype=torch.int32),
                    LARGE_TABLE_ROWS_4M),
        "two_rounds": (two_g, two_ids, LARGE_TABLE_ROWS),
    }
    real, fields = ek.large_table_plan, {}
    for name, (gg, ids, v) in cases.items():
        m, cc = gg.shape
        if not ek.large_table_plan(m, cc, v):
            raise AssertionError(f"K1 at {v} rows: not the large-table plan")
        ids_long = ids.long()
        b_ms, b_by = bound(m * cc * 2 + m * 4 + v * cc * 2, m * cc)
        call = (lambda gg=gg, ids=ids, v=v: scatter_add_rows(gg, ids, v))
        ek.large_table_plan = lambda *a: False
        try:
            cluster_ms = graph_ms(call, 10, 4)
        finally:
            ek.large_table_plan = real
        fields[name] = {
            "shape": {"g": [m, cc], "dtype": "bfloat16", "num_rows": v},
            **check_scatter(gg, ids, v, calls=2),
            **timings(call,
                      lambda: scatter_add_rows_reference(gg, ids, v),
                      lambda: torch.zeros(v, cc, device=device).index_add_(
                          0, ids_long, gg.float()).to(torch.bfloat16),
                      iters=20, replays=5, eager_iters=20),
            "cluster_plan_ms": cluster_ms,
            "kernel_split": kernel_times(call, top=2),
            "host_us": host_us(call),
            "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        }
        print(f"K1 large-table plan, {name}: " + json.dumps(fields[name]))
    # The planted fault: the segments merged last to first.
    gg, ids, v = cases["two_rounds"]
    got = scatter_add_rows(gg, ids, v).cpu().view(torch.int16)
    order = torch.cat([torch.arange(lo, min(lo + segment, TWO_ROUND_IDS))
                       for lo in reversed(range(0, TWO_ROUND_IDS, segment))])
    g_cpu, ids_cpu = gg.cpu().float(), ids.cpu()
    fault = ek.scatter_add_rows_in_segments(
        g_cpu[order], ids_cpu[order], v).to(torch.bfloat16).view(torch.int16)
    rows_off = int((fault != got).any(1).sum())
    if rows_off == 0 or torch.equal(fault[fault_row], got[fault_row]):
        raise AssertionError("K1 large-table plan: a row summed out of "
                             "segment order is not rejected")
    print(f"K1 large-table plan: a row's segment sums added last segment "
          f"first differ from the kernel in {rows_off} rows (rejected)")
    edges = {}
    edge_g = torch.randn(KEY_EDGE_IDS, c, device=device,
                         generator=gen).to(torch.bfloat16)
    for v in (2**21 - 1, 2**21, 2**21 + 1):
        ids = torch.randint(0, v, (KEY_EDGE_IDS,), device=device,
                            generator=gen, dtype=torch.int32)
        ids[segment - 1], ids[2 * segment - 1] = v - 1, -1
        if not ek.large_table_plan(KEY_EDGE_IDS, c, v):
            raise AssertionError(f"K1 at {v} rows: not the large-table plan")
        edges[str(v)] = check_scatter(edge_g, ids, v, calls=1)[
            "bitwise_equal"]
    print(f"K1 large-table plan, key edges (row V - 1 at place 2047), bit "
          f"for bit: {json.dumps(edges)}")
    entry = {
        "name": "scatter_add_rows.bf16_large",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/scatter_add_rows.cu",
        "replaces": "deep_recommenders_tpu/ops/embedding_kernels.py:90",
        "function": "scatter_add_rows_bf16_large",
        **fields["large_table"],
        "rows_4m": fields["rows_4m"],
        "two_rounds": fields["two_rounds"],
        "planted": {"segments_out_of_order_rows_differing": rows_off},
        "key_edges_bit_equal": edges,
        "library": "index_add_ of g.float() into fp32 torch.zeros, then "
                   ".to(torch.bfloat16)",
        "large_table_row_rounds": ek.LARGE_TABLE_ROW_ROUNDS,
    }
    del cases, two_g, two_ids
    torch.cuda.empty_cache()
    return entry


def check_fm(emb):
    """K2 against its plain version on the same embeddings (fp32 or bf16,
    both widened to fp32): sums over F and D in fp32 in two orders, so the
    error of either side is within (F + D) * u of the magnitude of its
    terms."""
    b, f, d = emb.shape
    out = fm_interaction_fused(emb)
    ref = fm_interaction(emb)
    x = emb.float()
    scale = x.abs().sum(1).square().sum(-1) + x.square().sum((1, 2))
    tol = 2.0 * (f + d) * U32 * scale[:, None]
    err = (out - ref).abs()
    torch.cuda.synchronize()
    if tuple(out.shape) != (b, 1) or not bool(torch.isfinite(out).all()) \
            or bool((err > tol).any()):
        raise AssertionError(f"fm_interaction_fused {emb.dtype} disagrees: "
                             f"max err {err.max().item():.3g}")
    return {"max_abs_err": err.max().item(), "tolerance": tol.max().item(),
            "max_err_over_tolerance": (err / tol).max().item()}


def ctr_kernel_inputs(ds: MovielensRanking, model: DeepFM, device):
    """K1's and K2's inputs at the main path's shapes: g (16384, 17) seeded
    normals beside the ids of one train batch's user_id and movie_id, the
    two big vocabularies, as the engine stacks them (16384 ids into 10044
    rows), the same ids skewed (90% of them on 16 hot rows), the table's
    row count, a generator for more, and the batch's (B, F, D)
    embeddings."""
    feats, _ = ds.train_arrays()
    batch = {k: torch.from_numpy(v[:BATCH]).to(device)
             for k, v in feats.items()}
    offsets = dict(zip((s.name for s in ds.feature_specs),
                       model.embeddings.feature_offsets))
    num_rows, c = model.embeddings.table.shape[0], EMBED_DIM + 1
    gen = torch.Generator(device=device).manual_seed(SEED)
    ids = torch.stack(
        [batch["user_id"] + offsets["user_id"],
         batch["movie_id"] + offsets["movie_id"]], dim=1,
    ).reshape(-1)
    g = torch.randn(ids.shape[0], c, device=device, generator=gen)
    hot = torch.randint(0, 16, ids.shape, device=device, generator=gen,
                        dtype=torch.int32)
    is_hot = torch.rand(ids.shape, device=device, generator=gen) < 0.9
    skewed = torch.where(is_hot, hot, ids)
    with torch.no_grad():
        emb = model.embeddings(batch).contiguous()
    return g, ids, skewed, num_rows, gen, emb


def kernel_phase(ds: MovielensRanking, model: DeepFM, device):
    """K1 and K2 at the main path's shapes, against their plain versions."""
    entries = []
    g, ids, skewed, num_rows, gen, emb32 = ctr_kernel_inputs(ds, model,
                                                             device)
    c = g.shape[1]
    batch_ids = check_scatter(g, ids, num_rows)
    skew = check_scatter(g, skewed, num_rows)
    # Ids drawn uniformly over the table: no hot row. (The train batch's
    # own ids are skewed: its most frequent movie holds about a quarter of
    # them.)
    spread = torch.randint(0, num_rows, ids.shape, device=device,
                           generator=gen, dtype=torch.int32)
    uniform = check_scatter(g, spread, num_rows)
    # A table of 10^6 rows, as the ranking models with hashed categorical
    # vocabularies hold: the output alone is 68 MB.
    large_rows = LARGE_TABLE_ROWS
    large_ids = torch.randint(0, large_rows, ids.shape, device=device,
                              generator=gen, dtype=torch.int32)
    large = check_scatter(g, large_ids, large_rows, calls=2)
    large_bound, large_by = bound(
        ids.shape[0] * (c * 4 + 4) + large_rows * c * 4, ids.shape[0] * c)
    # Ids out of range: [-V, 0) wraps to row V + id, the rest drop.
    wild = torch.randint(-2 * num_rows, 2 * num_rows, ids.shape,
                         device=device, generator=gen, dtype=torch.int32)
    out_of_range = check_scatter(g, wild, num_rows, calls=1)
    ids_long = ids.long()
    n = ids.shape[0]
    bound_ms, bound_by = bound(n * c * 4 + n * 4 + num_rows * c * 4, n * c)
    entries.append({
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/scatter_add_rows.cu",
        "replaces": "deep_recommenders_tpu/ops/embedding_kernels.py:90",
        "shape": {"g": [n, c], "num_rows": num_rows},
        "ids": "one train batch's user_id and movie_id",
        **batch_ids,
        **timings(
            lambda: scatter_add_rows(g, ids, num_rows),
            lambda: scatter_add_rows_reference(g, ids, num_rows),
            lambda: torch.zeros(num_rows, c, device=device).index_add_(
                0, ids_long, g
            ),
        ),
        "host_us": host_us(lambda: scatter_add_rows(g, ids, num_rows)),
        "skewed": {
            **skew,
            **timings(
                lambda: scatter_add_rows(g, skewed, num_rows),
                lambda: scatter_add_rows_reference(g, skewed, num_rows),
                lambda: torch.zeros(num_rows, c, device=device).index_add_(
                    0, skewed.long(), g)),
        },
        "uniform": {
            **uniform,
            **timings(
                lambda: scatter_add_rows(g, spread, num_rows),
                lambda: scatter_add_rows_reference(g, spread, num_rows),
                lambda: torch.zeros(num_rows, c, device=device).index_add_(
                    0, spread.long(), g)),
        },
        "large_table": {
            **large,
            "num_rows": large_rows,
            **timings(
                lambda: scatter_add_rows(g, large_ids, large_rows),
                lambda: scatter_add_rows_reference(g, large_ids, large_rows),
                lambda: torch.zeros(large_rows, c, device=device).index_add_(
                    0, large_ids.long(), g)),
            "bound_ms": large_bound,
            "bound_by": large_by,
        },
        "out_of_range_ids": out_of_range,
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
    })

    entries[-1]["esmm"] = esmm_scatter_fields(ids, num_rows, gen, device)
    entries.append(scatter_bf16_entry(g.to(torch.bfloat16), ids, skewed,
                                      spread, num_rows, device, large_ids))
    entries.append(scatter_bf16_large_entry(g.to(torch.bfloat16), large_ids,
                                            gen, device))

    # K2 on the (B, F, D) embeddings of the same batch, in fp32 and bf16.
    b, f, d = emb32.shape
    for emb in (emb32, emb32.to(torch.bfloat16)):
        size = emb.element_size()
        bound_ms, bound_by = bound(b * f * d * size + b * 4,
                                   b * (3 * f * d + 2 * d))
        entries.append({
            "name": "fm_interaction_fused" + (".bf16" if size == 2 else ""),
            "route": "cuda",
            "source": "deep_recommenders_torch/csrc/fm_interaction.cu",
            "replaces": "deep_recommenders_tpu/ops/fm.py:56",
            "shape": {"embeddings": [b, f, d], "dtype": str(emb.dtype)},
            **check_fm(emb),
            **timings(
                lambda: fm_interaction_fused(emb),
                lambda: fm_interaction(emb),
                lambda: 0.5 * (emb.sum(1, dtype=torch.float32).square()
                               .sum(-1)
                               - emb.float().square().sum((1, 2))),
            ),
            "host_us": host_us(lambda: fm_interaction_fused(emb)),
            "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
        })
    return entries


def check_fields(checks) -> dict:
    """A kernel entry's errors: the largest over its outputs, and each
    output's own (``ops/cin_tolerances.py``)."""
    return {"max_abs_err": ct.max_abs_err(checks),
            "max_err_over_tolerance": ct.worst_share(checks),
            "checks": checks}


def bf16_fields(name: str, checks) -> dict:
    """:func:`check_fields` of a bf16 CIN kernel held two ways, with
    ``max_abs_err`` against its bf16 plain version (the fp64 side's are in
    checks), and a line with every output's shares and the planted
    faults'."""
    own = {k: c for k, c in checks.items() if k != "planted"
           and not k.endswith("_fp64")}
    print(f"{name} shares: " + ", ".join(
        f"{k} {c['err_over_tol']:.6g} / fro {c['fro_over_tol']:.6g}"
        for k, c in checks.items() if k != "planted")
        + "; planted " + ", ".join(
            f"{k} {v:.6g}" for k, v in checks["planted"].items()))
    return {**check_fields(checks), "max_abs_err": ct.max_abs_err(own),
            "precision": "bf16 operands, products and intermediates where "
                         "the TPU kernel rounds; fp32 sums"}


def cin_kernel_phase(ds: MovielensRanking, device):
    """K3 and K4 at the xDeepFM paths' shapes, against their plain versions
    (``ops/cin_tolerances.py`` states the tolerances), on the real
    embeddings of one train batch and each model's initial CIN weights; the
    incoming gradients are seeded normals. Each weight-gradient check must
    also reject dW scaled by 1 + 1e-3, dW without its first chunk of
    ``ct.PLANTED_ROWS`` rows (one chunk of the weight passes) and the fp32
    function; K4's forward check must reject the fp32 function and the bf16
    emulation without one f-slice, K3's also z1 left unrounded before layer
    2 and W scaled by 1 + 1e-3."""
    feats, _ = ds.train_arrays()
    batch = {k: torch.from_numpy(v[:BATCH]).to(device)
             for k, v in feats.items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    flagship = make_xdeepfm(ds, XDEEPFM_MAPS, device)
    layered = make_xdeepfm(ds, LAYERED_MAPS, device)
    with torch.no_grad():
        x0 = flagship.embeddings(batch)
    b, f0, d = x0.shape
    r = b * d
    x0v = x0.transpose(1, 2).reshape(r, f0).contiguous()
    x0b = x0v.to(torch.bfloat16)
    entries = []

    # K3 on the flagship's bf16 rows, forward then backward on the forward's
    # own bf16 residuals.
    w1 = flagship.cin_w1.detach()
    w2 = flagship.cin_w2.detach()
    m1, m2 = XDEEPFM_MAPS
    gp1 = torch.randn(b, m1, device=device, generator=gen)
    gp2 = torch.randn(b, m2, device=device, generator=gen)
    got = ck.stack_forward(x0b, w1, w2, d, residuals=True)
    checks = ct.check_stack_forward(got, x0b, w1, w2, d, planted=True)
    z1, z2 = got[2], got[3]
    w_bytes = (f0 * f0 * m1 + f0 * m1 * m2) * 4
    # Reads x0 (bf16) and W; writes p1, p2 (fp32) and the bf16 residuals.
    fwd_ops = 2 * r * f0 * f0 * m1 + 2 * r * f0 * m1 * m2
    entries.append({
        "name": "cin_stack_pooled.fwd",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/cin_stack.cu",
        "replaces": "deep_recommenders_tpu/ops/cin_kernels.py:336",
        "shape": {"x0v": [r, f0], "dtype": "bfloat16", "m1": m1, "m2": m2,
                  "d": d},
        **bf16_fields("cin_stack_pooled.fwd", checks),
        **cin_timings(
            lambda: ck.stack_forward(x0b, w1, w2, d, residuals=True),
            lambda: ck.stack_forward_reference_bf16(x0b, w1, w2, d),
        ),
        **bound_fields(r * f0 * 2 + w_bytes + b * (m1 + m2) * 4
                       + r * (m1 + m2) * 2, fwd_ops, bf16=True),
    })
    entries[-1]["bound_bf16_share"] = (entries[-1]["bound_bf16_ms"]
                                       / entries[-1]["ms"])

    got = ck.stack_backward(x0b, w1, w2, z1, z2, gp1, gp2)
    checks = ct.check_stack_backward(got, x0b, w1, w2, z1, z2, gp1, gp2,
                                     planted_rows=ct.PLANTED_ROWS)
    # Tensor-core products: t_f and dW2 (layer 2), dy and dW1 (layer 1).
    # The folds of t_f into dz1 and dx0, and dx0's layer-1 sum, are fp32.
    bwd_ops = 4 * r * f0 * m1 * m2 + 4 * r * f0 * f0 * m1
    bwd_scalar_ops = 4 * r * f0 * m1 + 4 * r * f0 * f0
    entries.append({
        "name": "cin_stack_pooled.bwd",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/cin_stack.cu",
        "replaces": "deep_recommenders_tpu/ops/cin_kernels.py:434",
        "shape": {"x0v": [r, f0], "dtype": "bfloat16", "m1": m1, "m2": m2,
                  "d": d},
        **bf16_fields("cin_stack_pooled.bwd", checks),
        **cin_timings(
            lambda: ck.stack_backward(x0b, w1, w2, z1, z2, gp1, gp2),
            lambda: ck.stack_backward_reference_bf16(x0b, w1, w2, z1, z2,
                                                     gp1, gp2),
        ),
        # Reads x0, W, the bf16 residuals and the pooled gradients;
        # writes dx0 (bf16) and dW.
        **bound_fields(
            r * f0 * 2 * 2 + w_bytes * 2 + r * (m1 + m2) * 2
            + b * (m1 + m2) * 4, bwd_ops, bf16=True,
            scalar_ops=bwd_scalar_ops),
    })
    entries[-1]["bound_bf16_share"] = (entries[-1]["bound_bf16_ms"]
                                       / entries[-1]["ms"])
    print(f"cin_stack_pooled host us a call: fwd {entries[-2]['host_us']:.1f}"
          f", bwd {entries[-1]['host_us']:.1f}")
    del got, z1, z2

    # K4 on the layered model's first two layers: layer 0 (H = F0 = 6) on
    # the fp32 rows, layer 1 (H = 128) on layer 0's relu'd output.
    w_l0 = layered.cins[0].kernel.detach()
    w_l1 = layered.cins[1].kernel.detach()
    with torch.no_grad():
        x_l1 = torch.relu(ck.cin2d_reference(x0v, x0v, w_l0)).contiguous()
    fwd_entry, bwd_entry = {}, {}
    for xv, w in ((x0v, w_l0), (x_l1, w_l1)):
        h, m = xv.shape[1], w.shape[2]
        g = torch.randn(r, m, device=device, generator=gen)
        fwd_checks = ct.check_cin2d_forward(ck.cin2d_forward(x0v, xv, w),
                                            x0v, xv, w, planted=True)
        planted = fwd_checks["bf16"]["planted"]
        print(f"cin2d.fwd H={h} shares: bf16 terms "
              f"{fwd_checks['bf16']['err_over_tol']:.6g}, fp64 "
              f"{fwd_checks['fp64']['err_over_tol']:.6g}; planted fp32 "
              f"{planted['fp32']:.6g}, f-slice dropped "
              f"{planted['f_slice_dropped']:.6g}")
        bwd_checks = ct.check_cin2d_backward(
            ck.cin2d_backward(x0v, xv, w, g), x0v, xv, w, g,
            planted_rows=ct.PLANTED_ROWS)
        shape = {"x0v": [r, f0], "xv": [r, h], "w": [f0, h, m]}
        io_bytes = (r * (f0 + h) + f0 * h * m + r * m) * 4
        x0b, xb, wb = (t.bfloat16() for t in (x0v, xv, w))
        fwd = {
            "shape": shape,
            "precision": "bf16 operands and pair products, fp32 sums",
            **check_fields(fwd_checks),
            # Against the plain version; the fp64 check's own is in checks.
            "max_abs_err": fwd_checks["bf16"]["max_abs_err"],
            **cin_timings(
                lambda: ck.cin2d_forward(x0v, xv, w),
                lambda: ck.cin2d_reference_bf16(x0v, xv, w),
                lambda: torch.einsum("rf,rg,fgm->rm", x0v, xv, w),
            ),
            "library_bf16_ms": graph_ms(
                lambda: torch.einsum("rf,rg,fgm->rm", x0b, xb, wb),
                CIN_ITERS, CIN_REPLAYS),
            **bound_fields(io_bytes, 2 * r * f0 * h * m, bf16=True),
        }
        fwd["bound_bf16_share"] = fwd["bound_bf16_ms"] / fwd["ms"]
        del x0b, xb, wb
        bwd = {
            "shape": shape,
            **bf16_fields(f"cin2d.bwd H={h}", bwd_checks),
            **cin_timings(
                lambda: ck.cin2d_backward(x0v, xv, w, g),
                lambda: ck.cin2d_backward_reference_bf16(x0v, xv, w, g),
            ),
            # Reads x0, x, g and W, writes dx0, dx and dW. On the tensor
            # cores t_f = g @ W[f]^T and dW; the folds of t_f into dx and
            # dx0 are fp32.
            **bound_fields(
                (2 * r * (f0 + h) + r * m + 2 * f0 * h * m) * 4,
                4 * r * f0 * h * m, bf16=True, scalar_ops=4 * r * f0 * h),
        }
        bwd["bound_bf16_share"] = bwd["bound_bf16_ms"] / bwd["ms"]
        # The H = 128 layer (two of the three per step) leads the entry.
        if h == f0:
            fwd_entry["h6"], bwd_entry["h6"] = fwd, bwd
        else:
            fwd_entry.update(fwd)
            bwd_entry.update(bwd)
    for entry, direction, line in ((fwd_entry, "fwd", 81),
                                   (bwd_entry, "bwd", 125)):
        entries.append({
            "name": f"cin2d.{direction}",
            "route": "cuda",
            "source": "deep_recommenders_torch/csrc/cin2d.cu",
            "replaces": f"deep_recommenders_tpu/ops/cin_kernels.py:{line}",
            **entry,
        })
    del flagship, layered
    torch.cuda.empty_cache()
    return entries


# -- train paths --------------------------------------------------------------

def make_xdeepfm(ds: MovielensRanking, maps, device) -> XDeepFM:
    return XDeepFM(ds.feature_specs, EMBED_DIM, maps, "relu", XDEEPFM_HIDDEN,
                   generator=torch.Generator().manual_seed(SEED)).to(device)


def reset_launches() -> None:
    scatter_add_rows.launches = 0
    scatter_add_rows.launches_bf16 = 0
    scatter_add_rows.launches_bf16_large = 0
    fm_interaction_fused.launches = 0
    ck.cin_stack_pooled.launches = {"fwd": 0, "bwd": 0}
    ck.cin2d.launches = {"fwd": 0, "bwd": 0}
    att.flash_attention.launches = {"fwd": 0, "bwd": 0, "fwd_bf16": 0,
                                    "bwd_bf16": 0}
    att.flash_attention.launches_by_source = {}


def read_launches() -> dict:
    return {
        "scatter_add_rows": scatter_add_rows.launches,
        "scatter_add_rows_bf16": scatter_add_rows.launches_bf16,
        # A parent's tree (--ctr-only) has no large-table plan.
        "scatter_add_rows_bf16_large": getattr(
            scatter_add_rows, "launches_bf16_large", 0),
        "fm_interaction_fused": fm_interaction_fused.launches,
        "cin_stack_pooled.fwd": ck.cin_stack_pooled.launches["fwd"],
        "cin_stack_pooled.bwd": ck.cin_stack_pooled.launches["bwd"],
        "cin2d.fwd": ck.cin2d.launches["fwd"],
        "cin2d.bwd": ck.cin2d.launches["bwd"],
        "flash_attention.fwd": att.flash_attention.launches["fwd"],
        "flash_attention.bwd": att.flash_attention.launches["bwd"],
        "flash_attention_bf16.fwd": att.flash_attention.launches["fwd_bf16"],
        "flash_attention_bf16.bwd": att.flash_attention.launches["bwd_bf16"],
    }


def ctr_quality(name: str, final: dict) -> None:
    """A CTR path's eval metrics: finite, and an AUC above 0.5."""
    metrics = [final[k] for k in ("auc", "precision", "recall", "val_loss")]
    if not all(math.isfinite(v) for v in metrics) or not final["auc"] > 0.5:
        raise AssertionError(f"{name}: bad eval metrics: {final}")


def train_path(name, model, train, test, epochs, expect, device,
               optimizer=None, loss_fn=None, eval_spec=None,
               quality=ctr_quality):
    """``epochs`` of ``fit_device`` with the launch counters set to 0 just
    before and read just after; ``expect(steps, eval_batches)`` gives the
    launches each kernel must make. The optimizer is Adam at LEARNING_RATE
    unless one is given; the loss and the eval the Trainer's (BCE, AUC)
    unless given; ``quality(name, final)`` checks the last epoch's eval
    metrics. Returns the trainer, the launches and those metrics."""
    trainer = Trainer(
        model, optimizer or torch.optim.Adam(model.parameters(),
                                             lr=LEARNING_RATE),
        loss_fn=loss_fn, eval_spec=eval_spec, device=device,
    )
    reset_launches()
    result = trainer.fit_device(train, test, epochs=epochs,
                                shuffle_seed=SEED, verbose=False)
    launches = read_launches()
    losses = result["step_losses"]
    final = result["history"][-1]
    steps = len(losses)
    eval_batches = epochs * test.steps_per_epoch
    print(f"{name} train: {steps} steps of {train.batch_size}, loss "
          f"{losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, {result['examples_per_sec']:.1f} ex/s "
          f"(steady {result.get('examples_per_sec_steady', float('nan')):.1f}"
          f" ex/s, smoke figure)")
    print(f"{name} eval: " + " ".join(
        f"{k}={v:.6f}" for k, v in final.items()
        if k not in ("epoch", "loss")))
    print(f"{name} launches: {launches}")
    if steps != epochs * train.steps_per_epoch:
        raise AssertionError(f"{name}: {steps} train steps, expected "
                             f"{epochs * train.steps_per_epoch}")
    want = {k: 0 for k in launches}
    want.update(expect(steps, eval_batches))
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss not finite and falling: {losses}")
    quality(name, final)
    return trainer, launches, final


@contextlib.contextmanager
def stack_forward_bf16_on_cpu():
    """K3's forward on a CPU tensor as the card computes it
    (``stack_forward_reference_bf16``) instead of the fp32 function, so
    that the CPU path computes the card's function."""
    fp32 = ck.stack_forward

    def emulated(x0v, w1, w2, d, residuals=True):
        out = ck.stack_forward_reference_bf16(x0v, w1, w2, d)
        return out if residuals else (*out[:2], None, None)

    ck.stack_forward = emulated
    try:
        yield
    finally:
        ck.stack_forward = fp32


def _joined(out) -> torch.Tensor:
    """A model's output as one (B, k) tensor: a tuple of (B, 1) outputs
    (ESMM's probabilities) side by side."""
    return torch.cat(out, dim=1) if isinstance(out, (tuple, list)) else out


def check_logits(name, model, cpu_model, ds, device, rtol=1e-4, atol=1e-5,
                 plain=contextlib.nullcontext, feats=None, fp32_model=None,
                 outputs=1):
    """The trained model's logits on 256 test rows (``feats``, by default
    the test split's) on the card against the plain CPU path (the kernels'
    plain versions, under ``plain()``) on the same weights: within ``rtol``
    and ``atol``; or, for a bf16 model given the same model in fp32 on the
    CPU (``fp32_model``), nearer the CPU's bf16 logits than those lie to
    the CPU's fp32 logits (the largest difference of each), the rule of the
    bf16 Transformer. A model with several ``outputs`` (a tuple) is held on
    all of them."""
    if feats is None:
        feats, _ = ds.test_arrays()
    rows = {k: torch.from_numpy(v[:256]) for k, v in feats.items()}
    model.eval()
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu_model.load_state_dict(weights)
    cpu_model.eval()
    with torch.no_grad():
        on_card = _joined(model({k: v.to(device)
                                 for k, v in rows.items()})).cpu()
        with plain():
            on_cpu = _joined(cpu_model(rows))
            if fp32_model is not None:
                fp32_model.load_state_dict(weights)
                on_cpu32 = _joined(fp32_model.eval()(rows))
    if on_card.shape != (256, outputs) or on_card.dtype != torch.float32:
        raise AssertionError(f"{name}: logits {tuple(on_card.shape)} "
                             f"{on_card.dtype}")
    diff = (on_card - on_cpu).abs().max().item()
    gap = ""
    if fp32_model is None:
        torch.testing.assert_close(on_card, on_cpu, rtol=rtol, atol=atol)
    else:
        bf16_gap = (on_cpu - on_cpu32).abs().max().item()
        if not bool(torch.isfinite(on_card).all()) or not diff < bf16_gap:
            raise AssertionError(f"{name}: logits card vs cpu differ by "
                                 f"{diff}, bf16 vs fp32 on the cpu by "
                                 f"{bf16_gap}")
        gap = f", cpu bf16 vs fp32 {bf16_gap:.3g}"
    print(f"{name} logits card vs cpu: max abs diff {diff:.3g}{gap}")


def train_phase(ds: MovielensRanking, model: DeepFM, device):
    """The CTR train paths; returns each path's launches."""
    train = DeviceData.from_numpy(*ds.train_arrays(), BATCH, device=device)
    test = DeviceData.from_numpy(*ds.test_arrays(), BATCH, device=device)
    paths = {}

    paths["deepfm"], _ = deepfm_path(ds, model, train, test, device)
    launches, _ = xdeepfm_paths(ds, train, test, device)
    paths.update(launches)
    launches, _ = ranking_paths(ds, train, test, device)
    paths.update(launches)
    return paths


def one_k1(s, e):
    """The launches of a model with one fp32 table pass: K1 once a step."""
    return {"scatter_add_rows": s}


def ranking_paths(ds: MovielensRanking, train: DeviceData, test: DeviceData,
                  device):
    """The rest of the CTR family at the zoo's widths
    (benchmarks/run_models.py:141-169), then DeepFM and the flagship
    xDeepFM in bf16, each for EPOCHS with Adam at LEARNING_RATE (FM at
    FM_LEARNING_RATE, the FM example's; Wide & Deep with the example's
    crosses and its FTRL/Adam split): one fp32 K1 a step for fm, fnn, wdl
    and dcn; one bf16 K1 a step for deepfm_bf16; for xdeepfm_bf16 one bf16
    K1 (embeddings), one fp32 K1 (linear terms) and K3 as in the fp32
    flagship. The FNN starts from the trained FM's weights through
    save_checkpoint, restore_checkpoint and warm_start_from. Each path's
    logits on the card against the plain CPU path; each path's launches,
    and its final eval metrics with its profile."""
    # Imported here: --ctr-only also runs in a parent's tree, which may
    # not have these models.
    from deep_recommenders_torch.examples.train_wdl_on_movielens import (
        CROSSES,
        wdl_optimizer,
        wide_sparsity,
        with_crosses,
    )
    from deep_recommenders_torch.models.ranking import (
        DCN,
        FNN,
        FactorizationMachine,
        WideDeep,
    )
    from deep_recommenders_torch.training import (
        restore_checkpoint,
        save_checkpoint,
        warm_start_from,
    )

    specs = ds.feature_specs
    paths, results = {}, {}

    def gen():
        return torch.Generator().manual_seed(SEED)

    def run(name, model, expect, train=train, test=test, optimizer=None,
            cpu_model=None, **check):
        trainer, paths[name], final = train_path(
            name, model, train, test, EPOCHS, expect, device, optimizer)
        check_logits(name, model, cpu_model, ds, device, **check)
        results[name] = {"eval": final,
                         "profile": trainer_profile(trainer, train, test)}
        print(f"{name} profile: " + json.dumps(results[name]["profile"]))

    fm = FactorizationMachine(specs, EMBED_DIM, generator=gen()).to(device)
    run("fm", fm, one_k1, cpu_model=FactorizationMachine(specs, EMBED_DIM),
        optimizer=torch.optim.Adam(fm.parameters(), lr=FM_LEARNING_RATE))

    # The two-phase FM -> FNN flow, through a checkpoint under build/.
    scratch = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        saved = save_checkpoint(os.path.join(tmp, "fm"), fm.state_dict())
        fm_state = restore_checkpoint(
            saved, FactorizationMachine(specs, EMBED_DIM).state_dict())
    fnn = FNN(specs, EMBED_DIM, FNN_HIDDEN, generator=gen())
    fnn.load_state_dict(warm_start_from(fnn.state_dict(), fm_state))
    if not torch.equal(fnn.embeddings.table, fm.embeddings.table.cpu()):
        raise AssertionError("fnn: warm start did not take the FM's table")
    print(f"fnn warm-started from the fm path's checkpoint ({saved})")
    del fm
    run("fnn", fnn.to(device), one_k1,
        cpu_model=FNN(specs, EMBED_DIM, FNN_HIDDEN))

    feats, labels = ds.train_arrays()
    wtrain = DeviceData.from_numpy(with_crosses(feats), labels, BATCH,
                                   device=device)
    feats, labels = ds.test_arrays()
    test_feats = with_crosses(feats)
    wtest = DeviceData.from_numpy(test_feats, labels, BATCH, device=device)
    wide_specs = specs + CROSSES
    wdl = WideDeep(specs, wide_specs, EMBED_DIM, WDL_HIDDEN, generator=gen())
    run("wdl", wdl, one_k1, wtrain, wtest, wdl_optimizer(wdl),
        cpu_model=WideDeep(specs, wide_specs, EMBED_DIM, WDL_HIDDEN),
        feats=test_feats)
    results["wdl"]["wide_sparsity"] = wide_sparsity(wdl)
    print(f"wdl wide-weight sparsity (FTRL L1): "
          f"{results['wdl']['wide_sparsity']:.6f}")
    del wdl, wtrain, wtest

    run("dcn", DCN(specs, EMBED_DIM, DCN_CROSS_LAYERS, None, DCN_HIDDEN,
                   generator=gen()).to(device), one_k1,
        cpu_model=DCN(specs, EMBED_DIM, DCN_CROSS_LAYERS, None, DCN_HIDDEN))

    bf16 = torch.bfloat16
    run("deepfm_bf16",
        DeepFM(specs, EMBED_DIM, HIDDEN, compute_dtype=bf16,
               generator=gen()).to(device),
        lambda s, e: {"scatter_add_rows_bf16": s},
        cpu_model=DeepFM(specs, EMBED_DIM, HIDDEN, compute_dtype=bf16),
        fp32_model=DeepFM(specs, EMBED_DIM, HIDDEN))
    run("xdeepfm_bf16",
        XDeepFM(specs, EMBED_DIM, XDEEPFM_MAPS, "relu", XDEEPFM_HIDDEN,
                compute_dtype=bf16, generator=gen()).to(device),
        lambda s, e: {"scatter_add_rows": s, "scatter_add_rows_bf16": s,
                      "cin_stack_pooled.fwd": s + e,
                      "cin_stack_pooled.bwd": s},
        cpu_model=XDeepFM(specs, EMBED_DIM, XDEEPFM_MAPS, "relu",
                          XDEEPFM_HIDDEN, compute_dtype=bf16),
        fp32_model=XDeepFM(specs, EMBED_DIM, XDEEPFM_MAPS, "relu",
                           XDEEPFM_HIDDEN),
        plain=stack_forward_bf16_on_cpu)
    torch.cuda.empty_cache()
    return paths, results


def deepfm_path(ds: MovielensRanking, model: DeepFM, train: DeviceData,
                test: DeviceData, device):
    """DeepFM's train path (one K1 per step), its logits against the plain
    CPU path, and its profile: the launches, and the final eval metrics
    with the profile."""
    trainer, launches, final = train_path(
        "deepfm", model, train, test, EPOCHS,
        lambda s, e: {"scatter_add_rows": s}, device)
    check_logits("deepfm", model, DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN),
                 ds, device, rtol=1e-4, atol=1e-5)
    profile = trainer_profile(trainer, train, test)
    print("deepfm profile: " + json.dumps(profile))
    return launches, {"eval": final, "profile": profile}


class Bf16TableModel(torch.nn.Module):
    """DeepFM's composition (``models/ranking/deepfm.py``) over a table
    stored in bf16 (``EmbeddingCollection(param_dtype=torch.bfloat16)``):
    one fused pass of the table and the linear weights (cast to bf16
    beside it), the first-order sum and bias, the FM term and an MLP with
    no compute dtype, whose first layer promotes the bf16 rows to fp32.
    No model of the zoo stores its table in bf16: this is a user's model
    built on the collection."""

    def __init__(self, specs, param_dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.linear = LinearTerms(specs)
        self.embeddings = EmbeddingCollection(
            specs, EMBED_DIM, generator=generator, param_dtype=param_dtype)
        self.deep = MLP(len(specs) * EMBED_DIM, HIDDEN, output_dim=1,
                        generator=generator)

    def forward(self, batch) -> torch.Tensor:
        stacked, lin = fused_embedding_linear(self.embeddings, self.linear,
                                              batch)
        first_order = lin.sum(dim=1, keepdim=True) + self.linear.bias
        deep_logit = self.deep(stacked.reshape(stacked.shape[0], -1))
        return first_order + fm_interaction(stacked) + deep_logit.float()


def bf16_table_phase(ds: MovielensRanking, device,
                     name: str = "bf16_table") -> tuple:
    """The bf16-stored table: :class:`Bf16TableModel` trained one epoch
    (BF16_TABLE_EPOCHS) with the port's Adam at LEARNING_RATE (optax's
    order on the bf16 table) through ``fit_device``, evaluated with
    ``BinaryCTREval(model, auc=AUC(num_thresholds=500))``: one bf16 K1 a
    step and no fp32 K1. Then, outside the counted run: K1 on one step's
    real bf16 gradient against its order model (``check_scatter``, bit for
    bit) and timed; the table and its Adam moments still bf16; a
    checkpoint round trip bit for bit; the logits on the card against the
    plain CPU path (nearer the CPU's bf16 logits than those lie to the
    same weights in fp32); ``AUC(from_logits=True)`` on raw logits equal to
    ``AUC()`` on their sigmoid; the ms of a train step. A large table
    (``name`` "bf16_table_large": hashed ids; ``large_table_plan``) takes
    K1's large-table plan at every step, counted in
    ``scatter_add_rows_bf16_large`` too. Returns the launches and the K1
    fields for its kernel entry."""
    # Imported here: --ctr-only also runs in a parent's tree, which may
    # not have these.
    from deep_recommenders_torch.ops import embedding_kernels as ek
    from deep_recommenders_torch.training import (
        AUC,
        Adam,
        BinaryCTREval,
        restore_train_state,
        save_train_state,
    )

    t0 = time.perf_counter()
    specs = ds.feature_specs
    bf16 = torch.bfloat16
    model = Bf16TableModel(
        specs, generator=torch.Generator().manual_seed(SEED)).to(device)
    table_rows = model.embeddings.table.shape[0]
    large = ek.large_table_plan(BATCH, EMBED_DIM + 1, table_rows)
    if large != (name == "bf16_table_large"):
        raise AssertionError(f"{name}: a table of {table_rows} rows")
    train = DeviceData.from_numpy(*ds.train_arrays(), BATCH, device=device)
    test = DeviceData.from_numpy(*ds.test_arrays(), BATCH, device=device)
    trainer, launches, final = train_path(
        name, model, train, test, BF16_TABLE_EPOCHS,
        lambda s, e: {"scatter_add_rows_bf16": s,
                      **({"scatter_add_rows_bf16_large": s} if large
                         else {})}, device,
        optimizer=Adam(model.parameters(), lr=LEARNING_RATE),
        eval_spec=BinaryCTREval(model, auc=AUC(num_thresholds=500)))
    table = model.embeddings.table
    state = trainer.optimizer.state[table]
    dtypes = {"table": str(table.dtype), "exp_avg": str(state["exp_avg"]
                                                      .dtype),
              "exp_avg_sq": str(state["exp_avg_sq"].dtype)}
    if set(dtypes.values()) != {str(bf16)}:
        raise AssertionError(f"{name}: dtypes after training {dtypes}")

    # One more step, its K1 input kept: the real bf16 gradient of the rows.
    feats, labels = ds.train_arrays()
    batch = {k: torch.from_numpy(v[:BATCH]).to(device)
             for k, v in feats.items()}
    y_train = torch.from_numpy(labels[:BATCH]).to(device)
    seen, real = {}, ek.scatter_add_rows

    def keep(g, ids, num_rows):
        ek.scatter_add_rows = real  # the kernel counts itself by this name
        seen.update(g=g.clone(), ids=ids.clone(), num_rows=num_rows)
        return real(g, ids, num_rows)

    ek.scatter_add_rows = keep
    try:
        trainer.train_step(batch, y_train)
    finally:
        ek.scatter_add_rows = real
    g, ids, v = seen["g"], seen["ids"], seen["num_rows"]
    if g.dtype != bf16:
        raise AssertionError(f"{name}: K1 got {g.dtype} g")
    n, c = g.shape
    k1 = {"shape": {"g": [n, c], "dtype": "bfloat16", "num_rows": v},
          **check_scatter(g, ids, v),
          **timings(lambda: scatter_add_rows(g, ids, v),
                    lambda: scatter_add_rows_reference(g, ids, v),
                    lambda: torch.zeros(v, c, device=device).index_add_(
                        0, ids.long(), g.float()).to(bf16))}
    k1["bound_ms"], k1["bound_by"] = bound(n * c * 2 + n * 4 + v * c * 2,
                                           n * c)

    # The checkpoint: the bf16 table and its bf16 moments, bit for bit.
    scratch = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        save_train_state(tmp, model, trainer.optimizer)
        fresh = Bf16TableModel(specs).to(device)
        opt = Adam(fresh.parameters(), lr=LEARNING_RATE)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no dtype may be cast
            restore_train_state(tmp, fresh, opt)
    restored = opt.state[fresh.embeddings.table]
    pairs = [(fresh.embeddings.table, table)] + [
        (restored[k], state[k]) for k in ("exp_avg", "exp_avg_sq")]
    round_trip = all(a.dtype == bf16 and torch.equal(
        a.view(torch.int16), b.view(torch.int16)) for a, b in pairs)
    round_trip &= all(torch.equal(a.detach(), b.detach()) for a, b in zip(
        fresh.parameters(), model.parameters()))
    if not round_trip:
        raise AssertionError(f"{name}: checkpoint round trip changed bits")
    del fresh, opt

    check_logits(name, model, Bf16TableModel(specs), ds, device,
                 fp32_model=Bf16TableModel(specs,
                                           param_dtype=torch.float32))
    test_feats, test_labels = ds.test_arrays()
    rows = {k: torch.from_numpy(v[:BATCH]).to(device)
            for k, v in test_feats.items()}
    y = torch.from_numpy(test_labels[:BATCH]).to(device)
    with torch.no_grad():
        logits = model.eval()(rows)
    auc, from_logits = AUC(num_thresholds=500), AUC(500, from_logits=True)
    on_probs = auc.update(auc.init(device), y, torch.sigmoid(logits))
    on_logits = from_logits.update(from_logits.init(device), y, logits)
    same_auc = all(torch.equal(on_probs[k], on_logits[k]) for k in on_probs)
    if not same_auc:
        raise AssertionError(f"{name}: AUC(from_logits=True) differs from "
                             "AUC() on the sigmoid")
    step_ms = time_ms(lambda: trainer.train_step(batch, y_train), iters=10,
                      warmup=2)
    summary = {
        "card": card_line(), "launches": launches, "table_rows": table_rows,
        "k1_bf16_on_a_step_gradient": {
            key: k1[key] for key in ("bitwise_equal", "deterministic",
                                     "max_abs_err", "ms", "eager_ms",
                                     "plain_ms", "library_ms", "bound_ms",
                                     "max_row_updates")},
        "dtypes_after_training": dtypes, "checkpoint_bit_for_bit": round_trip,
        "auc_from_logits_equals_auc_of_sigmoid": same_auc,
        "eval_auc": final["auc"], "eval": final, "train_step_ms": step_ms,
        "seconds": time.perf_counter() - t0,
    }
    print(f"{name} " + json.dumps(summary))
    del model, trainer
    torch.cuda.empty_cache()
    return launches, k1


def ctr_kernel_times(ds: MovielensRanking, model: DeepFM, device) -> dict:
    """Device, eager, plain and library ms and host us of K1 (a train
    batch's ids and skewed ids) and of K2 on fp32 embeddings, at the kernel
    phase's inputs, without checks: they call only what every tree of the
    port has, so a copy of this script in a parent's tree measures the
    parent."""
    g, ids, skewed, num_rows, gen, emb = ctr_kernel_inputs(ds, model,
                                                           device)
    c = g.shape[1]
    spread = torch.randint(0, num_rows, ids.shape, device=device,
                           generator=gen, dtype=torch.int32)
    large_ids = torch.randint(0, LARGE_TABLE_ROWS, ids.shape, device=device,
                              generator=gen, dtype=torch.int32)
    times = {}
    for name, rows, v in (("batch", ids, num_rows),
                          ("skewed", skewed, num_rows),
                          ("uniform", spread, num_rows),
                          ("large_table", large_ids, LARGE_TABLE_ROWS)):
        rows_long = rows.long()
        times[f"scatter_add_rows.{name}"] = {
            **timings(
                lambda: scatter_add_rows(g, rows, v),
                lambda: scatter_add_rows_reference(g, rows, v),
                lambda: torch.zeros(v, c, device=device).index_add_(
                    0, rows_long, g)),
            "host_us": host_us(lambda: scatter_add_rows(g, rows, v))}
    times["fm_interaction_fused"] = {
        **timings(lambda: fm_interaction_fused(emb),
                  lambda: fm_interaction(emb),
                  lambda: 0.5 * (emb.sum(1).square().sum(-1)
                                 - emb.square().sum((1, 2)))),
        "host_us": host_us(lambda: fm_interaction_fused(emb))}
    return times


def xdeepfm_paths(ds: MovielensRanking, train: DeviceData, test: DeviceData,
                  device):
    """The flagship and the layered xDeepFM: each path's launches, and its
    final eval metrics with its profile."""
    paths, results = {}, {}

    # The stack reads bf16 rows, and its forward on the card rounds as the
    # TPU kernel does: the CPU side takes that function's bf16 emulation.
    # The card and the CPU sum the movie_genres bag in other orders, so an
    # embedding element can round to the neighbouring bf16 value (one part
    # in 256). At these weights' scale (embeddings ~0.25, CIN kernels
    # ~0.05, cin_head ~0.06) one such element moves a logit by about 2e-5:
    # atol 2e-4.
    xdeepfm = make_xdeepfm(ds, XDEEPFM_MAPS, device)
    trainer, paths["xdeepfm"], final = train_path(
        "xdeepfm", xdeepfm, train, test, EPOCHS,
        lambda s, e: {"scatter_add_rows": 2 * s,
                      "cin_stack_pooled.fwd": s + e,
                      "cin_stack_pooled.bwd": s}, device)
    check_logits("xdeepfm", xdeepfm,
                 XDeepFM(ds.feature_specs, EMBED_DIM, XDEEPFM_MAPS, "relu",
                         XDEEPFM_HIDDEN), ds, device, rtol=1e-4, atol=2e-4,
                 plain=stack_forward_bf16_on_cpu)
    results["xdeepfm"] = {"eval": final,
                          "profile": trainer_profile(trainer, train, test)}
    print("xdeepfm profile: " + json.dumps(results["xdeepfm"]["profile"]))
    del trainer, xdeepfm

    layered = make_xdeepfm(ds, LAYERED_MAPS, device)
    layers = len(LAYERED_MAPS)
    trainer, paths["xdeepfm_layered"], final = train_path(
        "xdeepfm_layered", layered, train, test, LAYERED_EPOCHS,
        lambda s, e: {"scatter_add_rows": 2 * s,
                      "cin2d.fwd": layers * (s + e),
                      "cin2d.bwd": layers * s}, device)
    results["xdeepfm_layered"] = {
        "eval": final,
        "profile": trainer_profile(trainer, train, test)}
    print("xdeepfm_layered profile: "
          + json.dumps(results["xdeepfm_layered"]["profile"]))
    del trainer, layered
    return paths, results


def trainer_profile(trainer: Trainer, train: DeviceData, test: DeviceData):
    """:func:`profile_phase` of a CTR model's ``Trainer``; its evaluation is
    one warm pass over the test split, which the steady examples/s window
    of ``fit_device`` contains."""
    perm = train.permutation(SEED, EPOCHS)
    batch = train.batch_size
    return profile_phase(
        lambda s: trainer.train_step(
            *train.gather(perm[s * batch:(s + 1) * batch])),
        lambda: trainer._evaluate_device(test))  # ends in a host read


def profile_phase(step, evaluate, steps: int = 10):
    """Where a steady train step's time goes: the wall time of ``steps``
    calls of ``step(s)`` without the profiler, then torch.profiler's device
    time by kernel and host time by range over as many steps. The idle share is 1 - device busy /
    wall time. The host's side of the same unprofiled steps is the wall
    time of the loop that queues them, before the final synchronisation
    (``host_loop_ms_per_step``): where it is as long as the step, the host
    sets the pace. Also the wall time of one warm ``evaluate()``, which
    must end in a host read."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        t0 = time.perf_counter()
        for s in range(steps):
            step(s)
        loop = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps, loop * 1e3 / steps

    t0 = time.perf_counter()
    evaluate()
    eval_ms = (time.perf_counter() - t0) * 1e3
    run()  # warm up
    step_ms, loop_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = run()[0]
    # Device activity only; user-annotated ranges (the optimizer's step)
    # span kernels that are counted on their own.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # The host's side: CPU time of each recorded range, children included
    # (the profiler adds to it alike on every tree).
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    top_host = sorted(host, key=lambda e: -e.cpu_time_total)[:24]
    return {
        "steps": steps,
        "eval_ms": eval_ms,
        "step_ms": step_ms,
        "host_loop_ms_per_step": loop_ms,
        "step_ms_profiled": profiled_ms,
        "device_busy_ms_per_step": busy_ms if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / step_ms if kernels
        else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top": [{"name": e.key[:80],
                 "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top],
        "top_host": [{"name": e.key[:80],
                      "cpu_ms_per_step": e.cpu_time_total / 1e3 / steps,
                      "calls_per_step": e.count / steps} for e in top_host],
    }


# -- flash attention (K5, K6) and the Transformer paths -----------------------

def _merge_checks(parts) -> dict:
    """One check per output from per-chunk checks: the largest error and
    share of a tolerance, and the smallest share a planted fault reached."""
    merged = {}
    for part in parts:
        for out, fields in part.items():
            m = merged.setdefault(out, {})
            if out == "planted":  # a fault's share of its limit
                for fault, share in fields.items():
                    m[fault] = min(m.get(fault, math.inf), share)
                continue
            for key, value in fields.items():
                if key == "planted":
                    shares = m.setdefault("planted", {})
                    for fault, share in value.items():
                        shares[fault] = min(shares.get(fault, math.inf), share)
                else:
                    m[key] = max(m.get(key, -math.inf), value)
    return merged


def _valid_pairs(mask: torch.Tensor, causal: bool) -> int:
    """(query, key) pairs the attention function must score: every valid
    key for each of the S queries, or with causal only queries at or after
    the key (S - j of them for key j)."""
    s = mask.shape[1]
    if not causal:
        return int(mask.sum().item()) * s
    after = torch.arange(s, 0, -1, device=mask.device, dtype=torch.float64)
    return int((mask.double() * after).sum().item())


def sdpa_inputs(q, k, v, mask, causal, heads=TX_HEADS):
    """q, k, v as (B, H, S, D) views and the boolean mask that
    ``F.scaled_dot_product_attention`` takes for the same function: the
    key mask of each example (its rows repeat over the ``heads`` heads),
    broadcast over heads and queries, with the causal triangle. The 4-D
    layout lets the library choose a fused backend; the 3-D one runs its
    math path."""
    bh, s, d = q.shape
    b = bh // heads
    q4, k4, v4 = (t.view(b, heads, s, d) for t in (q, k, v))
    allowed = (mask.view(b, heads, s)[:, 0] > 0)[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(s, s, dtype=torch.bool,
                                       device=q.device).tril()
    return q4, k4, v4, allowed


def sdpa_forward(q4, k4, v4, allowed):
    """One ``F.scaled_dot_product_attention`` call with the boolean mask:
    the library yardstick of K5 (the port never calls it)."""
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=allowed)


def sdpa_backward(q4, k4, v4, allowed, g4):
    """The backward of that call for the output gradient g, alone: the
    forward runs once here and its graph is kept (K6's yardstick)."""
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=allowed)
    return lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True)


def kernel_times(fn, top: int = 3):
    """The device kernels that take the most time in one call of ``fn``,
    with their device ms (torch.profiler): which backend a library call
    chose, or how a kernel's time splits between its launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return [{"name": e.key[:100], "ms": e.self_device_time_total / 1e3}
            for e in kernels[:top]]


def library_fields(q, k, v, mask, causal, g=None, heads=TX_HEADS) -> dict:
    """The library yardstick of K5 (``g`` None) or K6: one
    ``F.scaled_dot_product_attention`` call on the same inputs, or its
    backward, timed, with the kernels it ran. The forward is timed from
    CUDA-graph replays as the kernels are; the backward eagerly with CUDA
    events (autograd's backward is not captured in a graph; at
    milliseconds a call, the launch cost is noise). A shape the library
    refuses gives ``library_ms`` null and "refused" with its message."""
    args = sdpa_inputs(q, k, v, mask, causal, heads)
    try:
        if g is None:
            call = sdpa_forward(*args)
            fields = {"library_ms": graph_ms(call, 5, 4),
                      "library_timing": "CUDA-graph replays"}
        else:
            call = sdpa_backward(*args, g.view(args[0].shape))
            fields = {"library_ms": time_ms(call, iters=5, warmup=2),
                      "library_timing": "eager, CUDA events"}
    except RuntimeError as e:
        torch.cuda.synchronize()
        return {"library_ms": None, "library": "refused",
                "library_refusal": str(e)[:200]}
    fields["library_kernels"] = kernel_times(call)
    del call, args
    torch.cuda.empty_cache()
    return fields


def live_tile_pairs(mask: torch.Tensor, causal: bool) -> int:
    """(query, key) lanes of the tiles the bf16 kernels score, each of which
    takes one exp: every 64 x 64 tile of a (bh) row whose keys are not all
    padding, and with causal only tiles not wholly in the future."""
    bh, s = mask.shape
    nt = -(-s // ATT_TILE)
    padded = torch.zeros(bh, nt * ATT_TILE, device=mask.device)
    padded[:, :s] = mask
    live = (padded.reshape(bh, nt, ATT_TILE) > 0).any(-1).double()
    # Query tiles that see key tile t: all nt, or with causal nt - t.
    seen = torch.full((nt,), float(nt), dtype=torch.float64,
                      device=mask.device)
    if causal:
        seen -= torch.arange(nt, device=mask.device, dtype=torch.float64)
    return int((live * seen).sum().item()) * ATT_TILE * ATT_TILE


def kernel_source(dtype, d: int, backward: bool) -> str:
    """The repo path of the source whose kernel K5 (or K6) runs for
    operands of ``dtype`` at head width ``d``."""
    return (f"deep_recommenders_torch/csrc/"
            f"{att._kernel(dtype, d, backward)[0]}.cu")


def attention_inputs(imdb: SyntheticImdb, device, dtype=torch.float32,
                     d: int = TX_DIM // TX_HEADS):
    """The attention kernels' inputs at the Transformer slice's shapes:
    q, k, v, g (2048, 512, 16) seeded normals in ``dtype`` (or head width
    ``d``), and the key masks of one train batch's tokens repeated over the
    8 heads."""
    tokens = torch.from_numpy(imdb.train[0][:TX_BATCH]).to(device)
    mask = (tokens != 0).float().repeat_interleave(TX_HEADS, dim=0)
    bh, s = mask.shape[0], TX_LEN
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, g = (torch.randn(bh, s, d, device=device, generator=gen)
                  .to(dtype) for _ in range(4))
    return q, k, v, g, mask


def tf32_bound_fields(num_bytes: float, product_flop: float, exps: float,
                      exp_rate: float, fp32_ops: float) -> dict:
    """The bound of the fp32 K5 and K6 as they compute (3xTF32 on the
    tensor cores): the largest of the bytes over the memory rate, the
    products' operations times TF32_PASSES over the TF32 rate and the
    exponentials over the SFUs' rate; beside it the fp32 CUDA-core bound
    (``bound_fp32_ms``) of ``fp32_ops``."""
    parts = {"bytes": num_bytes / HBM_BYTES_PER_S * 1e3,
             "tf32_products": product_flop * TF32_PASSES / TF32_OPS_PER_S
             * 1e3,
             "exp_floor": exps / exp_rate * 1e3}
    which = max(parts, key=parts.get)
    fp32_ms, fp32_by = bound(num_bytes, fp32_ops)
    return {"bound_ms": parts[which], "bound_us": parts[which] * 1e3,
            "bound_by": "bytes" if which == "bytes" else "operations",
            "bound_part": which, "bound_parts_ms": parts,
            "bound_fp32_ms": fp32_ms, "bound_fp32_by": fp32_by,
            "gflop": product_flop / 1e9}


def attention_calls(q, k, v, g, mask, causal):
    """The K5 call and the K6 call on its residuals (the kernels of the
    operands' dtype)."""
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    return (lambda: att.flash_attention(q, k, v, mask, causal,
                                        return_lse=True),
            lambda: att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                                 causal))


def bf16_yardsticks(q, k, v, g, mask, causal, heads) -> dict:
    """The bounds of the bf16 K5 and K6 on these inputs, as the bf16 kernel
    phase counts them (bf16 bytes; 4 D and 10 D tensor-core operations a
    scored pair; K6 as its kernels split it, scores twice, 14 D:
    "bwd_bound_design_ms"), and the library calls' times
    (:func:`library_fields`; ``heads`` heads an example; null and
    "refused" where the library refuses the shape)."""
    bh, s, d = q.shape
    pairs = _valid_pairs(mask, causal)
    fwd_bytes = (4 * bh * s * d) * 2 + 2 * bh * s * 4
    bwd_bytes = (8 * bh * s * d) * 2 + 2 * bh * s * 4
    fwd_ms, fwd_by = bound(fwd_bytes, pairs * 4 * d, BF16_OPS_PER_S)
    bwd_ms, bwd_by = bound(bwd_bytes, pairs * 10 * d, BF16_OPS_PER_S)
    fields = {"fwd_bound_ms": fwd_ms, "fwd_bound_by": fwd_by,
              "bwd_bound_ms": bwd_ms, "bwd_bound_by": bwd_by,
              "bwd_bound_design_ms": bound(bwd_bytes, pairs * 14 * d,
                                           BF16_OPS_PER_S)[0]}
    for name, grad in (("fwd", None), ("bwd", g)):
        lib = library_fields(q, k, v, mask, causal, grad, heads)
        fields[f"{name}_library_ms"] = lib["library_ms"]
        fields[f"{name}_library"] = lib.get(
            "library_kernels", lib.get("library", "refused"))
    return fields


def attention_times(q, k, v, g, mask, heads=None) -> dict:
    """Device and eager ms of K5 and K6 on these inputs, non-causal and
    causal, and how K6's time splits between its two kernels: the same
    measurement on any tree of the port. With ``heads`` (the heads of an
    example among the (bh) rows), also :func:`bf16_yardsticks`."""
    times = {}
    for causal in (False, True):
        fwd, bwd = attention_calls(q, k, v, g, mask, causal)
        times[f"causal={causal}"] = {
            "fwd_ms": graph_ms(fwd, 5, 4), "fwd_eager_ms": time_ms(fwd, 10),
            "bwd_ms": graph_ms(bwd, 5, 4), "bwd_eager_ms": time_ms(bwd, 10),
            "bwd_kernel_split": kernel_times(bwd, top=2)}
        del fwd, bwd
        if heads is not None:
            times[f"causal={causal}"].update(
                bf16_yardsticks(q, k, v, g, mask, causal, heads))
    del q, k, v, g
    torch.cuda.empty_cache()
    return times


def fp32_attention_times(imdb: SyntheticImdb, device) -> dict:
    """:func:`attention_times` of the fp32 K5 and K6 at the slice's
    shapes."""
    return attention_times(*attention_inputs(imdb, device))


def attention_times_by_width(imdb: SyntheticImdb, device) -> dict:
    """:func:`attention_times` of the fp32 and the bf16 K5 and K6 at the
    Transformer slice's shapes (D = 16, :func:`attention_inputs`), of the
    bf16 ones at its (BH, S) and D = 32, 64 and 128 (``NARROW_TIMED``), and
    at D = 256, 512, 1024 and 2304 (:func:`wide_attention_inputs`,
    ``TIMED_SHAPES``): calls that every tree since the D > 256 instances
    takes, for setting a change beside its parent. The bf16 widths that no
    entry of the full run times (``NARROW_TIMED``, D = 1024 and 2304) also
    carry their bounds and library calls (:func:`bf16_yardsticks`)."""
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        times[f"d16/{dtype}"] = attention_times(
            *attention_inputs(imdb, device, dtype))
        if bf16:
            for d in NARROW_TIMED:
                times[f"d{d}/{dtype}"] = attention_times(
                    *attention_inputs(imdb, device, dtype, d),
                    heads=TX_HEADS)
        for which in TIMED_SHAPES:
            times[f"{which}/{dtype}"] = attention_times(
                *wide_attention_inputs(imdb, device, dtype, which),
                heads=1 if bf16 and which not in WIDE_SHAPES else None)
    return times


def lost_partial(fwd_checks, bwd_checks) -> str:
    """The share line's end where the checks also ran the planted fault of
    a lost partial score (K5 and K6 on clusters that split D)."""
    end = ""
    for which, checks in (("forward", fwd_checks), ("backward", bwd_checks)):
        share = checks.get("planted", {}).get("partial_dropped")
        if share is not None:
            end += f"; {which} less a block's partial scores {share:.6g}"
    return end


def attention_kernel_phase(imdb: SyntheticImdb, device, inputs=None,
                           heads=TX_HEADS, suffix=""):
    """K5 and K6 at the Transformer slice's shapes
    (:func:`attention_inputs`; or ``inputs``, whose (bh) rows are
    examples of ``heads`` heads, with ``suffix`` on the entries' names),
    non-causal and causal. Each is held against
    its plain version in fp64 (``ops/attention_tolerances.py`` states the
    tolerances of the kernels' 3xTF32 products), in chunks of ATT_CHUNK
    rows, on the same inputs, forward residuals and incoming gradient; the
    checks must reject the same function with single-pass TF32 products at
    least TF32_REJECT_FACTOR times over their limits, and dk less its
    first query tile (above PARTIAL_WIDTH also K5 and K6 less a block's
    partial scores). Times: kernel, plain version and one
    ``F.scaled_dot_product_attention`` call with the boolean mask (for K6
    its backward), with the kernels that call ran. Bounds: the 3xTF32
    design's (:func:`tf32_bound_fields`), the fp32 CUDA-core bound
    beside it."""
    q, k, v, g, mask = inputs or attention_inputs(imdb, device)
    del inputs
    bh, s, d = q.shape
    split = d > at.PARTIAL_WIDTH  # K5 and K6 on clusters that split D
    chunks = [slice(i, i + ATT_CHUNK) for i in range(0, bh, ATT_CHUNK)]
    shape = {"q": [bh, s, d], "k": [bh, s, d],
             "valid_keys": mask.mean().item()}
    exp_rate = SMS * EXP_PER_SM_CLOCK * sm_clock_hz()
    precision = ("fp32 operands; every product in three TF32 passes "
                 "(3xTF32) on the tensor cores, fp32 accumulation")
    fwd, bwd = {}, {}
    for causal in (False, True):
        out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
        grads = att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                             causal)
        torch.cuda.synchronize()
        fwd_checks = _merge_checks(
            at.check_forward((out[c], lse[c]), q[c], k[c], v[c], mask[c],
                             causal, planted_tf32=True,
                             planted_partial=split) for c in chunks)
        bwd_checks = _merge_checks(
            at.check_backward([t[c] for t in grads], q[c], k[c], v[c],
                              mask[c], out[c], lse[c], g[c], causal,
                              planted_rows=ATT_PLANTED_ROWS,
                              planted_tf32=True, planted_partial=split)
            for c in chunks)
        print(f"flash_attention{suffix} causal={causal} shares: out "
              f"{fwd_checks['out']['err_over_tol']:.6g} / fro "
              f"{fwd_checks['out']['fro_over_tol']:.6g}, lse "
              f"{fwd_checks['lse']['err_over_tol']:.6g}; " + ", ".join(
                  f"{n} {bwd_checks[n]['err_over_tol']:.6g} / fro "
                  f"{bwd_checks[n]['fro_over_tol']:.6g}"
                  for n in ("dq", "dk", "dv"))
              + "; single-pass TF32 forward "
              f"{fwd_checks['planted']['single_pass_tf32']:.6g}, backward "
              f"{bwd_checks['planted']['single_pass_tf32']:.6g} times its "
              "limit; dk less a query tile "
              f"{bwd_checks['dk']['planted']['query_tile_dropped']:.6g}"
              + lost_partial(fwd_checks, bwd_checks))
        pairs = _valid_pairs(mask, causal)
        fwd_call, bwd_call = attention_calls(q, k, v, g, mask, causal)
        fwd_entry = {
            "shape": {**shape, "causal": causal},
            "precision": precision,
            **check_fields(fwd_checks),
            **timings(
                fwd_call,
                lambda: att.flash_attention_reference(q, k, v, mask, causal),
                None, iters=5, replays=4, eager_iters=10),
            "host_us": host_us(lambda: att.flash_attention(q, k, v, mask,
                                                           causal)),
            **library_fields(q, k, v, mask, causal, heads=heads),
            # q, k, v and out; the mask and lse. Per scored pair: 4 D
            # products (q.k and p v) and one exp; on the CUDA cores 5
            # softmax operations beside them.
            **tf32_bound_fields((4 * bh * s * d + 2 * bh * s) * 4,
                                pairs * 4 * d, pairs, exp_rate,
                                pairs * (4 * d + 5)),
            "scored_pairs": pairs,
        }
        bwd_entry = {
            "shape": {**shape, "causal": causal},
            "precision": precision,
            **check_fields(bwd_checks),
            **timings(
                bwd_call,
                lambda: att.flash_attention_backward_reference(
                    q, k, v, mask, out, lse, g, causal),
                None, iters=5, replays=4, eager_iters=10),
            **library_fields(q, k, v, mask, causal, g, heads),
            # The dq kernel and the dk/dv kernel, one launch each.
            "kernel_split": kernel_times(bwd_call, top=2),
            # q, k, v, g, out, dq, dk and dv; the mask and lse. Per scored
            # pair: 10 D products (s, dp, dq, dk, dv) and one exp. The
            # kernels, as JAX splits them, compute s and dp twice and
            # rebuild p in both: 14 D products and two exps
            # ("bound_design_ms").
            **tf32_bound_fields((8 * bh * s * d + 2 * bh * s) * 4,
                                pairs * 10 * d, pairs, exp_rate,
                                pairs * (10 * d + 5)),
            "bound_design_ms": tf32_bound_fields(
                (8 * bh * s * d + 2 * bh * s) * 4, pairs * 14 * d,
                2 * pairs, exp_rate, 0)["bound_ms"],
            "gflop_kernels": pairs * 14 * d / 1e9,
            "scored_pairs": pairs,
        }
        # The Transformer's four non-causal attentions per step lead each
        # entry; its two causal ones follow under "causal".
        if causal:
            fwd["causal"], bwd["causal"] = fwd_entry, bwd_entry
        else:
            fwd.update(fwd_entry)
            bwd.update(bwd_entry)
        del out, lse, grads, fwd_call, bwd_call
    entries = [
        {"name": "flash_attention.fwd" + suffix, "route": "cuda",
         "source": kernel_source(torch.float32, d, False),
         "replaces": "deep_recommenders_tpu/ops/attention.py:165", **fwd},
        {"name": "flash_attention.bwd" + suffix, "route": "cuda",
         "source": kernel_source(torch.float32, d, True),
         "replaces": "deep_recommenders_tpu/ops/attention.py:377", **bwd},
    ]
    del q, k, v, g
    torch.cuda.empty_cache()
    return entries


def mma_sync_bf16_calls(q, k, v, g, mask, causal):
    """The bf16 K5 and K6 of csrc/flash_attention_bf16.cu (mma.sync, 64-key
    tiles, exp2f, K6 in a dq and a dk/dv kernel) called through their C
    functions on the same inputs, whatever the wrapper routes the shape to:
    the yardstick of the kernels that replaced them up to D = 128
    (flash_attention_tma_bf16.cu's, and flash_attention_cluster_bf16.cu's
    one-block instances) in one run (their times, and whether their
    exponentials change what the checks see).
    Returns (forward call, backward call on its own out and lse); no launch
    is counted."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    p, i32, f64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_double
    fwd_fn = _build.function("flash_attention_bf16", "flash_attention_fwd_bf16",
                             [p] * 6 + [i32] * 5 + [f64, p])
    bwd_fn = _build.function("flash_attention_bf16", "flash_attention_bwd_bf16",
                             [p] * 11 + [i32] * 5 + [f64, p])
    scale = d ** -0.5

    def fwd():
        out = torch.empty_like(q)
        lse = torch.empty(bh, sq, device=q.device)
        _build.check(fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                            bh, sq, sk, d, int(causal), scale, stream()),
                     "the mma.sync bf16 K5")
        return out, lse

    out, lse = fwd()

    def bwd():
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty(bh, sq, device=q.device)
        _build.check(bwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            mask.data_ptr(), lse.data_ptr(), out.data_ptr(),
                            g.data_ptr(), delta.data_ptr(),
                            *(t.data_ptr() for t in grads), bh, sq, sk, d,
                            int(causal), scale, stream()),
                     "the mma.sync bf16 K6")
        return grads

    return fwd, bwd


# Planted extreme scores: q times each of these on EXTREME_ROWS (bh) rows
# of the bf16 path's inputs puts the scores' spread in the tens and in the
# hundreds, so that some or most p lie below 2^-126, where ex2.approx.ftz
# flushes to 0 and exp2f does not.
EXTREME_Q_SCALES, EXTREME_ROWS = (16.0, 64.0), 256


def extreme_scores(q, k, v, g, mask) -> dict:
    """The bf16 K5 and K6 on planted extreme scores (q scaled by each of
    EXTREME_Q_SCALES, EXTREME_ROWS rows), non-causal and causal: the largest
    share of a tolerance, forward and backward, of the routed kernels
    (ex2.approx.ftz), of flash_attention_bf16.cu's mma.sync kernels (exp2f)
    and of the bf16 plain version
    (torch.exp) under the same fp64 checks, reported without raising (an
    output element whose every term is a p below 2^-126 has lost the
    relative precision the checks' model assumes, whatever the exp), and
    the share of valid lanes whose p lies below 2^-126."""
    rows = slice(0, EXTREME_ROWS)
    base = q[rows].float()
    k, v, g, mask = k[rows], v[rows], g[rows], mask[rows]
    bh, s, d = k.shape
    result = {}
    for scale, causal in itertools.product(EXTREME_Q_SCALES, (False, True)):
        q = (base * scale).to(torch.bfloat16)
        fields = {}
        sync_fwd, sync_bwd = mma_sync_bf16_calls(q, k, v, g, mask, causal)
        for name in ("routed", "mma_sync", "bf16_plain"):
            if name == "routed":
                out, lse = att.flash_attention(q, k, v, mask, causal,
                                               return_lse=True)
                grads = att.flash_attention_backward(q, k, v, mask, out, lse,
                                                     g, causal)
            elif name == "mma_sync":
                out, lse = sync_fwd()
                grads = sync_bwd()
            else:
                out, lse = att.flash_attention_reference_bf16(q, k, v, mask,
                                                              causal)
                grads = att.flash_attention_backward_reference_bf16(
                    q, k, v, mask, out, lse, g, causal)
            fwd_checks = at.check_forward_bf16((out, lse), q, k, v, mask,
                                               causal, hold=False)
            bwd_checks = at.check_backward_bf16(grads, q, k, v, mask, out,
                                                lse, g, causal, hold=False)
            fields[name] = {"forward": ct.worst_share(fwd_checks),
                            "backward": ct.worst_share(bwd_checks)}
        lanes = att._valid_lanes((bh, s, s), mask, causal,
                                 q.device).expand(bh, s, s)
        sc = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * d ** -0.5
        lse64 = att.flash_attention_reference(q.double(), k.double(),
                                              v.double(), mask, causal)[1]
        tiny = (sc - lse64[..., None]) < -126 * math.log(2)
        fields["valid_lanes_below_2^-126"] = (
            (tiny & lanes).sum() / lanes.sum()).item()
        result[f"q_scale={scale:g} causal={causal}"] = fields
        del sc, lanes, tiny
    torch.cuda.empty_cache()
    return result


def ptxas_summary(log: str) -> dict:
    """Registers and spilled bytes of each kernel in an nvcc -Xptxas -v
    log, and the lines of its warnings (C75xx: setmaxnreg, wgmma)."""
    kernels, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kernels[name] = {}
        elif name and "spill stores" in line:
            parts = line.replace(",", "").split()
            kernels[name]["spill_stores"] = int(parts[parts.index("spill") - 2])
            kernels[name]["spill_loads"] = int(parts[-4])
        elif name and "Used" in line and "registers" in line:
            parts = line.split()
            kernels[name]["registers"] = int(parts[parts.index("Used") + 1])
    warnings_ = [line.strip() for line in log.splitlines() if "C75" in line]
    return {"kernels": kernels, "warnings": warnings_}


def check_tma_sass() -> dict:
    """The bf16 K5 and K6 of narrow heads are fed by TMA: every kernel of
    csrc/flash_attention_tma_bf16.cu but K6's sum over query ranges
    (reduce_kernel: no product, no TMA) has UTMALDG instructions; K6's
    (bwd_kernel) run their products on wgmma (HGMMA, no HMMA), K5's
    (fwd_kernel) on mma.sync (HMMA, no HGMMA)."""
    def wrong(name, c):
        if "reduce_kernel" in name:
            return c["HMMA"] or c["HGMMA"]
        if not c["UTMALDG"]:
            return True
        if "bwd_kernel" in name:
            return c["HMMA"] or not c["HGMMA"]
        return c["HGMMA"] or not c["HMMA"]

    counts = sass_opcodes("flash_attention_tma_bf16")
    bad = {k: c for k, c in counts.items() if wrong(k, c)}
    if not counts or bad:
        raise AssertionError(f"flash_attention_tma_bf16 SASS: {counts}")
    print(f"flash_attention_tma_bf16 SASS: {counts}")
    return counts


def attention_bf16_kernel_phase(imdb: SyntheticImdb, device, inputs=None,
                                heads=TX_HEADS, suffix=""):
    """The bf16 K5 and K6 at the bf16 Transformer path's shapes: q, k, v, g
    (2048, 512, 16) seeded normals rounded to bf16, with the same key
    masks as the fp32 phase (or ``inputs``, ``heads`` and ``suffix`` as in
    :func:`attention_kernel_phase`), non-causal and causal. Each is held
    against its fp64 and its bf16 plain version (``check_forward_bf16`` at
    the kernel's key tile, ``check_backward_bf16`` in
    ``ops/attention_tolerances.py``), in chunks of ATT_CHUNK rows; the dk
    check must reject dk less its first query tile, the dq check dq less
    its first key tile, and above PARTIAL_WIDTH the checks K5 and K6 less
    a block's partial scores. Times: kernel, bf16 plain version, one bf16
    ``F.scaled_dot_product_attention`` call with the boolean mask (for K6
    its backward), and the mma.sync kernels (:func:`mma_sync_bf16_calls`)
    where the wrapper routes a width they take (up to 128) to another
    source. Bounds: bf16
    bytes and
    bf16 tensor-core operations, with the exp floors beside them (at 16 a
    clock per SM at the largest SM clock: one exp per lane of a scored
    64-key tile, two in K6 as JAX splits it, "exp_floor_ms"; one a valid
    pair, "exp_floor_valid_pairs_ms"; K6 scored once a pair,
    "exp_floor_one_pass_ms" and "exp_floor_one_pass_valid_pairs_ms");
    at D = 16 also the planted extreme scores (:func:`extreme_scores`)."""
    q, k, v, g, mask = inputs or attention_inputs(imdb, device,
                                                  torch.bfloat16)
    del inputs
    bh, s, d = q.shape
    split = d > at.PARTIAL_WIDTH  # K5 and K6 on clusters that split D
    chunks = [slice(i, i + ATT_CHUNK) for i in range(0, bh, ATT_CHUNK)]
    shape = {"q": [bh, s, d], "k": [bh, s, d], "dtype": "bfloat16",
             "valid_keys": mask.mean().item()}
    exp_rate = SMS * EXP_PER_SM_CLOCK * sm_clock_hz()
    routed = {direction: att._kernel(torch.bfloat16, d, direction)[0]
              for direction in (False, True)}
    fwd, bwd = {}, {}
    for causal in (False, True):
        out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
        grads = att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                             causal)
        torch.cuda.synchronize()
        fwd_checks = _merge_checks(
            at.check_forward_bf16((out[c], lse[c]), q[c], k[c], v[c],
                                  mask[c], causal, planted_partial=split)
            for c in chunks)
        bwd_checks = _merge_checks(
            at.check_backward_bf16([t[c] for t in grads], q[c], k[c], v[c],
                                   mask[c], out[c], lse[c], g[c], causal,
                                   planted_rows=ATT_PLANTED_ROWS,
                                   planted_keys=ATT_PLANTED_KEYS,
                                   planted_partial=split)
            for c in chunks)
        print(f"flash_attention_bf16{suffix} causal={causal} shares: out "
              f"{fwd_checks['out']['err_over_tol']:.6g} (fp64), "
              f"{fwd_checks['out_bf16_plain']['err_over_tol']:.6g} (bf16 "
              f"plain); dk {bwd_checks['dk']['err_over_tol']:.6g}, fro "
              f"{bwd_checks['dk']['fro_over_tol']:.6g}; planted dk fault "
              f"{bwd_checks['dk']['planted']['query_tile_dropped']:.6g}, "
              f"dq fault "
              f"{bwd_checks['dq']['planted']['key_tile_dropped']:.6g}"
              + lost_partial(fwd_checks, bwd_checks))
        pairs = _valid_pairs(mask, causal)
        lanes = live_tile_pairs(mask, causal)
        sync = {}
        if d <= 128 and "flash_attention_bf16" not in routed.values():
            sync_fwd, sync_bwd = mma_sync_bf16_calls(q, k, v, g, mask, causal)
            sync = {"fwd": {"mma_sync_ms": graph_ms(sync_fwd, 10, 4),
                            "mma_sync_eager_ms": time_ms(sync_fwd, 20)},
                    "bwd": {"mma_sync_ms": graph_ms(sync_bwd, 10, 4),
                            "mma_sync_eager_ms": time_ms(sync_bwd, 20)}}
            del sync_fwd, sync_bwd
        fwd_entry = {
            "shape": {**shape, "causal": causal},
            **check_fields(fwd_checks),
            # Against the bf16 plain version; the fp64 check's own is in
            # checks.
            "max_abs_err": fwd_checks["out_bf16_plain"]["max_abs_err"],
            **timings(
                lambda: att.flash_attention(q, k, v, mask, causal,
                                            return_lse=True),
                lambda: att.flash_attention_reference_bf16(q, k, v, mask,
                                                           causal),
                None, iters=10, replays=4, eager_iters=20),
            **sync.get("fwd", {}),
            "host_us": host_us(lambda: att.flash_attention(q, k, v, mask,
                                                           causal)),
            **library_fields(q, k, v, mask, causal, heads=heads),
            # q, k, v and out in bf16; the mask and lse in fp32. Per scored
            # pair 4 D tensor-core operations (q.k and p v).
            **bound_fields((4 * bh * s * d) * 2 + 2 * bh * s * 4,
                           pairs * 4 * d, bf16=True),
            "scored_pairs": pairs,
            "exp_lanes": lanes,
            "exp_floor_ms": lanes / exp_rate * 1e3,
            "exp_floor_valid_pairs_ms": pairs / exp_rate * 1e3,
        }
        bwd_entry = {
            "shape": {**shape, "causal": causal},
            **check_fields(bwd_checks),
            "max_abs_err": max(bwd_checks[f"{n}_bf16_plain"]["max_abs_err"]
                               for n in ("dq", "dk", "dv")),
            **timings(
                lambda: att.flash_attention_backward(q, k, v, mask, out, lse,
                                                     g, causal),
                lambda: att.flash_attention_backward_reference_bf16(
                    q, k, v, mask, out, lse, g, causal),
                None, iters=10, replays=4, eager_iters=20),
            **sync.get("bwd", {}),
            **library_fields(q, k, v, mask, causal, g, heads),
            # The kernels one call runs: one (scored once a pair) or the
            # mma.sync dq and dk/dv kernels.
            "kernel_split": kernel_times(
                lambda: att.flash_attention_backward(q, k, v, mask, out, lse,
                                                     g, causal), top=2),

            # q, k, v, g, out, dq, dk and dv in bf16; the mask and lse in
            # fp32. Per scored pair 10 D tensor-core operations (s, dp, dq,
            # dk, dv); as JAX splits it, 14 D ("gflop_kernels"), and each
            # kernel rebuilds p: two exps a lane ("exp_floor_ms", the
            # yardstick shared with the mma.sync kernels); scored once, one.
            **bound_fields((8 * bh * s * d) * 2 + 2 * bh * s * 4,
                           pairs * 10 * d, bf16=True),
            "gflop_kernels": pairs * 14 * d / 1e9,
            "scored_pairs": pairs,
            "exp_lanes": 2 * lanes,
            "exp_floor_ms": 2 * lanes / exp_rate * 1e3,
            "exp_floor_valid_pairs_ms": 2 * pairs / exp_rate * 1e3,
            "exp_floor_one_pass_ms": lanes / exp_rate * 1e3,
            "exp_floor_one_pass_valid_pairs_ms": pairs / exp_rate * 1e3,
        }
        if causal:
            fwd["causal"], bwd["causal"] = fwd_entry, bwd_entry
        else:
            fwd.update(fwd_entry)
            bwd.update(bwd_entry)
        del out, lse, grads
    entries = [
        {"name": "flash_attention_bf16.fwd" + suffix, "route": "cuda",
         "source": kernel_source(torch.bfloat16, d, False),
         "replaces": "deep_recommenders_tpu/ops/attention.py:165", **fwd},
        {"name": "flash_attention_bf16.bwd" + suffix, "route": "cuda",
         "source": kernel_source(torch.bfloat16, d, True),
         "replaces": "deep_recommenders_tpu/ops/attention.py:377", **bwd},
    ]
    if "tma" in routed[False] and not suffix:
        entries[0]["sass"] = entries[1]["sass"] = check_tma_sass()
        entries[0]["extreme_scores"] = extreme = extreme_scores(q, k, v, g,
                                                                mask)
        print("flash_attention_bf16 extreme scores " + json.dumps(extreme))
    del q, k, v, g
    torch.cuda.empty_cache()
    return entries


def wide_attention_inputs(imdb: SyntheticImdb, device, dtype,
                          which: str = "d256"):
    """The wide phase's inputs at ``TIMED_SHAPES[which]`` = (BH, D): q, k,
    v, g (BH, TX_LEN, D) seeded normals in ``dtype``, and the key masks of
    one SyntheticImdb train batch (BH examples, one head each)."""
    bh, d = TIMED_SHAPES[which]
    tokens = torch.from_numpy(imdb.train[0][:bh]).to(device)
    mask = (tokens != 0).float()
    gen = torch.Generator(device=device).manual_seed(SEED + d)
    q, k, v, g = (torch.randn(bh, TX_LEN, d, device=device,
                              generator=gen).to(dtype) for _ in range(4))
    return q, k, v, g, mask


# SASS opcodes counted in the bf16 K5's kernels: Hopper's warpgroup
# products and TMA loads and stores, and mma.sync (which they must not use).
SASS_OPCODES = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")


def sass_opcodes(source: str) -> dict:
    """Each kernel's count of ``SASS_OPCODES`` in the built library of
    ``source`` (cuobjdump -sass of build/kernels/lib<source>-<hash>.so)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library_path(source)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            counts[name] = dict.fromkeys(SASS_OPCODES, 0)
        elif name is not None and "*/" in line:
            op = line.split("*/", 1)[1].split()
            op = op[1] if op and op[0].startswith("@") and len(op) > 1 else (
                op[0] if op else "")
            base = op.split(".")[0]
            if base in counts[name]:
                counts[name][base] += 1
    return counts


def check_cluster_sass() -> dict:
    """The bf16 K5 from D = 256 to 2048 and K6 above 256 run on wgmma and
    TMA: every kernel of csrc/flash_attention_cluster_bf16.cu (fwd_cluster,
    and K6's dq_cluster and dkv_cluster) has HGMMA, UTMALDG and UTMASTG
    instructions and no HMMA (mma.sync)."""
    counts = sass_opcodes("flash_attention_cluster_bf16")
    bad = {k: c for k, c in counts.items()
           if c["HMMA"] or not (c["HGMMA"] and c["UTMALDG"] and c["UTMASTG"])}
    if not counts or bad:
        raise AssertionError(f"flash_attention_cluster_bf16 SASS: {counts}")
    print(f"flash_attention_cluster_bf16 SASS: {list(counts.values())}")
    return counts


def wide_attention_phase(imdb: SyntheticImdb, device):
    """K5 and K6 at D = 256 and at D = 512, fp32 and bf16, at
    (BH, S, D) = (256, TX_LEN, 256) and (128, TX_LEN, 512)
    (:func:`wide_attention_inputs`), non-causal and causal, by the fp32
    and bf16 kernel phases' checks, planted faults, times, bounds and library
    calls (the SDPA call's kernels where it takes the shape, "refused"
    where not); entries ``*.d256`` and ``*.d512``, the bf16 K5's (and the
    bf16 K6's at D = 512) with the cluster kernels' SASS opcode counts
    (:func:`check_cluster_sass`). At D = 512 the checks also reject K5 and
    K6 less a block's partial scores; the bf16 K6 at D = 1024 (clusters of
    4) is held too (:func:`cluster_backward_check`, its entry's
    "clusters_of_4")."""
    sass = check_cluster_sass()
    entries = []
    for which in WIDE_SHAPES:
        entries += attention_kernel_phase(
            imdb, device,
            wide_attention_inputs(imdb, device, torch.float32, which),
            heads=1, suffix="." + which)
        entries += attention_bf16_kernel_phase(
            imdb, device,
            wide_attention_inputs(imdb, device, torch.bfloat16, which),
            heads=1, suffix="." + which)
        entries[-2]["sass"] = sass
        if which != "d256":
            entries[-1]["sass"] = sass
    entries[-1]["clusters_of_4"] = cluster_backward_check(imdb, device)
    return entries


def cluster_backward_check(imdb: SyntheticImdb, device,
                           which: str = "d1024") -> dict:
    """The bf16 K6 at ``TIMED_SHAPES[which]``, (64, TX_LEN, 1024): clusters
    of 4 blocks that pull their peers' partial scores, non-causal and
    causal. Against its fp64 and bf16 plain versions
    (``check_backward_bf16``), with the planted faults (dk less a query
    tile, dq less a key tile, the backward less a block's partial scores);
    two calls bit for bit. Returns each causal mode's worst shares."""
    q, k, v, g, mask = wide_attention_inputs(imdb, device, torch.bfloat16,
                                             which)
    bh, s, d = q.shape
    chunks = [slice(i, i + ATT_CHUNK) for i in range(0, bh, ATT_CHUNK)]
    result = {"shape": {"q": [bh, s, d], "dtype": "bfloat16",
                        "source": kernel_source(torch.bfloat16, d, True)}}
    for causal in (False, True):
        out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
        runs = [att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                             causal) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"bf16 K6 at {which}: two calls differ")
        checks = _merge_checks(
            at.check_backward_bf16([t[c] for t in runs[0]], q[c], k[c], v[c],
                                   mask[c], out[c], lse[c], g[c], causal,
                                   planted_rows=ATT_PLANTED_ROWS,
                                   planted_keys=ATT_PLANTED_KEYS,
                                   planted_partial=True)
            for c in chunks)
        faults = {"dk_less_a_query_tile":
                  checks["dk"]["planted"]["query_tile_dropped"],
                  "dq_less_a_key_tile":
                  checks["dq"]["planted"]["key_tile_dropped"],
                  "less_a_partial": checks["planted"]["partial_dropped"]}
        print(f"flash_attention_bf16.bwd.{which} causal={causal} shares: "
              + ", ".join(f"{n} {checks[n]['err_over_tol']:.6g} / fro "
                          f"{checks[n]['fro_over_tol']:.6g}"
                          for n in ("dq", "dk", "dv"))
              + f"; planted dk fault {faults['dk_less_a_query_tile']:.6g}, "
              f"dq fault {faults['dq_less_a_key_tile']:.6g}; backward less "
              f"a block's partial scores {faults['less_a_partial']:.6g}; "
              "two calls bit for bit")
        result[f"causal={causal}"] = {
            "worst_share": ct.worst_share(checks),
            "planted": faults}
        del out, lse, runs
    del q, k, v, g
    torch.cuda.empty_cache()
    return result


def instances(table: dict, stems) -> dict:
    """The entries of ``table`` (by mangled kernel name: a ptxas summary's
    or sass_opcodes') whose names hold one of ``stems`` (a kernel's name
    and template arguments, mangled: "dq_soloILi2EE" is dq_solo<2>)."""
    return {k: v for k, v in table.items() if any(t in k for t in stems)}


def narrow_attention_phase(imdb: SyntheticImdb, device,
                           cluster_ptxas: dict) -> list:
    """The bf16 K5 and K6 at each of NARROW_HELD (D = 64: K5 of
    csrc/flash_attention_tma_bf16.cu, K6 of dq_solo<1> and dkv_solo<1> in
    csrc/flash_attention_cluster_bf16.cu; D = 128: K5 of fwd_solo<2> and
    K6 of dq_solo<2> and dkv_solo<2>, all on persistent grids)
    at the Transformer slice's (BH, S) = (2048, TX_LEN) and key
    masks (:func:`attention_inputs`): the bf16 kernel phase's checks,
    planted faults, times beside flash_attention_bf16.cu's mma.sync kernels
    in the same run, bounds and library calls (entries ``*.d64`` and
    ``*.d128``); two calls bit for bit, non-causal and causal. Each entry
    of a cluster kernel carries its instances' ptxas summary (registers,
    spills, from ``cluster_ptxas``) and SASS opcode counts (HGMMA, UTMALDG,
    UTMASTG, no HMMA: :func:`check_cluster_sass`), and every entry the C
    function it runs ("function")."""
    sass = check_cluster_sass()
    entries = []
    for d in NARROW_HELD:
        nc = d // 64
        q, k, v, g, mask = inputs = attention_inputs(imdb, device,
                                                     torch.bfloat16, d)
        same = {}
        for causal in (False, True):
            runs = []
            for _ in range(2):
                out, lse = att.flash_attention(q, k, v, mask, causal,
                                               return_lse=True)
                runs.append((out, lse, *att.flash_attention_backward(
                    q, k, v, mask, out, lse, g, causal)))
            torch.cuda.synchronize()
            same[f"causal={causal}"] = all(torch.equal(a, b)
                                           for a, b in zip(*runs))
            del runs, out, lse
        if not all(same.values()):
            raise AssertionError(f"bf16 K5/K6 at D = {d}: two calls differ "
                                 f"{same}")
        print(f"flash_attention_bf16.d{d} two calls bit for bit: {same}")
        new = attention_bf16_kernel_phase(imdb, device, inputs,
                                          heads=TX_HEADS, suffix=f".d{d}")
        del q, k, v, g, mask, inputs
        for entry in new:
            entry["two_calls_bit_equal"] = same
            # The C function the wrapper calls at this width.
            entry["function"] = att._kernel(
                torch.bfloat16, d, ".bwd." in entry["name"])[1]
            if "cluster" in entry["source"]:
                stems = ((f"dq_soloILi{nc}EE", f"dkv_soloILi{nc}EE")
                         if ".bwd." in entry["name"]
                         else (f"fwd_soloILi{nc}EE",))
                entry["ptxas"] = instances(cluster_ptxas.get("kernels", {}),
                                           stems)
                entry["sass"] = instances(sass, stems)
                if len(entry["sass"]) != len(stems):
                    raise AssertionError(f"{entry['name']}: SASS of {stems}: "
                                         f"{entry['sass']}")
        entries += new
    torch.cuda.empty_cache()
    return entries


# The mangled stem of the bf16 K5 above 2048: fwd_cluster<4, kReduce>.
REDUCE_STEMS = ("fwd_clusterILi4ELi3EE",)


def cluster_placement() -> dict:
    """How many clusters of the bf16 K5 the card places at once, by blocks
    a cluster: G = 2-16 at D = 256 G (cudaOccupancyMaxActiveClusters of
    the instance each width launches, with its shared memory)."""
    fn = _build.function("flash_attention_cluster_bf16",
                         "flash_attention_cluster_fwd_bf16_placement",
                         [ctypes.c_int, ctypes.c_void_p])
    placement = {}
    for group in range(2, 17):
        held = ctypes.c_int(0)
        _build.check(fn(256 * group, ctypes.byref(held)),
                     f"cluster placement at {group} blocks")
        placement[group] = held.value
    print("flash_attention_cluster_bf16 placement (clusters held at once, by "
          "blocks a cluster; one block an SM): " + json.dumps(placement))
    return placement


def reduce_scatter_attention_phase(imdb: SyntheticImdb, device,
                                   cluster_ptxas: dict) -> list:
    """The bf16 K5 above 2048 on clusters of 9-16 blocks
    (``fwd_cluster<4, kReduce>`` of csrc/flash_attention_cluster_bf16.cu:
    a reduce-scatter of the blocks' partial scores, then an all-gather),
    with the bf16 K6 of csrc/flash_attention_wide_bf16.cu beside it:
    the placement line (:func:`cluster_placement`); at
    ``TIMED_SHAPES["d2304"]`` = (32, TX_LEN, 2304), clusters of 9, on one
    SyntheticImdb batch's key masks, the bf16 kernel phase's checks (the
    forward's planted fault: the last block's partial scores lost), times,
    bounds and library calls (entries ``*.d2304``); at
    ``TIMED_SHAPES["d4096"]`` = (16, TX_LEN, 4096), clusters of 16,
    ``check_forward_bf16`` with the same planted fault, ms and the
    library's (the forward entry's "d4096"); two calls bit for bit at both,
    non-causal and causal; the instance's ptxas summary and SASS counts
    (HGMMA, UTMALDG, UTMASTG, no HMMA)."""
    placement = cluster_placement()
    sass = check_cluster_sass()
    same, wide = {}, {}
    for which in ("d2304", "d4096"):
        q, k, v, g, mask = wide_attention_inputs(imdb, device, torch.bfloat16,
                                                 which)
        for causal in (False, True):
            runs = [att.flash_attention(q, k, v, mask, causal,
                                        return_lse=True) for _ in range(2)]
            torch.cuda.synchronize()
            same[f"{which}/causal={causal}"] = all(
                torch.equal(a, b) for a, b in zip(*runs))
            if which == "d4096":
                checks = at.check_forward_bf16(runs[0], q, k, v, mask, causal,
                                               planted_partial=True)
                wide[f"causal={causal}"] = {
                    "worst_share": ct.worst_share(checks),
                    "less_a_partial": checks["planted"]["partial_dropped"],
                    "ms": graph_ms(lambda: att.flash_attention(
                        q, k, v, mask, causal), 5, 4),
                    "library_ms": library_fields(q, k, v, mask, causal,
                                                 heads=1)["library_ms"]}
                print(f"flash_attention_bf16.fwd.d4096 causal={causal}: "
                      + json.dumps(wide[f"causal={causal}"]))
            del runs
        del q, k, v, g, mask
    if not all(same.values()):
        raise AssertionError(f"bf16 K5 above 2048: two calls differ {same}")
    print(f"flash_attention_bf16.fwd.d2304/d4096 two calls bit for bit: "
          f"{same}")
    entries = attention_bf16_kernel_phase(
        imdb, device, wide_attention_inputs(imdb, device, torch.bfloat16,
                                            "d2304"),
        heads=1, suffix=".d2304")
    bh, d = TIMED_SHAPES["d2304"]
    fwd = entries[0]
    fwd.update(function=att._kernel(torch.bfloat16, d, False)[1],
               placement=placement, two_calls_bit_equal=same, d4096=wide,
               ptxas=instances(cluster_ptxas.get("kernels", {}),
                               REDUCE_STEMS),
               sass=instances(sass, REDUCE_STEMS))
    if len(fwd["sass"]) != len(REDUCE_STEMS):
        raise AssertionError(f"bf16 K5 above 2048: SASS {fwd['sass']}")
    torch.cuda.empty_cache()
    return entries


def long_attention_inputs(bh: int, s: int, d: int, device):
    """q, k, v, g (bh, s, d) bf16 seeded normals and the key masks of
    SyntheticImdb rows of length s (lengths uniform in [s / 4, s]), each
    repeated over the TX_DIM / d heads of an example, the first bh rows:
    :func:`attention_inputs` at any (BH, S). Also the heads."""
    heads = TX_DIM // d
    imdb = SyntheticImdb(num_words=TX_VOCAB, max_len=s, seed=SEED)
    tokens = torch.from_numpy(imdb.train[0][:-(-bh // heads)]).to(device)
    mask = (tokens != 0).float().repeat_interleave(heads, dim=0)[:bh]
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, g = (torch.randn(bh, s, d, device=device, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    return q, k, v, g, mask.contiguous(), heads


def lost_range_share(q, k, v, mask, out, lse, g, causal, drop, rows) -> float:
    """The bf16 backward check's largest share of a tolerance over dk and dv
    on the first ``rows`` (bh) rows of the card's K6 with query range
    ``drop``'s partials left out of their sum (the planted fault of
    ``att.flash_attention_backward_lost_range``), reported without
    raising."""
    lost = att.flash_attention_backward_lost_range(q, k, v, mask, out, lse, g,
                                                   causal, drop)
    c = slice(0, rows)
    checks = at.check_backward_bf16(
        [t[c] for t in lost], q[c], k[c], v[c], mask[c], out[c], lse[c],
        g[c], causal, hold=False)
    return max(checks[n]["err_over_tol"] for n in ("dk", "dv"))


def long_edge_checks(device) -> dict:
    """The bf16 K6 at each of LONG_EDGES, non-causal and causal: the range
    plan, the kernel's device ms, two calls bit for bit, the bf16 checks
    (fp64 and the bf16 plain version, dk less its first query tile and dq
    less its first key tile rejected) on every (bh) row, in chunks of
    LONG_CHECK_ROWS, and with more than one range the planted lost partial
    (of the range of the most rows) rejected on the first chunk; then each
    edge's ratio of the two sides' times."""
    sms = att._sm_count(device)
    edges = {}
    for bh, s, d in LONG_EDGES:
        q, k, v, g, mask, _ = long_attention_inputs(bh, s, d, device)
        if att._kernel(torch.bfloat16, d, True)[0] != \
                "flash_attention_tma_bf16":
            raise AssertionError(f"bf16 K6 at {(bh, s, d)} not routed to "
                                 "flash_attention_tma_bf16")
        fields = {}
        chunks = [slice(i, i + LONG_CHECK_ROWS)
                  for i in range(0, bh, LONG_CHECK_ROWS)]
        for causal in (False, True):
            starts = att.bwd_query_ranges(bh, s, s, d, sms, causal)
            out, lse = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)

            def call():
                return att.flash_attention_backward(q, k, v, mask, out, lse,
                                                    g, causal)

            first, second = call(), call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            checks = _merge_checks(
                at.check_backward_bf16(
                    [t[c] for t in first], q[c], k[c], v[c], mask[c],
                    out[c], lse[c], g[c], causal,
                    planted_rows=ATT_PLANTED_ROWS,
                    planted_keys=ATT_PLANTED_KEYS) for c in chunks)
            got = {"range_starts": starts, "ranges": len(starts) - 1,
                   "ms": graph_ms(call, 5, 4), "two_calls_bit_equal": same,
                   "max_err_over_tolerance": ct.worst_share(
                       {n: checks[n] for n in ("dq", "dk", "dv")}),
                   "planted": {"query_tile_dropped": checks["dk"]["planted"][
                       "query_tile_dropped"], "key_tile_dropped": checks[
                       "dq"]["planted"]["key_tile_dropped"]}}
            if len(starts) > 2:  # lose the range of the most query rows
                rows_of = [min(s, b * 128) - a * 128
                           for a, b in zip(starts, starts[1:])]
                share = lost_range_share(q, k, v, mask, out, lse, g, causal,
                                         rows_of.index(max(rows_of)),
                                         LONG_CHECK_ROWS)
                if not share > 1:
                    raise AssertionError(f"bf16 K6 at {(bh, s, d)}: the "
                                         "check accepts a lost range's "
                                         f"partials: {share}")
                got["planted"]["range_partial_dropped"] = share
            if not same:
                raise AssertionError(f"bf16 K6 at {(bh, s, d)} causal="
                                     f"{causal}: two calls differ")
            fields[f"causal={causal}"] = got
            del first, second, out, lse
        edges[f"{bh},{s},{d}"] = fields
        print(f"flash_attention_bf16.bwd edge {(bh, s, d)}: "
              + json.dumps(fields))
        del q, k, v, g, mask
        torch.cuda.empty_cache()
    for (a, b) in zip(LONG_EDGES[::2], LONG_EDGES[1::2]):
        for causal in (False, True):
            key = f"causal={causal}"
            edges[f"{a} -> {b} {key} ms ratio"] = (
                edges[",".join(map(str, b))][key]["ms"]
                / edges[",".join(map(str, a))][key]["ms"])
    return edges


def long_attention_phase(device) -> list:
    """The bf16 K6 past the shapes of one query range: the edge checks
    (:func:`long_edge_checks`), then the entry ``flash_attention_bf16.bwd
    .long`` at the long path's (BH, S, D) = (TXL_BATCH x TX_HEADS, TXL_LEN,
    16) with its key masks (:func:`long_attention_inputs`), non-causal and
    causal: the checks on every (bh) row in chunks of LONG_CHUNK (fp64 and
    the bf16 plain version, with the planted faults: dk less its first
    query tile, dq less its first key tile, and each query range's dk and
    dv partials lost in turn), two calls bit for bit, device ms (CUDA-graph
    replays) beside the mma.sync kernels of csrc/flash_attention_bf16.cu
    in the same run (in the order mma.sync, routed, routed, mma.sync),
    eager ms, the bf16 plain version's ms on the chunks, cuDNN's backward,
    the bytes and tensor-core bounds, the exp floors, and the kernels one
    call runs."""
    edges = long_edge_checks(device)
    bh, s, d = TXL_BATCH * TX_HEADS, TXL_LEN, TX_DIM // TX_HEADS
    q, k, v, g, mask, heads = long_attention_inputs(bh, s, d, device)
    sms = att._sm_count(device)
    exp_rate = SMS * EXP_PER_SM_CLOCK * sm_clock_hz()
    chunks = [slice(i, i + LONG_CHUNK) for i in range(0, bh, LONG_CHUNK)]
    entry = {"name": "flash_attention_bf16.bwd.long", "route": "cuda",
             "source": kernel_source(torch.bfloat16, d, True),
             "replaces": "deep_recommenders_tpu/ops/attention.py:377",
             "function": att._kernel(torch.bfloat16, d, True)[1],
             "edges": edges}
    for causal in (False, True):
        starts = att.bwd_query_ranges(bh, s, s, d, sms, causal)
        ranges = len(starts) - 1
        out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)

        def call():
            return att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                                causal)

        def plain():
            return [att.flash_attention_backward_reference_bf16(
                q[c], k[c], v[c], mask[c], out[c], lse[c], g[c], causal)
                for c in chunks]

        grads, again = call(), call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        if not same:
            raise AssertionError(f"bf16 K6 at {(bh, s, d)} causal={causal}: "
                                 "two calls differ")
        checks = _merge_checks(
            at.check_backward_bf16([t[c] for t in grads], q[c], k[c], v[c],
                                   mask[c], out[c], lse[c], g[c], causal,
                                   planted_rows=ATT_PLANTED_ROWS,
                                   planted_keys=ATT_PLANTED_KEYS)
            for c in chunks)
        lost = {f"range {r}": lost_range_share(q, k, v, mask, out, lse, g,
                                               causal, r, LONG_CHUNK)
                for r in range(ranges)}
        if not min(lost.values()) > 1:
            raise AssertionError(f"bf16 K6 at {(bh, s, d)}: the check "
                                 f"accepts a lost range's partials: {lost}")
        _, sync = mma_sync_bf16_calls(q, k, v, g, mask, causal)
        order = []
        for name in ("mma_sync", "routed", "routed", "mma_sync"):
            order.append(graph_ms(sync if name == "mma_sync" else call, 5, 4))
        pairs = _valid_pairs(mask, causal)
        lanes = live_tile_pairs(mask, causal)
        fields = {
            "shape": {"q": [bh, s, d], "k": [bh, s, d], "dtype": "bfloat16",
                      "valid_keys": mask.mean().item(), "causal": causal},
            **check_fields(checks),
            "max_abs_err": max(checks[f"{n}_bf16_plain"]["max_abs_err"]
                               for n in ("dq", "dk", "dv")),
            "range_starts": starts, "ranges": ranges,
            "planted_range_partial_dropped": lost,
            "two_calls_bit_equal": same,
            "ms": (order[1] + order[2]) / 2,
            "ms_in_order": order[1:3],
            "mma_sync_ms": (order[0] + order[3]) / 2,
            "mma_sync_ms_in_order": [order[0], order[3]],
            "eager_ms": time_ms(call, 10, 3),
            "plain_ms": time_ms(plain, 2, 1),
            "plain": f"flash_attention_backward_reference_bf16 on "
                     f"{len(chunks)} chunks of {LONG_CHUNK} (bh) rows",
            **library_fields(q, k, v, mask, causal, g, heads),
            "kernel_split": kernel_times(call, top=3),
            # q, k, v, g, out, dq, dk and dv in bf16; the mask and lse in
            # fp32. Per scored pair 10 D tensor-core operations; one exp.
            **bound_fields((8 * bh * s * d) * 2 + 2 * bh * s * 4,
                           pairs * 10 * d, bf16=True),
            "scored_pairs": pairs,
            "exp_floor_one_pass_ms": pairs / exp_rate * 1e3,
            "exp_floor_one_pass_lanes_ms": lanes / exp_rate * 1e3,
            # The ranges' fp32 partials, written once and read once.
            "workspace_bytes": 2 * ranges * bh * s * d * 4,
        }
        print(f"flash_attention_bf16.bwd.long causal={causal}: ms "
              f"{fields['ms']:.4f} (mma.sync {fields['mma_sync_ms']:.4f}, "
              f"library {fields['library_ms']}), shares dq "
              f"{checks['dq']['err_over_tol']:.4g} dk "
              f"{checks['dk']['err_over_tol']:.4g} dv "
              f"{checks['dv']['err_over_tol']:.4g}, lost range {lost}")
        if causal:
            entry["causal"] = fields
        else:
            entry.update(fields)
        del grads, out, lse, sync
        torch.cuda.empty_cache()
    del q, k, v, g, mask
    torch.cuda.empty_cache()
    return [entry]


def attention_width_path(device, d: int,
                         dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """A wide head width's main path: ``attention()`` over the memory
    budget at head width ``d``, (BH, S) = (HW_WIDE_BH, HW_LEN), in each of
    ``dtypes`` (fp32 and then bf16), forward and backward, with seeded
    post-padding key masks. It must warn of nothing and launch K5 and K6
    once each in each dtype (D padded to ``kernel_head_dim(d)``: 256 for
    200, 320 for 257, 2304 for 2300; 128 as it is, the bf16 kernels'
    one-block instances in csrc/flash_attention_cluster_bf16.cu; at 2300
    the bf16 K5 on clusters of 9 blocks and the streamed K6 of
    csrc/flash_attention_wide_bf16.cu), and agree with
    the plain versions at the true D (``ops/attention_tolerances.py``) on
    HW_CHUNK rows. Returns the launches of the calls."""
    name = f"attention_d{d}"
    gen = torch.Generator(device=device).manual_seed(SEED + d)
    bh, s, width = HW_WIDE_BH, HW_LEN, att.kernel_head_dim(d)
    if not att.use_flash_for(bh, s, s, "cuda", False):
        raise AssertionError(f"{name}: under the budget")
    lengths = torch.randint(s // 16, s + 1, (bh,), device=device,
                            generator=gen)
    mask = (torch.arange(s, device=device)[None, :]
            < lengths[:, None]).float()
    reset_launches()
    runs = {}
    for dtype in dtypes:
        q, k, v, g = (torch.randn(bh, s, d, device=device, generator=gen)
                      .to(dtype) for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = att.attention(*leaves, key_mask=mask)
            out.backward(g)
        runs[dtype] = (q, k, v, g, out.detach(), [t.grad for t in leaves])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {key: 0 for key in launches}
    for key in itertools.chain(*map(flash_keys, dtypes)):
        want[key] = 1
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    shares, rows = {}, slice(0, HW_CHUNK)
    for dtype, (q, k, v, g, out, grads) in runs.items():
        bf16 = dtype == torch.bfloat16
        lse = att.flash_attention(
            *(att.pad_head_dim(t[rows], width) for t in (q, k, v)),
            mask[rows], False, return_lse=True, scale=d ** -0.5)[1]
        forward = at.check_forward_bf16 if bf16 else at.check_forward
        backward = at.check_backward_bf16 if bf16 else at.check_backward
        fwd_checks = forward((out[rows], lse), q[rows], k[rows], v[rows],
                             mask[rows], False)
        bwd_checks = backward([t[rows] for t in grads], q[rows], k[rows],
                              v[rows], mask[rows], out[rows], lse, g[rows],
                              False)
        shares["bf16" if bf16 else "fp32"] = max(
            ct.worst_share(fwd_checks), ct.worst_share(bwd_checks))
    del runs
    torch.cuda.empty_cache()
    print(f"{name} launches: {launches}; kernel width {width}; worst "
          f"shares {shares}; no warning")
    return launches


def head_width_phase(device) -> dict:
    """``attention()`` and ``FlashAttention`` at head widths that no kernel
    is built for. Over the memory budget at the IMDB example's
    ``--model-dim 32 --max-len 1024`` shape, (BH, S, D) = (256, 1024, 8)
    with seeded post-padding key masks, in fp32 and bf16, forward and
    backward must launch K5 and K6 once each (padded to D = 16) and pass the
    checks of ``ops/attention_tolerances.py`` at D = 8 against the plain
    versions (in chunks of HW_CHUNK rows); FlashAttention at D = 24 on
    (6, 150, 130) the same way. (D = 200 and D = 257 over the budget are
    main paths: :func:`attention_width_path`.)"""
    gen = torch.Generator(device=device).manual_seed(SEED)
    result = {}
    for name, (bh, s, d, call) in {
            "attention_d8": (HW_BH, HW_LEN, 8, "attention"),
            "flash_attention_d24": (6, 150, 24, "FlashAttention")}.items():
        lengths = torch.randint(s // 16, s + 1, (bh,), device=device,
                                generator=gen)
        mask = (torch.arange(s, device=device)[None, :]
                < lengths[:, None]).float()
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            q, k, v, g = (torch.randn(bh, s, d, device=device, generator=gen)
                          .to(dtype) for _ in range(4))
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fwd_key, bwd_key = flash_keys(dtype)
            reset_launches()
            if call == "attention":
                if not att.use_flash_for(bh, s, s, "cuda", False):
                    raise AssertionError(f"{name}: under the budget")
                out = att.attention(*leaves, key_mask=mask)
            else:
                out = att.FlashAttention.apply(*leaves, mask, False)
            out.backward(g)
            launches = read_launches()
            want = {key: 0 for key in launches}
            want[fwd_key] = want[bwd_key] = 1
            if launches != want or out.shape != q.shape:
                raise AssertionError(f"{name} {dtype}: launches {launches}, "
                                     f"out {tuple(out.shape)}")
            out = out.detach()
            grads = [t.grad for t in leaves]
            width = att.kernel_head_dim(d)
            lse = att.flash_attention(
                *(att.pad_head_dim(t, width) for t in (q, k, v)), mask,
                False, return_lse=True, scale=d ** -0.5)[1]
            forward = at.check_forward_bf16 if bf16 else at.check_forward
            backward = at.check_backward_bf16 if bf16 else at.check_backward
            chunks = [slice(i, i + HW_CHUNK) for i in range(0, bh, HW_CHUNK)]
            fwd_checks = _merge_checks(
                forward((out[c], lse[c]), q[c], k[c], v[c], mask[c], False)
                for c in chunks)
            bwd_checks = _merge_checks(
                backward([t[c] for t in grads], q[c], k[c], v[c], mask[c],
                         out[c], lse[c], g[c], False) for c in chunks)
            torch.cuda.synchronize()
            result[f"{name}_{'bf16' if bf16 else 'fp32'}"] = {
                "shape": [bh, s, d], "kernel_width": width,
                "launches": {fwd_key: 1, bwd_key: 1},
                "worst_share": max(ct.worst_share(fwd_checks),
                                   ct.worst_share(bwd_checks)),
                "checks": {**fwd_checks, **bwd_checks}}
            del q, k, v, g, leaves, out, grads, lse
    print("head widths: " + ", ".join(
        f"{k} worst share {v['worst_share']:.6g}" for k, v in result.items()
        if "worst_share" in v))
    return result


def make_transformer(device, dtype=None, heads=TX_HEADS) -> Transformer:
    return Transformer(TX_VOCAB, TX_DIM, heads, TX_LAYERS, TX_LAYERS,
                       TX_FFN, dropout=0.0, compute_dtype=dtype,
                       generator=torch.Generator().manual_seed(SEED)
                       ).to(device)


def flash_keys(dtype):
    """The launch counters of K5 and K6 for the Transformer's dtype."""
    if dtype == torch.bfloat16:
        return "flash_attention_bf16.fwd", "flash_attention_bf16.bwd"
    return "flash_attention.fwd", "flash_attention.bwd"


def copy_task(tokens: torch.Tensor):
    """(inputs, targets_in, targets_out, mask) of the copy task: the
    decoder reads [1] + tokens[:-1] and predicts the tokens, padding
    masked out of the loss."""
    start = torch.ones_like(tokens[:, :1])
    return (tokens, torch.cat([start, tokens[:, :-1]], dim=1), tokens,
            (tokens != 0).float())


def transformer_path(imdb: SyntheticImdb, device, dtype=None,
                     heads=TX_HEADS, batch=TX_BATCH, steps=None, evals=None,
                     logit_rows=8, suffix=""):
    """The slice's main path: TX_EPOCHS of the copy task on the card through
    ``Transformer.loss``, Adam under Noam(TX_DIM, TX_WARMUP), with every
    launch counter set to 0 just before and read just after (the held-out
    loss before and after training included). In fp32 (``dtype`` None) each
    train step must launch 6 K5 and 6 K6 (encoder self-attention x2,
    decoder causal self-attention x2, cross-attention x2), each held-out
    batch 6 K5; with ``dtype=torch.bfloat16`` the same counts of the bf16
    K5 and K6 and no fp32 launch; K1-K4 none; and by source, only the
    sources ``_kernel`` routes the path's shape to (with their K6 calls
    over more than one query range where csrc/flash_attention_tma_bf16.cu
    cuts the shape so). ``heads`` heads of TX_DIM / heads and ``batch``
    sequences of the rows' length a step (the zoo's 8 and TX_BATCH, or its
    2 x 64 heads at TX2_BATCH: path "transformer_seq2seq_bf16_2x64"), or
    the first ``steps`` steps and ``evals`` held-out batches, and the
    logits of ``logit_rows`` rows; ``suffix`` ends the path's name. Then
    the trained logits on the card, through K5, against the plain CPU path,
    and a profile of ten steady steps. Returns the launches and the
    profile."""
    train = torch.from_numpy(imdb.train[0]).long().to(device)
    test = torch.from_numpy(imdb.test[0]).long().to(device)
    n_train, n_test = len(train) // batch, len(test) // batch
    n_test = min(n_test, evals or n_test)
    length = train.shape[1]
    model = make_transformer(device, dtype, heads)
    opt = torch.optim.Adam(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, noam_schedule(TX_DIM, TX_WARMUP))

    def step(rows):
        inp, tgt_in, tgt_out, mask = copy_task(train[rows])
        opt.zero_grad(set_to_none=True)
        loss = model.loss(inp, tgt_in, tgt_out, epsilon=TX_EPSILON,
                          mask=mask)
        loss.backward()
        opt.step()
        sched.step()
        return loss.detach()

    def heldout() -> float:
        total = 0.0
        with torch.no_grad():
            for i in range(n_test):
                inp, tgt_in, tgt_out, mask = copy_task(
                    test[i * batch:(i + 1) * batch])
                total += model.loss(inp, tgt_in, tgt_out,
                                    epsilon=TX_EPSILON, training=False,
                                    mask=mask)
        return float(total) / n_test

    def permutation(epoch):
        return torch.randperm(
            len(train), device=device,
            generator=torch.Generator(device=device).manual_seed(SEED + epoch))

    planned = min(steps or TX_EPOCHS * n_train, TX_EPOCHS * n_train)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    before = heldout()
    t0 = time.perf_counter()
    losses = []
    for epoch in range(TX_EPOCHS):
        perm = permutation(epoch)
        for s in range(min(n_train, planned - len(losses))):
            losses.append(step(perm[s * batch:(s + 1) * batch]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    after = heldout()
    launches = read_launches()
    by_source = dict(att.flash_attention.launches_by_source)
    losses = torch.stack(losses).tolist()
    steps, evals = len(losses), 2 * n_test
    name = "transformer_seq2seq" + ("_bf16" if dtype else "") + (
        f"_{heads}x{TX_DIM // heads}" if heads != TX_HEADS else "") + suffix
    d = TX_DIM // heads
    routes = {direction: att._kernel(dtype or torch.float32, d, backward)[0]
              for direction, backward in (("K5", False), ("K6", True))}
    want_source = {f"{routes['K5']}.fwd": 6 * (steps + evals),
                   f"{routes['K6']}.bwd": 6 * steps}
    if routes["K6"] == "flash_attention_tma_bf16":
        # Two of the six K6 a step are causal, which may take other ranges.
        ranged = sum(len(att.bwd_query_ranges(
            batch * heads, length, length, d, att._sm_count(device),
            causal)) > 2 for causal in (False, False, True, False, False,
                                        True))
        if ranged:
            want_source["flash_attention_tma_bf16.bwd.ranges"] = (
                ranged * steps)
    print(f"{name} train: {steps} steps of {batch} x {length}, {heads} "
          f"heads of {d} ({routes}), loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, held-out loss {before:.6f} "
          f"-> {after:.6f}, {steps * batch / train_s:.1f} sequences/s "
          f"(smoke figure), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{name} launches: {launches}")
    print(f"{name} launches by source: {by_source}")
    fwd_key, bwd_key = flash_keys(dtype)
    want = {key: 0 for key in launches}
    want[fwd_key] = 6 * (steps + evals)
    want[bwd_key] = 6 * steps
    if steps != planned or launches != want or by_source != want_source:
        raise AssertionError(f"{name}: {steps} steps, launches {launches}, "
                             f"expected {want}; by source {by_source}, "
                             f"expected {want_source}")
    if not np.isfinite(losses).all() or not after < before:
        raise AssertionError(f"{name}: loss not finite and falling: "
                             f"{losses}, held-out {before} -> {after}")
    check_transformer_logits(name, model, test[:logit_rows], dtype, heads)
    perm = permutation(TX_EPOCHS)
    profile = profile_phase(
        lambda s: step(perm[s * batch:(s + 1) * batch]), heldout)
    print(f"{name} profile: " + json.dumps(profile))
    del model, opt, train, test
    torch.cuda.empty_cache()
    return launches, profile


def check_transformer_logits(name: str, model: Transformer,
                             tokens: torch.Tensor, dtype=None,
                             heads=TX_HEADS, hold: bool = True) -> dict:
    """The trained model's logits on a few test rows (``tokens``): on the
    card with every ``MultiHeadAttention.use_flash`` set to True (so few
    rows are under the dispatch's budget), so K5 runs six times, against
    the CPU on the same weights. Returns the largest differences; with
    ``hold`` raises where a rule fails.

    fp32: logits are sums over the width of LayerNorm'd unit-scale terms
    and table rows of norm ~sqrt(128), up to ~40 in size; fp32 sums in
    other orders through 4 layers stay within rtol 1e-4 and atol 1e-3 of
    the CPU's (its attention K5's fp32 plain version).

    bf16, two rules, each on the largest difference:

    - the same algorithm: the CPU runs its attention through K5's bf16
      plain version (``use_flash=True`` there: p rounded to bf16 before
      normalising, as the kernels do). The card and the CPU round the same
      values to bf16 at the same places but sum in fp32 in other orders
      (cuBLAS and the kernel against the CPU's GEMMs and the plain
      version, whose p is rounded against the row's max, not the running
      max of 128-key tiles), so some intermediates round to the other bf16
      neighbour and the difference carries through the layers: the card's
      logits must lie nearer the CPU's than those lie to the same path in
      fp32 (``same_path``).
    - an independent one: dense attention on the CPU (weights normalised,
      then rounded), which shares no code with K5. Its bf16 logits and the
      card's are two bf16 roundings of one fp32 computation, each about a
      bf16 error from it and not from each other (rounded in other places,
      their difference is up to the sum of the two errors, and it fails
      the same-path rule at random: 0.2309 against 0.2168 once at S =
      4096). So the card's logits must lie within twice the dense bf16
      path's distance of the dense fp32 logits (``dense``)."""
    inp, tgt_in, _, _ = copy_task(tokens)
    cpu_model = make_transformer("cpu", dtype, heads)
    cpu_model.load_state_dict({key: value.cpu() for key, value in
                               model.state_dict().items()})

    def flash(m, use):
        for layer in m.modules():
            if isinstance(layer, MultiHeadAttention):
                layer.use_flash = use

    def cpu_logits(m, use):
        flash(m, use)
        with torch.no_grad():
            return m(inp.cpu(), tgt_in.cpu())

    layers = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    flash(model, True)
    fwd_key = flash_keys(dtype)[0]
    before = read_launches()[fwd_key]
    with torch.no_grad():
        on_card = model(inp, tgt_in).cpu()
        launched = read_launches()[fwd_key] - before
    flash(model, None)
    on_cpu = cpu_logits(cpu_model, True)
    if launched != len(layers) or on_card.shape != (*tokens.shape, TX_VOCAB) \
            or on_card.dtype != torch.float32:
        raise AssertionError(f"{name}: {launched} K5 launches for "
                             f"{len(layers)} attentions, logits "
                             f"{tuple(on_card.shape)} {on_card.dtype}")

    def largest(a, b):
        return (a - b).abs().max().item()

    diff = largest(on_card, on_cpu)
    if dtype is None:
        if hold:
            torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-3)
        print(f"{name} logits card (K5) vs cpu: max abs diff {diff:.3g}, "
              f"largest logit {on_cpu.abs().max().item():.3g}")
        return {"card_vs_cpu": diff}
    fp32_model = make_transformer("cpu", heads=heads)
    fp32_model.load_state_dict(cpu_model.state_dict())
    dense, dense32 = (cpu_logits(m, None) for m in (cpu_model, fp32_model))
    gaps = {"card_vs_cpu": diff,
            "cpu_vs_fp32": largest(on_cpu, cpu_logits(fp32_model, True)),
            "card_vs_dense_fp32": largest(on_card, dense32),
            "dense_vs_dense_fp32": largest(dense, dense32),
            "card_vs_dense": largest(on_card, dense)}
    gaps["same_path_share"] = gaps["card_vs_cpu"] / gaps["cpu_vs_fp32"]
    gaps["dense_share"] = (gaps["card_vs_dense_fp32"]
                           / (2 * gaps["dense_vs_dense_fp32"]))
    print(f"{name} logits card (K5) vs cpu: " + json.dumps(gaps)
          + f", largest logit {on_cpu.abs().max().item():.3g}")
    if hold and (not bool(torch.isfinite(on_card).all())
                 or not gaps["same_path_share"] < 1
                 or not gaps["dense_share"] < 1):
        raise AssertionError(f"{name}: logits card vs cpu {gaps}")
    return gaps


def imdb_path():
    """The ported IMDB example at its defaults (d 64, 4 heads, 2 layers,
    batch 64, S 128, 3 epochs) on the card. Its attention goes dense under
    the dispatch (256 x 128 x 128 scores), so it launches no kernel at all;
    its loss must be finite and falling."""
    name = "transformer_imdb"
    reset_launches()
    result = train_transformer_on_imdb.main(["--device", "cuda"])
    launches = read_launches()
    losses = np.asarray(result["step_losses"])
    first, last = losses[:20].mean(), losses[-20:].mean()
    print(f"{name} train: {len(losses)} steps, mean loss of the first 20 "
          f"{first:.6f}, of the last 20 {last:.6f}, test accuracy "
          f"{[h['accuracy'] for h in result['history']]}")
    print(f"{name} launches: {launches}")
    if any(launches.values()):
        raise AssertionError(f"{name}: launches {launches}, expected none")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"{name}: loss not finite and falling")
    return launches


# -- DIN and the multitask models (imported in each function: --ctr-only
# and --attention-fp32-only also run in a parent's tree, which may not have
# them) ------------------------------------------------------------------------

class DINOnBatch(torch.nn.Module):
    """A DIN over a batch dict {"behaviors", "mask", "candidate"}, the form
    in which the Trainer's loss and eval and ``check_logits`` pass a
    batch."""

    def __init__(self, dtype=None, seeded=False):
        from deep_recommenders_torch.models.ranking import DIN

        super().__init__()
        self.din = DIN(DIN_UNITS, DIN_HIDDEN, embedding_dim=DIN_DIM,
                       compute_dtype=dtype,
                       generator=torch.Generator().manual_seed(SEED)
                       if seeded else None)

    def forward(self, batch):
        return self.din(batch["behaviors"], batch["mask"], batch["candidate"])


def din_paths(device):
    """DIN at the zoo's config in fp32 (``din``) and bf16 (``din_bf16``),
    EPOCHS each through ``Trainer.fit_device`` (its BCE loss and eval, the
    batch dict unpacked by :class:`DINOnBatch`) on the DIN example's task
    (``make_data`` at DIN_EXAMPLES, DIN_ITEMS, DIN_LEN, DIN_DIM; the
    behaviors, ~0.8 GB fp32, live on the card). No kernel of the port is on
    DIN's path (JAX gathers and scores it with plain ops): zero launches.
    Each with an AUC above 0.5 and its logits on the card against the plain
    CPU path (fp32: rtol 1e-4; bf16: nearer the CPU's bf16 logits than
    those lie to its fp32 ones), and a profile."""
    from deep_recommenders_torch.examples import train_din_on_synthetic

    behaviors, mask, candidates, labels = train_din_on_synthetic.make_data(
        DIN_EXAMPLES, DIN_ITEMS, DIN_DIM, DIN_LEN, SEED)
    n_train = int(DIN_EXAMPLES * 0.8)
    feats = {"behaviors": behaviors, "mask": mask, "candidate": candidates}
    train = DeviceData.from_numpy({k: v[:n_train] for k, v in feats.items()},
                                  labels[:n_train], BATCH, device=device)
    test_feats = {k: v[n_train:] for k, v in feats.items()}
    test = DeviceData.from_numpy(test_feats, labels[n_train:], BATCH,
                                 device=device)
    del behaviors, feats
    paths, results = {}, {}
    for name, dtype in (("din", None), ("din_bf16", torch.bfloat16)):
        din = DINOnBatch(dtype, seeded=True).to(device)
        trainer, paths[name], final = train_path(
            name, din, train, test, EPOCHS, lambda s, e: {}, device)
        check_logits(name, din, DINOnBatch(dtype), None, device,
                     feats=test_feats,
                     fp32_model=DINOnBatch() if dtype else None)
        results[name] = {"eval": final,
                         "profile": trainer_profile(trainer, train, test)}
        print(f"{name} profile: " + json.dumps(results[name]["profile"]))
        del trainer, din
    del train, test
    torch.cuda.empty_cache()
    return paths, results


def din_example_path():
    """The ported DIN example at its defaults (40k examples, T 20, D 16,
    batch 256, 3 epochs, its own loop) on the card: zero launches, the loss
    finite; a profile of its steps."""
    from deep_recommenders_torch.examples import train_din_on_synthetic as ex

    name = "din_example"
    reset_launches()
    result = ex.main(["--device", "cuda"])
    launches = read_launches()
    losses = result["step_losses"]
    print(f"{name} train: {len(losses)} steps of {result['batch_size']}, "
          f"mean loss of the first 20 {losses[:20].mean():.6f}, of the last "
          f"20 {losses[-20:].mean():.6f}, test auc "
          f"{[round(h['auc'], 6) for h in result['history']]}")
    print(f"{name} launches: {launches}")
    if any(launches.values()):
        raise AssertionError(f"{name}: launches {launches}, expected none")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: loss not finite")
    model, opt, data = result["model"], result["optimizer"], result["data"]
    n_train, bs = result["n_train"], result["batch_size"]
    perm = torch.randperm(n_train, device=data[0].device,
                          generator=torch.Generator(data[0].device)
                          .manual_seed(SEED))
    profile = profile_phase(
        lambda s: ex.train_step(model, opt, *(
            a.index_select(0, perm[s * bs:(s + 1) * bs]) for a in data)),
        lambda: ex.evaluate(model, data, n_train, bs))
    print(f"{name} profile: " + json.dumps(profile))
    return launches, {"eval": result["history"][-1], "profile": profile}


def mmoe_example_path():
    """The ported MMoE example at its defaults (512,000 x 256, batch 512, 4
    experts (256,) -> 128, towers (64,), 1 epoch) with a temporary
    --checkpoint-dir under build/, then again with --epochs 2 on the same
    directory: it must resume at epoch 1 and train that epoch only. Zero
    launches over both calls; each task's eval MSE finite and below the
    variance of its eval labels; a profile of the resumed trainer."""
    from deep_recommenders_torch.examples import train_mmoe_on_synthetic

    name = "mmoe_example"
    scratch = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        args = ["--device", "cuda", "--checkpoint-dir", tmp]
        reset_launches()
        first = train_mmoe_on_synthetic.main(args)
        resumed = train_mmoe_on_synthetic.main(args + ["--epochs", "2"])
        launches = read_launches()
    steps = resumed["train_data"].steps_per_epoch
    variance = resumed["eval_data"].labels.var(0, correction=0).tolist()
    print(f"{name} launches: {launches}")
    for run, result in (("first", first), ("resumed", resumed)):
        history = result["history"]
        losses = result["step_losses"]
        print(f"{name} {run}: epochs {[h['epoch'] for h in history]}, "
              f"{len(losses)} steps, loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}, eval " + " ".join(
                  f"{k}={v:.6f}" for k, v in history[-1].items()
                  if k not in ("epoch", "loss"))
              + f", eval label variance {variance}")
    if [h["epoch"] for h in first["history"]] != [0] \
            or [h["epoch"] for h in resumed["history"]] != [1] \
            or len(first["step_losses"]) != steps \
            or len(resumed["step_losses"]) != steps:
        raise AssertionError(f"{name}: the resume did not train epoch 1 "
                             f"alone")
    if any(launches.values()):
        raise AssertionError(f"{name}: launches {launches}, expected none")
    for result in (first, resumed):
        last = result["history"][-1]
        if not np.isfinite(result["step_losses"]).all() or not all(
                math.isfinite(last[f"mse_{t}"])
                and last[f"mse_{t}"] < variance[t] for t in range(2)):
            raise AssertionError(f"{name}: bad eval MSE {last}, label "
                                 f"variance {variance}")
    del first
    profile = trainer_profile(resumed["trainer"], resumed["train_data"],
                              resumed["eval_data"])
    print(f"{name} profile: " + json.dumps(profile))
    out = {"eval": resumed["history"][-1], "label_variance": variance,
           "profile": profile}
    del resumed
    torch.cuda.empty_cache()
    return launches, out


def esmm_loss(model):
    """The zoo's ESMM loss (benchmarks/run_models.py:245-251): BCE on the
    probabilities p_ctr (label column 0) and p_ctcvr (column 1), eps
    1e-7."""

    def bce(p, y):
        return -(y * torch.log(p + 1e-7)
                 + (1 - y) * torch.log(1 - p + 1e-7)).mean()

    def loss_fn(batch, labels):
        _, p_ctr, p_ctcvr = model(batch)
        return bce(p_ctr, labels[:, :1]) + bce(p_ctcvr, labels[:, 1:])

    return loss_fn


def esmm_quality(name: str, final: dict) -> None:
    """ESMM's eval: every metric finite, the ctr task's AUC above 0.5."""
    if not all(math.isfinite(v) for k, v in final.items() if k != "epoch") \
            or not final["auc_ctr"] > 0.5:
        raise AssertionError(f"{name}: bad eval metrics: {final}")


def esmm_path(ds: MovielensRanking, device):
    """ESMM at the zoo's config over the six MovieLens features (the
    ``specs`` front end, D 16, towers (256, 128)), EPOCHS with Adam at
    LEARNING_RATE and batch 8192 on the CTR paths' data: ctr the ratings'
    binary label, ctcvr ctr times a seeded Bernoulli(ESMM_CVR_RATE) draw;
    ``MultiTaskBCEEval`` on (p_ctr, p_ctcvr). One fp32 K1 a train step
    (the shared table's gradient, C = 16) and no other kernel; the ctr AUC
    above 0.5; the three probabilities on the card against the plain CPU
    path; a profile."""
    from deep_recommenders_torch.models.multitask import ESMM
    from deep_recommenders_torch.training import MultiTaskBCEEval

    rng = np.random.default_rng(SEED)

    def two_tasks(labels):
        ctr = labels.reshape(-1, 1).astype(np.float32)
        cvr = (rng.random(ctr.shape) < ESMM_CVR_RATE).astype(np.float32)
        return np.concatenate([ctr, ctr * cvr], axis=1)

    feats, labels = ds.train_arrays()
    train = DeviceData.from_numpy(feats, two_tasks(labels), BATCH,
                                  device=device)
    feats, labels = ds.test_arrays()
    test = DeviceData.from_numpy(feats, two_tasks(labels), BATCH,
                                 device=device)

    def make(seeded=False):
        return ESMM(None, ESMM_HIDDEN, ESMM_HIDDEN, specs=ds.feature_specs,
                    embedding_dim=EMBED_DIM,
                    generator=torch.Generator().manual_seed(SEED) if seeded
                    else None)

    model = make(seeded=True).to(device)
    trainer, launches, final = train_path(
        "esmm", model, train, test, EPOCHS, one_k1, device,
        loss_fn=esmm_loss(model),
        eval_spec=MultiTaskBCEEval(model, 2, ("ctr", "ctcvr"), (1, 2)),
        quality=esmm_quality)
    check_logits("esmm", model, make(), ds, device, outputs=3)
    result = {"eval": final, "profile": trainer_profile(trainer, train, test)}
    print("esmm profile: " + json.dumps(result["profile"]))
    del trainer, model, train, test
    torch.cuda.empty_cache()
    return launches, result


# -- two-tower retrieval ------------------------------------------------------

def make_two_tower(ds: MovielensRanking, seeded: bool = True):
    from deep_recommenders_torch.models.retrieval import TwoTower

    return TwoTower(ds.user_specs(), ds.item_specs(), TT_DIM, TT_HIDDEN,
                    TT_DIM, generator=torch.Generator().manual_seed(SEED)
                    if seeded else None)


def two_tower_data() -> dict:
    """The two-tower paths' data: ``MovielensRanking`` at NUM_RATINGS, seed
    SEED, with the rank-power movie marginal (the retrieval corpus); each
    split's positive pairs (user dict, movie dict, movie ids) on the host;
    and a seeded TwoTower on the CPU, whose tables' shapes the K1 entry
    reads."""
    ds = MovielensRanking(batch_size=TT_BATCH, num_ratings=NUM_RATINGS,
                          seed=SEED, movie_popularity="rank-power")
    return {"ds": ds, "train": ds.retrieval_arrays("train"),
            "test": ds.retrieval_arrays("test"), "model": make_two_tower(ds)}


def two_k1(s, e):
    """The two-tower's launches: one fp32 K1 a tower each train step (C =
    32), none in an eval batch."""
    return {"scatter_add_rows": 2 * s}


def retrieval_quality(name: str, final: dict) -> None:
    """A two-tower path's in-batch eval: every metric finite, the top-k
    accuracies in [0, 1] and rising with k. (Its val_loss, per example, is
    printed beside log(TT_BATCH), the in-batch loss of uniform scores.)"""
    acc = [final[f"top_{k}_categorical_accuracy"]
           for k in (1, 5, 10, 50, 100)]
    if not all(math.isfinite(v) for v in acc + [final["val_loss"]]) \
            or acc != sorted(acc) or not 0.0 <= acc[0] <= acc[-1] <= 1.0:
        raise AssertionError(f"{name}: bad eval metrics: {final}")
    print(f"{name} val_loss {final['val_loss']:.6f}, log(batch) "
          f"{math.log(TT_BATCH):.6f}")


def _on(device, batch: dict, rows=slice(None)) -> dict:
    return {k: torch.from_numpy(v[rows]).to(device) for k, v in batch.items()}


def row_losses(task, q, c) -> torch.Tensor:
    """Each row's term of the task's SUM-reduced loss: the task with a
    one-hot sample weight, row by row."""
    eye = torch.eye(q.shape[0], device=q.device)
    return torch.stack([task(q, c, sample_weight=w) for w in eye])


def check_two_tower(name, model, cpu_model, tt, task, device) -> None:
    """The trained towers' embeddings and the task's loss on 256 test pairs
    on the card against the plain CPU path (K1 is not on the forward) on
    the same weights: the embeddings within rtol 1e-4 (atol 1e-5); the
    fp32 loss within rtol 1e-4; a bf16 task's loss nearer the CPU's bf16
    loss than that lies to the CPU's fp32 loss, row by row (each row's
    term: the sum over 256 rows would add fp32 rounding of its own)."""
    user, item, _ = tt["test"]
    rows = slice(0, 256)
    model.eval()
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    cpu_model.eval()
    fp32 = dataclasses.replace(task, compute_dtype=None)
    with torch.no_grad():
        q, c = model(_on(device, user, rows), _on(device, item, rows))
        q_cpu, c_cpu = cpu_model(_on("cpu", user, rows),
                                 _on("cpu", item, rows))
        loss = row_losses(task, q, c).cpu()
        loss_cpu = row_losses(task, q_cpu, c_cpu)
        loss_cpu32 = row_losses(fp32, q_cpu, c_cpu)
    for got, want in ((q, q_cpu), (c, c_cpu)):
        if got.shape != (256, TT_DIM) or got.dtype != torch.float32:
            raise AssertionError(f"{name}: embeddings {tuple(got.shape)}")
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    diff = max((q.cpu() - q_cpu).abs().max().item(),
               (c.cpu() - c_cpu).abs().max().item())
    loss_diff = (loss - loss_cpu).abs().max().item()
    gap = (loss_cpu - loss_cpu32).abs().max().item()
    if task.compute_dtype is None:
        torch.testing.assert_close(loss, loss_cpu, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(loss.sum(), loss_cpu.sum(), rtol=1e-4,
                                   atol=1e-5)
    elif not (bool(torch.isfinite(loss).all()) and loss_diff < gap):
        raise AssertionError(f"{name}: row losses card vs cpu bf16 differ "
                             f"by {loss_diff}, cpu bf16 vs fp32 by {gap}")
    print(f"{name} card vs cpu: embeddings max abs diff {diff:.3g}; loss "
          f"card {loss.sum().item():.6f} cpu {loss_cpu.sum().item():.6f} "
          f"(cpu fp32 {loss_cpu32.sum().item():.6f}); row losses differ by "
          f"{loss_diff:.3g}, cpu bf16 vs fp32 by {gap:.3g}")


def check_two_tower_step(name, model, tt, task, device) -> dict:
    """The backward on the card: one train step's gradients from the seeded
    weights on the first TT_BATCH train pairs, on the card (two K1, counted
    after the path's launches were read) against the plain CPU path. fp32:
    every parameter's gradient within rtol 1e-4, atol 1e-4 times its
    largest element (sums of 4096 rows in other orders). bf16: each
    parameter's gradient nearer (Frobenius) the CPU's bf16 gradient than
    that lies to the CPU's fp32 gradient. And the trained ``model``: every
    parameter moved from the seeded weights."""
    from deep_recommenders_torch.training import retrieval_loss

    user, item, _ = tt["train"]
    rows = slice(0, TT_BATCH)

    def grads(dev, step_task):
        tower = make_two_tower(tt["ds"]).to(dev)
        loss = retrieval_loss(tower, step_task)(
            (_on(dev, user, rows), _on(dev, item, rows)), None)
        loss.backward()
        return loss.item(), {k: p.grad.cpu()
                             for k, p in tower.named_parameters()}

    loss, got = grads(device, task)
    loss_cpu, want = grads("cpu", task)
    worst = {}
    if task.compute_dtype is None:
        for key, g in got.items():
            scale = want[key].abs().max().item()
            torch.testing.assert_close(g, want[key], rtol=1e-4,
                                       atol=1e-4 * scale)
            worst[key] = (g - want[key]).abs().max().item() / scale
    else:
        _, want32 = grads("cpu", dataclasses.replace(task,
                                                     compute_dtype=None))
        for key, g in got.items():
            diff = (g - want[key]).norm().item()
            gap = (want[key] - want32[key]).norm().item()
            if not diff < gap:
                raise AssertionError(f"{name}: {key}'s gradient card vs cpu "
                                     f"bf16 {diff}, cpu bf16 vs fp32 {gap}")
            worst[key] = diff / gap
    init = tt["model"].state_dict()
    still = [k for k, v in model.state_dict().items()
             if torch.equal(v.cpu(), init[k])]
    if still:
        raise AssertionError(f"{name}: training left {still} at the seeded "
                             f"weights")
    rule = ("max abs err / max |grad|" if task.compute_dtype is None
            else "|card - cpu bf16| / |cpu bf16 - cpu fp32|")
    print(f"{name} train step card vs cpu: loss {loss:.6f} cpu "
          f"{loss_cpu:.6f}; gradients agree, {rule} at most "
          f"{max(worst.values()):.3g} ({max(worst, key=worst.get)}); every "
          f"trained parameter moved from the seeded weights")
    return worst


def two_level_top_k(scores: torch.Tensor, k: int, block: int = 1024):
    """JAX's exact_top_k on (B, N) rows wider than 2 * block: each block's
    top-k (the last padded with -inf), then the top-k of the winners. Timed
    beside the port's one torch.topk; used nowhere in the port."""
    b, n = scores.shape
    nb = -(-n // block)
    padded = torch.nn.functional.pad(scores, (0, nb * block - n),
                                     value=float("-inf"))
    sb, ib = torch.topk(padded.reshape(b, nb, block), k, dim=-1)
    ib = ib + torch.arange(nb, device=scores.device)[:, None] * block
    top, at = torch.topk(sb.reshape(b, nb * k), k, dim=-1)
    return top, ib.reshape(b, nb * k).gather(1, at)


def check_indexes(name, model, tt, device) -> dict:
    """The exact indexes on the trained towers: the candidate tower's
    embeddings of the distinct test movies (by encoded id; the ids as
    identifiers) and the query tower's of the first TT_QUERIES test pairs.
    BruteForce's top TT_K + 1 against Streaming's (batches of TT_STREAM, with
    identifiers), InMemoryStreaming's (chunks of TT_CHUNK) and the
    BruteForce rebuilt by save_index/load_index (under build/): scores
    within rtol 1e-6 plus 2 D u, the fp32 summation bound of two products
    of unit vectors (the loaded index: equal); ids equal at every place
    whose score lies farther than twice that from its neighbours' (the
    others tie). FactorizedTopK's hits with the index equal its hits with
    ``candidates=`` the corpus. Then the time of one query batch (TT_QUERIES
    queries, top TT_K) of each index, and of the selection alone on the
    (TT_QUERIES, N) scores, top TT_K + 1: the port's one torch.topk and
    JAX's two levels (:func:`two_level_top_k`, the same scores), from CUDA
    events."""
    from deep_recommenders_torch.models.retrieval import (
        BruteForce,
        FactorizedTopK,
        InMemoryStreaming,
        Streaming,
        load_index,
        save_index,
    )
    from deep_recommenders_torch.ops.topk import exact_top_k

    user, item, _ = tt["test"]
    _, first = np.unique(item["movie_id"], return_index=True)
    rows = slice(0, TT_QUERIES)
    model.eval()
    with torch.no_grad():
        corpus = model.candidate_tower(_on(device, item, first))
        qe, ce = model(_on(device, user, rows), _on(device, item, rows))
    ids = torch.from_numpy(item["movie_id"][first].astype(np.int64)).to(
        device)
    n, k = corpus.shape[0], TT_K + 1
    brute = BruteForce(device=device).index(corpus, ids)
    results = {"streaming": Streaming(lambda: (
        (ids[lo:lo + TT_STREAM], corpus[lo:lo + TT_STREAM])
        for lo in range(0, n, TT_STREAM)), device=device)(qe, k=k)}
    s, r = InMemoryStreaming(TT_CHUNK, device=device).index(corpus)(qe, k=k)
    results["in_memory"] = (s, ids[r])
    scratch = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        loaded = load_index(save_index(os.path.join(tmp, "index"), brute),
                            device=device)
        if loaded._candidates.device != corpus.device:
            raise AssertionError(f"{name}: loaded index on "
                                 f"{loaded._candidates.device}")
    ref_s, ref_i = brute(qe, k=k)
    tol = 1e-6 * ref_s.abs().max().item() + 2 * TT_DIM * U32
    gaps = ref_s[:, :-1] - ref_s[:, 1:]
    before = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                        gaps[:, :-1]], dim=1)
    isolated = (before > 2 * tol) & (gaps > 2 * tol)  # places 0..TT_K - 1
    errors = {}
    for other, (s, i) in results.items():
        errors[other] = (s - ref_s).abs().max().item()
        if errors[other] > tol or not torch.equal(
                i[:, :TT_K][isolated], ref_i[:, :TT_K][isolated]):
            raise AssertionError(f"{name}: {other} disagrees with "
                                 f"BruteForce: score err {errors[other]}")
    got = loaded(qe, k=k)
    errors["loaded"] = (got[0] - ref_s).abs().max().item()
    if not (torch.equal(got[0], ref_s) and torch.equal(got[1], ref_i)):
        raise AssertionError(f"{name}: the loaded index disagrees")
    with_index = FactorizedTopK(brute)
    with_corpus = FactorizedTopK()
    hits = with_index.update(with_index.init(device), qe, ce)["hits"]
    want = with_corpus.update(with_corpus.init(device), qe, ce,
                              candidates=corpus)["hits"]
    if not torch.equal(hits, want):
        raise AssertionError(f"{name}: FactorizedTopK hits {hits.tolist()} "
                             f"with the index, {want.tolist()} with the "
                             f"candidates")
    share = isolated.float().mean().item()
    stream = Streaming(lambda: (
        (ids[lo:lo + TT_STREAM], corpus[lo:lo + TT_STREAM])
        for lo in range(0, n, TT_STREAM)), device=device)
    in_memory = InMemoryStreaming(TT_CHUNK, device=device).index(corpus)
    query_ms = {key: time_ms(lambda: index(qe, k=TT_K), iters=20, warmup=3)
                for key, index in (("brute_force", brute),
                                   ("streaming", stream),
                                   ("in_memory_streaming", in_memory))}
    scores = qe @ corpus.T
    if not torch.equal(exact_top_k(scores, k)[0],
                       two_level_top_k(scores, k)[0]):
        raise AssertionError(f"{name}: torch.topk and the two-level "
                             f"selection disagree")
    select_ms = {key: time_ms(lambda: fn(scores, k), iters=20, warmup=3)
                 for key, fn in (("torch_topk", exact_top_k),
                                 ("two_level", two_level_top_k))}
    print(f"{name} indexes: N {n} movies, {TT_QUERIES} queries, top {TT_K}: "
          f"Streaming, InMemoryStreaming and the loaded BruteForce agree "
          f"(largest score errors {errors}, tolerance {tol:.3g}; ids equal "
          f"at the {share:.4f} of places without a tie); FactorizedTopK "
          f"hits {hits.tolist()} with the index and with candidates=; ms a "
          f"query batch {query_ms}; ms a selection of the top {k} of "
          f"({TT_QUERIES}, {n}) scores {select_ms}")
    return {"corpus": n, "isolated_share": share, "hits": hits.tolist(),
            "score_errors": errors, "tolerance": tol, "query_ms": query_ms,
            "select_ms": select_ms}


def two_tower_paths(tt: dict, device):
    """The zoo's two-tower (``two_tower``) and its bf16 score product
    (``two_tower_bf16``: ``Retrieval(compute_dtype=bfloat16)``), EPOCHS
    each through ``Trainer.fit_device`` with Adam at LEARNING_RATE on the
    train pairs (labels: the movie ids, unused by the plain task), the
    in-batch ``RetrievalEval`` on the test pairs: two fp32 K1 a train step
    (C = 32), none in an eval batch; the eval's metrics finite; the card
    against the CPU, forward (:func:`check_two_tower`) and one train step's
    gradients (:func:`check_two_tower_step`); the exact indexes
    (:func:`check_indexes`); a profile."""
    from deep_recommenders_torch.models.retrieval import Retrieval
    from deep_recommenders_torch.training import (
        RetrievalEval,
        retrieval_loss,
    )

    train = DeviceData.from_numpy(tt["train"][:2], tt["train"][2],
                                  TT_BATCH, device=device)
    test = DeviceData.from_numpy(tt["test"][:2], tt["test"][2], TT_BATCH,
                                 device=device)
    paths, results = {}, {}
    for name, dtype in (("two_tower", None),
                        ("two_tower_bf16", torch.bfloat16)):
        model = make_two_tower(tt["ds"]).to(device)
        task = Retrieval(compute_dtype=dtype)
        trainer, paths[name], final = train_path(
            name, model, train, test, EPOCHS, two_k1, device,
            loss_fn=retrieval_loss(model, task),
            eval_spec=RetrievalEval(model, task), quality=retrieval_quality)
        check_two_tower(name, model, make_two_tower(tt["ds"], seeded=False),
                        tt, task, device)
        step = check_two_tower_step(name, model, tt, task, device)
        indexes = check_indexes(name, model, tt, device)
        results[name] = {"eval": final, "indexes": indexes, "step": step,
                         "profile": trainer_profile(trainer, train, test)}
        print(f"{name} profile: " + json.dumps(results[name]["profile"]))
        del trainer, model
    del train, test
    torch.cuda.empty_cache()
    return paths, results


def two_tower_example_path():
    """The ported two-tower example at its defaults (1,000,209 ratings of
    the rank-power corpus, batch 1024, 5 epochs, temperature 0.1, Adagrad
    0.05, log-Q correction and accidental-negative removal, then
    FactorizedTopK over the full corpus of distinct test movies) on the
    card: two K1 a train step and none else; the loss finite; val_loss
    lower after the last epoch than after the first; the full-corpus
    top-100 accuracy above twice the chance rate 100 / N; a profile."""
    from deep_recommenders_torch.examples import (
        train_two_tower_on_movielens as ex,
    )

    name = "two_tower_example"
    reset_launches()
    result = ex.main(["--device", "cuda"])
    launches = read_launches()
    history, losses = result["history"], result["step_losses"]
    train = result["train_data"]
    n, metrics = result["corpus_size"], result["metrics"]
    chance = 100 / n
    top100 = metrics["top_100_categorical_accuracy"]
    print(f"{name} train: {len(losses)} steps of {train.batch_size}, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; val_loss by epoch "
          f"{[round(h['val_loss'], 6) for h in history]}; full corpus N {n},"
          f" chance top-100 {chance:.6f}, " + " ".join(
              f"{k}={v:.6f}" for k, v in metrics.items()))
    print(f"{name} launches: {launches}")
    want = {k: 0 for k in launches}
    want.update(two_k1(len(losses), 0))
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    if len(losses) != len(history) * train.steps_per_epoch \
            or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: {len(losses)} steps, loss finite "
                             f"{np.isfinite(losses).all()}")
    if not history[-1]["val_loss"] < history[0]["val_loss"]:
        raise AssertionError(f"{name}: val_loss did not fall: "
                             f"{[h['val_loss'] for h in history]}")
    if not top100 > 2 * chance:
        raise AssertionError(f"{name}: top-100 {top100} not above twice "
                             f"the chance rate {chance}")
    profile = trainer_profile(result["trainer"], train, result["eval_data"])
    print(f"{name} profile: " + json.dumps(profile))
    out = {"eval": history[-1], "metrics": metrics, "corpus": n,
           "profile": profile}
    del result
    torch.cuda.empty_cache()
    return launches, out


# -- serving, model artifacts, the approximate indexes and GCN (imported in
# each function: --wrapper-host-us also runs in a parent's tree, which has
# none of them) -----------------------------------------------------------------

# A second batch size for the polymorphic programs (the first is BATCH).
SERVE_BATCH_2 = 1000
# The zoo's index config (benchmarks/run_models.py:395-409): a 100,000 x 64
# N(0, 1) corpus, 4096 queries, top 100; IVF with 128 lists, probing 8, and
# InMemoryStreaming in chunks of 16384 candidates.
IX_CORPUS, IX_DIM, IX_QUERIES, IX_K = 100_000, 64, 4096, 100
IX_NLIST, IX_NPROBE, IX_CHUNK = 128, 8, 16384
# The full probe's (B, nprobe * cap, D) gather is held under this many bytes
# by querying in blocks of rows.
IX_GATHER_BYTES = 4e9


class Seq2Seq(torch.nn.Module):
    """The Transformer called on a batch dict {"inputs", "targets"}, as
    ``export_model`` calls a model."""

    def __init__(self, model: Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model(batch["inputs"], batch["targets"])


@contextlib.contextmanager
def cin2d_forward_bf16_on_cpu():
    """K4's forward on a CPU tensor as the card computes it
    (``cin2d_reference_bf16``), the layered model's counterpart of
    :func:`stack_forward_bf16_on_cpu`."""
    fp32 = ck.cin2d_forward
    ck.cin2d_forward = ck.cin2d_reference_bf16
    try:
        yield
    finally:
        ck.cin2d_forward = fp32


def serve_path(name, model, samples, op, expect, device, tmp,
               polymorphic=True, exact=True):
    """Export ``model`` on the card (``samples[0]`` the sample batch), load
    the artifact and serve each of ``samples``: the program's graph must
    hold the kernel op ``op`` (or none), each served batch must make
    exactly the launches ``expect`` (counters set to 0 just before it and
    read just after), and its output must equal the eager model's on the
    card bit for bit (``exact``: the same ops on the same inputs), or for
    K3, which pools with atomic adds in an order that varies from run to
    run, within rtol 1e-6 and atol 1e-6. Returns the served module and
    its numbers (ms a batch served and eager, from CUDA events)."""
    from deep_recommenders_torch.ops import custom_ops
    from deep_recommenders_torch.serving import (
        export_model,
        load_serving_module,
    )

    t0 = time.perf_counter()
    path = export_model(os.path.join(tmp, name), model, samples[0],
                        polymorphic_batch=polymorphic)
    export_s = time.perf_counter() - t0
    served = load_serving_module(path, device=device)
    ops = custom_ops.graph_ops(served.program.graph_module)
    if ops != ({op} if op else set()):
        raise AssertionError(f"{name}: the program calls {ops}, not {op}")
    model.eval()
    batches = []
    for batch in samples:
        reset_launches()
        out = served(batch)
        torch.cuda.synchronize()
        launches = read_launches()
        want = {k: 0 for k in launches}
        want.update(expect)
        if launches != want:
            raise AssertionError(f"{name}: a served batch launched "
                                 f"{launches}, expected {want}")
        with torch.no_grad():
            eager = model(batch)
        diff = (out - eager).abs().max().item()
        if exact and not torch.equal(out, eager):
            raise AssertionError(f"{name}: served and eager differ by {diff}")
        if not exact:
            torch.testing.assert_close(out, eager, rtol=1e-6, atol=1e-6)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: served output not finite")
        b = next(iter(batch.values())).shape[0]
        with torch.no_grad():
            batches.append({
                "batch": b, "max_abs_diff_eager": diff,
                "served_ms": time_ms(lambda: served(batch), iters=10,
                                     warmup=2),
                "eager_ms": time_ms(lambda: model(batch), iters=10,
                                    warmup=2)})
        del out, eager
    print(f"{name} served: program ops {sorted(ops)}, export "
          f"{export_s:.1f} s, launches a batch {expect}, per batch "
          f"{batches}")
    return served, {"ops": sorted(ops), "export_s": export_s,
                    "launches_per_batch": expect, "batches": batches}


def served_vs_cpu(name, served, cpu_model, rows, device, rtol, atol,
                  plain=contextlib.nullcontext):
    """The served program's output on 256 test rows against the plain CPU
    path on the same weights (under ``plain()``), at the tolerances of the
    train paths' logit checks."""
    on_card = served({k: v.to(device) for k, v in rows.items()}).cpu()
    cpu_model.eval()
    with torch.no_grad(), plain():
        on_cpu = cpu_model(rows)
    torch.testing.assert_close(on_card, on_cpu, rtol=rtol, atol=atol)
    diff = (on_card - on_cpu).abs().max().item()
    print(f"{name} served vs cpu: max abs diff {diff:.3g}")
    return diff


def trace_names_kernel(served, batch, kernel: str, tmp) -> list:
    """One served call under ``training.profiler.trace``: the names of the
    CUDA kernels its trace file holds that contain ``kernel``."""
    from deep_recommenders_torch.training import profiler

    logdir = os.path.join(tmp, "trace")
    with profiler.trace(logdir):
        served(batch)
        torch.cuda.synchronize()
    (path,) = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = sorted({e["name"] for e in events
                    if e.get("cat") == "kernel" and kernel in e["name"]})
    if not names:
        raise AssertionError(f"the trace names no kernel with {kernel!r}")
    return names


def serving_phase(ds: MovielensRanking, deepfm: DeepFM, imdb: SyntheticImdb,
                  device) -> dict:
    """Serving on the card: DeepFM (the trained model of the DeepFM path),
    the flagship xDeepFM (K3) and the layered one (K4) at seeded weights,
    each exported with a polymorphic batch and served at BATCH and
    SERVE_BATCH_2 test rows, and the Transformer (K5) in fp32 and bf16 at
    the zoo's width (seeded), exported at TX_BATCH x TX_LEN with a fixed
    batch (a polymorphic export raises ValueError: its attention's
    dispatch reads the batch size). Each against the eager model and the
    plain CPU path; one flagship call profiled. Returns the launches of
    one served batch by kernel, and the numbers."""
    feats, _ = ds.test_arrays()
    samples = [{k: torch.from_numpy(v[:n]).to(device)
                for k, v in feats.items()} for n in (BATCH, SERVE_BATCH_2)]
    rows = {k: torch.from_numpy(v[:256]) for k, v in feats.items()}
    scratch = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(scratch, exist_ok=True)
    out, launches = {}, {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        served, out["deepfm"] = serve_path("deepfm", deepfm, samples, None,
                                           {}, device, tmp)
        out["deepfm"]["cpu_diff"] = served_vs_cpu(
            "deepfm", served, _cpu_copy(deepfm, DeepFM(
                ds.feature_specs, EMBED_DIM, HIDDEN)), rows, device, 1e-4,
            1e-5)

        flagship = make_xdeepfm(ds, XDEEPFM_MAPS, device)
        served, out["xdeepfm"] = serve_path(
            "xdeepfm", flagship, samples, "cin_stack_fwd_pooled",
            {"cin_stack_pooled.fwd": 1}, device, tmp, exact=False)
        out["xdeepfm"]["cpu_diff"] = served_vs_cpu(
            "xdeepfm", served, _cpu_copy(flagship, XDeepFM(
                ds.feature_specs, EMBED_DIM, XDEEPFM_MAPS, "relu",
                XDEEPFM_HIDDEN)), rows, device, 1e-4, 2e-4,
            plain=stack_forward_bf16_on_cpu)
        out["xdeepfm"]["trace_kernels"] = trace_names_kernel(
            served, samples[1], "cin_stack_fwd", tmp)
        print(f"xdeepfm served under profiler.trace: kernels "
              f"{out['xdeepfm']['trace_kernels']}")
        launches["xdeepfm_served"] = out["xdeepfm"]["launches_per_batch"]
        del flagship, served

        layered = make_xdeepfm(ds, LAYERED_MAPS, device)
        served, out["xdeepfm_layered"] = serve_path(
            "xdeepfm_layered", layered, samples, "cin2d_fwd",
            {"cin2d.fwd": len(LAYERED_MAPS)}, device, tmp)
        out["xdeepfm_layered"]["cpu_diff"] = served_vs_cpu(
            "xdeepfm_layered", served, _cpu_copy(layered, XDeepFM(
                ds.feature_specs, EMBED_DIM, LAYERED_MAPS, "relu",
                XDEEPFM_HIDDEN)), rows, device, 1e-4, 2e-4,
            plain=cin2d_forward_bf16_on_cpu)
        launches["xdeepfm_layered_served"] = out["xdeepfm_layered"][
            "launches_per_batch"]
        del layered, served

        tokens = torch.from_numpy(imdb.test[0][:TX_BATCH]).to(device)
        inp, tgt_in, _, _ = copy_task(tokens)
        sample = {"inputs": inp, "targets": tgt_in}
        for dtype, key in ((None, "transformer_seq2seq"),
                           (torch.bfloat16, "transformer_seq2seq_bf16")):
            from deep_recommenders_torch.serving import export_model

            model = Seq2Seq(make_transformer(device, dtype))
            try:
                export_model(os.path.join(tmp, "polymorphic"), model, sample)
            except ValueError as err:
                refused = str(err).split(":")[0]
            else:
                raise AssertionError(f"{key}: a polymorphic export of the "
                                     "Transformer on the card did not raise")
            fwd = flash_keys(dtype)[0]
            op = ("flash_attention_fwd_bf16" if dtype else
                  "flash_attention_fwd")
            served, out[key] = serve_path(
                key, model, [sample], op, {fwd: 6}, device, tmp,
                polymorphic=False)
            out[key]["polymorphic_refused"] = refused
            with torch.no_grad():
                on_card = served(sample)[:8].cpu()
            out[key]["cpu_diff"] = transformer_rows_vs_cpu(
                key, model.model, on_card, inp[:8], tgt_in[:8], dtype)
            launches[key + "_served"] = {fwd: 6}
            del model, served, on_card
            torch.cuda.empty_cache()
    return launches, out


def _cpu_copy(model: torch.nn.Module, cpu_model: torch.nn.Module):
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    return cpu_model


def transformer_rows_vs_cpu(name, model, on_card, inp, tgt_in, dtype):
    """Served logits of 8 rows against the plain CPU path on the same
    weights, by :func:`check_transformer_logits`'s rules: fp32 within rtol
    1e-4 and atol 1e-3; bf16 nearer the CPU's bf16 logits than those lie
    to its fp32 ones."""
    cpu_model = make_transformer("cpu", dtype)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with torch.no_grad():
        on_cpu = cpu_model(inp.cpu(), tgt_in.cpu())
    diff = (on_card - on_cpu).abs().max().item()
    if dtype is None:
        torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-3)
    else:
        fp32_model = make_transformer("cpu")
        fp32_model.load_state_dict(cpu_model.state_dict())
        with torch.no_grad():
            gap = (on_cpu - fp32_model(inp.cpu(), tgt_in.cpu())
                   ).abs().max().item()
        if not diff < gap:
            raise AssertionError(f"{name}: served vs cpu {diff}, cpu bf16 "
                                 f"vs fp32 {gap}")
    print(f"{name} served vs cpu (8 rows): max abs diff {diff:.3g}")
    return diff


def model_io_cases(device):
    """The zoo cases of tests/test_model_io.py:52-157 in the port: (name,
    the model seeded, its inputs on ``device``); the port's constructors
    take the input widths flax infers."""
    from deep_recommenders_torch.features.columns import (
        CrossedFeature,
        Feature,
    )
    from deep_recommenders_torch.models.multitask import ESMM, MMoE
    from deep_recommenders_torch.models.ranking import (
        DCN,
        DIN,
        FNN,
        FactorizationMachine,
        WideDeep,
    )
    from deep_recommenders_torch.models.retrieval import GCN, TwoTower

    rng = np.random.default_rng(SEED)
    specs = (Feature("user", hash_buckets=50),
             Feature("gender", vocab=("F", "M")),
             Feature("item", hash_buckets=60),
             Feature("tags", vocab=tuple(range(7)), max_len=3))

    def ids(b=8):
        return {"user": rng.integers(0, 50, b), "gender": rng.integers(0, 3, b),
                "item": rng.integers(0, 60, b),
                "tags": rng.integers(0, 8, (b, 3))}

    def on(batch):
        return {k: torch.from_numpy(v.astype(np.float32 if k.endswith("__wt")
                                             else np.int32)).to(device)
                for k, v in batch.items()}

    def id_batch():
        return (on({**ids(), "tags__wt": rng.random((8, 3)) < 0.8}),)

    def dense(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)

    cross = CrossedFeature("gxi", ("gender", "item"), hash_buckets=40)
    cases = [
        ("deepfm", lambda g: DeepFM(specs, 8, (16,), generator=g), id_batch),
        ("fm", lambda g: FactorizationMachine(specs, 8, generator=g),
         id_batch),
        ("fnn", lambda g: FNN(specs, 8, (16,), generator=g), id_batch),
        ("widedeep", lambda g: WideDeep(specs, specs + (cross,), 8, (16,),
                                        generator=g),
         lambda: (on({**ids(), "tags__wt": rng.random((8, 3)) < 0.8,
                      "gxi": rng.integers(0, 40, 8)}),)),
        ("dcn", lambda g: DCN(specs, 8, 2, 4, (16,), generator=g), id_batch),
        ("xdeepfm", lambda g: XDeepFM(specs, 8, (8,), hidden=(16,),
                                      generator=g), id_batch),
        ("xdeepfm_stack", lambda g: XDeepFM(specs, 8, (6, 6), hidden=(16,),
                                            generator=g), id_batch),
        ("mmoe", lambda g: MMoE(16, 2, 3, (16,), 8, (8,), generator=g),
         lambda: (dense(8, 16),)),
        ("esmm", lambda g: ESMM(16, (16,), (16,), generator=g),
         lambda: (dense(8, 16),)),
        ("gcn", lambda g: GCN(12, (8,), 3, 0.0, generator=g),
         lambda: (dense(10, 12), torch.eye(10, device=device))),
        ("transformer", lambda g: Transformer(30, 16, 2, 1, 1, 32,
                                              dropout=0.0, generator=g),
         lambda: tuple(torch.from_numpy(rng.integers(1, 30, s)).to(device)
                       for s in ((2, 6), (2, 5)))),
        ("two_tower", lambda g: TwoTower(specs[:2], specs[2:], 8, (16,), 8,
                                         generator=g),
         lambda: (on({k: v for k, v in ids().items()
                      if k in ("user", "gender")}),
                  on({"item": rng.integers(0, 60, 8),
                      "tags": rng.integers(0, 8, (8, 3)),
                      "tags__wt": np.ones((8, 3))}))),
        ("din", lambda g: DIN(8, (16,), True, embedding_dim=8, generator=g),
         lambda: (dense(4, 5, 8), torch.ones(4, 5, device=device),
                  dense(4, 8))),
    ]
    return [(name, build(torch.Generator().manual_seed(SEED)).to(device),
             inputs()) for name, build, inputs in cases]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def model_io_phase(device) -> dict:
    """``save_model`` and ``load_model`` on the card for the 13 zoo cases:
    the reloaded model's class and config must equal the saved one's, and
    its predictions the saved model's bit for bit, but for the fused
    xDeepFM stack, whose K3 pools with atomic adds (within rtol 1e-6 and
    atol 1e-6)."""
    from deep_recommenders_torch.serving import (
        load_model,
        model_config,
        save_model,
    )

    scratch = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(scratch, exist_ok=True)
    diffs = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for name, model, inputs in model_io_cases(device):
            model.eval()
            with torch.no_grad():
                before = _flat(model(*inputs))
            loaded = load_model(save_model(os.path.join(tmp, name), model),
                                device=device).eval()
            if type(loaded) is not type(model) or \
                    model_config(loaded) != model_config(model):
                raise AssertionError(f"model_io {name}: the config differs")
            with torch.no_grad():
                after = _flat(loaded(*inputs))
            diffs[name] = max((a - b).abs().max().item()
                              for a, b in zip(before, after))
            for a, b in zip(before, after):
                if name == "xdeepfm_stack":
                    torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
                elif not torch.equal(a, b):
                    raise AssertionError(f"model_io {name}: predictions "
                                         f"differ by {diffs[name]}")
    print(f"model_io on the card: {len(diffs)} zoo models saved and "
          f"reloaded, max abs diff of the predictions {diffs}")
    return diffs


def index_phase(device) -> dict:
    """The approximate indexes at the zoo's index config: ApproxTopK and
    IVF(nlist=128, nprobe=128) against BruteForce (scores within rtol 1e-6
    plus 2 D u, the fp32 bound of two sums of the D products; ids equal at
    every place whose score lies farther than twice that from its
    neighbours'; ApproxTopK computes BruteForce's product and selection:
    equal), IVF(128, 8)'s recall@100 against the exact ids, kmeans on the
    card against the CPU from the same init, both index files through
    save_index/load_index (equal results), and queries/s of BruteForce,
    InMemoryStreaming(16384), ApproxTopK and IVF(128, 8), with IVF's bucket
    cap, the bytes of its (B, nprobe * cap, D) gather and the peak
    memory of a query batch."""
    from deep_recommenders_torch.models.retrieval import (
        IVF,
        ApproxTopK,
        BruteForce,
        InMemoryStreaming,
        kmeans,
        load_index,
        save_index,
    )

    rng = np.random.default_rng(SEED)
    corpus = rng.normal(0, 1, (IX_CORPUS, IX_DIM)).astype(np.float32)
    queries = torch.from_numpy(rng.normal(0, 1, (IX_QUERIES, IX_DIM)).astype(
        np.float32)).to(device)
    k = IX_K
    t0 = time.perf_counter()
    brute = BruteForce(device=device).index(corpus)
    approx = ApproxTopK(device=device).index(corpus)
    full = IVF(IX_NLIST, IX_NLIST, device=device).index(corpus)
    ivf = IVF(IX_NLIST, IX_NPROBE, device=device).index(corpus)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ref_s, ref_i = brute(queries, k=k)
    tol = 1e-6 * ref_s.abs().max().item() + 2 * IX_DIM * U32
    gaps = ref_s[:, :-1] - ref_s[:, 1:]
    isolated = torch.cat([gaps[:, :1] > 2 * tol, (gaps[:, 1:] > 2 * tol)
                          & (gaps[:, :-1] > 2 * tol)], dim=1)
    s, i = approx(queries, k=k)
    if not (torch.equal(s, ref_s) and torch.equal(i, ref_i)):
        raise AssertionError("ApproxTopK disagrees with BruteForce")
    # The full probe gathers nlist * cap rows a query: blocks of queries.
    block = max(1, int(IX_GATHER_BYTES // (IX_NLIST * full.cap * IX_DIM * 4)))
    parts = [full(queries[lo:lo + block], k=k)
             for lo in range(0, IX_QUERIES, block)]
    s = torch.cat([p[0] for p in parts])
    i = torch.cat([p[1] for p in parts])
    full_err = (s - ref_s).abs().max().item()
    if full_err > tol or not torch.equal(i[:, :-1][isolated],
                                         ref_i[:, :-1][isolated]):
        raise AssertionError(f"IVF({IX_NLIST}, {IX_NLIST}) disagrees with "
                             f"BruteForce: score err {full_err}, tol {tol}")
    s, i = ivf(queries, k=k)
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(
        i.cpu().tolist(), ref_i.cpu().tolist())])
    if not (0.0 < recall <= 1.0 and bool(torch.isfinite(s).all())):
        raise AssertionError(f"IVF({IX_NLIST}, {IX_NPROBE}): recall {recall}")

    # kmeans on the card against the CPU from the same init: after one
    # iteration (only near ties may assign apart) and after ten (a flipped
    # point moves its centroids, and the runs may drift apart).
    init = corpus[np.random.default_rng(0).choice(IX_CORPUS, IX_NLIST,
                                                  replace=False)]
    kmeans_fields = {}
    for iters in (1, 10):
        c_card, a_card = kmeans(torch.from_numpy(corpus).to(device),
                                torch.from_numpy(init).to(device), IX_NLIST,
                                iters)
        c_cpu, a_cpu = kmeans(torch.from_numpy(corpus),
                              torch.from_numpy(init), IX_NLIST, iters)
        kmeans_fields[f"iters_{iters}"] = {
            "centroid_max_dist": (c_card.cpu() - c_cpu).norm(dim=1).max(
            ).item(),
            "assignments_agree": (a_card.cpu() == a_cpu).float().mean(
            ).item()}
    if not kmeans_fields["iters_1"]["assignments_agree"] > 0.999:
        raise AssertionError(f"kmeans card vs cpu: {kmeans_fields}")

    scratch = os.path.dirname(_build.BUILD_DIR)
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for name, index in (("approx", approx), ("ivf", ivf)):
            loaded = load_index(save_index(os.path.join(tmp, name), index),
                                device=device)
            a, b = index(queries, k=k), loaded(queries, k=k)
            if type(loaded) is not type(index) or not (
                    torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{name}: the loaded index disagrees")

    stream = InMemoryStreaming(IX_CHUNK, device=device).index(corpus)
    qps, peak = {}, {}
    for name, index in (("BruteForce", brute),
                        ("InMemoryStreaming", stream),
                        ("ApproxTopK", approx), ("IVF", ivf)):
        ms = time_ms(lambda: index(queries, k=k), iters=10, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        index(queries, k=k)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
        qps[name] = {"ms": ms, "queries_per_s": IX_QUERIES / ms * 1e3}
    fields = {
        "corpus": IX_CORPUS, "dim": IX_DIM, "queries": IX_QUERIES, "k": k,
        "build_s": build_s, "tolerance": tol, "ivf_full_probe_err": full_err,
        "ivf_full_probe_block": block,
        "isolated_share": isolated.float().mean().item(),
        "ivf_recall_at_100": recall, "ivf_cap": ivf.cap,
        "ivf_gather_bytes": IX_QUERIES * IX_NPROBE * ivf.cap * IX_DIM * 4,
        "kmeans": kmeans_fields, "query": qps, "peak_bytes_over_index": peak}
    print("indexes " + json.dumps(fields))
    del brute, approx, full, ivf, stream
    torch.cuda.empty_cache()
    return fields


def gcn_phase(device) -> dict:
    """The ported GCN example at its defaults (synthetic Cora, 200 epochs,
    Adam 0.01, hidden 16), dense and with --sparse-adjacency: test
    accuracy above 0.95 each; the dense run's trained model with the
    sparse adjacency against the dense one (the sparse product's row sums
    add with atomics: within rtol 1e-5 and atol 1e-6); and one Adam step
    without dropout from the seeded weights, on the card and on the CPU:
    the logits after it within rtol 1e-4 and atol 1e-5, as the CTR
    paths' logits."""
    from deep_recommenders_torch.datasets import Cora
    from deep_recommenders_torch.examples import train_gcn_on_cora
    from deep_recommenders_torch.models.retrieval import GCN
    from deep_recommenders_torch.ops.sparse import SparseAdjacency
    from deep_recommenders_torch.training.losses import softmax_cross_entropy

    out = {}
    for key, argv in (("dense", []), ("sparse", ["--sparse-adjacency"])):
        t0 = time.perf_counter()
        result = train_gcn_on_cora.main(argv)
        torch.cuda.synchronize()
        out[key] = {"test_accuracy": result["test_accuracy"],
                    "final_loss": result["losses"][-1],
                    "wall_s": time.perf_counter() - t0}
        if not result["test_accuracy"] > 0.95:
            raise AssertionError(f"gcn {key}: test accuracy "
                                 f"{result['test_accuracy']}")
        if key == "dense":
            model, x, adj = (result[n] for n in ("model", "features",
                                                  "adjacency"))
            with torch.no_grad():
                dense = model(x, adj)
                sparse = model(x, SparseAdjacency.from_dense(adj).to(device))
            torch.testing.assert_close(sparse, dense, rtol=1e-5, atol=1e-6)
            out["dense_vs_sparse"] = (sparse - dense).abs().max().item()

    cora = Cora(seed=SEED)
    labels, mask = cora.splits()["train"]
    logits = {}
    for key, dev in (("card", device), ("cpu", torch.device("cpu"))):
        gen = torch.Generator().manual_seed(SEED)
        model = GCN(cora.features.shape[1], generator=gen).to(dev)
        x = torch.from_numpy(cora.features).to(dev)
        adj = torch.from_numpy(cora.spectral_adjacency).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=0.01)
        softmax_cross_entropy(model(x, adj), torch.from_numpy(labels).to(dev),
                              mask=torch.from_numpy(mask).float().to(dev)
                              ).backward()
        opt.step()
        with torch.no_grad():
            logits[key] = model(x, adj).cpu()
    torch.testing.assert_close(logits["card"], logits["cpu"], rtol=1e-4,
                               atol=1e-5)
    out["step_card_vs_cpu"] = (logits["card"] - logits["cpu"]).abs().max(
    ).item()
    print("gcn " + json.dumps(out))
    return out


def wrapper_host_us(device) -> dict:
    """The host's us a call of the forward wrappers K3 (flagship rows), K4
    (H = 128) and K5 (fp32, bf16) at the main paths' shapes, on seeded
    inputs: the median of five :func:`host_us` runs of 20 calls. Calls only
    what every tree since K5's bf16 instance has (a parent's tree, with
    this script copied in, times the parent)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    r, f0, m = BATCH * EMBED_DIM, 6, 128
    x0 = torch.randn(r, f0, device=device, generator=gen)
    x0b = x0.bfloat16()
    w1 = torch.randn(f0, f0, m, device=device, generator=gen) * 0.05
    w2 = torch.randn(f0, m, m, device=device, generator=gen) * 0.05
    xv = torch.randn(r, m, device=device, generator=gen)
    bh, s, d = TX_BATCH * TX_HEADS, TX_LEN, TX_DIM // TX_HEADS
    q = torch.randn(bh, s, d, device=device, generator=gen)
    mask = torch.ones(bh, s, device=device)
    qb = q.bfloat16()
    calls = {
        "cin_stack_pooled.fwd": lambda: ck.stack_forward(x0b, w1, w2,
                                                         EMBED_DIM),
        "cin2d.fwd": lambda: ck.cin2d_forward(x0, xv, w2),
        "flash_attention.fwd": lambda: att.flash_attention(q, q, q, mask),
        "flash_attention_bf16.fwd": lambda: att.flash_attention(qb, qb, qb,
                                                                mask),
    }
    return {name: float(np.median([host_us(fn) for _ in range(5)]))
            for name, fn in calls.items()}


# -- the native ETL and loader; the mesh ------------------------------------

# Steps of each model in each two-rank mesh: the train split's whole
# batches (160,000 rows of NUM_RATINGS, in batches of BATCH).
MESH_STEPS = 19
# The two-rank meshes, (data, model).
MESH_CONFIGS = ((1, 2), (2, 1))
# The first step's loss and each gradient against the unmeshed run on the
# card: relative error (a gradient's in norm). All MESH_STEPS losses: the
# looser bound, after that many Adam steps in another summation order.
MESH_FIRST_STEP_RTOL = 1e-5
MESH_LOSSES_RTOL = 1e-3
# The one-rank NCCL mesh runs every op of the unmeshed path on the same
# values and all-reduces over groups of one: its per-step losses are
# expected equal; they are held to this.
MESH_ONE_RANK_RTOL = 1e-6


# The meshed models of the two-rank phase: the two-tower at the zoo's width
# (TT_*) for MESH_STEPS steps of TT_BATCH pairs; ShardedBruteForce over the
# index phase's corpus (IX_*); MMoE at its example's defaults, expert
# parallel; DeepFM at the bench width through sharded checkpoints
# (CKPT_EPOCHS, resumed after the first) and load_model(mesh=). Scores of
# ShardedBruteForce against BruteForce: relative; a meshed artifact's
# logits against the unmeshed load: relative.
MMOE_INPUT, MMOE_BATCH, MMOE_EXPERTS = 256, 512, 4
MMOE_EXPERT_HIDDEN, MMOE_EXPERT_DIM, MMOE_TOWER = (256,), 128, (64,)
CKPT_EPOCHS = 2
SHARDED_SCORES_RTOL = 1e-6
LOAD_MODEL_RTOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def native_phase(ds: MovielensRanking, device) -> dict:
    """The port's native library, built with g++ here (the run fails if it
    cannot be built); ``crc32_bucket`` and ``pack_bags`` on the data
    phase's corpus against their Python versions; then DeepFM at the bench
    width fed by ``NativeStreamLoader`` (``shuffle=False``) through
    ``Trainer.fit``, one epoch: each batch equal to the numpy slice of the
    train split at its step, one K1 per step, a finite, falling loss."""
    native.library()  # built at first use (the data phase's hashing)
    raw = synthesize_ml1m(NUM_RATINGS, seed=SEED)
    buckets = ds.feature_specs[0].hash_buckets
    got = native.crc32_bucket(raw["UserID"], buckets)
    want = np.asarray([zlib.crc32(str(v).encode("utf-8")) % buckets
                       for v in raw["UserID"]], np.int32)
    if not np.array_equal(got, want):
        raise AssertionError("native crc32_bucket differs from zlib")
    index = {g: i for i, g in enumerate(GENRES_VOCAB)}
    bags = [[index[g] for g in genres] for genres in raw["Genres"]]
    offsets = np.zeros(len(bags) + 1, np.int64)
    np.cumsum([len(b) for b in bags], out=offsets[1:])
    ids, wt = native.pack_bags(
        np.asarray([i for b in bags for i in b], np.int32), offsets,
        MAX_GENRES)
    want_ids = np.zeros((len(bags), MAX_GENRES), np.int32)
    want_wt = np.zeros((len(bags), MAX_GENRES), np.float32)
    for r, bag in enumerate(bags):
        bag = bag[:MAX_GENRES]
        want_ids[r, :len(bag)] = bag
        want_wt[r, :len(bag)] = 1.0
    if not (np.array_equal(ids, want_ids) and np.array_equal(wt, want_wt)):
        raise AssertionError("native pack_bags differs from its Python loop")

    feats, labels = ds.train_arrays()
    model = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN,
                   generator=torch.Generator().manual_seed(SEED))
    bce = bce_loss(model)
    losses = []

    def loss_fn(batch, y):
        loss = bce(batch, y)
        losses.append(loss.detach())
        return loss

    trainer = Trainer(model, torch.optim.Adam(model.parameters(),
                                              lr=LEARNING_RATE),
                      loss_fn=loss_fn, device=device)
    with native.NativeStreamLoader(feats, labels, BATCH,
                                   shuffle=False) as loader:
        def batches():  # a factory with no argument, as JAX's fit takes
            for s in range(loader.steps_per_epoch):
                f, y = loader.next_batch()
                rows = slice(s * BATCH, (s + 1) * BATCH)
                if not (all(np.array_equal(f[k], feats[k][rows])
                            for k in feats)
                        and np.array_equal(y, labels[rows])):
                    raise AssertionError(f"native loader: batch {s} is not "
                                         "the split's rows in order")
                yield f, y

        reset_launches()
        result = trainer.fit(batches, epochs=1, verbose=False)
        torch.cuda.synchronize()
        launches = read_launches()
        steps = loader.steps_per_epoch
    losses = torch.stack(losses).cpu().numpy()
    want = {k: 0 for k in launches}
    want["scatter_add_rows"] = steps
    if launches != want or len(losses) != steps:
        raise AssertionError(f"native: launches {launches}, expected {want}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"native: loss not finite and falling: {losses}")
    out = {"library": os.path.basename(native.library_path()),
           "crc32_bucket_rows": len(got),
           "pack_bags_rows": len(bags), "steps": steps,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "examples": result["examples"],
           "examples_per_sec": result["examples_per_sec"]}
    print("native " + json.dumps(out))
    print(f"native_deepfm launches: {launches}")
    return launches


def mesh_one_rank_phase(ds: MovielensRanking, device) -> dict:
    """A process group of one on NCCL, a (data=1, model=1) mesh, and
    DeepFM at the bench width through ``Trainer(mesh=).fit_device`` for one
    epoch over ``DeviceData.from_numpy(mesh=)``: one K1 per step, three
    NCCL all-reduces per step (the rows over "model", the linear weights'
    gradient over "model", the gradients and the loss over "data"), and
    per-step losses equal to the unmeshed run's from the same weights on
    the same batches."""
    parallel.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                    device=device.type)
    try:
        backend = parallel.distributed.BACKENDS[device.type]
        if dist.get_backend() != backend:
            raise AssertionError(f"backend {dist.get_backend()}, not "
                                 f"{backend}")
        mesh = parallel.create_mesh(parallel.MeshConfig(data=1, model=1),
                                    device=device.type)
        state = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN,
                       generator=torch.Generator().manual_seed(SEED)
                       ).state_dict()
        plain = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN)
        plain.load_state_dict(state)
        train = DeviceData.from_numpy(*ds.train_arrays(), BATCH,
                                      device=device)
        want = Trainer(plain, torch.optim.Adam(plain.parameters(),
                                               lr=LEARNING_RATE),
                       device=device).fit_device(
            train, epochs=1, shuffle_seed=SEED, verbose=False)["step_losses"]
        meshed = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN, mesh=mesh)
        meshed.load_state_dict(convert.shard_state(state, 1, 0))
        trainer = Trainer(meshed, torch.optim.Adam(meshed.parameters(),
                                                   lr=LEARNING_RATE),
                          mesh=mesh, device=device)
        mtrain = DeviceData.from_numpy(*ds.train_arrays(), BATCH,
                                       device=device, mesh=mesh)
        reset_launches()
        calls = all_reduce.calls
        got = trainer.fit_device(mtrain, epochs=1, shuffle_seed=SEED,
                                 verbose=False)
        torch.cuda.synchronize()
        launches = read_launches()
        calls = all_reduce.calls - calls
        losses = got["step_losses"]
        steps = len(losses)
    finally:
        dist.destroy_process_group()
    expect = {k: 0 for k in launches}
    expect["scatter_add_rows"] = steps
    if launches != expect:
        raise AssertionError(f"mesh_nccl: launches {launches}, "
                             f"expected {expect}")
    if calls != 3 * steps:
        raise AssertionError(f"mesh_nccl: {calls} all-reduces in {steps} "
                             "steps, expected 3 a step")
    err = float(np.max(np.abs(losses - want) / np.abs(want)))
    if len(losses) != len(want) or not err <= MESH_ONE_RANK_RTOL:
        raise AssertionError(f"mesh_nccl: losses {losses} vs unmeshed "
                             f"{want}")
    out = {"steps": steps, "all_reduces_per_step": calls / steps,
           "loss_max_rel_err": err, "loss_bitwise_equal":
           bool(np.array_equal(losses, want)),
           "examples_per_sec": got["examples_per_sec"]}
    print("mesh_nccl " + json.dumps(out))
    print(f"mesh_nccl_deepfm launches: {launches}")
    return launches


def _mesh_model(name: str, specs, mesh=None):
    gen = torch.Generator().manual_seed(SEED)
    if name == "deepfm":
        return DeepFM(specs, EMBED_DIM, HIDDEN, mesh=mesh, generator=gen)
    return XDeepFM(specs, EMBED_DIM, XDEEPFM_MAPS, "relu", XDEEPFM_HIDDEN,
                   mesh=mesh, generator=gen)


def _mesh_steps(trainer, batches):
    """MESH_STEPS train steps: the losses, the first step's gradients (on
    the host) and the mean time of a step after the first (ms, host clock
    to a synchronise; the first step warms the libraries up)."""
    losses = [trainer.train_step(*batches[0])]
    grads = {k: p.grad.detach().cpu()
             for k, p in trainer.model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, y in batches[1:]:
        losses.append(trainer.train_step(b, y))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    return torch.stack(losses).cpu().numpy(), grads, step_ms


def _k1_times(model, batch, specs, lo: int, rows: int,
              width: int = EMBED_DIM + 1) -> dict:
    """K1's device time on the big-vocab ids of a batch as a table of
    ``rows`` rows starting at ``lo`` sees them (ids off the shard at local
    row 0, as ``embedding/sharded.py`` sends them), g of the fused table's
    ``width`` (DeepFM's: its embeddings and linear weights): the hot row
    0's count beside it."""
    offsets = model.embeddings.feature_offsets
    ids = torch.stack([batch[s.name] + o for s, o in zip(specs, offsets)
                       if s.cardinality > SMALL_VOCAB_MAX
                       and not s.is_multi], dim=1).reshape(-1) - lo
    ok = (ids >= 0) & (ids < rows)
    local = torch.where(ok, ids, 0)
    g = torch.randn(local.shape[0], width, device=local.device)
    ms = graph_ms(lambda: scatter_add_rows(g, local, rows))
    return {"ms": ms, "ids": int(local.shape[0]), "rows": rows,
            "resident": int(ok.sum()),
            "row0_count": int((local == 0).sum())}


def _tower_specs():
    specs = default_movielens_features()
    return (tuple(f for f in specs if f.name in MovielensRanking.USER_KEYS),
            tuple(f for f in specs if f.name in MovielensRanking.ITEM_KEYS))


def _two_tower(mesh=None):
    from deep_recommenders_torch.models.retrieval import TwoTower

    return TwoTower(*_tower_specs(), TT_DIM, TT_HIDDEN, TT_DIM, mesh=mesh)


def _tt_batches(tmp: str, device, rows=None):
    """The two-tower's MESH_STEPS batches ((user, movie) dicts, labels:
    each pair's movie id and its sampling probability), at ``rows`` of
    each global batch (all by default)."""
    with np.load(os.path.join(tmp, "tt.npz")) as f:
        data = {k: f[k] for k in f.files}
    rows = rows or slice(0, TT_BATCH)
    out = []
    for s in range(MESH_STEPS):
        lo = s * TT_BATCH
        part = slice(lo + rows.start, lo + rows.stop)
        pick = {k: torch.from_numpy(v[part]).to(device)
                for k, v in data.items()}
        user = {k[2:]: v for k, v in pick.items() if k.startswith("u/")}
        item = {k[2:]: v for k, v in pick.items() if k.startswith("i/")}
        out.append(((user, item), {"candidate_ids": pick["ids"],
                                   "sampling_prob": pick["prob"]}))
    return out


def _tt_trainer(model, task, mesh, device):
    from deep_recommenders_torch.training import retrieval_loss

    return Trainer(model, torch.optim.Adam(model.parameters(),
                                           lr=LEARNING_RATE),
                   loss_fn=retrieval_loss(model, task), mesh=mesh,
                   device=device)


def _options_step(trainer, batch):
    """One step with the log-Q correction and accidental-negative
    removal: its loss and gradients (on the host)."""
    loss = trainer.train_step(*batch)
    return float(loss), {k: p.grad.detach().cpu()
                         for k, p in trainer.model.named_parameters()}


def _mmoe(expert_parallel: bool = False):
    from deep_recommenders_torch.models.multitask import MMoE

    return MMoE(MMOE_INPUT, 2, MMOE_EXPERTS, MMOE_EXPERT_HIDDEN,
                MMOE_EXPERT_DIM, MMOE_TOWER, expert_parallel=expert_parallel)


def _mmoe_step(model, mesh, x, y, device):
    """One SGD step at lr 0 of the summed two-task MSE: its loss and
    gradients (on the host)."""
    from deep_recommenders_torch.training import multitask_mse_loss

    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.0),
                      loss_fn=multitask_mse_loss(model), mesh=mesh,
                      device=device)
    loss = trainer.train_step(x, y)
    return float(loss), {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()}


def _ckpt_deepfm(mesh, tmp):
    model = DeepFM(default_movielens_features(), EMBED_DIM, HIDDEN,
                   mesh=mesh)
    state = torch.load(os.path.join(tmp, "deepfm_init.pt"))
    n_model = parallel.axis_size(mesh, "model")
    model.load_state_dict(convert.shard_state(
        state, n_model, parallel.axis_index(mesh, "model")))
    return model, torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)


def mesh_rank_models(rank: int, mesh, tmp: str) -> dict:
    """This rank's meshed models in ``mesh_two_rank_phase``, at both meshes:
    the two-tower with pod-wide negatives (MESH_STEPS steps and their K1
    launches, the first step's gradients, one step with the options, step
    times and K1's time on the query tower's shard). At (1, 2) also:
    ShardedBruteForce over the index corpus and a load_index(mesh=) round
    trip; MMoE expert parallel, one step; DeepFM's CKPT_EPOCHS epochs of
    fit_device at once, and again through a sharded checkpoint resumed by
    a fresh model; load_model(mesh=) of the unmeshed artifact. At (2, 1):
    the (1, 2) checkpoint restored."""
    from deep_recommenders_torch.models.retrieval import (
        Retrieval,
        ShardedBruteForce,
        load_index,
        save_index,
    )
    from deep_recommenders_torch.models.multitask import shard_expert_params
    from deep_recommenders_torch.serving.model_io import load_model
    from deep_recommenders_torch.training import restore_train_state

    n_data = parallel.axis_size(mesh, "data")
    n_model = parallel.axis_size(mesh, "model")
    d = parallel.axis_index(mesh, "data")
    key = f"{n_data}x{n_model}"
    device = parallel.sharding.mesh_device(mesh)
    b = TT_BATCH // n_data
    batches = _tt_batches(tmp, device, slice(d * b, (d + 1) * b))
    state = torch.load(os.path.join(tmp, "tt_init.pt"))
    m = parallel.axis_index(mesh, "model")
    out = {}

    model = _two_tower(mesh)
    model.load_state_dict(convert.shard_state(state, n_model, m))
    task = Retrieval(axis_name="data", mesh=mesh)
    trainer = _tt_trainer(model, task, mesh, device.type)
    reset_launches()
    losses, grads, step_ms = _mesh_steps(
        trainer, [(bt, None) for bt, _ in batches])
    launches = read_launches()
    torch.save(grads, os.path.join(tmp, f"rank{rank}_{key}_tt.pt"))
    tt = {"losses": losses.tolist(), "launches": launches,
          "step_ms": step_ms, "local_rows": b}
    lo = m * model.query_tower.embeddings.table.shape[0]
    for r in range(2):  # one rank at a time: the two share the card
        if r == rank:
            tt["k1"] = _k1_times(
                model.query_tower, batches[0][0][0], _tower_specs()[0], lo,
                model.query_tower.embeddings.table.shape[0], TT_DIM)
        dist.barrier()
    model = _two_tower(mesh)
    model.load_state_dict(convert.shard_state(state, n_model, m))
    options = Retrieval(remove_accidental_negatives=True, axis_name="data",
                        mesh=mesh)
    loss, grads = _options_step(_tt_trainer(model, options, mesh, device.type),
                                batches[0])
    tt["options_loss"] = loss
    torch.save(grads, os.path.join(tmp, f"rank{rank}_{key}_tt_options.pt"))
    out[f"{key}_two_tower"] = tt
    del model, trainer, batches
    if (n_data, n_model) == (2, 1):
        model, opt = _ckpt_deepfm(mesh, tmp)
        restore_train_state(os.path.join(tmp, "ckpt", "step_0"), model, opt,
                            mesh)
        torch.save({"model": model.state_dict(),
                    "optimizer": opt.state_dict()},
                   os.path.join(tmp, f"rank{rank}_restored.pt"))
        return out

    # ShardedBruteForce over the index phase's corpus.
    rng = np.random.default_rng(SEED)
    corpus = torch.from_numpy(rng.normal(0, 1, (IX_CORPUS, IX_DIM)).astype(
        np.float32)).to(device)
    queries = torch.from_numpy(rng.normal(0, 1, (IX_QUERIES, IX_DIM)).astype(
        np.float32)).to(device)
    index = ShardedBruteForce(mesh).index(corpus)
    got = index(queries, IX_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        index(queries, IX_K)
    torch.cuda.synchronize()
    path = os.path.join(tmp, "sharded_index")
    loaded = load_index(save_index(path, index), device=device.type, mesh=mesh)
    again = loaded(queries, IX_K)
    if rank == 0:
        torch.save({"scores": got[0].cpu(), "ids": got[1].cpu(),
                    "loaded_equal": torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])},
                   os.path.join(tmp, "sharded_top_k.pt"))
    out["sharded_brute_force"] = {
        "rows_held": int(index._candidates.shape[0]),
        "query_ms": (time.perf_counter() - t0) * 1e3 / 5}
    del corpus, queries, index, loaded, got, again

    # MMoE, expert parallel.
    with np.load(os.path.join(tmp, "mmoe.npz")) as f:
        x, y = (torch.from_numpy(f[k]).to(device) for k in ("x", "y"))
    parallel.set_default_mesh(mesh)
    model = _mmoe(expert_parallel=True)
    model.load_state_dict(shard_expert_params(
        torch.load(os.path.join(tmp, "mmoe_init.pt")), mesh))
    loss, grads = _mmoe_step(model, mesh, x, y, device.type)
    parallel.set_default_mesh(None)
    torch.save(grads, os.path.join(tmp, f"rank{rank}_mmoe.pt"))
    out["mmoe"] = {"loss": loss,
                   "experts_held": int(model.experts.kernels[0].shape[0])}

    # DeepFM through a sharded checkpoint.
    with np.load(os.path.join(tmp, "train.npz")) as f:
        feats = {k: f[k] for k in f.files if k != "__labels__"}
        labels = f["__labels__"]
    data = DeviceData.from_numpy(feats, labels, BATCH, device=device.type,
                                 mesh=mesh)
    model, opt = _ckpt_deepfm(mesh, tmp)
    whole = Trainer(model, opt, mesh=mesh, device=device.type).fit_device(
        data, epochs=CKPT_EPOCHS, shuffle_seed=SEED, verbose=False)
    ckpt = os.path.join(tmp, "ckpt")
    model, opt = _ckpt_deepfm(mesh, tmp)
    first = Trainer(model, opt, mesh=mesh, device=device.type).fit_device(
        data, epochs=1, shuffle_seed=SEED, checkpoint_dir=ckpt,
        verbose=False)
    model, opt = _ckpt_deepfm(mesh, tmp)
    resumed = Trainer(model, opt, mesh=mesh, device=device.type).fit_device(
        data, epochs=CKPT_EPOCHS, shuffle_seed=SEED, checkpoint_dir=ckpt,
        verbose=False)
    out["checkpoint"] = {
        "uninterrupted": whole["step_losses"].tolist(),
        "resumed": np.concatenate([first["step_losses"],
                                   resumed["step_losses"]]).tolist(),
        "resumed_epochs": [h["epoch"] for h in resumed["history"]]}
    del model, opt, data

    # load_model(mesh=) of the unmeshed artifact.
    served = load_model(os.path.join(tmp, "artifact"), mesh=mesh,
                        device=device.type)
    with torch.no_grad():
        logits = served({k: torch.from_numpy(v[:BATCH]).to(device)
                         for k, v in feats.items()})
    torch.save(logits.cpu(), os.path.join(tmp, f"rank{rank}_logits.pt"))
    out["load_model"] = {
        "table_rows": int(served.embeddings.table.shape[0])}
    return out


def mesh_rank_main(rank: int, port: int, tmp: str) -> int:
    """One of the two ranks of ``mesh_two_rank_phase``."""
    torch.set_num_threads(1)  # two processes share the machine's cores
    # NCCL refuses two ranks on one device ("Duplicate GPU detected"), so
    # the two ranks on the one H100 run gloo, whose all-reduce and
    # broadcast take CUDA tensors: the only way model sharding runs on one
    # card.
    parallel.initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                    device="cuda", backend="gloo")
    with np.load(os.path.join(tmp, "train.npz")) as f:
        feats = {k: f[k] for k in f.files if k != "__labels__"}
        labels = f["__labels__"]
    specs = default_movielens_features()
    results = {}
    for n_data, n_model in MESH_CONFIGS:
        mesh = parallel.create_mesh(parallel.MeshConfig(n_data, n_model))
        d = parallel.axis_index(mesh, "data")
        m = parallel.axis_index(mesh, "model")
        b = BATCH // n_data
        batches = []
        for s in range(MESH_STEPS):
            rows = slice(s * BATCH + d * b, s * BATCH + (d + 1) * b)
            batches.append(parallel.shard_batch(
                ({k: v[rows] for k, v in feats.items()}, labels[rows]),
                mesh))
        for name in ("deepfm", "xdeepfm"):
            state = torch.load(os.path.join(tmp, f"{name}_init.pt"))
            model = _mesh_model(name, specs, mesh)
            model.load_state_dict(convert.shard_state(state, n_model, m))
            trainer = Trainer(model, torch.optim.Adam(model.parameters(),
                                                      lr=LEARNING_RATE),
                              mesh=mesh, device="cuda")
            reset_launches()
            losses, grads, step_ms = _mesh_steps(trainer, batches)
            launches = read_launches()
            key = f"{n_data}x{n_model}_{name}"
            torch.save(grads, os.path.join(tmp, f"rank{rank}_{key}.pt"))
            results[key] = {"losses": losses.tolist(), "launches": launches,
                            "step_ms": step_ms, "coords": [d, m],
                            "local_rows": b}
            if name == "deepfm":
                # One rank at a time: the two share the card.
                lo, hi = parallel.row_range(
                    sum(s.cardinality for s in specs), mesh)
                for r in range(2):
                    if r == rank:
                        results[key]["k1"] = _k1_times(
                            model, batches[0][0], specs, lo, hi - lo)
                    dist.barrier()
        results.update(mesh_rank_models(rank, mesh, tmp))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()
    return 0


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def mesh_model_references(device, tmp: str) -> dict:
    """The unmeshed runs on the card that ``mesh_rank_models``' results are
    held to, and the inputs the ranks read from ``tmp``: the two-tower's
    batches and seeded weights (its MESH_STEPS steps, and one step with
    the options), MMoE's seeded weights and batch (one step), DeepFM's
    artifact and its logits on a batch, BruteForce over the index
    corpus (top IX_K + 1)."""
    from deep_recommenders_torch.models.retrieval import (
        BruteForce,
        Retrieval,
    )
    from deep_recommenders_torch.serving.model_io import load_model, save_model

    shutil.rmtree(os.path.join(tmp, "ckpt"), ignore_errors=True)
    refs = {}
    ds = MovielensRanking(batch_size=TT_BATCH, num_ratings=NUM_RATINGS,
                          seed=SEED, movie_popularity="rank-power")
    user, item, ids = ds.retrieval_arrays("train")
    n = MESH_STEPS * TT_BATCH
    if len(ids) < n:
        raise AssertionError(f"two-tower: {len(ids)} train pairs, fewer "
                             f"than {MESH_STEPS} batches")
    prob = (np.bincount(ids)[ids] / len(ids)).astype(np.float32)
    np.savez(os.path.join(tmp, "tt.npz"), ids=ids[:n], prob=prob[:n],
             **{f"u/{k}": v[:n] for k, v in user.items()},
             **{f"i/{k}": v[:n] for k, v in item.items()})
    model = make_two_tower(ds)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(tmp, "tt_init.pt"))
    batches = _tt_batches(tmp, device)
    refs["tt"] = _mesh_steps(_tt_trainer(model, Retrieval(), None, device),
                             [(b, None) for b, _ in batches])
    model = _two_tower()
    model.load_state_dict(state)
    refs["tt_options"] = _options_step(_tt_trainer(
        model, Retrieval(remove_accidental_negatives=True), None, device),
        batches[0])
    del model, batches

    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(MMOE_BATCH, MMOE_INPUT)).astype(np.float32)
    y = rng.normal(size=(MMOE_BATCH, 2)).astype(np.float32)
    np.savez(os.path.join(tmp, "mmoe.npz"), x=x, y=y)
    torch.manual_seed(SEED)
    model = _mmoe()
    torch.save(model.state_dict(), os.path.join(tmp, "mmoe_init.pt"))
    refs["mmoe"] = _mmoe_step(model, None, torch.from_numpy(x).to(device),
                              torch.from_numpy(y).to(device), device)

    model = DeepFM(default_movielens_features(), EMBED_DIM, HIDDEN)
    model.load_state_dict(torch.load(os.path.join(tmp, "deepfm_init.pt")))
    save_model(os.path.join(tmp, "artifact"), model)
    with np.load(os.path.join(tmp, "train.npz")) as f:
        batch = {k: torch.from_numpy(f[k][:BATCH]).to(device)
                 for k in f.files if k != "__labels__"}
    with torch.no_grad():
        refs["logits"] = load_model(os.path.join(tmp, "artifact"),
                                    device=device)(batch).cpu()

    rng = np.random.default_rng(SEED)
    corpus = rng.normal(0, 1, (IX_CORPUS, IX_DIM)).astype(np.float32)
    queries = torch.from_numpy(rng.normal(0, 1, (IX_QUERIES, IX_DIM)).astype(
        np.float32)).to(device)
    s, i = BruteForce(device=device).index(corpus)(queries, IX_K + 1)
    refs["brute"] = (s.cpu(), i.cpu())
    torch.cuda.empty_cache()
    return refs


def _grad_errs(grads, want, what) -> dict:
    """Each gradient's relative error (in norm) against ``want``; the
    padding rows of a joined table must be zero."""
    errs = {}
    for g in grads:
        for k, ref in want.items():
            if g[k][ref.shape[0]:].any():
                raise AssertionError(f"{what}: padding rows of {k}")
            errs[k] = max(errs.get(k, 0.0), _rel(g[k][:ref.shape[0]], ref))
    return errs


def _joined_checkpoint(path: str):
    """The (1, 2) checkpoint's two files joined by hand: the fused table
    and its Adam moments concatenated and cut to the unpadded rows."""
    parts = [torch.load(os.path.join(path, f"model_{m}.pt"),
                        map_location="cpu") for m in (0, 1)]
    rows = sum(s.cardinality for s in default_movielens_features())
    model = dict(parts[0]["model"])
    model["embeddings.table"] = torch.cat(
        [p["model"]["embeddings.table"] for p in parts])[:rows]
    names = list(model)  # Adam was built on model.parameters()
    opt = {}
    for i, entry in parts[0]["optimizer"]["state"].items():
        opt[i] = dict(entry)
        if names[i] == "embeddings.table":
            for k in ("exp_avg", "exp_avg_sq"):
                opt[i][k] = torch.cat([p["optimizer"]["state"][i][k]
                                       for p in parts])[:rows]
    return model, opt


def mesh_model_checks(tmp: str, ranks, refs) -> tuple:
    """``mesh_rank_models``' results against ``refs``: the two-tower's
    launches (two K1 a step a rank), first step and losses as DeepFM's
    are held, and its options step; ShardedBruteForce's scores
    (SHARDED_SCORES_RTOL) and ids (on tie-free rows) against BruteForce
    and its loaded copy equal; expert-parallel MMoE's loss and gradients
    (MESH_FIRST_STEP_RTOL); the checkpoint's resume bit for bit and its
    restore at (2, 1) equal to the joined state; load_model(mesh=)'s
    logits (LOAD_MODEL_RTOL). Returns (paths, summary)."""
    paths, summary = {}, {}
    ref_losses, ref_grads, ref_ms = refs["tt"]
    opt_loss, opt_grads = refs["tt_options"]
    summary["unmeshed_two_tower_step_ms"] = ref_ms
    for n_data, n_model in MESH_CONFIGS:
        key = f"{n_data}x{n_model}"
        grads, options = ([torch.load(os.path.join(
            tmp, f"rank{r}_{key}_{name}.pt")) for r in range(2)]
            for name in ("tt", "tt_options"))
        if n_model == 2:  # rank = model index at data = 1
            grads = [convert.join_shards(grads)]
            options = [convert.join_shards(options)]
        errs = _grad_errs(grads, ref_grads, key)
        opt_errs = _grad_errs(options, opt_grads, key)
        for rank, r in enumerate(ranks):
            res = r[f"{key}_two_tower"]
            losses = np.asarray(res["losses"])
            first = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
            steps_err = float(np.max(np.abs(losses - ref_losses)
                                     / np.abs(ref_losses)))
            opt_err = abs(res["options_loss"] - opt_loss) / abs(opt_loss)
            expect = {k: 0 for k in res["launches"]}
            expect["scatter_add_rows"] = 2 * MESH_STEPS
            if res["launches"] != expect:
                raise AssertionError(f"{key} two-tower rank {rank}: "
                                     f"launches {res['launches']}")
            worst = max(max(errs.values()), max(opt_errs.values()),
                        first, opt_err)
            if not (worst <= MESH_FIRST_STEP_RTOL
                    and steps_err <= MESH_LOSSES_RTOL):
                raise AssertionError(
                    f"{key} two-tower rank {rank}: first loss {first}, "
                    f"options loss {opt_err}, gradients {errs}, options "
                    f"gradients {opt_errs}, losses {steps_err}")
            paths[f"mesh_gloo_{key}_two_tower_rank{rank}"] = res["launches"]
            summary[f"{key}_two_tower_rank{rank}"] = {
                "local_rows": res["local_rows"], "step_ms": res["step_ms"],
                "first_loss_rel_err": first, "loss_max_rel_err": steps_err,
                "max_grad_rel_err": max(errs.values()),
                "options_loss_rel_err": opt_err,
                "options_max_grad_rel_err": max(opt_errs.values()),
                "k1_query_tower_shard": res["k1"]}
            print(f"mesh_gloo_{key}_two_tower_rank{rank} launches: "
                  f"{res['launches']}")

    got = torch.load(os.path.join(tmp, "sharded_top_k.pt"))
    ref_s, ref_i = refs["brute"]
    tol = SHARDED_SCORES_RTOL * ref_s.abs().max().item() + 2 * IX_DIM * U32
    score_err = ((got["scores"] - ref_s[:, :IX_K]).abs()
                 / ref_s[:, :IX_K].abs().clamp_min(1e-30)).max().item()
    tie_free = ((ref_s[:, :-1] - ref_s[:, 1:]) > 2 * tol).all(1)
    ids_equal = torch.equal(got["ids"][tie_free], ref_i[tie_free, :IX_K])
    if not (score_err <= SHARDED_SCORES_RTOL and ids_equal
            and got["loaded_equal"] and tie_free.float().mean() > 0.5):
        raise AssertionError(
            f"ShardedBruteForce: score rel err {score_err}, ids equal on "
            f"{int(tie_free.sum())} tie-free rows {ids_equal}, loaded index "
            f"equal {got['loaded_equal']}")
    summary["sharded_brute_force"] = {
        "score_max_rel_err": score_err, "tie_free_rows": int(tie_free.sum()),
        "ids_equal_on_tie_free_rows": ids_equal,
        "loaded_index_equal": got["loaded_equal"],
        **{f"rank{r}": ranks[r]["sharded_brute_force"] for r in range(2)}}

    loss, want = refs["mmoe"]
    grads = convert.join_shards([torch.load(os.path.join(
        tmp, f"rank{r}_mmoe.pt")) for r in range(2)])
    errs = _grad_errs([grads], want, "mmoe")
    loss_err = max(abs(r["mmoe"]["loss"] - loss) / abs(loss) for r in ranks)
    if not (max(errs.values()) <= MESH_FIRST_STEP_RTOL
            and loss_err <= MESH_FIRST_STEP_RTOL
            and all(r["mmoe"]["experts_held"] == MMOE_EXPERTS // 2
                    for r in ranks)):
        raise AssertionError(f"expert-parallel MMoE: loss {loss_err}, "
                             f"gradients {errs}")
    summary["mmoe_expert_parallel"] = {
        "loss_rel_err": loss_err, "max_grad_rel_err": max(errs.values())}

    for rank, r in enumerate(ranks):
        c = r["checkpoint"]
        if c["resumed"] != c["uninterrupted"] or c["resumed_epochs"] != [1]:
            raise AssertionError(f"checkpoint rank {rank}: resumed losses "
                                 f"{c['resumed']} against "
                                 f"{c['uninterrupted']}")
    model, opt = _joined_checkpoint(os.path.join(tmp, "ckpt", "step_0"))
    for rank in range(2):
        got = torch.load(os.path.join(tmp, f"rank{rank}_restored.pt"),
                         map_location="cpu")
        same = all(torch.equal(got["model"][k].cpu(), v)
                   for k, v in model.items()) and all(
            torch.equal(got["optimizer"]["state"][i][k].cpu(), t.cpu())
            for i, e in opt.items() for k, t in e.items())
        if not same or sorted(got["model"]) != sorted(model):
            raise AssertionError(f"checkpoint restored at (2, 1) rank "
                                 f"{rank}: not the joined state")
    summary["checkpoint"] = {
        "steps": len(ranks[0]["checkpoint"]["uninterrupted"]),
        "resume_bitwise_equal": True, "restored_2x1_equal_joined": True}

    ref = refs["logits"]
    logit_err = max(_rel(torch.load(os.path.join(
        tmp, f"rank{r}_logits.pt")), ref) for r in range(2))
    if not logit_err <= LOAD_MODEL_RTOL:
        raise AssertionError(f"load_model(mesh=): logits rel err "
                             f"{logit_err}")
    summary["load_model_mesh"] = {
        "logits_rel_err": logit_err,
        "table_rows": [r["load_model"]["table_rows"] for r in ranks]}
    return paths, summary


def mesh_two_rank_phase(ds: MovielensRanking, device) -> dict:
    """Two processes on the card, gloo on CUDA tensors, in the meshes
    (data=1, model=2) and (data=2, model=1): DeepFM and the flagship
    xDeepFM at the bench width, MESH_STEPS steps of the global batch of
    BATCH rows. Each rank launches one K1 a step on its table (half the
    table at model = 2; xDeepFM adds one on its replicated linear terms'
    table) and xDeepFM one K3 forward and one K3 backward a step on its
    rows (BATCH / data examples). The first step's loss and gradients,
    the shards put back together, against the unmeshed run on the card
    from the same weights (MESH_FIRST_STEP_RTOL), every loss within
    MESH_LOSSES_RTOL; each rank's step time and K1's device time on its
    shard are printed, and nothing is claimed from them."""
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "mesh_smoke")
    os.makedirs(tmp, exist_ok=True)
    feats, labels = ds.train_arrays()
    n = MESH_STEPS * BATCH
    np.savez(os.path.join(tmp, "train.npz"), __labels__=labels[:n],
             **{k: v[:n] for k, v in feats.items()})
    specs = ds.feature_specs
    want, plain_k1 = {}, None
    batches = [({k: torch.from_numpy(v[s * BATCH:(s + 1) * BATCH])
                 .to(device) for k, v in feats.items()},
                torch.from_numpy(labels[s * BATCH:(s + 1) * BATCH])
                .to(device)) for s in range(MESH_STEPS)]
    for name in ("deepfm", "xdeepfm"):
        model = _mesh_model(name, specs)
        torch.save(model.state_dict(), os.path.join(tmp, f"{name}_init.pt"))
        trainer = Trainer(model, torch.optim.Adam(model.parameters(),
                                                  lr=LEARNING_RATE),
                          device=device)
        want[name] = _mesh_steps(trainer, batches)
        if name == "deepfm":
            plain_k1 = _k1_times(model, batches[0][0], specs, 0,
                                 model.embeddings.table.shape[0])
    refs = mesh_model_references(device, tmp)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank",
         str(rank), "--mesh-port", str(port), "--mesh-dir", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh rank {rank} failed:\n{log[-4000:]}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    paths, summary = {}, {"unmeshed": {
        "deepfm_step_ms": want["deepfm"][2],
        "xdeepfm_step_ms": want["xdeepfm"][2], "deepfm_k1": plain_k1}}
    for n_data, n_model in MESH_CONFIGS:
        for name in ("deepfm", "xdeepfm"):
            key = f"{n_data}x{n_model}_{name}"
            ref_losses, ref_grads, _ = want[name]
            grads = [torch.load(os.path.join(tmp, f"rank{r}_{key}.pt"))
                     for r in range(2)]
            if n_model == 2:  # rank = model index at data = 1
                grads = [convert.join_shards(grads)]
            errs = {}
            for g in grads:
                for k, ref in ref_grads.items():
                    if g[k][ref.shape[0]:].any():
                        raise AssertionError(f"{key}: padding rows of {k}")
                    errs[k] = max(errs.get(k, 0.0),
                                  _rel(g[k][:ref.shape[0]], ref))
            for rank, r in enumerate(ranks):
                res = r[key]
                losses = np.asarray(res["losses"])
                first = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
                steps_err = float(np.max(np.abs(losses - ref_losses)
                                         / np.abs(ref_losses)))
                expect = {k: 0 for k in res["launches"]}
                expect["scatter_add_rows"] = MESH_STEPS * (
                    1 if name == "deepfm" else 2)
                if name == "xdeepfm":
                    expect["cin_stack_pooled.fwd"] = MESH_STEPS
                    expect["cin_stack_pooled.bwd"] = MESH_STEPS
                if res["launches"] != expect:
                    raise AssertionError(f"{key} rank {rank}: launches "
                                         f"{res['launches']}, expected "
                                         f"{expect}")
                if not (first <= MESH_FIRST_STEP_RTOL
                        and max(errs.values()) <= MESH_FIRST_STEP_RTOL
                        and steps_err <= MESH_LOSSES_RTOL):
                    raise AssertionError(
                        f"{key} rank {rank}: first loss rel err {first}, "
                        f"gradient rel errs {errs}, losses rel err "
                        f"{steps_err}")
                paths[f"mesh_gloo_{key}_rank{rank}"] = res["launches"]
                summary[f"{key}_rank{rank}"] = {
                    "coords": res["coords"], "local_rows": res["local_rows"],
                    "step_ms": res["step_ms"], "first_loss_rel_err": first,
                    "loss_max_rel_err": steps_err,
                    "max_grad_rel_err": max(errs.values()),
                    **({"k1": res["k1"]} if "k1" in res else {})}
                print(f"mesh_gloo_{key}_rank{rank} launches: "
                      f"{res['launches']}")
    more_paths, more = mesh_model_checks(tmp, ranks, refs)
    paths.update(more_paths)
    summary.update(more)
    print("mesh_gloo " + json.dumps(summary))
    return paths


# Which path's launches each kernel's entry reports.
ENTRY_PATH = {
    "scatter_add_rows": "deepfm",
    "scatter_add_rows.bf16": "deepfm_bf16",
    "fm_interaction_fused": "deepfm",
    "fm_interaction_fused.bf16": "deepfm",
    "cin_stack_pooled.fwd": "xdeepfm",
    "cin_stack_pooled.bwd": "xdeepfm",
    "cin2d.fwd": "xdeepfm_layered",
    "cin2d.bwd": "xdeepfm_layered",
    "flash_attention.fwd": "transformer_seq2seq",
    "flash_attention.bwd": "transformer_seq2seq",
    "flash_attention_bf16.fwd": "transformer_seq2seq_bf16",
    "flash_attention_bf16.bwd": "transformer_seq2seq_bf16",
    "flash_attention.fwd.d256": "attention_d200",
    "flash_attention.bwd.d256": "attention_d200",
    "flash_attention_bf16.fwd.d256": "attention_d200",
    "flash_attention_bf16.bwd.d256": "attention_d200",
    "flash_attention.fwd.d512": "attention_d257",
    "flash_attention.bwd.d512": "attention_d257",
    "flash_attention_bf16.fwd.d512": "attention_d257",
    "flash_attention_bf16.bwd.d512": "attention_d257",
    "flash_attention_bf16.fwd.d64": "transformer_seq2seq_bf16_2x64",
    "flash_attention_bf16.bwd.d64": "transformer_seq2seq_bf16_2x64",
    "flash_attention_bf16.fwd.d128": "attention_d128",
    "flash_attention_bf16.bwd.d128": "attention_d128",
    "flash_attention_bf16.fwd.d2304": "attention_d2304",
    "flash_attention_bf16.bwd.d2304": "attention_d2304",
    "scatter_add_rows.bf16_large": "bf16_table_large",
    "flash_attention_bf16.bwd.long": "transformer_seq2seq_bf16_long",
}


# Which served path's launches (one served batch) each forward kernel's
# entry reports.
SERVED_PATH = {
    "cin_stack_pooled.fwd": "xdeepfm_served",
    "cin2d.fwd": "xdeepfm_layered_served",
    "flash_attention.fwd": "transformer_seq2seq_served",
    "flash_attention_bf16.fwd": "transformer_seq2seq_bf16_served",
}


# An entry whose launch counter has another name: K2 on bf16 embeddings is
# the same wrapper, counted in fm_interaction_fused.launches; K1 on bf16 g
# is counted in scatter_add_rows.launches_bf16, its large-table plan also
# in scatter_add_rows.launches_bf16_large; the D = 256 and D > 256
# instances of K5 and K6, and the bf16 ones at D = 64, 128 and 2304, in
# their dtype's counters, on the paths that run those widths alone; the
# bf16 K6 over query ranges in the bf16 counter, on the long path.
COUNTER = {"fm_interaction_fused.bf16": "fm_interaction_fused",
           "scatter_add_rows.bf16": "scatter_add_rows_bf16",
           "scatter_add_rows.bf16_large": "scatter_add_rows_bf16_large",
           "flash_attention_bf16.fwd.d2304": "flash_attention_bf16.fwd",
           "flash_attention_bf16.bwd.d2304": "flash_attention_bf16.bwd",
           "flash_attention_bf16.bwd.long": "flash_attention_bf16.bwd",
           **{f"{k}.{which}": k for k in (
               "flash_attention.fwd", "flash_attention.bwd",
               "flash_attention_bf16.fwd", "flash_attention_bf16.bwd")
              for which in WIDE_SHAPES},
           **{f"{k}.d{d}": k for k in (
               "flash_attention_bf16.fwd", "flash_attention_bf16.bwd")
              for d in NARROW_HELD}}


def device_line() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main(argv=()) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ctr-only", action="store_true",
                        help="time only K1 and K2 and run the DeepFM and "
                             "the two xDeepFM train paths")
    parser.add_argument("--attention-fp32-only", action="store_true",
                        help="time only the fp32 K5 and K6 and run the "
                             "fp32 Transformer path")
    parser.add_argument("--attention-times", action="store_true",
                        help="time only the fp32 and bf16 K5 and K6 at "
                             "D = 16, 256, 512, 1024 and 2304 (bf16 also "
                             "32, 64 and 128)")
    parser.add_argument("--wrapper-host-us", action="store_true",
                        help="time only the host's us a call of the K3, K4 "
                             "and K5 forward wrappers")
    # One rank of the two-rank mesh phase, which starts it (internal).
    parser.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-dir", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.mesh_rank is not None:
        return mesh_rank_main(args.mesh_rank, args.mesh_port, args.mesh_dir)
    print(card_line())
    device = resolve_device("cuda")
    t0 = time.perf_counter()
    logs = _build.build()
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_summary(logs.get("flash_attention_tma_bf16", ""))
    print("flash_attention_tma_bf16 ptxas " + json.dumps(ptxas))
    cluster_ptxas = ptxas_summary(logs.get("flash_attention_cluster_bf16",
                                           ""))
    print("flash_attention_cluster_bf16 ptxas " + json.dumps(cluster_ptxas))

    if args.wrapper_host_us:
        # Not the full smoke run: no checks of the kernels, no "ok" line.
        print(json.dumps({"wrapper_host_us": wrapper_host_us(device)}))
        return 0
    if args.attention_fp32_only:
        imdb = SyntheticImdb(num_words=TX_VOCAB, max_len=TX_LEN, seed=SEED)
        times = fp32_attention_times(imdb, device)
        launches, profile = transformer_path(imdb, device)
        # Not the full smoke run: no checks of the kernels, no "ok" line.
        print(json.dumps({"attention_fp32": {
            "kernels": times, "transformer_seq2seq": {
                "launches": launches, "profile": profile}}}))
        return 0
    if args.attention_times:
        imdb = SyntheticImdb(num_words=TX_VOCAB, max_len=TX_LEN, seed=SEED)
        # Not the full smoke run: no checks of the kernels, no "ok" line.
        print(json.dumps({"attention_times": attention_times_by_width(
            imdb, device)}))
        return 0
    t0 = time.perf_counter()
    ds = MovielensRanking(batch_size=BATCH, num_ratings=NUM_RATINGS,
                          seed=SEED)
    model = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN,
                   generator=torch.Generator().manual_seed(SEED)).to(device)
    if args.ctr_only:
        times = ctr_kernel_times(ds, model, device)
        train = DeviceData.from_numpy(*ds.train_arrays(), BATCH,
                                      device=device)
        test = DeviceData.from_numpy(*ds.test_arrays(), BATCH, device=device)
        _, results = deepfm_path(ds, model, train, test, device)
        _, more = xdeepfm_paths(ds, train, test, device)
        # Not the full smoke run: no checks of the kernels, no "ok" line.
        print(json.dumps({"ctr": {"kernels": times, "deepfm": results,
                                  **more}}))
        return 0
    print(f"data: {ds.train_steps_per_epoch} train steps/epoch, "
          f"{ds.test_steps} test steps ({time.perf_counter() - t0:.1f} s)")

    imdb = SyntheticImdb(num_words=TX_VOCAB, max_len=TX_LEN, seed=SEED)
    tt = two_tower_data()
    entries = kernel_phase(ds, model, device)
    entries[0]["two_tower"] = two_tower_scatter_fields(tt, device)
    entries += cin_kernel_phase(ds, device)
    entries += attention_kernel_phase(imdb, device)
    entries += attention_bf16_kernel_phase(imdb, device)
    entries += wide_attention_phase(imdb, device)
    entries += narrow_attention_phase(imdb, device, cluster_ptxas)
    entries += reduce_scatter_attention_phase(imdb, device, cluster_ptxas)
    entries += long_attention_phase(device)
    head_widths = head_width_phase(device)
    print(f"kernel phase done ({time.perf_counter() - t0:.1f} s)")
    paths = train_phase(ds, model, device)
    paths["bf16_table"], bf16_k1 = bf16_table_phase(ds, device)
    next(e for e in entries
         if e["name"] == "scatter_add_rows.bf16")["bf16_table"] = bf16_k1
    hashed = MovielensRanking(
        batch_size=BATCH, num_ratings=NUM_RATINGS, seed=SEED,
        features=default_movielens_features(
            user_hash_buckets=LARGE_TABLE_BUCKETS,
            movie_hash_buckets=LARGE_TABLE_BUCKETS))
    paths["bf16_table_large"], large_k1 = bf16_table_phase(
        hashed, device, "bf16_table_large")
    del hashed
    k1_large = next(e for e in entries
                    if e["name"] == "scatter_add_rows.bf16_large")
    k1_large["bf16_table_large"] = large_k1
    k1_large["ptxas"] = ptxas_summary(logs.get("scatter_add_rows", ""))
    paths["attention_d200"] = attention_width_path(device, 200)
    paths["attention_d257"] = attention_width_path(device, 257)
    paths["attention_d128"] = attention_width_path(device, 128)
    paths["attention_d2304"] = attention_width_path(device, 2300,
                                                    (torch.bfloat16,))
    served, serving = serving_phase(ds, model, imdb, device)
    paths["esmm"] = esmm_path(ds, device)[0]
    del model
    torch.cuda.empty_cache()
    paths.update(din_paths(device)[0])
    paths["din_example"] = din_example_path()[0]
    paths["mmoe_example"] = mmoe_example_path()[0]
    paths.update(two_tower_paths(tt, device)[0])
    del tt
    paths["two_tower_example"] = two_tower_example_path()[0]
    paths["transformer_seq2seq"] = transformer_path(imdb, device)[0]
    paths["transformer_seq2seq_bf16"] = transformer_path(
        imdb, device, torch.bfloat16)[0]
    paths["transformer_seq2seq_bf16_2x64"] = transformer_path(
        imdb, device, torch.bfloat16, TX2_HEADS, TX2_BATCH)[0]
    paths["transformer_seq2seq_bf16_long"] = transformer_path(
        SyntheticImdb(num_words=TX_VOCAB, max_len=TXL_LEN, seed=SEED),
        device, torch.bfloat16, TX_HEADS, TXL_BATCH, TXL_STEPS, TXL_EVALS,
        TXL_ROWS, "_long")[0]
    paths["transformer_imdb"] = imdb_path()
    model_io_phase(device)
    index_phase(device)
    gcn_phase(device)
    t0 = time.perf_counter()
    paths["native_deepfm"] = native_phase(ds, device)
    paths["mesh_nccl_deepfm"] = mesh_one_rank_phase(ds, device)
    paths.update(mesh_two_rank_phase(ds, device))
    print(f"native and mesh phases done ({time.perf_counter() - t0:.1f} s)")
    for entry in entries:
        path = ENTRY_PATH[entry["name"]]
        counter = COUNTER.get(entry["name"], entry["name"])
        entry["path"] = path
        entry["launches"] = paths[path][counter]
        entry["launches_by_path"] = {p: n[counter] for p, n in paths.items()}
        if entry["name"] in SERVED_PATH:
            entry["serving_launches_per_batch"] = served[SERVED_PATH[
                entry["name"]]][counter]
    for entry in entries:
        if entry["name"] in ("flash_attention_bf16.fwd",
                             "flash_attention_bf16.bwd"):
            entry["ptxas"] = ptxas
        if entry["name"] in ("flash_attention_bf16.fwd.d512",
                             "flash_attention_bf16.bwd.d512"):
            entry["ptxas"] = cluster_ptxas
    print("serving " + json.dumps(serving))
    print("head_widths " + json.dumps(head_widths))
    print(json.dumps({"kernels": entries}))
    print(device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
