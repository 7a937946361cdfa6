#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeptables_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeptables_torch/csrc`` and runs
these phases, each printing one JSON line:

1. ``card``: the card's name and power limit (``nvidia-smi``), the versions,
   the kernel build time, what ``ptxas`` reports for each kernel and the
   kernels that spill (``spills``).
2. ``kernel``: the FM forward kernel against its plain PyTorch version
   (``fm_reference``) on the card, in float32 and bfloat16, at every batch
   shape the serving path gives it (F=26, D=16), a ragged B=4093 and the
   training forward's B=8192, inputs rotated over more than twice the 50 MB
   L2. ``ms`` is the device time of one call (``torch.profiler``),
   ``call_ms`` the time between back-to-back calls (CUDA events), beside
   the bound (bytes over 3.35 TB/s). Each row names the design that ran
   (``fm_design``: ``vec16`` at every one of these shapes, which the script
   checks, also by the kernel's name in the profiler) and what ``ptxas``
   reports for its kernel. Two more rows (float32 and bfloat16, B=4096)
   take an x one element into its storage, which is not 16-byte aligned,
   and so hold the ``scalar`` design against ``fm_reference`` the same way
   (``x_offset`` 1; the main path's rows have 0). Two more (float32 and
   bfloat16, B=8192) take F=104, fgcnn_fm_nets' FM over the FGCNN output.
3. ``kernel`` for ``fm_bwd`` (the FM backward kernel against
   ``fm_backward_reference``, float32 and bfloat16) at the training shapes
   B = 64, 512, 4093, 8192 (F=26, D=16), and ``emb_grad`` (the
   embedding-gradient kernel against ``emb_grad_reference``) on
   ``load_criteo_synthetic`` ids, which follow a Zipf law, and on uniform
   ids at the same shapes, on AutoInt's avazu-style ids
   (``load_avazu_synthetic``, 22 columns, B=8192), on Wide&Deep+DCN's adult
   ids (8 columns, 102 rows, B=8192), on the stream phase's hashed ids
   (uniform over 26 columns' buckets, 855,648 rows, B=8192) and on a batch
   whose ids are all one row (B=8192, no bar), with the same timings and each
   kernel's time apart (``kernels_ms``: the sort's kernels, the fill, the
   segment sum and the merge; ``sort_ms``, ``fill_ms`` and ``segment_ms``
   sum them, and ``sort_alone_ms`` times ``torch.sort`` by itself). Each
   ``emb_grad`` row checks that two calls give the same bits and those of
   ``emb_grad_sorted_reference`` (the plain twin of the kernel's order) on
   the CPU, times ``index_add_`` into a zeroed table, the one PyTorch call
   that computes the same function, and ``index_put_`` with
   ``accumulate=True`` under ``torch.use_deterministic_algorithms(True)``,
   the deterministic one, and names the design that ran
   (``emb_grad_design``: ``segment_v4`` at every one of these shapes, which
   the script checks, also by the kernel's name in the profiler). Three
   more rows take the criteo, uniform and avazu ids at B=8192 again with g
   one element into its storage (``g_offset`` 1), which runs the
   ``segment_scalar`` design on the same ids.
4. ``kernel`` for ``cin_fwd`` (K4, the CIN contraction) and ``cin_bwd`` (K3,
   its gradient) against ``cin_fwd_reference`` and ``cin_bwd_reference``
   at xDeepFM's two CIN layers, (F, G, L) = (26, 26, 128) and (26, 64, 128),
   B = 4096, 8192 and 4093, and at fgcnn_cin_nets' over the FGCNN output,
   (104, 104, 128) and (104, 64, 128) at B=8192, D=16, float32 and bfloat16, every output within
   1e-5 of the sum of its terms' magnitudes (dx0 and dh in bfloat16 also
   rtol 1e-2, their one rounding). Beside each: the yardstick
   ``torch.einsum('bfd,bgd,lfg->bld')`` (K4) and ``torch.autograd.grad`` of
   it (K3, several kernels), which the port never calls, and the bound (the
   larger of bytes over 3.35 TB/s and operations over the card's rate for
   the input type: 989 TFLOP/s bfloat16, 495 float32, TF32's rate, the
   card's peak for 32-bit operands; beside it ``split_floor_ms``, the
   floor of a float32-accurate product on the tensor cores, three TF32
   passes of the GEMM, and ``simt_bound_ms``, every operation at 67 TFLOP/s
   off the tensor cores). ``cin_fwd`` and
   ``cin_bwd`` rows name the kernels that ran: ``design`` ``wgmma``
   (bfloat16 on the tensor cores), ``wgmma_f32`` (float32 on the tensor
   cores, three exact bfloat16 planes) at every one of these shapes, which
   the script checks. Two more float32 rows: xDeepFM at the paper's 200
   maps, (26, 200, 200) at B=8192, D=10, whose K3 takes
   ``wgmma_f32_rs`` (dz split in registers: its three planes do not fit a
   block), with ``simt_ms`` (the CUDA-core kernels at the same shape) and
   ``designs`` (``cin_bwd.designs`` counted over the kernel's own timed
   calls) beside the yardstick and the bound; and B=1024 at
   (26, 229, 193), past every tensor-core kernel's shared memory, which
   holds the CUDA-core ``simt`` kernels against the plain versions the
   same way.
5. ``kernel`` for ``fa_fwd`` and ``fa_bwd`` (K5, field attention and its
   gradient) and ``ab_fwd`` and ``ab_bwd`` (K6, the fused attention block)
   against their plain versions at AutoInt's shapes (F=22, 2 heads of
   dh=8), B = 8192 and 4096, float32 and bfloat16, and K5 with bfloat16
   inputs and a float32 output; every output within 1e-5 of its largest
   value (bfloat16 outputs also rtol 1e-2). Yardsticks for K5:
   ``scaled_dot_product_attention`` and ``torch.autograd.grad`` of it.
   Then one bfloat16 row a kernel (``lifted``) at B=64 past the register
   width and shared memory: K5 at F=200, one head of dh=128; K6 at F=22,
   U=128. Every row names the design that ran (``fa_design``,
   ``ab_design``: ``tile`` at AutoInt's shapes in every type pair, which
   the script checks; ``warp`` at the lifted shapes) and what ``ptxas``
   reports for its kernel (registers, spill bytes).
6. For DeepFM, xDeepFM (26 categorical columns at D=16, 13 dense, DNN
   1024/512 relu; xDeepFM's CIN (128, 128) relu), AutoInt and AutoInt with
   ``fuse_projections`` (the 22 avazu-style columns of
   ``load_avazu_synthetic`` at D=16, 3 attention blocks of 2 heads; the
   bench's 8 batches of 8192 rows, 7 to train on and 1 to validate) and
   Wide&Deep+DCN (``linear``, ``dnn_nets``, ``dcn_nets``: adult's 8
   categorical columns of 102 rows in all at D=16, 6 dense, DNN 1024/512
   relu, 4 cross layers; ids and dense inputs drawn as
   ``benchmarks/bench_models.py`` draws them, labels from a fixed logistic
   model of both), random weights from ``config.seed``:
   - ``serving`` under ``dtype_policy='bfloat16'`` and then ``'float32'``,
     through ``Predictor`` with the default buckets, requests of 1, 37, 4096
     and 10000 rows from ``load_criteo_synthetic``. It checks the
     probabilities (finite, ``(n, 2)``, rows sum to 1), that the forward
     kernel ran once (FM), twice (the CIN layers) or three times (the
     attention blocks, K5 or K6) per padded chunk (Wide&Deep+DCN: that no
     kernel ran), and that the same
     weights on ``device='cpu'`` (the plain path) and, for xDeepFM, the
     batch-minor CIN tower, for AutoInt the batch-major layout, give the
     same probabilities: float32 atol 1e-5, bfloat16 atol 1e-2. ``profile``
     (bfloat16): device time by kernel over three 4096-row requests and the
     busy share.
   - ``train``, under ``'bfloat16'`` and then ``'float32'``:
     ``DeepModel.fit`` over 8 batches of 8192 rows of
     ``load_criteo_synthetic`` (AutoInt: 7 batches of its rows) for 3
     epochs, one more batch for validation. It checks that every loss is
     finite, that the loss fell from epoch 1 to epoch 3, and each kernel's
     launches: the embedding gradient once a step; DeepFM's FM backward
     once a step and FM forward once a step and validation batch; xDeepFM's
     K3 twice a step and K4 twice a step and validation batch; AutoInt's
     K5-bwd (K6-bwd when fused) three times a step and K5-fwd (K6-fwd)
     three times a step and validation batch; Wide&Deep+DCN K1 alone. It prints the median step
     time and examples/s over epochs 2-3 and ``val_auc``. Then
     ``train_profile``: two train steps under ``torch.profiler`` (device
     time by kernel, busy share; ``cin_kernels``: every CIN kernel by name,
     and for xDeepFM a check that each policy ran its type's tensor-core K4
     and K3 passes (float32 the ``_f32`` ones) and no CUDA-core CIN kernel;
     ``fa_kernels``: every field-attention
     kernel by name, and for both AutoInt models a check that they ran
     the tile kernels, K5's (K6's when fused), in bfloat16 (block 0) and
     float32 (blocks 1-2, after BatchNorm's promotion) under
     ``'bfloat16'``, in float32 only under ``'float32'``, and never the
     one-warp ones; ``k1k2_kernels``: the embedding gradient's and the FM
     forward's kernels by name, and a check that every model ran K1's
     ``segment_v4`` kernels and DeepFM K2-fwd's ``vec16`` kernel, never the
     scalar ones). Then the same initial weights on the card
     and on ``device='cpu'`` (the plain path), at 8192-row batches for
     DeepFM and 1024-row batches for xDeepFM (the CPU plain path
     materialises the CIN pair) and AutoInt, give the same step-1
     gradients (float32 rtol 1e-4, bfloat16 rtol 1e-2, both atol 1e-2 of
     each tensor's largest gradient: a ReLU input within rounding of zero
     may flip one example's gradient) and, fitting three batches, the same
     losses (float32 rtol 1e-4, bfloat16 atol 1e-2) and, in float32,
     parameters within atol 2e-4 for all but at most 1% of a tensor's
     elements (Adam turns rounding in a gradient near zero into steps of
     ~lr).

7. ``heads``: DeepFM at full criteo width under ``'bfloat16'`` for each
   task head, loss and optimizer of ``HEADS_RUNS`` (multiclass with 7
   classes, ``categorical_crossentropy`` and ``adamw``; regression with
   ``mse`` and ``rmsprop``, and with ``huber`` and ``adagrad``; multilabel
   with 4 labels, ``multilabel_binary_crossentropy`` and ``lamb``; binary
   with ``binary_focal_loss`` and with GHMC (momentum 0.75, its state
   carried), both with ``adam``; binary with an ``l2`` embedding weight
   penalty and an ``l1`` activity penalty): labels from a seed, three
   8192-row steps and a validation batch through ``DeepModel.fit`` on the
   card, each line with the step times, K1's and K2's launches (checked:
   once a step, K2-fwd also for the validation batch) and the card against
   the same steps on the CPU's plain path: step-1 gradients and the
   parameters after three steps by the train phase's rules, the losses,
   and GHMC's state. Then ``heads_request``: a multiclass request of 4093
   rows through ``Predictor.predict_proba_arrays``, whose rows must sum
   to 1.

8. ``zoo``: each of the 14 other builders of the zoo alone at criteo
   width (``ZOO``), then DeepFM with a var-len column (20 tokens, max
   pooling: K2 at F=27, K1 twice a step), under ``'bfloat16'``: three
   8192-row steps and a validation batch through ``DeepModel.fit``, a
   4093-row request through ``Predictor``, each one's kernel launches
   checked, and the card against the CPU's plain path at the batch each
   states (``zoo_phase`` says the rules).

Then ``determinism`` lines: two fits from one seed of every model the
script trains (DeepFM, xDeepFM under both policies, AutoInt plain and
fused, Wide&Deep+DCN at three 8192-row steps; each ZOO net and the var-len
DeepFM at two), each line with the parameter tensors whose bits differ
between the two fits; all printed, then checked: every tensor bit-equal.
Then ``dae`` (``fe.DAE()`` at its defaults on the 13 dense criteo columns:
the mse falls, one epoch against the CPU's plain path, ``transform`` on the
card), ``distributed`` (an NCCL process group of one process over a
``file://`` store: DeepFM under ``DataParallel(num_devices=1)`` bit-equal
to the plain fit, with the same launches) and ``checkpoint`` (DeepFM
resumed from ``save_checkpoint``/``restore_checkpoint`` after two steps:
its third step bit-equal to three uninterrupted steps; the checkpoint's
bytes and its save and restore times), then ``sharded``: DeepFM (bf16,
criteo width) with its 324,489-row table row-sharded over a model axis of
2, ``DataAndModelParallel(1, 2)``, two ranks of a gloo process group on
the one card (the script run again as ``--sharded-rank``; NCCL refuses
two ranks on one device, and gloo moves the CUDA tensors through the
host), three 8192-row steps each of ``'sharded'``, exact ``'sharded_a2a'``
and ``'sharded_a2a'`` at ``capacity_factor=1.5``: the first batch's rows
against the whole table's gather bit for bit, the exact runs' parameters
and the table put back from its shards against a one-process replicated
fit by the train phase's rules, the bounded run's drops, K1 once a rank
a step on R = 162,245 rows. One line a run: backend, mesh, R, capacity,
drops, largest difference and each rank's step times (two ranks on one
card: no throughput). The ``emb_grad`` kernel rows add ``shard``: K1 on
the local ids the exact all-to-all hands a rank at B=8192 (unused slots
included), into R rows, with its bound and ``index_add_``'s time.

9. Streaming from files, on TSV shards the script writes to a temporary
   directory (Criteo format, ``write_stream_tsv``: two training shards of
   165,000 rows, a validation shard of 41,000), at the JAX package's
   ingest configuration (``STREAM_BUCKETS``, 855,648 table rows):
   - ``ingest``: the host parser (``csrc/fast_ingest.cpp``) built, and
     equal to its Python twin on the first 2000 rows; its rows/s and MB/s
     over the training shards alone, beside ``os.cpu_count()``.
   - ``stream``: ``CriteoTsvSource`` (16 MB reads) → ``CriteoStreamLoader``
     → ``DeepModel.fit`` on the card, DeepFM under ``'bfloat16'``, B=8192,
     two epochs with a validation loader: examples/s a epoch and the step
     times (host clock, synchronised), the launches (K1 and K2-bwd once a
     step, K2-fwd once a step and a validation batch, checked), the peak
     allocation (``utils/device.memory_stats``), that the loss fell,
     streaming ``evaluate`` and ``predict`` within 1e-5 of the in-memory
     ones on the same rows, and the card against the CPU's plain path over
     the same shards (three steps, both policies, the train phase's rules).
   - ``stream_determinism``: two fits from one seed end with equal
     parameters, bit for bit (checked).

10. ``estimator`` (four lines): the estimator layer on the card with
    ``pandas`` and ``sklearn`` blocked in ``sys.modules``, so that nothing
    on it leans on them. The ``bank_deepfm`` row of
    ``deeptables_torch/tools/parity_quality.py`` (``load_bank(20000)``'s
    numpy columns, its 80/20 split, DeepFM, batch 512, seed 0):
    - ``card_vs_cpu``: ``DeepTable.fit`` on the card and with
      ``device='cpu'`` from the same seed, embedding dropout off (the
      devices draw other masks) and cut to three steps, held to the train
      phase's rules (losses rtol 1e-4, parameters ``check_params``;
      BatchNorm's running statistics of bank's raw columns also rtol
      1e-5) and the
      test rows' ``predict_proba`` within ``ESTIMATOR_PROBA_ATOL``; both
      ``evaluate``s printed.
    - ``cv``: ``fit_cross_validation``, 3 folds of one epoch on the card:
      the out-of-fold shape, and K1, K2-fwd and K2-bwd launched in every
      fold's fit (checked).
    - ``serving``: ``save`` → ``serving.Predictor.load(..., device=None)``
      → ``predict_proba`` of 512 test rows (a full bucket), bit-equal to a
      ``Predictor`` over the estimator before it was saved, and within
      1e-5 of its ``predict_proba`` (which takes the sigmoid on the host)
      (checked).
    - ``quality``: ``parity_quality.run`` at seed 0 on the card, its three
      kernel rows (``bank_deepfm`` K2/K1, ``criteo_xdeepfm`` K4/K3,
      ``avazu_autoint`` K5), each beside its ``BASELINE.md`` row and σ;
      every metric finite, every AUC above the row's mean less 5 σ where
      the table is the one ``BASELINE.md`` trained on (its digest,
      ``ESTIMATOR_TABLES``), else above half way from chance to that mean
      (checked). numpy's own Zipf stream differs between releases; the
      port's loaders draw numpy 2.0's on any release, so every row's
      ``baseline_table`` should read true.

11. ``stream_csv`` (five lines and ``stream_csv_wall``): out-of-core
    training from CSV through ``DeepTable``, again with ``pandas`` and
    ``sklearn`` blocked. Four training shards of 50,000 rows and a
    validation shard of 10,000, written with the standard library's
    ``csv`` in the Criteo display-ads layout: ``label``, the 13 dense
    columns of ``load_criteo_synthetic`` (~5% of fields empty) and its 26
    categorical columns as 8-hex-digit tokens of a 32-bit hash of the id
    (~3% empty). DeepFM at full criteo width (D=16, DNN 1024/512 relu,
    ``C1``..``C26`` categorical) under the default ``'float32'`` policy,
    batches of 8192, chunks of 25,000 rows read by ``columns.read_csv``:
    - ``stream_csv_pre``: ``fit_preprocessor_streaming`` (exact) gives the
      column lists, vocabularies and fills of ``DeepTable``'s in-memory fit
      of the shards read whole and concatenated, the means within
      ``STREAM_CSV_MEAN_RTOL``; the pass's seconds and rows/s.
    - ``stream_csv_card_vs_cpu``: ``DeepTable.fit`` over a
      ``StreamingDataLoader`` on the card and with ``device='cpu'`` from
      one seed, embedding dropout off, three steps and the validation
      loader: losses rtol 1e-4, parameters by ``check_params``.
    - ``stream_csv_fit``: two epochs with the validation loader: the loss
      falls, examples/s an epoch and the step times (host clock,
      synchronised); K1 and K2-bwd once a step, K2-fwd once a step and a
      validation batch (checked).
    - ``stream_csv_cv``: ``fit_cross_validation_streaming``, 3 folds of one
      epoch over the first two shards: finite scores, K1, K2-fwd and
      K2-bwd in every fold's fit.
    - ``stream_csv_estimator``: both leaderboards come back as
      ``Columns``; ``probe_evaluate`` on ``dnn_nets``' output (validation
      rows, AUC above 0.5); ``get_score_importances`` (``n_iter=1``, 2000
      rows): 39 finite rows, sorted.

12. ``gbm`` (four lines and ``gbm_wall``): GBM leaf features
    (``DeepTable(apply_gbm_features=True)``: ``models/gbm.py``, scikit-learn
    1.9.0's boosting and trees on the host, built from
    ``csrc/gbm_tree.cpp`` at first use), with ``pandas``, ``sklearn``,
    ``pyarrow``, ``lightgbm``, ``zstandard``, ``lz4`` and ``brotli``
    blocked (``ESTIMATOR_BLOCKED``):
    - ``gbm_leaves``: the parity tool's ``bank_deepfm``,
      ``glass_multiclass`` and ``boston_regression`` tables (binary,
      multiclass, regression), each held to its digest (``GBM_TABLES``);
      ``DefaultPreprocessor`` with ``gbm_params={'random_state': 0}`` on
      the row's train split gives ``gbm_leaf_*`` columns whose digest is
      scikit-learn's (``GBM_LEAF_DIGESTS``, recorded from the JAX
      package); the encoder's fit seconds a table.
    - ``gbm_options``: each option past the defaults (``GBM_OPTIONS``: the
      exponential loss on bank; absolute, Huber and quantile error on
      boston; ``ccp_alpha``, early stopping, ``init='zero'``,
      ``min_weight_fraction_leaf`` with ``subsample`` on all three) gives
      the leaves of the JAX package over scikit-learn
      (``GBM_OPTION_DIGESTS``); each fit's seconds.
    - ``gbm_card_vs_cpu``: ``DeepTable`` at the ``bank_deepfm`` row with
      the leaves, both ``gbm_feature_type``s, and as embeddings grown with
      ``GBM_FIT_OPTIONS`` (exponential loss, ``ccp_alpha``, early
      stopping), on the card and with ``device='cpu'`` from one seed,
      embedding dropout off, three steps: losses rtol 1e-4, parameters by
      ``check_params``; K1 and K2 launched on the card, the fields (K2's F)
      given.
    - ``gbm_criteo``: DeepFM at full criteo width (float32, D=16, DNN
      1024/512 relu) through ``DeepTable`` on 100,000 rows of
      ``load_criteo_synthetic``, 10 GBM leaf columns as embedding fields
      (K2 at F=36), one epoch at B=8192 with a fifth held out: the step
      losses fall, the GBM fit's seconds, examples/s, ``val_auc``; K1 and
      K2-bwd once a step, K2-fwd once a step and a validation batch
      (checked).

13. ``parquet`` (four lines and ``parquet_wall``), with the same packages
    blocked: ``parquet_read``: every file of ``tests/torch_data/`` (the
    bank table in two SNAPPY shards and edge cases: every kind with nulls,
    GZIP, uncompressed, data page v2, no dictionary, a dictionary that
    falls back to PLAIN, row groups, an index, zero rows; ZSTD, LZ4_RAW,
    LZ4 in Hadoop's framing, BROTLI, the DELTA encodings and
    BYTE_STREAM_SPLIT, INT96 timestamps; the Criteo-layout shards) read by
    ``columns.read_parquet`` to the digest of ``pd.read_parquet``'s table
    (``PARQUET_DIGESTS``), rows/s; AutoML's ``_read_table`` reads a
    ``.parquet`` path. ``parquet_codecs``: each codec's read rows/s and
    MB/s on the kinds files (``PARQUET_CODEC_FILES``, best of three), and
    the native ZSTD and LZ4 decoders (``csrc/parquet_codecs.cpp``) alone
    on the Criteo shards' pages, the BROTLI decoder alone on
    ``kinds_brotli.parquet``'s pages, MB/s out and in. ``parquet_fit``:
    ``fit_preprocessor_streaming`` and one epoch of
    ``DeepTable.fit(StreamingDataLoader)`` at the ``bank_deepfm`` row over
    the two shards: the step losses fall, K1, K2-fwd and K2-bwd once a
    step (checked). ``parquet_criteo``: DeepFM at full criteo width
    (``stream_csv``'s configuration, float32, B=8192) through
    ``DeepTable`` from the two ZSTD shards (``ChunkedSource`` →
    ``fit_preprocessor_streaming`` → ``StreamingDataLoader``), validated
    on the LZ4_RAW shard: the card against the CPU over three steps
    (losses rtol 1e-4, ``check_params``), then two epochs: the step
    losses fall, K1 and K2-bwd once a step, K2-fwd once a step and a
    validation batch (checked); the preprocessor's seconds, examples/s an
    epoch and the read's share of it (``columns.read_parquet``'s seconds,
    validation reads included, over the epoch's).

14. ``explain``: ``DeepTablesExplainer`` (Kernel SHAP without shap,
    ``utils/shap.py``) with ``shap`` blocked as well
    (``EXPLAIN_BLOCKED``), at the JAX defaults (background 100,
    ``nsamples='auto'``), on the ``bank_deepfm`` row (M = 16: sampled
    coalitions and the AIC lasso; K2-fwd in every predict, checked) and
    the ``glass_multiclass`` row (M = 10: every coalition), each fitted on
    the card by the parity tool's protocol and explained on
    ``EXPLAIN_ROWS`` test rows: glass's values equal the Shapley values enumerated from the
    same predictions, every row's values sum to ``f(x) - E f``, and the
    card's values equal the CPU path's on the same model (saved, loaded
    with ``device='cpu'``) where no synthetic prediction's hard class
    flips (the flips counted and bounded), all to ``EXPLAIN_ATOL``; the
    synthetic rows a second through ``predict``, the seconds a row.

15. ``eda``: ``columns_info``, ``reduce_mem_usage`` and
    ``top_categories`` on the ``bank_deepfm`` row's table as ``Columns``
    with the same packages blocked, at their digests (``EDA_DIGESTS``).

Then a ``profiler`` line
(``incomplete_windows``: the timing windows that
lost launches three times in a row, whose times are the means of the
launches seen), one ``kernels`` line (every ported kernel, its launches on
the serving and training runs, for the field-attention kernels also by
type, error and times), the ``nvidia-smi`` line again, and last
``{"ok": true, "device": {...}}``. Any failed check raises and exits
nonzero. Without a CUDA device, or outside a checkout, it prints no result
and exits nonzero.
"""

import contextlib
import functools
import hashlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, and the float32 rate outside the
# tensor cores (the FM kernel runs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

BF16_OPS_PER_S = 989e12  # dense bfloat16 tensor cores
TF32_OPS_PER_S = 495e12  # dense TF32 tensor cores

F_CRITEO, D_CRITEO, N_DENSE = 26, 16, 13
WDCN = 'Wide&Deep+DCN'
NETS = {'DeepFM': ['linear', 'fm_nets', 'dnn_nets'],
        'xDeepFM': ['linear', 'cin_nets', 'dnn_nets'],
        'AutoInt': ['autoint_nets'], 'AutoInt-fused': ['autoint_nets'],
        WDCN: ['linear', 'dnn_nets', 'dcn_nets']}
# Wide&Deep+DCN on the adult schema (benchmarks/bench_models.py:165-172):
# 8 categorical columns of these vocabularies (102 rows at D=16), 6 dense
# columns, DNN 1024/512 relu, 4 cross layers
ADULT_VOCABS = (9, 16, 7, 15, 6, 5, 2, 42)
N_DENSE_ADULT = 6
# the FGCNN output at criteo width: 26·2 + 13·2 new fields and the 26
F_FGCNN = 104
XDEEPFM_CIN = {'cross_layer_size': (128, 128), 'activation': 'relu'}
# AutoInt on the avazu-style schema (benchmarks/bench_models.py:176-184):
# 22 categorical columns, no dense ones, D=16, 3 blocks of 2 heads (dh=8);
# vocabularies max(id) + 1 over the bench's 8 batches of 8192 rows, + 1
F_AVAZU, D_AVAZU = 22, 16
AUTOINT_PARAMS = {'num_attention': 3, 'num_heads': 2, 'dropout_rate': 0,
                  'use_residual': True}
AUTOINT_MODELS = {'AutoInt': {}, 'AutoInt-fused': {'fuse_projections': True}}
AVAZU_BATCHES = 8
# the forward kernel a request runs, and its launches per padded chunk
SERVING_KERNEL = {'DeepFM': ('fm_fwd', 1), 'xDeepFM': ('cin_fwd', 2),
                  'AutoInt': ('fa_fwd', 3), 'AutoInt-fused': ('ab_fwd', 3),
                  WDCN: (None, 0)}
# the field-attention kernels' shapes: F=22, 2 heads of dh=8, the AutoInt
# training batch and half of it
FA_BATCHES = (8192, 4096)
FA_HEADLINE = ('bfloat16', 8192)
# K6-bwd: examples with a projection within this of 0 may take the other
# side of its relu mask in the kernel and the plain version (see
# ab_mask_margin)
AB_MASK_MARGIN = 1e-5
# (B, F, H, dh) past the kernels' register width and shared memory: K5 at
# F=200 and one head of 128, K6 at AutoInt's F=22 and U=128 in one head
FA_LIFTED = {'fa': (64, 200, 1, 128), 'ab': (64, 22, 1, 128)}
# xDeepFM's CIN layers, (F, G, L): G = 26 input fields, then 64 = 128 / 2
CIN_LAYERS = {'layer1': (26, 26, 128), 'layer2': (26, 64, 128)}
# ... and fgcnn_cin_nets' over the FGCNN output at criteo width, at the
# training batch only
CIN_FGCNN_LAYERS = {'fgcnn_layer1': (F_FGCNN, F_FGCNN, 128),
                    'fgcnn_layer2': (F_FGCNN, 64, 128)}
CIN_BATCHES = (4096, 8192, 4093)
CIN_HEADLINE = ('bfloat16', 'layer2', 8192)
# a float32 (layer, F, G, L, B) past the tensor-core kernels' shared memory
# (F + G > 252 for K4, G > 228 for K3's dW pass): the CUDA-core kernels
CIN_SIMT_EDGE = ('simt_edge', 26, 229, 193, 1024)
# xDeepFM's layers 1-2 at the paper's 200 maps (perfbench's
# xdeepfm_criteo_synth: D = 10), float32 (layer, F, G, L, B, D): K3's dz
# planes do not fit a block, so its dx0/dh pass splits dz in registers
CIN_200_MAPS = ('xdeepfm_200maps', 26, 200, 200, 8192, 10)
# the tensor-core K4 and K3 kernels as ptxas names them (mangled: one
# template a pass, instantiated for each type), by design and G tile: the
# card line reports each one's registers and spills
CIN_PTXAS = {
    design: {'fwd': f'cin_fwd_wgmma_kernelI{t}E',
             'dx_n32': f'cin_bwd_dx_wgmma_kernelI{t}Li32E',
             'dx_n64': f'cin_bwd_dx_wgmma_kernelI{t}Li64E',
             'dw': f'cin_bwd_dw_wgmma_kernelI{t}E'}
    for design, t in (('wgmma', '13__nv_bfloat16'), ('wgmma_f32', 'f'))}
CIN_PTXAS['wgmma_f32_rs'] = {
    'dx_n32': 'cin_bwd_dx_rs_wgmma_kernelILi32E',
    'dx_n64': 'cin_bwd_dx_rs_wgmma_kernelILi64E'}
# the K4 and K3 kernels of each design, as the profiler names them
CIN_DESIGN_KERNELS = {
    design: (f'cin_fwd_wgmma_kernel<{t}>', f'cin_bwd_dx_wgmma_kernel<{t},',
             f'cin_bwd_dw_wgmma_kernel<{t}>')
    for design, t in (('wgmma', '__nv_bfloat16'), ('wgmma_f32', 'float'))}
CIN_DESIGN_KERNELS['simt'] = ('cin_fwd_kernel<', 'cin_bwd_dx_kernel<',
                              'cin_bwd_dw_kernel<')
KERNEL_BATCHES = (1, 8, 64, 512, 4096, 4093, 8192, 12288)
TRAIN_KERNEL_BATCHES = (64, 512, 4093, 8192)
REQUESTS = (1, 37, 4096, 10000)
REPEATS = 5
HEADLINE = ('bfloat16', 4096)  # the kernels line: bench dtype, largest bucket
TRAIN_HEADLINE = ('bfloat16', 8192)  # ... and the training batch of bench.py
RTOL = {'float32': 1e-5, 'bfloat16': 1e-2}
SERVING_ATOL = {'float32': 1e-5, 'bfloat16': 1e-2}
TRAIN_BATCH, TRAIN_STEPS, TRAIN_EPOCHS = 8192, 8, 3
# the card-against-CPU comparison's batch (three of them and one validation)
COMPARE_BATCH = {'DeepFM': TRAIN_BATCH, 'xDeepFM': 1024, 'AutoInt': 1024,
                 'AutoInt-fused': 1024, WDCN: TRAIN_BATCH}
# against index_add_: a segment cut by the kernel's chunks is added as a
# sum of pieces, another association, so only rounding may differ
EMB_GRAD_RTOL = 1e-5
# card against CPU after three float32 Adam steps (see check_params)
PARAM_ATOL, PARAM_OUTLIERS = 2e-4, 1e-2
# the heads phase: DeepFM at full criteo width under bfloat16, three steps
# of each run (task, classes, loss, optimizer, extra config)
HEADS_STEPS = 3
HEADS_RUNS = (
    ('multiclass', 7, 'categorical_crossentropy', 'adamw', {}),
    ('regression', 1, 'mse', 'rmsprop', {}),
    ('regression', 1, 'huber', 'adagrad', {}),
    ('multilabel', 4, 'multilabel_binary_crossentropy', 'lamb', {}),
    ('binary', 2, 'binary_focal_loss', 'adam', {}),
    ('binary', 2, 'ghmc', 'adam', {}),  # GHMCLoss(momentum=0.75)
    ('binary', 2, 'binary_crossentropy', 'adam',
     {'embeddings_regularizer': 'l2',
      'embeddings_activity_regularizer': 'l1'}),
)
HEADS_REQUEST = 4093  # rows of the multiclass Predictor request
# the zoo phase: every other builder alone at criteo width under bfloat16,
# then DeepFM with a var-len column; three steps, a request, and the card
# against the CPU at the batch each states (the CPU plain path
# materialises fgcnn_cin's pair and fgcnn_afm's pair products)
ZOO = ('afm_nets', 'opnn_nets', 'ipnn_nets', 'pnn_nets', 'cross_nets',
       'cross_dnn_nets', 'fg_nets', 'fgcnn_cin_nets', 'fgcnn_fm_nets',
       'fgcnn_afm_nets', 'fgcnn_ipnn_nets', 'fgcnn_dnn_nets', 'fibi_nets',
       'fibi_dnn_nets')
ZOO_VARLEN = 'DeepFM+var_len'
# the determinism phase fits the zoo at this depth (8192-row steps)
DETERMINISM_ZOO_STEPS = 2
# the dae phase: rows of the 13 dense criteo columns, epochs, and the rows
# of the card-against-CPU epoch
DAE_ROWS, DAE_EPOCHS, DAE_COMPARE_ROWS = 65_536, 3, 8192
# the distributed phase's steps
DIST_STEPS = 3
ZOO_STEPS = 3
ZOO_REQUEST = 4093
ZOO_COMPARE_BATCH = {'fgcnn_cin_nets': 256, 'fgcnn_afm_nets': 512,
                     'fgcnn_ipnn_nets': 512}
ZOO_COMPARE_DEFAULT = 1024
# the nets that read the dense inputs only through bn_concat_emb_dense, so
# that the dense BatchNorm's bias gets a gradient that is zero in exact
# arithmetic: held within this share of the model's largest gradient, and
# its parameters within 2·steps·lr (Adam moves an element by at most ~lr a
# step whatever the gradient)
ZOO_DENSE_VIA_BN = ('opnn_nets', 'ipnn_nets', 'pnn_nets', 'cross_nets',
                    'cross_dnn_nets')
ZOO_ROUNDING = 1e-6
ZOO_ROUNDING_PARAM_ATOL = 2 * 3 * 1e-3
# the var-len column: 20 tokens (padded with 0) of a 1000-token vocabulary,
# max pooling; its field stacks onto the 26 (K2 at F=27)
VARLEN_TOKENS, VARLEN_VOCAB = 20, 1000
HEADS_METRICS = {'binary': ['AUC'], 'multiclass': ['accuracy'],
                 'regression': ['mse'], 'multilabel': ['logloss']}
# the stream phase: DeepFM trained from Criteo TSV shards through the native
# parser and CriteoStreamLoader, at the JAX package's ingest configuration
# (benchmarks/bench_ingest_e2e.py:65, 91-109): these hash buckets (855,648
# table rows), D=16, 13 dense inputs, DNN 1024/512 relu, bfloat16, B=8192;
# two training shards and a validation one, read 16 MB at a time
STREAM_BUCKETS = (100_000,) * 7 + (8192,) * 19
STREAM_ROWS = {'train': (165_000, 165_000), 'val': (41_000,)}
STREAM_CHUNK_BYTES = 16 << 20
STREAM_EPOCHS = 2
# the label's columns: the first three draw their tokens from pools of these
# sizes (the rest uniformly from 2^32, as the bench draws them all), so that
# a logistic model of them and of the first three dense values can be learnt
STREAM_POOLS = (50, 500, 5000)
STREAM_PARSE_CHECK_ROWS = 2000  # native parser against its Python twin
STREAM_COMPARE_STEPS = 3  # card against CPU: steps_per_epoch
STREAM_DETERMINISM_STEPS = 6
STREAM_SEED = 21
# streaming evaluate/predict against the in-memory ones on the same rows
STREAM_EVAL_ATOL = 1e-5
# the estimator phase: the card against the CPU after three steps (the
# train phase's rules hold the parameters within 2e-4; a probability moves
# by at most a quarter of its logit's change), the CV folds, the serving
# request's rows, and BASELINE.md's rows (JAX package, TPU v5e) of the
# three kernel rows of the parity tool: (metric, mean, sigma)
ESTIMATOR_STEPS, ESTIMATOR_PROBA_ATOL = 3, 1e-3
ESTIMATOR_RUNNING_RTOL = 1e-5
ESTIMATOR_FOLDS, ESTIMATOR_REQUEST = 3, 512
ESTIMATOR_BASELINE = {
    'bank_deepfm': {'auc': (0.9344, 0.0014), 'logloss': (0.2645, 0.0077)},
    'criteo_xdeepfm': {'auc': (0.8740, 0.0032),
                       'logloss': (0.3718, 0.0032)},
    'avazu_autoint': {'auc': (0.7299, 0.0178), 'logloss': (0.4393, 0.0302)},
}
ESTIMATOR_BLOCKED = ('pandas', 'sklearn', 'pyarrow', 'lightgbm', 'zstandard',
                     'lz4', 'brotli')
# the stream_csv phase: DeepFM at full criteo width (the package's default
# float32 policy) through DeepTable from CSV shards in the Criteo
# display-ads layout, read by columns.read_csv with pandas and scikit-learn
# blocked: four training shards and a validation one of
# load_criteo_synthetic's rows, ~5% of dense and ~3% of categorical fields
# empty; chunks of STREAM_CSV_CHUNK rows; the probe's rows of the
# validation shard (train, test) and the importances' rows
STREAM_CSV_SHARDS, STREAM_CSV_ROWS, STREAM_CSV_VAL_ROWS = 4, 50_000, 10_000
STREAM_CSV_CHUNK = 25_000
STREAM_CSV_MISSING = {'dense': 0.05, 'categorical': 0.03}
STREAM_CSV_SEED = 31
STREAM_CSV_EPOCHS, STREAM_CSV_FOLDS = 2, 3
# the shards the streaming CV folds (each fold reads them three times)
STREAM_CSV_CV_SHARDS = 2
STREAM_CSV_PROBE_ROWS = (6000, 4000)
STREAM_CSV_IMPORTANCE_ROWS = 2000
# the streamed imputation means against the in-memory ones: sums of chunks
# against one pairwise sum
STREAM_CSV_MEAN_RTOL = 1e-9
# the digests (parity_quality.table_digest) of those rows' tables as numpy
# 2.0 draws them: the tables of BASELINE.md's rows and of the port's CPU
# parity runs. The port's loaders draw their Zipf ids as numpy 2.0 does on
# any numpy (data/datasets.py, zipf), so the card's tables are these; a row
# on another table would be held to half way from chance to its
# BASELINE.md mean instead
ESTIMATOR_TABLES = {'bank_deepfm': '5d67b946b3437391',
                    'criteo_xdeepfm': 'ff1371b6dfcecb53',
                    'avazu_autoint': '766566b60adf6216'}
# the gbm phases: GBM leaf features (models/gbm.py, scikit-learn 1.9.0's
# trees) on the parity tool's binary, multiclass and regression tables,
# whose digests (parity_quality.table_digest) are these on numpy 2.0 and
# 2.3 alike, fitted by DefaultPreprocessor with apply_gbm_features=True and
# these gbm_params on the row's train split. GBM_LEAF_DIGESTS are the first
# 16 hex digits of the sha256 of the gbm_leaf_* columns (int32, C order) of
# the JAX package's preprocessor over scikit-learn 1.9.0 on the same split
# (tests/test_torch_preprocessor.py recomputes them)
GBM_ROWS = ('bank_deepfm', 'glass_multiclass', 'boston_regression')
GBM_TABLES = {'bank_deepfm': '5d67b946b3437391',
              'glass_multiclass': '9a57e7e1877f6326',
              'boston_regression': '26bf7ae3c8ce8197'}
GBM_PARAMS = {'random_state': 0}
GBM_LEAF_DIGESTS = {'bank_deepfm': 'cb3a29bb9920a5e0',
                    'glass_multiclass': 'ba0495f7d44ecc7c',
                    'boston_regression': 'a1db61fc7042060c'}
GBM_FEATURE_TYPES = ('embedding', 'dense')
# each option of scikit-learn's gradient boosting past the defaults, on the
# rows whose task takes it, with GBM_PARAMS: (rows, gbm_params), and the
# leaves' digests of the JAX package's preprocessor over scikit-learn 1.9.0
# (tests/test_torch_preprocessor.py recomputes them)
GBM_OPTIONS = {
    'exponential': (('bank_deepfm',), {'loss': 'exponential'}),
    'absolute_error': (('boston_regression',), {'loss': 'absolute_error'}),
    'huber': (('boston_regression',), {'loss': 'huber', 'alpha': 0.8}),
    'quantile': (('boston_regression',), {'loss': 'quantile',
                                          'alpha': 0.3}),
    'ccp_alpha': (GBM_ROWS, {'ccp_alpha': 0.002, 'max_depth': 5}),
    'n_iter_no_change': (GBM_ROWS, {'n_iter_no_change': 2,
                                    'n_estimators': 40,
                                    'learning_rate': 0.5}),
    'init_zero': (GBM_ROWS, {'init': 'zero'}),
    'min_weight_fraction_leaf': (GBM_ROWS, {'min_weight_fraction_leaf': 0.05,
                                            'subsample': 0.8}),
}
GBM_OPTION_DIGESTS = {
    'exponential': {'bank_deepfm': '93086d2679fbc7d4'},
    'absolute_error': {'boston_regression': '8fd392ade6816cd8'},
    'huber': {'boston_regression': '11bc7a68aa25cdc0'},
    'quantile': {'boston_regression': '53d8e8db1c0b94a7'},
    'ccp_alpha': {'bank_deepfm': '45f22c2f4005243e',
                  'glass_multiclass': '79cbfaf46592bd23',
                  'boston_regression': 'a56c04362a9254cc'},
    'n_iter_no_change': {'bank_deepfm': '1c1d7e798f8aeaeb',
                         'glass_multiclass': 'e06969cfc842fe24',
                         'boston_regression': '2d31748ef5b76dec'},
    'init_zero': {'bank_deepfm': '95f491d528fa48ca',
                  'glass_multiclass': 'c46acdd814066092',
                  'boston_regression': 'a1db61fc7042060c'},
    'min_weight_fraction_leaf': {'bank_deepfm': 'cc2c06e3f4b9191d',
                                 'glass_multiclass': 'bbe3405310f6dcf7',
                                 'boston_regression': 'fda455e9b374199c'}}
# the DeepTable fit of bank_deepfm on leaves grown with these options
GBM_FIT_OPTIONS = {'loss': 'exponential', 'ccp_alpha': 1e-4,
                   'n_iter_no_change': 3, 'n_estimators': 30,
                   'learning_rate': 0.3}
# gbm_criteo: DeepFM at full criteo width with 10 GBM leaf columns, fitted
# through DeepTable on these rows of load_criteo_synthetic, one epoch,
# a fifth of the rows held out for validation
GBM_CRITEO_ROWS, GBM_CRITEO_VALIDATION = 100_000, 0.2
# the parquet phase: the files of tests/torch_data/ (written by pyarrow
# 25.0.0 from pandas 3.0.3, tests/torch_parquet_fixtures.py) and the
# digests (columns_digest) of pd.read_parquet's tables, which
# columns.read_parquet must give (tests/test_torch_parquet.py recomputes
# them); the bank shards feed a streaming fit of the bank_deepfm row
PARQUET_DIR = 'tests/torch_data'
PARQUET_DIGESTS = {
    'bank_0.parquet': '191fc5979ff6126f',
    'bank_1.parquet': '0c5b283b23d176bf',
    'criteo_train_0.parquet': '8a19062c4a770994',
    'criteo_train_1.parquet': '37b1dc9e615375f8',
    'criteo_val.parquet': '0ef1b662567792ba',
    'dictionary_fallback.parquet': 'd991adc846c14e79',
    'index.parquet': '367d5c71c2430cd9',
    'int96.parquet': 'd8f2622ecbb0d419',
    'kinds_delta.parquet': 'f581e7d215c6a2c7',
    'kinds_brotli.parquet': 'e21d844a442eba17',
    'kinds_gzip.parquet': 'e21d844a442eba17',
    'kinds_lz4_hadoop.parquet': 'e21d844a442eba17',
    'kinds_lz4_raw.parquet': 'e21d844a442eba17',
    'kinds_no_dictionary.parquet': 'f581e7d215c6a2c7',
    'kinds_page_v2.parquet': 'e21d844a442eba17',
    'kinds_snappy.parquet': 'e21d844a442eba17',
    'kinds_uncompressed.parquet': 'e21d844a442eba17',
    'kinds_zstd.parquet': 'e21d844a442eba17',
    'range_index.parquet': 'd66a8062724de9e8',
    'row_groups.parquet': 'e21d844a442eba17',
    'zero_rows.parquet': '53e707318ac3f886'}
PARQUET_BANK = ('bank_0.parquet', 'bank_1.parquet')
PARQUET_CHUNK = 5000
# the eda phase: columns_info, reduce_mem_usage and top_categories on the
# bank_deepfm row's table as Columns with pandas blocked; the tables'
# digests (parity_quality.table_digest) as numpy 2.0 computes them here,
# columns_info's statistics rounded to EDA_DIGITS significant digits: their
# float sums move in the last bit between numpy releases (three of the 17
# deviations on numpy 2.3.5), as pandas' own do (tests/test_torch_aux.py
# recomputes them and holds the helpers to the JAX package's on the same
# DataFrame)
EDA_DIGESTS = {'columns_info': '9869d1c7dd7b68a1',
               'reduce_mem_usage': '05ce820105ba9d72',
               'top_categories': ['self-employed', 'housemaid', 'retired',
                                  'blue-collar', 'admin.']}
EDA_TOP = ('job', 5)
EDA_DIGITS = 12
# the Criteo-layout shards (tests/torch_parquet_fixtures.py): two ZSTD
# training shards of 16,384 rows (one dictionary-encoded, one with
# DELTA_BYTE_ARRAY tokens and BYTE_STREAM_SPLIT dense columns) and an
# LZ4_RAW validation shard of 4,096; DeepFM at full criteo width fits two
# epochs from them in chunks of PARQUET_CRITEO_CHUNK rows
PARQUET_CRITEO = ('criteo_train_0.parquet', 'criteo_train_1.parquet')
PARQUET_CRITEO_VAL = 'criteo_val.parquet'
PARQUET_CRITEO_CHUNK = 8192
PARQUET_CRITEO_EPOCHS = 2
# the files each codec's read rate is taken on
PARQUET_CODEC_FILES = {'UNCOMPRESSED': 'kinds_uncompressed.parquet',
                       'SNAPPY': 'kinds_snappy.parquet',
                       'GZIP': 'kinds_gzip.parquet',
                       'ZSTD': 'kinds_zstd.parquet',
                       'LZ4_RAW': 'kinds_lz4_raw.parquet',
                       'LZ4': 'kinds_lz4_hadoop.parquet',
                       'BROTLI': 'kinds_brotli.parquet'}
# the explain phase: DeepTablesExplainer (Kernel SHAP, utils/shap.py) at
# the JAX defaults (a background of 100 rows, nsamples 'auto') with shap
# blocked too, on the parity tool's bank_deepfm row (M = 16 varying
# features: 2080 sampled coalitions, the AIC lasso; K2-fwd in every
# predict) and glass_multiclass row (M = 10: all 1022 coalitions), each
# fitted on the card by the parity tool's protocol (EPOCHS, patience 3: a
# weaker bank model calls every row 'yes', 81% of the table, and explains
# nothing); EXPLAIN_ROWS test rows explained
# (cut from a larger set to keep the phase near a minute; the background
# is not cut). Glass's values equal the Shapley values the phase
# enumerates from the same predictions to EXPLAIN_ATOL; every row's sum
# equals f(x) - E f to EXPLAIN_ATOL; the card's values equal the port's
# CPU path on the same model (saved and loaded on the CPU) to EXPLAIN_ATOL
# where the two give the same hard class on every synthetic row; a
# probability within rounding of 0.5 may flip, and the share of synthetic
# predictions that flip must stay under EXPLAIN_FLIP_SHARE
EXPLAIN_BLOCKED = ESTIMATOR_BLOCKED + ('shap',)
EXPLAIN_ROWS = 2
EXPLAIN_ATOL = 1e-9
EXPLAIN_FLIP_SHARE = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, message):
    if not cond:
        raise AssertionError(message)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def call_ms(torch, fn, inputs, iters):
    """Mean milliseconds between back-to-back calls of ``fn``, from CUDA
    events: the host's launch cost wherever that exceeds the device's."""
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, prof):
    """The device-side events of a ``torch.profiler`` run (kernels, copies,
    fills), busiest first. User annotations on the device's timeline (such
    as ``Optimizer.step#Adam.step``) span kernels already counted and are
    left out."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    return sorted(events, key=lambda e: -e.self_device_time_total)


def profile_window(torch, work, tries=3):
    """Run ``work()`` under ``torch.profiler``: the device events (busiest
    first), their total µs and the wall µs of the window. A window in which
    the profiler records no device activity at all (it happens, rarely, on
    the card) is run again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t)
        device = device_kernels(torch, prof)
        busy_us = sum(e.self_device_time_total for e in device)
        if busy_us > 0:
            return device, busy_us, wall_us
    raise AssertionError('the profiler saw no device time')


def device_ms(torch, fn, inputs, iters, by_kernel=False):
    """Mean device time of one call of ``fn`` in ms: the sum of the
    kernels it launches, from ``torch.profiler``; with ``by_kernel`` also
    {kernel name: ms a call}."""
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()

    def work():
        for i in range(iters):
            fn(inputs[i % len(inputs)])
    # the profiler now and then loses a few calls' kernels from a window (a
    # kernel seen other than a whole number of times a call; three windows
    # in a row have lost them): such a window is run again, up to twice.
    # A kernel's time a call is its mean time a launch times its launches
    # a call, so a window still short after that gives the mean of the
    # launches it saw, not a sum short of some; it is listed in
    # INCOMPLETE_WINDOWS.
    for _ in range(3):
        events, _, _ = profile_window(torch, work)
        lost = [(e.key[:60], e.count) for e in events
                if e.count < iters or e.count % iters]
        if not lost:
            break
    if lost:
        INCOMPLETE_WINDOWS.append({'iters': iters, 'kernels': lost})
    split = {e.key: e.self_device_time_total / e.count / 1e3
             * max(1, round(e.count / iters)) for e in events}
    ms = sum(split.values())
    return (ms, split) if by_kernel else ms


# device_ms's windows that lost launches three times in a row
INCOMPLETE_WINDOWS = []


def fm_bound(B, F, D, itemsize):
    """Least time for FM pooling in ms, and what bounds it: read x once,
    write one value a row; 3 operations per element (add, multiply-add)
    and 3 per (row, d)."""
    bytes_ms = 1e3 * (B * F * D + B) * itemsize / HBM_BYTES_PER_S
    ops_ms = 1e3 * (3 * B * F * D + 3 * B * D) / FP32_OPS_PER_S
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


# ptxas's report of each kernel (mangled name): registers and spill bytes,
# filled by card_phase
PTXAS = {}


def ptxas_by_kernel(lines):
    """{mangled name: {'registers', 'spill_stores', 'spill_loads'}} from
    an ``nvcc -Xptxas -v`` log."""
    out, kernel = {}, None
    for line in lines:
        if 'Function properties for' in line:
            kernel = line.rsplit(' ', 1)[1]
            out[kernel] = {}
        elif kernel and 'spill stores' in line:
            for n, what in re.findall(r'(\d+) bytes spill (stores|loads)',
                                      line):
                out[kernel][f'spill_{what}'] = int(n)
        elif kernel and re.search(r'Used \d+ registers', line):
            out[kernel]['registers'] = int(
                re.search(r'Used (\d+) registers', line).group(1))
    return out


def kernel_ptxas(pattern):
    """ptxas's report (registers, spill bytes) of the one kernel whose
    mangled name matches ``pattern``."""
    found = [(re.search(pattern, k).group(0), v) for k, v in PTXAS.items()
             if re.search(pattern, k)]
    check(len(found) == 1, f'ptxas reports {len(found)} kernels {pattern}')
    return dict(found[0][1], kernel=found[0][0])


# the kernel that each design of K2-fwd and K1 launches: a part of its name
# in the profiler
DESIGN_KERNELS = {'fm_fwd': {'vec16': 'fm_fwd_vec16_kernel',
                             'scalar': 'fm_fwd_kernel<'},
                  'emb_grad': {'segment_v4': 'segment_kernel<float4>',
                               'segment_scalar': 'segment_kernel<float>'}}
# K1's kernels as ptxas names them (mangled), by design
EMB_GRAD_PTXAS = {'segment_v4': ('segment_kernelI6float4E',
                                 'merge_kernelI6float4E'),
                  'segment_scalar': ('segment_kernelIfE', 'merge_kernelIfE')}
# the kernels of K1 itself; the rest of a call's kernels are the sort's
EMB_GRAD_OWN = {'fill': ('zero_kernel',),
                'segment': ('segment_kernel<', 'merge_kernel<')}


def ran_design(kernel, design, split):
    """Checks that the kernels that ran (``split``: the profiler's kernel
    names) are the design's."""
    want = DESIGN_KERNELS[kernel][design]
    others = [v for d, v in DESIGN_KERNELS[kernel].items() if d != design]
    names = list(split)
    check(any(want in n for n in names)
          and not any(o in n for o in others for n in names),
          f'{kernel}: the {design} design should run {want}, ran {names}')


def fm_ptxas(fm_module, design, dtype, F, D):
    """ptxas's report of the K2-fwd kernel a call at (F, D) in ``dtype``
    runs."""
    t = '13__nv_bfloat16' if dtype.itemsize == 2 else 'f'
    if design == 'vec16':
        chunks, slices = fm_module.fm_vec16_plan(dtype, F, D)
        return kernel_ptxas(f'fm_fwd_vec16_kernelI{t}Li{chunks}ELi{slices}EE')
    group = 1 << max(0, min(D, 32) - 1).bit_length()
    return kernel_ptxas(f'fm_fwd_kernelI{t}Li{group}EE')


def card_phase(torch, _build):
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas, spills = {}, {}
    for log in sorted(build_dir.glob('lib*.log')):
        lines = log.read_text().splitlines()
        ptxas[log.stem[3:]] = sorted({line.split(':', 1)[1].strip()
                                      for line in lines
                                      if 'registers' in line})
        PTXAS.update(ptxas_by_kernel(lines))
        # every kernel (mangled name) that spills, with ptxas's line
        kernel = None
        for line in lines:
            if 'Function properties for' in line:
                kernel = line.rsplit(' ', 1)[1]
            elif 'spill stores' in line and \
                    '0 bytes spill stores, 0 bytes spill loads' not in line:
                spills.setdefault(log.stem[3:], {})[kernel] = line.strip()
    emit({'phase': 'card', 'nvidia_smi': smi,
          'kind': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(),
          'python': sys.version.split()[0], 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'build_s': build_s,
          'sources': [p.name for p in _build.sources()], 'ptxas': ptxas,
          'spills': spills,
          'cin_ptxas': {design: {k: kernel_ptxas(pattern)
                                 for k, pattern in kernels.items()}
                        for design, kernels in CIN_PTXAS.items()},
          'tf32': {'matmul': torch.backends.cuda.matmul.allow_tf32,
                   'cudnn': torch.backends.cudnn.allow_tf32}})
    return smi


def n_buffers(nbytes):
    """Distinct inputs to rotate over so that they come from HBM."""
    return max(1, min(64, math.ceil(2 * L2_BYTES / nbytes)))


def fm_row(torch, fm_module, dtype, B, offset, gen, F=F_CRITEO):
    """One ``fm_fwd`` row: the kernel against fm_reference on (B, F, 16)
    inputs ``offset`` elements into their storage, timed over rotated
    inputs."""
    fm, fm_reference = fm_module.fm, fm_module.fm_reference
    shape = (B, F, D_CRITEO)
    n = B * F * D_CRITEO

    def make():
        flat = torch.randn(n + offset, generator=gen, device='cuda').to(dtype)
        return flat[offset:].view(shape)
    x = make()
    out = fm(x)
    ref = fm_reference(x.float())
    torch.cuda.synchronize()
    check(out.shape == (B, 1) and out.dtype == dtype,
          f'fm returned {tuple(out.shape)} {out.dtype}')
    dtype_name = str(dtype).split('.')[1]
    rtol = RTOL[dtype_name]
    # FM is a difference of two sums of size Σ x²: the absolute term of the
    # tolerance scales with it
    scale = float(x.float().square().sum(dim=(1, 2)).max())
    err = (out.float() - ref).abs()
    max_abs_err = float(err.max())
    check(bool((err <= rtol * scale + rtol * ref.abs()).all()),
          f'fm kernel disagrees with fm_reference: {dtype_name} B={B} '
          f'x_offset={offset} max_abs_err={max_abs_err}')
    # rotate over enough distinct inputs to read them from HBM
    n_buf = n_buffers(x.nbytes)
    bufs = [x] + [make() for _ in range(n_buf - 1)]
    iters = 200 if B <= 4096 else 100
    bound_ms, bound_by = fm_bound(B, F, D_CRITEO, x.element_size())
    design = fm_module.fm_design(dtype, B, F, D_CRITEO,
                                 fm_module.pointer_alignment(x))
    # F=26 and F=104 at D=16 are the main path's shapes at every batch; x
    # one element into its storage is not 16-byte aligned
    want = 'scalar' if offset else 'vec16'
    check(design == want, f'fm at {dtype_name} B={B} F={F} x_offset='
                          f'{offset} runs the {design} design, not {want}')
    ms, split = device_ms(torch, fm, bufs, iters, by_kernel=True)
    ran_design('fm_fwd', design, split)
    return {
        'dtype': dtype_name, 'B': B, 'F': F, 'D': D_CRITEO,
        'x_offset': offset, 'design': design, 'max_abs_err': max_abs_err,
        'rtol': rtol, 'atol': rtol * scale, 'ms': ms,
        'plain_ms': device_ms(torch, fm_reference, bufs, iters),
        'call_ms': call_ms(torch, fm, bufs, iters),
        'plain_call_ms': call_ms(torch, fm_reference, bufs, iters),
        'bound_ms': bound_ms, 'bound_by': bound_by, 'buffers': n_buf,
        'ptxas': fm_ptxas(fm_module, design, dtype, F, D_CRITEO)}


def kernel_phase(torch, fm_module):
    """FM kernel against fm_reference on the card; returns the rows."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        rows += [fm_row(torch, fm_module, dtype, B, 0, gen)
                 for B in KERNEL_BATCHES]
        rows.append(fm_row(torch, fm_module, dtype, HEADLINE[1], 1, gen))
        # fgcnn_fm_nets: FM over the FGCNN output, at the training batch
        rows.append(fm_row(torch, fm_module, dtype, TRAIN_BATCH, 0, gen,
                           F=F_FGCNN))
    emit({'phase': 'kernel', 'kernel': 'fm_fwd', 'library_ms': None,
          'library_note': 'no single PyTorch call computes FM pooling',
          'rows': rows})
    return rows


def fm_bwd_bound(B, F, D, itemsize):
    """Least time for the FM gradient in ms: read x and g once, write dx
    once; 3 operations per element (the sum over f, a subtraction, a
    multiplication)."""
    bytes_ms = 1e3 * (2 * B * F * D + B) * itemsize / HBM_BYTES_PER_S
    ops_ms = 1e3 * 3 * B * F * D / FP32_OPS_PER_S
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def emb_grad_bound(N, D, V):
    """Least time for the embedding gradient in ms: read the N int32 ids and
    the (N, D) float32 g once, write the (V, D) float32 gradient once (the
    zero fill of the rows no id touches included); one addition per element
    of g."""
    bytes_ms = 1e3 * (4 * N + 4 * N * D + 4 * V * D) / HBM_BYTES_PER_S
    ops_ms = 1e3 * N * D / FP32_OPS_PER_S
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def fm_bwd_kernel_phase(torch, fm_module):
    """FM backward kernel against fm_backward_reference on the card."""
    fm_backward = fm_module.fm_backward
    reference = fm_module.fm_backward_reference
    gen = torch.Generator(device='cuda').manual_seed(1)
    rows = []
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        itemsize = torch.empty((), dtype=dtype).element_size()
        for B in TRAIN_KERNEL_BATCHES:
            shape = (B, F_CRITEO, D_CRITEO)

            def make():
                return (torch.randn(shape, generator=gen, device='cuda')
                        .to(dtype),
                        torch.randn((B, 1), generator=gen, device='cuda')
                        .to(dtype))
            x, g = make()
            dx = fm_backward(x, g)
            ref = reference(x, g)
            torch.cuda.synchronize()
            check(dx.shape == x.shape and dx.dtype == dtype,
                  f'fm_backward returned {tuple(dx.shape)} {dx.dtype}')
            rtol = RTOL[dtype_name]
            # dx = g·(Σ_f x − x): its terms are of size |g|·Σ_f |x|
            scale = float((g.float().abs().reshape(-1, 1, 1)
                           * x.float().abs().sum(dim=1, keepdim=True)).max())
            err = (dx.float() - ref.float()).abs()
            max_abs_err = float(err.max())
            check(bool((err <= rtol * scale + rtol * ref.float().abs()).all()),
                  f'fm_backward kernel disagrees with fm_backward_reference: '
                  f'{dtype_name} B={B} max_abs_err={max_abs_err}')
            bufs = [(x, g)] + [make() for _ in range(
                n_buffers(2 * x.nbytes) - 1)]
            iters = 200 if B <= 4096 else 100
            bound_ms, bound_by = fm_bwd_bound(B, F_CRITEO, D_CRITEO, itemsize)

            def kernel(a):
                return fm_backward(*a)

            def plain(a):
                return reference(*a)
            rows.append({
                'dtype': dtype_name, 'B': B, 'F': F_CRITEO, 'D': D_CRITEO,
                'max_abs_err': max_abs_err, 'rtol': rtol,
                'atol': rtol * scale,
                'ms': device_ms(torch, kernel, bufs, iters),
                'plain_ms': device_ms(torch, plain, bufs, iters),
                'call_ms': call_ms(torch, kernel, bufs, iters),
                'plain_call_ms': call_ms(torch, plain, bufs, iters),
                'bound_ms': bound_ms, 'bound_by': bound_by,
                'buffers': len(bufs)})
            del bufs, x, g
    emit({'phase': 'kernel', 'kernel': 'fm_bwd', 'library_ms': None,
          'library_note': 'no single PyTorch call computes the FM gradient',
          'rows': rows})
    return rows


def cin_bound(kernel, B, F, G, L, D, itemsize):
    """Least time of the CIN contraction (``cin_fwd``) or its gradient
    (``cin_bwd``) in ms, what bounds it and its operations; then, for
    float32, the floor of a float32-accurate product on the tensor cores
    (None for bfloat16), and the least time off the tensor cores (ms).
    Bytes: each input read once, each output written once (z and dW
    float32, dx0 and dh in the input type). Operations: the GEMM (2·L·F·G
    per column) and the pair products (F·G per column); the gradient twice
    the GEMM (dpair and dW) and 5·F·G per column (pair, dx0 and dh products
    and sums). The bound takes all of them at the card's peak for the input
    type: bfloat16's 989 TFLOP/s, float32's 495, TF32's rate, the most the
    card does on 32-bit operands. ``split_floor_ms``: the least time of an
    exact float32 product on the tensor cores, three TF32 passes of the
    GEMM (the rest on the CUDA cores alongside), a choice of design that
    the function does not need. ``simt_bound_ms``: every operation at the
    CUDA cores' 67 TFLOP/s."""
    N = B * D
    if kernel == 'cin_fwd':
        nbytes = itemsize * (N * F + N * G + L * F * G) + 4 * L * N
        gemm, rest = 2 * L * F * G * N, F * G * N
    else:
        nbytes = itemsize * (2 * N * F + 2 * N * G + L * F * G + L * N) \
            + 4 * L * F * G
        gemm, rest = 4 * L * F * G * N, 5 * F * G * N
    ops = gemm + rest
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / (BF16_OPS_PER_S if itemsize == 2
                          else TF32_OPS_PER_S)
    bound = (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms,
                                                            'operations')
    split_floor_ms = None if itemsize == 2 else max(
        bytes_ms, 1e3 * 3 * gemm / TF32_OPS_PER_S,
        1e3 * rest / FP32_OPS_PER_S)
    return bound + (ops, split_floor_ms,
                    max(bytes_ms, 1e3 * ops / FP32_OPS_PER_S))


def cin_kernel_phase(torch, cin_module):
    """K4 (``cin_fwd``) and K3 (``cin_bwd``) against their plain versions
    on the card, at the xDeepFM layers' shapes and fgcnn_cin_nets' (F=104)
    at the training batch; returns the rows by kernel. Every output is held to 1e-5 times the sum of the magnitudes
    of its terms (both sum float32 products of the same inputs, in another
    order); dx0 and dh in bfloat16 add rtol 1e-2 for their one rounding."""
    fwd, bwd = cin_module.cin_fwd, cin_module.cin_bwd
    fwd_ref, bwd_ref = cin_module.cin_fwd_reference, cin_module.cin_bwd_reference
    gen = torch.Generator(device='cuda').manual_seed(3)
    rows = {'cin_fwd': [], 'cin_bwd': []}
    D = D_CRITEO
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        itemsize = torch.empty((), dtype=dtype).element_size()
        rtol_out = 0. if dtype_name == 'float32' else 1e-2
        shapes = [(layer, F, G, L, B, D_CRITEO)
                  for layer, (F, G, L) in CIN_LAYERS.items()
                  for B in CIN_BATCHES]
        shapes += [(layer, F, G, L, TRAIN_BATCH, D_CRITEO)
                   for layer, (F, G, L) in CIN_FGCNN_LAYERS.items()]
        if dtype_name == 'float32':
            shapes += [CIN_200_MAPS, CIN_SIMT_EDGE + (D_CRITEO,)]
        for layer, F, G, L, B, D in shapes:
            def make():
                return tuple(
                    torch.randn(shape, generator=gen, device='cuda')
                    .to(dtype) for shape in
                    ((B, F, D), (B, G, D), (L, F, G), (B, L, D)))
            x0, h, w, dz = make()
            outs = {'cin_fwd': (fwd(x0, h, w),),
                    'cin_bwd': bwd(x0, h, w, dz)}
            refs = {'cin_fwd': (fwd_ref(x0, h, w),),
                    'cin_bwd': bwd_ref(x0, h, w, dz)}
            scales = {'cin_fwd': (fwd_ref(x0.abs(), h.abs(), w.abs()),),
                      'cin_bwd': bwd_ref(x0.abs(), h.abs(), w.abs(),
                                         dz.abs())}
            torch.cuda.synchronize()
            errs, shares = {}, {}
            for name in rows:
                errs[name], shares[name] = 0., 0.
                for i, (out, ref, scale) in enumerate(zip(
                        outs[name], refs[name], scales[name])):
                    check(out.shape == ref.shape and out.dtype == ref.dtype,
                          f'{name} output {i}: {tuple(out.shape)} '
                          f'{out.dtype}')
                    err = (out.float() - ref.float()).abs()
                    r = rtol_out if ref.dtype != torch.float32 else 0.
                    limit = 1e-5 * scale.float() + r * ref.float().abs()
                    errs[name] = max(errs[name], float(err.max()))
                    shares[name] = max(shares[name], float(
                        (err / limit.clamp_min(1e-30)).max()))
                    check(bool((err <= limit).all()),
                          f'{name} kernel disagrees with its plain '
                          f'version: {dtype_name} {layer} B={B} output '
                          f'{i} max_abs_err={float(err.max())}')
            del outs, refs, scales
            bufs = [(x0, h, w, dz)] + [make() for _ in range(
                n_buffers(x0.nbytes + h.nbytes + dz.nbytes) - 1)]
            iters = 10
            einsum = 'bfd,bgd,lfg->bld'

            def graph(a):
                leaves = [t.detach().requires_grad_(True) for t in a[:3]]
                return leaves, torch.einsum(einsum, *leaves), a[3]
            graphs = [graph(a) for a in bufs]
            fns = {'cin_fwd': (lambda a: fwd(*a[:3]),
                               lambda a: fwd_ref(*a[:3]),
                               lambda a: torch.einsum(einsum, *a[:3]),
                               bufs),
                   'cin_bwd': (lambda a: bwd(*a), lambda a: bwd_ref(*a),
                               lambda g: torch.autograd.grad(
                                   g[1], g[0], g[2], retain_graph=True),
                               graphs)}
            for name, (kernel, plain, library, lib_inputs) in fns.items():
                bound_ms, bound_by, ops, split_floor_ms, simt_bound_ms = \
                    cin_bound(name, B, F, G, L, D, itemsize)
                row = {'dtype': dtype_name, 'layer': layer, 'B': B,
                       'F': F, 'G': G, 'L': L, 'D': D,
                       'max_abs_err': errs[name],
                       'max_err_share_of_tolerance': shares[name],
                       'rtol_terms': 1e-5,
                       'rtol_out': rtol_out,
                       'ms': device_ms(torch, kernel, bufs, iters),
                       'plain_ms': device_ms(torch, plain, bufs, iters),
                       'library_ms': device_ms(torch, library,
                                               lib_inputs, iters),
                       'call_ms': call_ms(torch, kernel, bufs, iters),
                       'plain_call_ms': call_ms(torch, plain, bufs,
                                                iters),
                       'library_call_ms': call_ms(
                           torch, library, lib_inputs, iters),
                       'bound_ms': bound_ms, 'bound_by': bound_by,
                       'split_floor_ms': split_floor_ms,
                       'simt_bound_ms': simt_bound_ms,
                       'gflop': ops / 1e9, 'buffers': len(bufs)}
                row['tflop_per_s'] = ops / row['ms'] / 1e9
                row['design'] = (
                    cin_module.fwd_design(dtype, F, G)
                    if name == 'cin_fwd'
                    else cin_module.bwd_design(dtype, F, G, L))
                want = ('simt' if layer == CIN_SIMT_EDGE[0]
                        else 'wgmma' if itemsize == 2 else 'wgmma_f32')
                if name == 'cin_bwd' and layer == CIN_200_MAPS[0]:
                    want = 'wgmma_f32_rs'
                    before = dict(bwd.designs)
                    call_ms(torch, kernel, bufs, iters)
                    row['designs'] = {
                        k: v - before.get(k, 0)
                        for k, v in bwd.designs.items()
                        if v != before.get(k, 0)}
                    check(list(row['designs']) == [want],
                          f"K3 at {layer} counted {row['designs']}")
                    design = cin_module.bwd_design
                    cin_module.bwd_design = lambda *shape: 'simt'
                    try:
                        row['simt_ms'] = device_ms(torch, kernel, bufs,
                                                   iters)
                    finally:
                        cin_module.bwd_design = design
                check(row['design'] == want,
                      f"{name} ran the {row['design']} kernels on "
                      f'{dtype_name} {layer}, expected {want}')
                rows[name].append(row)
            del bufs, graphs, x0, h, w, dz
            torch.cuda.empty_cache()
    emit({'phase': 'kernel', 'kernel': 'cin_fwd',
          'library_call': "torch.einsum('bfd,bgd,lfg->bld', x0, h, w)",
          'rows': rows['cin_fwd']})
    emit({'phase': 'kernel', 'kernel': 'cin_bwd',
          'library_call': 'autograd: torch.autograd.grad of that einsum '
                          '(several kernels, not one call)',
          'rows': rows['cin_bwd']})
    return rows


def fa_bound(kernel, B, F, H, dh, itemsize, out_itemsize):
    """Least time of a field-attention kernel in ms, and what bounds it.
    Bytes: each input read once, each output written once (K5: q, k, v and
    o, or also do, dq, dk, dv; K6: x, w_aug and out, or x, w_aug, do and the
    4U-wide dpre). Operations, per example and head: 2 per multiply-add of
    the F x F x dh products (two forward, five backward, six in K6's
    backward, which recomputes the context) and 4 per score forward (scale,
    max-subtract, exp, divide), 8 backward; K6 adds the projection, 2 per
    multiply-add of the (F, U) x (U, 4U) product. Peak: the card's rate for
    the input type."""
    U = H * dh
    N = B * F * U
    fwd = 4 * F * F * dh + 4 * F * F
    w_bytes = (U + 1) * 4 * U * itemsize
    proj = 8 * F * U * U
    if kernel == 'fa_fwd':
        nbytes, ops = 3 * N * itemsize + N * out_itemsize, B * H * fwd
    elif kernel == 'fa_bwd':
        nbytes = 6 * N * itemsize + N * out_itemsize
        ops = B * H * (10 * F * F * dh + 8 * F * F)
    elif kernel == 'ab_fwd':
        nbytes, ops = 2 * N * itemsize + w_bytes, B * (proj + H * fwd)
    else:
        nbytes = 6 * N * itemsize + w_bytes
        ops = B * (proj + H * (12 * F * F * dh + 8 * F * F))
    peak = BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / peak
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms,
                                                           'operations')


def fa_ptxas(fa, name, dtype, dh, design, out_dtype=None):
    """ptxas's report of the K5 or K6 kernel a launch runs: the tile
    kernel's instantiation (input type, for K5 also the output's or do's
    type ``out_dtype``, padded head), or for the one-warp design the most
    registers and spill bytes over its instantiations for the types. The
    types are matched in the mangled name: a second bfloat16 is a
    substitution (``S<n>_``)."""
    def mangled(t):
        return '13__nv_bfloat16' if t == 'bfloat16' else 'f'
    t = mangled(dtype)
    if out_dtype is not None:
        t += r'S\d*_' if out_dtype == dtype == 'bfloat16' \
            else mangled(out_dtype)
    if design == 'tile':
        pattern = re.compile(f'{name}_tile_kernelI{t}Li{fa._tile_dhp(dh)}EE')
        found = [(pattern.search(k).group(0), v) for k, v in PTXAS.items()
                 if pattern.search(k)]
        check(len(found) == 1, f'ptxas reports {len(found)} kernels '
                               f'{pattern.pattern}')
        return dict(found[0][1], kernel=found[0][0])
    pattern = re.compile(f'{name}_kernelI{t}L')
    found = [v for k, v in PTXAS.items() if pattern.search(k)]
    check(len(found) > 0, f'ptxas reports no {pattern.pattern}')
    return {'registers': max(v.get('registers', 0) for v in found),
            'spill_bytes': max(v.get('spill_stores', 0)
                               + v.get('spill_loads', 0) for v in found),
            'instantiations': len(found)}


def fa_kernel_phase(torch, fa):
    """K5 (``fa_fwd``, ``fa_bwd``) and K6 (``ab_fwd``, ``ab_bwd``) against
    their plain versions on the card at AutoInt's shapes (F=22, H=2, dh=8),
    B = 8192 and 4096, float32 and bfloat16, and K5 with bfloat16 inputs and
    a float32 output (the batch-major layout). Both sides compute in
    float32 from the same inputs: every output is held to 1e-5 of its
    largest value, outputs rounded to bfloat16 also to rtol 1e-2 (their one
    rounding). K6-bwd leaves out the examples with a projection within
    AB_MASK_MARGIN of 0 (at most 5% of them). Yardsticks: for K5
    ``scaled_dot_product_attention`` on (B, H, F, dh) (transposed outside
    the timed window) and ``torch.autograd.grad`` of it; K6 has none."""
    gen = torch.Generator(device='cuda').manual_seed(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, dh, F = AUTOINT_PARAMS['num_heads'], D_AVAZU // 2, F_AVAZU
    U = H * dh
    rows = {name: [] for name in ('fa_fwd', 'fa_bwd', 'ab_fwd', 'ab_bwd')}
    for dtype_name, out_name in (('float32', 'float32'),
                                 ('bfloat16', 'bfloat16'),
                                 ('bfloat16', 'float32')):
        dtype, out_dtype = getattr(torch, dtype_name), getattr(torch,
                                                               out_name)
        itemsize = torch.empty((), dtype=dtype).element_size()
        out_itemsize = torch.empty((), dtype=out_dtype).element_size()
        same = dtype_name == out_name
        for B in FA_BATCHES:
            def make():
                def randn(shape, t, std=1.0):
                    return (std * torch.randn(shape, generator=gen,
                                              device='cuda')).to(t)
                return (randn((B, F, U), dtype), randn((B, F, U), dtype),
                        randn((B, F, U), dtype), randn((B, F, U), out_dtype),
                        randn((B, F, U), dtype),
                        randn((U + 1, 4 * U), dtype, 0.35),
                        randn((B, F, U), dtype))
            q, k, v, do, x, w, dx = make()
            design = {'fa': fa.fa_design(dtype, out_dtype, B, F, H, dh)}
            if same:
                design['ab'] = fa.ab_design(dtype, B, F, H, dh)
            for kernel, d in design.items():
                check(d == 'tile', f'AutoInt\'s shape ({dtype_name}->'
                                   f'{out_name}, B={B}, F={F}, H={H}, '
                                   f'dh={dh}) runs the {d} {kernel} design')
            outs = {'fa_fwd': (fa.fa_fwd(q, k, v, H, out_dtype),),
                    'fa_bwd': fa.fa_bwd(q, k, v, do, H)}
            refs = {'fa_fwd': (fa.fa_fwd_reference(q, k, v, H, out_dtype),),
                    'fa_bwd': fa.fa_bwd_reference(q, k, v, do, H)}
            keep = None
            if same:
                outs.update(ab_fwd=(fa.ab_fwd(x, w, H),),
                            ab_bwd=(fa.ab_bwd(x, w, dx, H),))
                refs.update(ab_fwd=(fa.ab_fwd_reference(x, w, H),),
                            ab_bwd=(fa.ab_bwd_reference(x, w, dx, H),))
                keep = fa.ab_mask_margin(x, w, H) >= AB_MASK_MARGIN
            torch.cuda.synchronize()
            errs = {}
            for name in outs:
                errs[name] = 0.
                for i, (out, ref) in enumerate(zip(outs[name], refs[name])):
                    check(out.shape == ref.shape and out.dtype == ref.dtype,
                          f'{name} output {i}: {tuple(out.shape)} '
                          f'{out.dtype}, expected {tuple(ref.shape)} '
                          f'{ref.dtype}')
                    if name == 'ab_bwd':
                        out, ref = out[keep], ref[keep]
                    err = (out.float() - ref.float()).abs()
                    r = 1e-2 if ref.dtype == torch.bfloat16 else 0.
                    limit = 1e-5 * float(ref.float().abs().max()) \
                        + r * ref.float().abs()
                    errs[name] = max(errs[name], float(err.max()))
                    check(bool((err <= limit).all()),
                          f'{name} kernel disagrees with its plain version: '
                          f'{dtype_name}->{out_name} B={B} output {i} '
                          f'max_abs_err={float(err.max())}')
            excluded = 0 if keep is None else int((~keep).sum())
            check(excluded <= 0.05 * B, f'ab_bwd: {excluded} of {B} examples '
                                        f'within {AB_MASK_MARGIN} of a relu '
                                        f'mask')
            del outs, refs
            bufs = [(q, k, v, do, x, w, dx)] + [make() for _ in range(
                n_buffers(7 * q.nbytes) - 1)]

            def heads(t):
                return t.reshape(B, F, H, dh).transpose(1, 2).contiguous()

            def graph(a):
                leaves = [heads(t).requires_grad_(True) for t in a[:3]]
                return leaves, sdpa(*leaves), heads(a[3])
            head_bufs = [[heads(t) for t in a[:3]] for a in bufs]
            graphs = [graph(a) for a in bufs] if same else None
            fns = {'fa_fwd': (lambda a: fa.fa_fwd(*a[:3], H, out_dtype),
                              lambda a: fa.fa_fwd_reference(*a[:3], H,
                                                            out_dtype),
                              (lambda a: sdpa(*a), head_bufs) if same
                              else None),
                   'fa_bwd': (lambda a: fa.fa_bwd(*a[:4], H),
                              lambda a: fa.fa_bwd_reference(*a[:4], H),
                              (lambda g: torch.autograd.grad(
                                  g[1], g[0], g[2], retain_graph=True),
                               graphs) if same else None)}
            if same:
                fns.update(ab_fwd=(lambda a: fa.ab_fwd(a[4], a[5], H),
                                   lambda a: fa.ab_fwd_reference(a[4], a[5],
                                                                 H), None),
                           ab_bwd=(lambda a: fa.ab_bwd(*a[4:], H),
                                   lambda a: fa.ab_bwd_reference(*a[4:], H),
                                   None))
            iters = 50
            for name, (kernel, plain, library) in fns.items():
                bound_ms, bound_by = fa_bound(name, B, F, H, dh, itemsize,
                                              out_itemsize)
                row = {'dtype': dtype_name, 'out_dtype': out_name, 'B': B,
                       'F': F, 'H': H, 'dh': dh, 'max_abs_err': errs[name],
                       'rtol_of_max': 1e-5,
                       'rtol_out': 1e-2 if out_name == 'bfloat16' else 0.,
                       'ms': device_ms(torch, kernel, bufs, iters),
                       'plain_ms': device_ms(torch, plain, bufs, iters),
                       'call_ms': call_ms(torch, kernel, bufs, iters),
                       'plain_call_ms': call_ms(torch, plain, bufs, iters),
                       'library_ms': None if library is None else
                       device_ms(torch, *library, iters),
                       'library_call_ms': None if library is None else
                       call_ms(torch, *library, iters),
                       'bound_ms': bound_ms, 'bound_by': bound_by,
                       'buffers': len(bufs)}
                if name == 'ab_bwd':
                    row['excluded_examples'] = excluded
                row['design'] = design[name[:2]]
                row['ptxas'] = fa_ptxas(
                    fa, name, dtype_name, dh, row['design'],
                    out_name if name[:2] == 'fa' else None)
                rows[name].append(row)
            del bufs, head_bufs, graphs, q, k, v, do, x, w, dx
            torch.cuda.empty_cache()
    fa_lifted_rows(torch, fa, gen, rows)
    notes = {'fa_fwd': 'torch.nn.functional.scaled_dot_product_attention on '
                       '(B, H, F, dh)',
             'fa_bwd': 'autograd: torch.autograd.grad of that call',
             'ab_fwd': None, 'ab_bwd': None}
    for name, note in notes.items():
        line = {'phase': 'kernel', 'kernel': name, 'rows': rows[name]}
        if note is None:
            line.update(library_ms=None, library_note='no single PyTorch '
                        'call computes the fused attention block')
        else:
            line['library_call'] = note
        emit(line)
    return rows


def fa_lifted_rows(torch, fa, gen, rows):
    """One bfloat16 row per K5/K6 kernel at a shape past the register
    width and past shared memory (FA_LIFTED): dh=128 runs in two slices of
    64; K5 at F=200 and K6 at U=128 keep their buffers in device memory, and
    K6 reads w_aug (264 KB in float32) from there. Held to the plain
    version as the AutoInt rows are; timed as they are, without yardstick."""
    dtype = torch.bfloat16
    for name in ('fa_fwd', 'fa_bwd', 'ab_fwd', 'ab_bwd'):
        B, F, H, dh = FA_LIFTED[name[:2]]
        U = H * dh

        def randn(shape, std=1.0):
            return (std * torch.randn(shape, generator=gen, device='cuda')
                    ).to(dtype)
        x, k, v, do = (randn((B, F, U)) for _ in range(4))
        w = randn((U + 1, 4 * U), 0.35)
        args = {'fa_fwd': (x, k, v), 'fa_bwd': (x, k, v, do),
                'ab_fwd': (x, w), 'ab_bwd': (x, w, do)}[name]
        kernel = getattr(fa, name)
        plain = getattr(fa, name + '_reference')
        outs, refs = kernel(*args, H), plain(*args, H)
        torch.cuda.synchronize()
        if not isinstance(outs, tuple):
            outs, refs = (outs,), (refs,)
        keep = fa.ab_mask_margin(x, w, H) >= AB_MASK_MARGIN \
            if name == 'ab_bwd' else None
        err_max = 0.
        for i, (out, ref) in enumerate(zip(outs, refs)):
            check(out.shape == ref.shape and out.dtype == ref.dtype,
                  f'{name} output {i}: {tuple(out.shape)} {out.dtype}')
            if keep is not None:
                out, ref = out[keep], ref[keep]
            err = (out.float() - ref.float()).abs()
            limit = 1e-5 * float(ref.float().abs().max()) \
                + 1e-2 * ref.float().abs()
            err_max = max(err_max, float(err.max()))
            check(bool((err <= limit).all()),
                  f'{name} kernel disagrees with its plain version at '
                  f'{(B, F, H, dh)}: output {i} max_abs_err='
                  f'{float(err.max())}')
        bound_ms, bound_by = fa_bound(name, B, F, H, dh, 2, 2)
        row = {'dtype': 'bfloat16', 'out_dtype': 'bfloat16', 'B': B, 'F': F,
               'H': H, 'dh': dh, 'lifted': True, 'max_abs_err': err_max,
               'rtol_of_max': 1e-5, 'rtol_out': 1e-2,
               'ms': device_ms(torch, lambda a: kernel(*a, H), [args], 20),
               'plain_ms': device_ms(torch, lambda a: plain(*a, H), [args],
                                     20),
               'library_ms': None, 'bound_ms': bound_ms,
               'bound_by': bound_by}
        if keep is not None:
            row['excluded_examples'] = int((~keep).sum())
        k5 = name[:2] == 'fa'
        row['design'] = fa.fa_design(dtype, dtype, B, F, H, dh) if k5 \
            else fa.ab_design(dtype, B, F, H, dh)
        row['ptxas'] = fa_ptxas(fa, name, 'bfloat16', dh, row['design'],
                                'bfloat16' if k5 else None)
        rows[name].append(row)
        del outs, refs, args, x, k, v, do, w
    torch.cuda.empty_cache()


# the field-attention kernels, the TPU kernel body each replaces, and the
# yardstick of its `kernels` entry
FA_KERNELS = {
    'fa_fwd': ('deeptables_tpu/ops/kernels/field_attention.py:71',
               'torch.nn.functional.scaled_dot_product_attention on '
               '(B, H, F, dh)'),
    'fa_bwd': ('deeptables_tpu/ops/kernels/field_attention.py:98',
               'autograd: torch.autograd.grad of that call (several kernels, '
               'not one call)'),
    'ab_fwd': ('deeptables_tpu/ops/kernels/field_attention.py:254',
               'no single PyTorch call computes the fused attention block'),
    'ab_bwd': ('deeptables_tpu/ops/kernels/field_attention.py:281',
               'no single PyTorch call computes the fused block\'s '
               'gradient')}


def fa_entry(name, rows, launches):
    """The `kernels` entry of a field-attention kernel, at FA_HEADLINE."""
    head = next(r for r in rows if (r['dtype'], r['B']) == FA_HEADLINE
                and r['out_dtype'] == r['dtype'])
    by_type = LAUNCHES_BY_TYPE.get(name, {})
    check(sum(by_type.values()) == launches,
          f'{name}: launches by type {by_type} do not sum to {launches}')
    replaces, note = FA_KERNELS[name]
    return {'name': name, 'route': 'cuda',
            'source': 'deeptables_torch/csrc/field_attention.cu',
            'replaces': replaces, 'launches': launches,
            'launches_by_type': by_type,
            'max_abs_err': head['max_abs_err'], 'ms': head['ms'],
            'plain_ms': head['plain_ms'], 'bound_ms': head['bound_ms'],
            'bound_by': head['bound_by'], 'library_ms': head['library_ms'],
            'library_note': note,
            'at': {k: head[k] for k in ('dtype', 'B', 'F', 'H', 'dh')},
            **({'design': head['design']} if 'design' in head else {})}


def flat_ids(torch, cat, vocabs):
    """(B, columns) ids → the flat int32 ids of the fused table."""
    offsets = np.concatenate([[0], np.cumsum(np.asarray(vocabs) + 1)[:-1]])
    return torch.from_numpy((cat + offsets).astype(np.int32).reshape(-1))


def emb_grad_cases(torch, vocabs, load_criteo_synthetic, datasets):
    """The K1 rows: (ids kind, B, the table's vocabularies, make(seed) → the
    (B, columns) ids as the flat int32 ids of the fused table, g's offset
    in elements into its storage). criteo (Zipf) and uniform ids at the
    training shapes; AutoInt's avazu schema at its training batch
    (8192-row slices of the bench's rows); every id on one row of the
    criteo table; Wide&Deep+DCN's adult ids; then criteo, uniform and avazu
    ids again at B=8192 with g one element into its storage, which is not
    16-byte aligned and so runs the scalar design on the same ids."""
    def criteo(B):
        return lambda seed: flat_ids(torch, load_criteo_synthetic(
            n_rows=B, seed=seed, return_arrays=True)[0], vocabs)

    def uniform(B):
        def make(seed):
            rng = np.random.default_rng(seed)
            return flat_ids(torch, np.stack(
                [rng.integers(0, v + 1, B) for v in vocabs], axis=1), vocabs)
        return make
    avazu_arrays, _, avazu_vocabs = avazu_data(datasets)
    avazu_cat = avazu_arrays['cat']

    def avazu(seed):
        start = seed % AVAZU_BATCHES * TRAIN_BATCH
        return flat_ids(torch, avazu_cat[start:start + TRAIN_BATCH],
                        avazu_vocabs)

    def one_row(seed):
        del seed
        return torch.full((TRAIN_BATCH * len(vocabs),), 5, dtype=torch.int32)
    cases = [('criteo', B, vocabs, criteo(B), 0) for B in TRAIN_KERNEL_BATCHES]
    cases += [('uniform', B, vocabs, uniform(B), 0)
              for B in TRAIN_KERNEL_BATCHES]
    cases.append(('avazu', TRAIN_BATCH, avazu_vocabs, avazu, 0))
    # Wide&Deep+DCN's 8 columns of 102 rows in all: the longest runs of one
    # id of any model's path (its vocabulary-2 column, 4096 ids a row)
    adult_table = np.asarray(ADULT_VOCABS) - 1

    def adult(seed):
        return flat_ids(torch, adult_data(TRAIN_BATCH, seed)[0]['cat'],
                        adult_table)
    cases.append(('adult', TRAIN_BATCH, adult_table, adult, 0))
    # the stream phase's table of 855,648 rows: uniform 32-bit tokens
    # hashed into each column's buckets are uniform over them
    stream_table = np.asarray(STREAM_BUCKETS) - 1

    def stream(seed):
        rng = np.random.default_rng(seed)
        return flat_ids(torch, np.stack(
            [rng.integers(0, b, TRAIN_BATCH) for b in STREAM_BUCKETS],
            axis=1), stream_table)
    cases.append(('stream', TRAIN_BATCH, stream_table, stream, 0))
    # a shard of the sharded phase's table: the local ids that the exact
    # all-to-all hands model rank 0 of 2 at a batch of criteo ids (both
    # ranks' stripes' requests, unused slots at id 0 included), into its
    # R = 162,245 rows; the columns only give N = B·26 and V = R
    n_model = SHARDED_MESH[1]
    shard_R = -(-int(np.sum(np.asarray(vocabs) + 1)) // n_model)
    shard_table = np.full(F_CRITEO, shard_R // F_CRITEO) - 1
    shard_table[-1] += shard_R % F_CRITEO

    def shard(seed):
        from deeptables_torch.parallel import sharded_embedding
        ids = criteo(TRAIN_BATCH)(seed)
        stripe = -(-len(ids) // n_model)
        recv = torch.stack([sharded_embedding._dispatch_plan(
            ids[s * stripe:(s + 1) * stripe], n_model, stripe, shard_R)[0][0]
            for s in range(n_model)])
        return recv.reshape(-1).clamp(0, shard_R - 1).to(torch.int32)
    cases.append(('shard', TRAIN_BATCH, shard_table, shard, 0))
    cases.append(('one_row', TRAIN_BATCH, vocabs, one_row, 0))
    cases += [('criteo', TRAIN_BATCH, vocabs, criteo(TRAIN_BATCH), 1),
              ('uniform', TRAIN_BATCH, vocabs, uniform(TRAIN_BATCH), 1),
              ('avazu', TRAIN_BATCH, avazu_vocabs, avazu, 1)]
    return cases


def emb_grad_kernel_phase(torch, eg_module, vocabs, load_criteo_synthetic,
                          datasets):
    """Embedding-gradient kernel against emb_grad_reference on the card, on
    the ids of emb_grad_cases."""
    emb_grad, reference = eg_module.emb_grad, eg_module.emb_grad_reference
    gen = torch.Generator(device='cuda').manual_seed(2)
    rows = []
    for ids_kind, B, table_vocabs, make_ids, offset in emb_grad_cases(
            torch, vocabs, load_criteo_synthetic, datasets):
        V = int(np.sum(np.asarray(table_vocabs) + 1))
        N = B * len(table_vocabs)

        def make(seed):
            g = torch.randn(N * D_CRITEO + offset, generator=gen,
                            device='cuda')
            return make_ids(seed).cuda(), g[offset:].view(N, D_CRITEO)
        ids, g = make(300)
        out = emb_grad(ids, g, V)
        again = emb_grad(ids, g, V)
        ref = reference(ids, g, V)
        row_abs = reference(ids, g.abs(), V)
        torch.cuda.synchronize()
        check(out.shape == (V, D_CRITEO) and out.dtype == torch.float32,
              f'emb_grad returned {tuple(out.shape)} {out.dtype}')
        check(torch.equal(out, again),
              f'emb_grad gave other bits on a second call: {ids_kind} B={B} '
              f'g_offset={offset}')
        check(torch.equal(out.cpu(), eg_module.emb_grad_sorted_reference(
            ids.cpu(), g.cpu(), V)),
            f'emb_grad differs from emb_grad_sorted_reference: {ids_kind} '
            f'B={B} g_offset={offset}')
        err = (out - ref).abs()
        max_abs_err = float(err.max())
        atol = EMB_GRAD_RTOL * float(row_abs.max())
        check(bool((err <= atol + EMB_GRAD_RTOL * ref.abs()).all()),
              f'emb_grad kernel disagrees with emb_grad_reference: '
              f'{ids_kind} B={B} g_offset={offset} max_abs_err={max_abs_err}')
        # the share of its column's B rows that the most frequent id takes
        top_share = float(torch.bincount(ids.long()).max()) / B
        touched = int((torch.bincount(ids.long(), minlength=V) > 0).sum())
        design = eg_module.emb_grad_design(N, D_CRITEO, V,
                                           eg_module.pointer_alignment(g))
        # D=16 on a fresh g is the main path's shape (criteo and avazu);
        # g one element into its storage is not 16-byte aligned
        want = 'segment_scalar' if offset else 'segment_v4'
        check(design == want, f'emb_grad at {ids_kind} B={B} g_offset='
                              f'{offset} runs the {design} design, not {want}')
        bufs = [(ids, g)] + [make(301 + i) for i in range(
            n_buffers(ids.nbytes + g.nbytes) - 1)]
        # index_put_ takes int64 indices: made before the timing
        long_bufs = [(a[0].long(), a[1]) for a in bufs]
        iters = 100
        bound_ms, bound_by = emb_grad_bound(N, D_CRITEO, V)

        def kernel(a):
            return emb_grad(a[0], a[1], V)

        def plain(a):
            return reference(a[0], a[1], V)

        def sort(a):
            return torch.sort(a[0], stable=True)

        def library(a):
            return torch.zeros((V, D_CRITEO), device='cuda').index_add_(
                0, a[0], a[1])

        def library_deterministic(a):
            return torch.zeros((V, D_CRITEO), device='cuda').index_put_(
                (a[0],), a[1], accumulate=True)
        ms, split = device_ms(torch, kernel, bufs, iters, by_kernel=True)
        ran_design('emb_grad', design, split)
        part_ms = {part: sum(v for k, v in split.items()
                             if any(n in k for n in names))
                   for part, names in EMB_GRAD_OWN.items()}
        torch.use_deterministic_algorithms(True)
        try:
            deterministic_ms = device_ms(torch, library_deterministic,
                                         long_bufs, iters)
        finally:
            torch.use_deterministic_algorithms(False)
        rows.append({
            'ids': ids_kind, 'B': B, 'N': N, 'D': D_CRITEO, 'V': V,
            'g_offset': offset, 'design': design, 'touched_rows': touched,
            'top_id_column_share': top_share, 'deterministic': True,
            'max_abs_err': max_abs_err, 'rtol': EMB_GRAD_RTOL,
            'atol': atol, 'ms': ms, 'kernels_ms': split,
            'sort_ms': ms - sum(part_ms.values()),
            'fill_ms': part_ms['fill'], 'segment_ms': part_ms['segment'],
            'sort_alone_ms': device_ms(torch, sort, bufs, iters),
            'plain_ms': device_ms(torch, plain, bufs, iters),
            'library_ms': device_ms(torch, library, bufs, iters),
            'library_deterministic_ms': deterministic_ms,
            'call_ms': call_ms(torch, kernel, bufs, iters),
            'plain_call_ms': call_ms(torch, plain, bufs, iters),
            'library_call_ms': call_ms(torch, library, bufs, iters),
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'buffers': len(bufs),
            'ptxas': [kernel_ptxas(name)
                      for name in EMB_GRAD_PTXAS[design]]})
        del bufs, long_bufs, ids, g, out, again, ref, row_abs
    emit({'phase': 'kernel', 'kernel': 'emb_grad',
          'library_call': 'torch.zeros(V, D).index_add_(0, ids, g)',
          'library_deterministic_call':
              'torch.zeros(V, D).index_put_((ids.long(),), g, '
              'accumulate=True) under use_deterministic_algorithms(True)',
          'rows': rows})
    return rows


def criteo_model(port, dtype_policy, device, vocabs, model='DeepFM',
                 cin_params=None, task='binary', num_classes=2, var_len=False,
                 **config):
    """DeepFM or xDeepFM at full criteo width; ``cin_params`` updates
    xDeepFM's CIN (128, 128) relu; ``task``, ``num_classes`` and
    ``config`` (loss, optimizer, regularizers, metrics, or other ``nets``)
    serve the heads and zoo phases; ``var_len`` adds the var-len column
    ``genres`` (VARLEN_TOKENS tokens, max pooling, D=16)."""
    settings = dict(
        nets=NETS[model], metrics=['AUC'],
        task=task, embedding_dropout=0,
        embeddings_output_dim=D_CRITEO,
        dnn_params={'hidden_units': ((1024, 0, False), (512, 0, False)),
                    'activation': 'relu'},
        cin_params=dict(XDEEPFM_CIN, **(cin_params or {})),
        dtype_policy=dtype_policy)
    settings.update(config)
    config = port.ModelConfig(**settings)
    cats = tuple(port.CategoricalColumn(f'C{i + 1}', int(v) + 1, D_CRITEO)
                 for i, v in enumerate(vocabs))
    conts = (port.ContinuousColumn(
        'input_continuous_all', [f'I{i + 1}' for i in range(N_DENSE)]),)
    var_cols = []
    if var_len:
        genres = port.VarLenCategoricalColumn(
            'genres', VARLEN_VOCAB, D_CRITEO, pooling_strategy='max')
        genres.max_elements_length = VARLEN_TOKENS
        var_cols.append(genres)
    return port.DeepModel(task, num_classes, config, cats, conts,
                          var_categorical_len_columns=var_cols,
                          device=device)


def varlen_ids(n, seed):
    """(n, VARLEN_TOKENS) token ids: each row 0 to VARLEN_TOKENS tokens of
    1 .. VARLEN_VOCAB - 1, then padding 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, VARLEN_TOKENS + 1, n)
    ids = rng.integers(1, VARLEN_VOCAB, (n, VARLEN_TOKENS))
    ids[np.arange(VARLEN_TOKENS)[None] >= lengths[:, None]] = 0
    return ids.astype(np.int32)


def adult_data(n_rows, seed):
    """Wide&Deep+DCN's rows: ids uniform over adult's vocabularies and
    normal dense inputs, as benchmarks/bench_models.py draws them, and
    labels drawn from a fixed logistic model of both (learnable, so that
    the train phase's loss falls)."""
    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, v, n_rows) for v in ADULT_VOCABS],
                   axis=1).astype(np.int32)
    dense = rng.normal(size=(n_rows, N_DENSE_ADULT)).astype(np.float32)
    truth = np.random.default_rng(1234)
    score = dense @ truth.normal(size=N_DENSE_ADULT) + sum(
        truth.normal(size=v)[cat[:, i]] for i, v in enumerate(ADULT_VOCABS))
    y = (rng.uniform(size=n_rows) < 1 / (1 + np.exp(-score)))
    return {'cat': cat, 'input_continuous_all': dense}, y.astype(np.float32)


def adult_model(port, dtype_policy, device):
    """Wide&Deep+DCN at full adult width."""
    config = port.ModelConfig(
        nets=NETS[WDCN], metrics=['AUC'], task='binary', embedding_dropout=0,
        embeddings_output_dim=D_CRITEO,
        dnn_params={'hidden_units': ((1024, 0, False), (512, 0, False)),
                    'activation': 'relu'},
        cross_params={'num_cross_layer': 4}, dtype_policy=dtype_policy)
    cats = tuple(port.CategoricalColumn(f'C{i + 1}', v, D_CRITEO)
                 for i, v in enumerate(ADULT_VOCABS))
    conts = (port.ContinuousColumn(
        'input_continuous_all', [f'I{i + 1}' for i in range(N_DENSE_ADULT)]),)
    return port.DeepModel('binary', 2, config, cats, conts, device=device)


def avazu_data(datasets):
    """The bench's AutoInt rows (``load_avazu_synthetic(8192 * 8)``,
    seed 31) as packed arrays, their labels and the vocabularies
    ``max(id) + 1``."""
    fields, click = datasets._avazu_fields(n_rows=AVAZU_BATCHES * TRAIN_BATCH)
    cat = np.stack(list(fields.values()), axis=1)
    return ({'cat': cat.astype(np.int32)}, click.astype(np.float32),
            cat.max(axis=0) + 1)


def autoint_model(port, dtype_policy, device, vocabs, model='AutoInt',
                  extra=None):
    """AutoInt at full avazu width; ``extra`` updates its
    autoint_params."""
    params = dict(AUTOINT_PARAMS, **AUTOINT_MODELS[model], **(extra or {}))
    config = port.ModelConfig(
        nets=NETS[model], metrics=['AUC'], task='binary',
        embedding_dropout=0, embeddings_output_dim=D_AVAZU,
        autoint_params=params, dtype_policy=dtype_policy)
    cats = tuple(port.CategoricalColumn(f'C{i + 1}', int(v) + 1, D_AVAZU)
                 for i, v in enumerate(vocabs))
    return port.DeepModel('binary', 2, config, cats, (), device=device)


def make_model(port, model, dtype_policy, device, vocabs, extra=None):
    if model in AUTOINT_MODELS:
        return autoint_model(port, dtype_policy, device, vocabs, model, extra)
    if model == WDCN:
        return adult_model(port, dtype_policy, device)
    return criteo_model(port, dtype_policy, device, vocabs, model, extra)


def estimator(model):
    """What ``Predictor`` reads from a fitted estimator."""
    return types.SimpleNamespace(task=model.task, preprocessor=None,
                                 get_model=lambda selector: model)


# the field-attention kernels' launches on the main paths by type (their
# wrappers' launches_by_type), summed over the serving and training runs
LAUNCHES_BY_TYPE = {}


def reset_launches(kernel_fns):
    for fn in kernel_fns.values():
        fn.launches = 0
        if hasattr(fn, 'launches_by_type'):
            fn.launches_by_type.clear()


def read_launches(kernel_fns):
    """Each kernel's launches since reset_launches; the counts by type go
    to LAUNCHES_BY_TYPE as well. Read once a run."""
    for name, fn in kernel_fns.items():
        by_type = LAUNCHES_BY_TYPE.setdefault(name, {})
        for key, n in getattr(fn, 'launches_by_type', {}).items():
            by_type[key] = by_type.get(key, 0) + n
    return {name: fn.launches for name, fn in kernel_fns.items()}


def serving_phase(torch, port, kernel_fns, dtype_policy, vocabs, requests,
                  model_name='DeepFM'):
    """Serve the requests on the card; the forward kernel's launch count
    (FM for DeepFM, once a padded chunk; the CIN contraction for xDeepFM,
    once a layer and chunk; none for Wide&Deep+DCN, which runs no forward
    kernel) is read around exactly this run."""
    name, per_chunk = SERVING_KERNEL[model_name]
    fn = kernel_fns[name] if name else types.SimpleNamespace(launches=0)
    t0 = time.perf_counter()
    model = make_model(port, model_name, dtype_policy, None, vocabs)
    predictor = port.Predictor(estimator(model))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(model.device.type == 'cuda', f'model is on {model.device}')

    reset_launches(kernel_fns)
    t0 = time.perf_counter()
    predictor.warmup()
    warmup_s = time.perf_counter() - t0
    check(fn.launches == per_chunk * len(predictor.buckets),
          f'warmup launched {name} {fn.launches} times for '
          f'{len(predictor.buckets)} buckets')
    served, outputs = [], {}
    for n, arrays in requests:
        bucket = predictor._bucket_for(n)
        chunks = math.ceil(n / bucket)
        times = []
        for _ in range(REPEATS):
            before = fn.launches
            t = time.perf_counter()
            proba = predictor.predict_proba_arrays(arrays)
            times.append(1e3 * (time.perf_counter() - t))
            check(fn.launches - before == per_chunk * chunks,
                  f'n={n}: {fn.launches - before} {name} launches for '
                  f'{chunks} padded chunks')
        check(proba.shape == (n, 2), f'n={n}: proba shape {proba.shape}')
        check(bool(torch.isfinite(torch.from_numpy(proba)).all()),
              f'n={n}: non-finite probabilities')
        row_sum_err = float(abs(proba.sum(axis=1) - 1).max())
        check(row_sum_err <= 1e-6, f'n={n}: rows sum to 1 ± {row_sum_err}')
        outputs[n] = proba
        served.append({'n': n, 'bucket': bucket, 'chunks': chunks,
                       'ms': times, 'ms_median': sorted(times)[REPEATS // 2],
                       'row_sum_err': row_sum_err})
    launches = read_launches(kernel_fns)
    check(name is None or launches[name] > 0,
          f'the serving run never launched {name}')
    check(all(v == 0 for k, v in launches.items() if k != name),
          f'{model_name} serving launched {launches}')

    # the same weights on the CPU run the plain path; for xDeepFM, the
    # batch-minor CIN tower on the card gives the same probabilities, for
    # AutoInt the batch-major layout (K5 with a float32 output)
    twins = [('cpu', make_model(port, model_name, dtype_policy, 'cpu',
                                vocabs))]
    twin_layout = {'xDeepFM': 'batch_minor', 'AutoInt': 'batch_major'}
    if model_name in twin_layout:
        layout = twin_layout[model_name]
        twins.append((layout, make_model(port, model_name, dtype_policy,
                                         None, vocabs, {'layout': layout})))
    atol = SERVING_ATOL[dtype_policy]
    for twin_name, twin in twins:
        twin.build().load_state_dict(model.module.state_dict())
        twin_predictor = port.Predictor(estimator(twin))
        for row, (n, arrays) in zip(served, requests):
            diff = float(abs(twin_predictor.predict_proba_arrays(arrays)
                             - outputs[n]).max())
            check(diff <= atol, f'{model_name} {dtype_policy} n={n}: the '
                                f'card and {twin_name} differ by {diff} > '
                                f'{atol}')
            row[f'max_abs_diff_vs_{twin_name}'] = diff
        del twin, twin_predictor
    emit({'phase': 'serving', 'model': model_name,
          'dtype_policy': dtype_policy,
          'build_s': build_s, 'warmup_s': warmup_s,
          'buckets': predictor.buckets, 'kernel': name,
          'launches': launches.get(name, 0),
          'launches_per_chunk': per_chunk,
          'atol_vs_twins': atol, 'requests': served})
    return predictor, launches.get(name, 0)


def profile_phase(torch, predictor, arrays, n, model_name='DeepFM'):
    """Device time by kernel over three requests, and the busy share."""
    predictor.predict_proba_arrays(arrays)
    torch.cuda.synchronize()

    def work():
        for _ in range(3):
            predictor.predict_proba_arrays(arrays)
    device, busy_us, wall_us = profile_window(torch, work)
    emit({'phase': 'profile', 'model': model_name,
          'dtype_policy': predictor.model.config.dtype_policy, 'n': n, 'requests': 3, 'wall_ms': wall_us / 1e3,
          'device_busy_ms': busy_us / 1e3,
          'device_busy_share': busy_us / wall_us,
          'by_kernel': [{'name': e.key[:90], 'count': e.count,
                         'device_ms': e.self_device_time_total / 1e3}
                        for e in device[:12]]})


def train_data(load_criteo_synthetic, n_batches, seed):
    cat, dense, y, _ = load_criteo_synthetic(n_rows=n_batches * TRAIN_BATCH,
                                             seed=seed, return_arrays=True)
    return {'cat': cat, 'input_continuous_all': dense}, y


def rows_of(arrays, start, stop):
    return {k: v[start:stop] for k, v in arrays.items()}


def check_step1_grads(what, dtype_policy, grads, exact_zero=(), outliers=0.,
                      zoo_flips=None):
    """The card's step-1 gradients (``grads['card']``) against the CPU's,
    each tensor's largest error over its largest gradient returned with
    the tolerance: f32 sums in another order (rtol 1e-4), bf16 rounds at
    other places (rtol 1e-2). Both with 1e-2 of the tensor's largest
    gradient: a ReLU input within rounding of zero may take the other side
    on the other device and change that one example's gradient, which is
    all an embedding row of a rare id sees (measured on the card: one
    example's embedding gradient moved by 7%, 8.9e-4 of the largest).

    The zoo phase adds two terms. ``exact_zero``: tensors whose gradient is
    zero in exact arithmetic, so rounding on both devices: they are held
    within ZOO_ROUNDING of the model's largest gradient instead (and that
    they are, on the CPU). ``outliers``: the share of a tensor's elements that may lie
    past that tolerance, the tensor then held within 1e-2 of the CPU's in
    relative L2 norm (a wide net, such as the CIN over FGCNN's 104 fields,
    has more ReLU inputs within rounding of zero, and each one that takes
    the other side moves a few rows of the table); ``zoo_flips`` collects
    {tensor: share past the elementwise tolerance}."""
    g_rtol, g_atol = (1e-4 if dtype_policy == 'float32' else 1e-2), 1e-2
    check(set(grads['card']) == set(grads['cpu']),
          f'{what}: the card and the CPU give gradients to other parameters')
    grad_err = {}
    floor = ZOO_ROUNDING * max(float(g.abs().max())
                               for g in grads['cpu'].values())
    for k, ref in grads['cpu'].items():
        err = (grads['card'][k] - ref).abs()
        scale = float(ref.abs().max())
        grad_err[k] = float(err.max()) / max(scale, 1e-30)
        if k in exact_zero:
            check(scale <= floor and float(err.max()) <= floor,
                  f'{what}: the step-1 gradient of {k}, zero in exact '
                  f'arithmetic, reads {scale} on the CPU and differs by '
                  f'{float(err.max())} on the card (limit {floor})')
            continue
        past = err > g_rtol * ref.abs() + g_atol * scale
        if not outliers:
            check(not bool(past.any()),
                  f'{what}: card and CPU step-1 gradients of {k} differ by '
                  f'{float(err.max())} (largest gradient {scale})')
            continue
        share = float(past.double().mean())
        rel_l2 = float(err.double().norm()
                       / max(float(ref.double().norm()), 1e-30))
        if share:
            zoo_flips[k] = {'share': share, 'rel_l2': rel_l2}
        check(share <= outliers and (not share or rel_l2 <= 1e-2),
              f'{what}: card and CPU step-1 gradients of {k} differ by '
              f'{float(err.max())} (largest gradient {scale}) at a share '
              f'{share} of the elements, relative L2 {rel_l2}')
    return grad_err, g_rtol, g_atol


def check_params(what, card_state, cpu_state, loose=(), loose_atol=None,
                 loose_rtol=0.):
    """Parameters after three steps on the card and the CPU: atol 2e-4,
    but an optimizer that normalises a step (Adam moves an element by ~lr
    whatever its gradient's size) turns a gradient near zero, where the two
    devices' sums differ in relative terms, into steps a few lr apart: at
    most PARAM_OUTLIERS of a tensor's elements may exceed the atol. The
    tensors ``loose`` (the zoo phase: those whose gradient is rounding; the
    estimator phase: BatchNorm's running statistics of raw columns) are
    held to ``loose_atol`` plus ``loose_rtol`` of each element instead."""
    params = {}
    for k, v in card_state.items():
        ref = cpu_state[k].double()
        d = (v.double() - ref).abs()
        atol = loose_atol + loose_rtol * ref.abs() if k in loose \
            else PARAM_ATOL
        params[k] = {'max_abs_diff': float(d.max()),
                     'over_atol': int((d > atol).sum()),
                     'elements': d.numel()}
        check(params[k]['over_atol'] <= PARAM_OUTLIERS * d.numel(),
              f'{what}: card and CPU parameters {k} differ after 3 steps: '
              f'{params[k]}')
    return params


def train_phase(torch, port, kernel_fns, dtype_policy, vocabs, data,
                model_name='DeepFM', train_steps=TRAIN_STEPS):
    """fit on the card, ``train_steps`` batches an epoch and one batch of
    validation; the kernels' launch counts are read around exactly this
    run."""
    arrays, y = data
    n_train = train_steps * TRAIN_BATCH
    train = rows_of(arrays, 0, n_train), y[:n_train]
    val = rows_of(arrays, n_train, n_train + TRAIN_BATCH), y[n_train:]
    model = make_model(port, model_name, dtype_policy, None, vocabs)
    module = model.build()
    init_state = {k: v.detach().cpu().clone()
                  for k, v in module.state_dict().items()}

    step_s = []
    train_step = model._train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out
    model._train_step = timed_step

    reset_launches(kernel_fns)
    t0 = time.perf_counter()
    history = model.fit(train[0], train[1], batch_size=TRAIN_BATCH,
                        epochs=TRAIN_EPOCHS, validation_data=val, verbose=0)
    fit_s = time.perf_counter() - t0
    launches = read_launches(kernel_fns)
    del model._train_step
    steps = len(step_s)
    logs = {k: list(v) for k, v in history.history.data.items()}
    check(steps == train_steps * TRAIN_EPOCHS, f'fit ran {steps} steps')
    check(all(math.isfinite(v) for vs in logs.values() for v in vs),
          f'non-finite logs: {logs}')
    check(logs['loss'][-1] < logs['loss'][0],
          f'the loss did not fall from epoch 1 to {TRAIN_EPOCHS}: '
          f'{logs["loss"]}')
    # one width group: K1 once a step. DeepFM: K2-bwd once a step, K2-fwd
    # once a step and once a validation batch. xDeepFM: K3 once a CIN layer
    # and step, K4 once a layer and step or validation batch. AutoInt: K5-bwd
    # once a block and step, K5-fwd once a block and step or validation
    # batch; with fuse_projections K6 in their place. Wide&Deep+DCN: K1
    # alone
    expected = dict.fromkeys(kernel_fns, 0)
    expected['emb_grad'] = steps
    if model_name == 'DeepFM':
        expected.update(fm_bwd=steps, fm_fwd=steps + TRAIN_EPOCHS)
    elif model_name == 'xDeepFM':
        layers = len(XDEEPFM_CIN['cross_layer_size'])
        expected.update(cin_bwd=layers * steps,
                        cin_fwd=layers * (steps + TRAIN_EPOCHS))
    elif model_name in AUTOINT_MODELS:
        fwd, blocks = SERVING_KERNEL[model_name][0], \
            AUTOINT_PARAMS['num_attention']
        expected.update({fwd: blocks * (steps + TRAIN_EPOCHS),
                         fwd[:-3] + 'bwd': blocks * steps})
    check(launches == expected, f'{model_name}: {steps} steps and '
                                f'{TRAIN_EPOCHS} validations launched '
                                f'{launches}, expected {expected}')
    later = sorted(step_s[train_steps:])
    median_s = later[len(later) // 2]

    # two steps under the profiler: device time by kernel, busy share
    loss_fn = model._loss_fn()
    batches = [(rows_of(train[0], i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH),
                train[1][i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(2)]
    torch.cuda.synchronize()

    def work():
        for batch, yb in batches:
            model._train_step(batch, yb, None, loss_fn)
    device, busy_us, wall_us = profile_window(torch, work)
    cin_kernels = [{'name': e.key[:90], 'count': e.count,
                    'device_ms': e.self_device_time_total / 1e3}
                   for e in device if 'cin_' in e.key]
    if model_name == 'xDeepFM':
        # K4 and K3's passes by name: the policy type's tensor-core
        # kernels, and never another design's (no CUDA-core CIN kernel)
        ran = {k for names in CIN_DESIGN_KERNELS.values() for k in names
               if any(k in e['name'] for e in cin_kernels)}
        want = set(CIN_DESIGN_KERNELS['wgmma' if dtype_policy == 'bfloat16'
                                      else 'wgmma_f32'])
        check(ran == want, f'xDeepFM {dtype_policy} training ran the CIN '
                           f'kernels {sorted(ran)}, expected {sorted(want)}')
    fa_kernels = [{'name': e.key[:90], 'count': e.count,
                   'device_ms': e.self_device_time_total / 1e3}
                  for e in device
                  if re.search(r'(fa|ab)_(fwd|bwd)(_tile)?_kernel<', e.key)]
    if model_name in AUTOINT_MODELS:
        # K5 (K6 when fused) by name: the tile kernels, in bfloat16 (block
        # 0) and float32 (blocks 1-2: BatchNorm returns float32) under
        # 'bfloat16', and never the one-warp ones
        k = 'ab' if model_name == 'AutoInt-fused' else 'fa'
        types = ('__nv_bfloat16', 'float') if dtype_policy == 'bfloat16' \
            else ('float',)
        names = [f'{k}_{p}_tile_kernel<{t}' for p in ('fwd', 'bwd')
                 for t in ('__nv_bfloat16', 'float')] + [f'{k}_fwd_kernel<',
                                                         f'{k}_bwd_kernel<']
        ran = {n for n in names if any(n in e.key for e in device)}
        want = {f'{k}_{p}_tile_kernel<{t}' for p in ('fwd', 'bwd')
                for t in types}
        check(ran == want, f'{model_name} {dtype_policy} training ran the '
                           f'{k} kernels {sorted(ran)}, expected '
                           f'{sorted(want)}')
    # K1 (every model) and K2-fwd (DeepFM) by name: the designs of the
    # main path's shapes, segment_v4 and vec16, and never the scalar ones
    k1k2_kernels = [{'name': e.key[:90], 'count': e.count,
                     'device_ms': e.self_device_time_total / 1e3}
                    for e in device
                    if re.search(r'(segment|merge|fm_fwd(_vec16)?)_kernel',
                                 e.key)]
    k1 = ('segment_kernel<float4>', 'merge_kernel<float4>')
    ran = {k for k in k1 + ('segment_kernel<float>', 'merge_kernel<float>',
                            'fm_fwd_vec16_kernel', 'fm_fwd_kernel<')
           if any(k in e['name'] for e in k1k2_kernels)}
    want = set(k1) | (
        {'fm_fwd_vec16_kernel'} if model_name == 'DeepFM' else set())
    check(ran == want, f'{model_name} {dtype_policy} training ran the K1/K2 '
                       f'kernels {sorted(ran)}, expected {sorted(want)}')

    # the same initial weights on the card and the CPU: the gradients of
    # one step, then the losses and parameters of a fit over three batches
    # (xDeepFM at smaller batches: the CPU plain path materialises the
    # pair, 218 M values a layer at B=8192)
    cb = COMPARE_BATCH[model_name]
    compare = rows_of(train[0], 0, 3 * cb), train[1][:3 * cb]
    compare_val = rows_of(val[0], 0, cb), val[1][:cb]
    first = rows_of(train[0], 0, cb), train[1][:cb]
    twins, grads, fits = {}, {}, {}
    for run, device_name in (('card', None), ('cpu', 'cpu')):
        twin = make_model(port, model_name, dtype_policy, device_name,
                          vocabs)
        twin_module = twin.build()
        twin_module.load_state_dict(init_state)
        logits, _ = twin_module(twin.to_device(first[0]), training=True)
        twin._loss_fn()(logits, torch.from_numpy(first[1]).to(
            twin.device), None).backward()
        # (a parameter that feeds no net, such as bn_concat_emb_dense of an
        # AutoInt-only model, has no gradient)
        grads[run] = {k: p.grad.detach().cpu().clone()
                      for k, p in twin_module.named_parameters()
                      if p.grad is not None}
        twin_module.zero_grad(set_to_none=True)
        twin_module.load_state_dict(init_state)  # undo the BN statistics
        h = twin.fit(compare[0], compare[1], batch_size=cb, epochs=1,
                     validation_data=compare_val, shuffle=False, verbose=0)
        fits[run] = ({k: v.detach().cpu() for k, v in
                      twin_module.state_dict().items()},
                     {k: v[0] for k, v in h.history.data.items()})
        del twin, twin_module
    card_state, card_logs = fits['card']
    cpu_state, cpu_logs = fits['cpu']
    loss_diff = {k: abs(card_logs[k] - cpu_logs[k])
                 for k in ('loss', 'val_loss')}
    grad_err, g_rtol, g_atol = check_step1_grads(
        f'{model_name} {dtype_policy}', dtype_policy, grads)
    params = None
    if dtype_policy == 'float32':
        for k, d in loss_diff.items():
            check(d <= 1e-4 * abs(cpu_logs[k]),
                  f'{model_name} {dtype_policy}: card {k} {card_logs[k]} vs CPU '
                  f'{cpu_logs[k]}')
        params = check_params(f'{model_name} {dtype_policy}', card_state,
                              cpu_state)
        tolerance = {'loss_rtol': 1e-4, 'grad_rtol': g_rtol,
                     'grad_atol_of_max': g_atol, 'param_atol': PARAM_ATOL,
                     'param_outlier_share': PARAM_OUTLIERS}
    else:
        # bf16 rounds at other places on the card (kernels) and the CPU
        # (plain path)
        check(all(d <= 1e-2 for d in loss_diff.values()),
              f'{model_name} {dtype_policy}: card and CPU losses differ by {loss_diff}')
        tolerance = {'loss_atol': 1e-2, 'grad_rtol': g_rtol,
                     'grad_atol_of_max': g_atol}

    emit({'phase': 'train', 'model': model_name,
          'dtype_policy': dtype_policy, 'batch_size': TRAIN_BATCH, 'steps': steps, 'epochs': TRAIN_EPOCHS,
          'fit_s': fit_s, 'step_ms': [1e3 * t for t in step_s],
          'median_step_ms_after_epoch_1': 1e3 * median_s,
          'examples_per_s_after_epoch_1': TRAIN_BATCH / median_s,
          'launches': launches, 'logs': logs,
          'val_auc': logs['val_auc'][-1],
          'card_vs_cpu': {'batch_size': cb, 'card': card_logs,
                          'cpu': cpu_logs,
                          'loss_diff': loss_diff,
                          'step1_grad_err_of_max': grad_err,
                          'params_vs_cpu': params,
                          'tolerance': tolerance}})
    emit({'phase': 'train_profile', 'model': model_name,
          'dtype_policy': dtype_policy,
          'steps': 2, 'wall_ms': wall_us / 1e3,
          'device_busy_ms': busy_us / 1e3,
          'device_busy_share': busy_us / wall_us,
          'by_kernel': [{'name': e.key[:90], 'count': e.count,
                         'device_ms': e.self_device_time_total / 1e3}
                        for e in device[:16]],
          'cin_kernels': cin_kernels, 'fa_kernels': fa_kernels,
          'k1k2_kernels': k1k2_kernels})
    del model, fits
    return launches


def heads_labels(task, num_classes, n, seed):
    """Labels of a task from a seed: 0/1, class ids, reals or (n, C) 0/1."""
    rng = np.random.default_rng(seed)
    if task == 'multiclass':
        return rng.integers(0, num_classes, n).astype(np.int32)
    if task == 'multilabel':
        return (rng.uniform(size=(n, num_classes)) < 0.3).astype(np.float32)
    if task == 'regression':
        return rng.normal(1.0, 2.0, n).astype(np.float32)
    return (rng.uniform(size=n) < 0.25).astype(np.float32)


def heads_phase(torch, port, kernel_fns, vocabs, data, smi):
    """DeepFM at full criteo width under 'bfloat16' on each run of
    HEADS_RUNS (a task head, a loss, an optimizer, regularizers), three
    8192-row steps and one validation batch on the card, held against the
    same steps on the CPU's plain path from the same initial weights: the
    step-1 gradients and the parameters after three steps (the train
    phase's rules), the losses (atol 1e-2 of max(1, |loss|): bfloat16
    rounds at other places) and GHMC's state (its bin counts, within
    PARAM_OUTLIERS of the batch: an example whose |sigmoid - y| lies
    within rounding of a bin edge may fall in the other bin). K1 and K2
    launch once a step (K2-fwd also once for the validation batch). Then
    a multiclass Predictor request. Returns the launches of the runs and
    the request."""
    arrays, _ = data
    n = HEADS_STEPS * TRAIN_BATCH
    train = rows_of(arrays, 0, n)
    val = rows_of(arrays, n, n + TRAIN_BATCH)
    first = rows_of(arrays, 0, TRAIN_BATCH)
    total = dict.fromkeys(kernel_fns, 0)
    for i, (task, classes, loss, optimizer, extra) in enumerate(HEADS_RUNS):
        y = heads_labels(task, classes, n + TRAIN_BATCH, seed=300 + i)
        config = dict(task=task, num_classes=classes, loss=loss,
                      optimizer=optimizer, metrics=HEADS_METRICS[task],
                      **extra)
        what = f'heads {task} {loss} {optimizer} {sorted(extra.items())}'
        init_state, grads, fits, step_ms, launches = None, {}, {}, [], None
        for run, device_name in (('card', None), ('cpu', 'cpu')):
            model = criteo_model(port, 'bfloat16', device_name, vocabs,
                                 **config)
            module = model.build()
            if init_state is None:
                init_state = {k: v.detach().cpu().clone()
                              for k, v in module.state_dict().items()}
            module.load_state_dict(init_state)
            loss_fn = model._loss_fn()
            if getattr(loss_fn, 'stateful', False):
                model.loss_state = loss_fn.init_state().to(model.device)
            step1, _, _ = model.training_loss(
                model.to_device(first),
                torch.from_numpy(y[:TRAIN_BATCH]).to(model.device), None,
                loss_fn)
            step1.backward()
            grads[run] = {k: p.grad.detach().cpu().clone()
                          for k, p in module.named_parameters()
                          if p.grad is not None}
            module.zero_grad(set_to_none=True)
            module.load_state_dict(init_state)  # undo the BN statistics
            model.loss_state = None
            if run == 'card':
                train_step = model._train_step

                def timed_step(*args, train_step=train_step):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = train_step(*args)
                    torch.cuda.synchronize()
                    step_ms.append(1e3 * (time.perf_counter() - t))
                    return out
                model._train_step = timed_step
                reset_launches(kernel_fns)
            h = model.fit(train, y[:n], batch_size=TRAIN_BATCH, epochs=1,
                          validation_data=(val, y[n:]), shuffle=False,
                          verbose=0)
            if run == 'card':
                launches = read_launches(kernel_fns)
                del model._train_step
                if task == 'multiclass':
                    multiclass = model
            fits[run] = ({k: v.detach().cpu() for k, v in
                          module.state_dict().items()},
                         {k: v[0] for k, v in h.history.data.items()},
                         None if model.loss_state is None
                         else model.loss_state.cpu())
        card_state, card_logs, card_ls = fits['card']
        cpu_state, cpu_logs, cpu_ls = fits['cpu']
        check(all(math.isfinite(v) for v in card_logs.values()),
              f'{what}: non-finite logs {card_logs}')
        expected = dict.fromkeys(kernel_fns, 0)
        expected.update(emb_grad=HEADS_STEPS, fm_bwd=HEADS_STEPS,
                        fm_fwd=HEADS_STEPS + 1)
        check(launches == expected,
              f'{what}: launched {launches}, expected {expected}')
        grad_err, g_rtol, g_atol = check_step1_grads(what, 'bfloat16', grads)
        loss_diff = {k: abs(card_logs[k] - cpu_logs[k])
                     for k in ('loss', 'val_loss')}
        for k, d in loss_diff.items():
            check(d <= 1e-2 * max(1.0, abs(cpu_logs[k])),
                  f'{what}: card {k} {card_logs[k]} vs CPU {cpu_logs[k]}')
        params = check_params(what, card_state, cpu_state)
        state = None
        if cpu_ls is not None:
            state = {'card': card_ls.tolist(), 'cpu': cpu_ls.tolist(),
                     'max_abs_diff': float((card_ls - cpu_ls).abs().max()),
                     'atol': PARAM_OUTLIERS * TRAIN_BATCH}
            check(state['max_abs_diff'] <= state['atol'],
                  f'{what}: card and CPU loss states differ: {state}')
        for name, count in launches.items():
            total[name] += count
        emit({'phase': 'heads', 'task': task, 'num_classes': classes,
              'loss': loss, 'optimizer': optimizer, 'extra': extra,
              'dtype_policy': 'bfloat16', 'batch_size': TRAIN_BATCH,
              'steps': HEADS_STEPS, 'step_ms': step_ms,
              'median_step_ms': sorted(step_ms)[len(step_ms) // 2],
              'launches': {k: launches[k] for k in
                           ('emb_grad', 'fm_fwd', 'fm_bwd')},
              'card': card_logs, 'cpu': cpu_logs, 'loss_diff': loss_diff,
              'step1_grad_err_of_max_worst': max(grad_err.values()),
              'params_max_abs_diff': max(p['max_abs_diff']
                                         for p in params.values()),
              'params_worst_over_atol_share': max(
                  p['over_atol'] / p['elements'] for p in params.values()),
              'loss_state': state,
              'tolerance': {'grad_rtol': g_rtol, 'grad_atol_of_max': g_atol,
                            'loss_atol_of_max_1': 1e-2,
                            'param_atol': PARAM_ATOL,
                            'param_outlier_share': PARAM_OUTLIERS},
              'nvidia_smi': smi})
        del fits, grads

    # a multiclass request through Predictor on the fitted card model
    predictor = port.Predictor(estimator(multiclass))
    request = rows_of(val, 0, HEADS_REQUEST)
    rows = len(request['cat'])
    reset_launches(kernel_fns)
    proba = predictor.predict_proba_arrays(request)
    launches = read_launches(kernel_fns)
    classes = HEADS_RUNS[0][1]
    check(proba.shape == (rows, classes) and np.isfinite(proba).all(),
          f'multiclass request: {proba.shape}')
    row_sums = proba.sum(axis=1)
    check(bool(np.abs(row_sums - 1).max() <= 1e-5),
          f'multiclass rows do not sum to 1: {np.abs(row_sums - 1).max()}')
    check(launches['fm_fwd'] == 1, f'multiclass request launched {launches}')
    for name, count in launches.items():
        total[name] += count
    emit({'phase': 'heads_request', 'task': 'multiclass',
          'num_classes': classes, 'rows': rows,
          'max_abs_row_sum_err': float(np.abs(row_sums - 1).max()),
          'launches': {'fm_fwd': launches['fm_fwd']}, 'nvidia_smi': smi})
    del multiclass, predictor
    return total


def zoo_phase(torch, port, kernel_fns, vocabs, data, smi):
    """Every builder of ZOO alone at criteo width (DNN 1024/512 relu,
    xDeepFM's CIN for fgcnn_cin_nets, the config's defaults else), then
    DeepFM with a var-len column, under 'bfloat16': three 8192-row steps
    and a validation batch through ``DeepModel.fit`` on the card, then a
    4093-row request through ``Predictor``, each with its kernels' launches
    checked: K1 once a step (twice beside the var-len column, whose table
    has its own); fgcnn_fm_nets and DeepFM K2-fwd once a step, validation
    batch and request, K2-bwd once a step; fgcnn_cin_nets K4 and K3 twice
    as often. Then the card against the CPU's plain path from the same
    initial weights, at the batch ZOO_COMPARE_BATCH states, by the heads
    phase's rules (the train phase's for the step-1 gradients and the
    parameters after three steps; the losses atol 1e-2 of max(1, |loss|)),
    with two more terms: the dense BatchNorm's bias has a gradient that is
    zero in exact arithmetic where only the next BatchNorm reads the dense
    inputs (ZOO_DENSE_VIA_BN), so its step-1 gradient is held within
    ZOO_ROUNDING of the model's largest on both devices, and its
    parameters, which Adam moves by up to lr a step on rounding, to
    ZOO_ROUNDING_PARAM_ATOL (both devices' three steps apart); and, as for
    the parameters, at most PARAM_OUTLIERS of a tensor's step-1 gradients
    may lie past the elementwise tolerance (ReLU inputs within rounding of
    zero), the tensor then within 1e-2 in relative L2 norm.
    Returns the launches of the fits and requests."""
    arrays, y = data
    n = ZOO_STEPS * TRAIN_BATCH
    total = dict.fromkeys(kernel_fns, 0)
    for i, run in enumerate(ZOO + (ZOO_VARLEN,)):
        var_len = run == ZOO_VARLEN
        nets = NETS['DeepFM'] if var_len else [run]
        rows = dict(arrays)
        if var_len:
            rows['genres'] = varlen_ids(len(y), seed=500)
        train, val = rows_of(rows, 0, n), rows_of(rows, n, n + TRAIN_BATCH)
        request = rows_of(val, 0, ZOO_REQUEST)
        cb = ZOO_COMPARE_BATCH.get(run, ZOO_COMPARE_DEFAULT)
        # the compare: three batches of cb rows and one of validation
        compare = rows_of(train, 0, 3 * cb), y[:3 * cb]
        compare_val = rows_of(val, 0, cb), y[n:n + cb]
        first = rows_of(train, 0, cb)

        def build(device):
            return criteo_model(port, 'bfloat16', device, vocabs, nets=nets,
                                var_len=var_len)
        model = build(None)
        init_state = {k: v.detach().cpu().clone()
                      for k, v in model.build().state_dict().items()}
        step_ms = []
        train_step = model._train_step

        def timed_step(*args, train_step=train_step):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = train_step(*args)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            return out
        model._train_step = timed_step
        reset_launches(kernel_fns)
        h = model.fit(train, y[:n], batch_size=TRAIN_BATCH, epochs=1,
                      validation_data=(val, y[n:n + TRAIN_BATCH]),
                      shuffle=False, verbose=0)
        fit_launches = read_launches(kernel_fns)
        del model._train_step
        logs = {k: v[0] for k, v in h.history.data.items()}
        check(len(step_ms) == ZOO_STEPS and all(
            math.isfinite(v) for v in logs.values()),
            f'zoo {run}: {len(step_ms)} steps, logs {logs}')
        predictor = port.Predictor(estimator(model))
        reset_launches(kernel_fns)
        t = time.perf_counter()
        proba = predictor.predict_proba_arrays(request)
        request_ms = 1e3 * (time.perf_counter() - t)
        request_launches = read_launches(kernel_fns)
        check(proba.shape == (ZOO_REQUEST, 2) and np.isfinite(proba).all()
              and float(np.abs(proba.sum(axis=1) - 1).max()) <= 1e-6,
              f'zoo {run}: request gave {proba.shape}')
        steps = ZOO_STEPS
        want_fit = dict.fromkeys(kernel_fns, 0)
        want_fit['emb_grad'] = steps * (2 if var_len else 1)
        want_request = dict.fromkeys(kernel_fns, 0)
        if var_len or run == 'fgcnn_fm_nets':
            want_fit.update(fm_fwd=steps + 1, fm_bwd=steps)
            want_request['fm_fwd'] = 1
        elif run == 'fgcnn_cin_nets':
            layers = len(XDEEPFM_CIN['cross_layer_size'])
            want_fit.update(cin_fwd=layers * (steps + 1),
                            cin_bwd=layers * steps)
            want_request['cin_fwd'] = layers
        check(fit_launches == want_fit,
              f'zoo {run}: the fit launched {fit_launches}, expected '
              f'{want_fit}')
        check(request_launches == want_request,
              f'zoo {run}: the request launched {request_launches}, '
              f'expected {want_request}')
        for name in kernel_fns:
            total[name] += fit_launches[name] + request_launches[name]
        del model, predictor

        # the card against the CPU from the same initial weights
        grads, fits = {}, {}
        for where, device_name in (('card', None), ('cpu', 'cpu')):
            twin = build(device_name)
            module = twin.build()
            module.load_state_dict(init_state)
            loss_fn = twin._loss_fn()
            step1, _, _ = twin.training_loss(
                twin.to_device(first),
                torch.from_numpy(y[:cb]).to(twin.device), None, loss_fn)
            step1.backward()
            grads[where] = {k: p.grad.detach().cpu().clone()
                            for k, p in module.named_parameters()
                            if p.grad is not None}
            module.zero_grad(set_to_none=True)
            module.load_state_dict(init_state)  # undo the BN statistics
            th = twin.fit(compare[0], compare[1], batch_size=cb, epochs=1,
                          validation_data=compare_val, shuffle=False,
                          verbose=0)
            fits[where] = ({k: v.detach().cpu() for k, v in
                            module.state_dict().items()},
                           {k: v[0] for k, v in th.history.data.items()})
            del twin, module
        what = f'zoo {run}'
        # a net that reads the dense inputs only through the next BatchNorm
        # (the product and cross nets) leaves the dense BatchNorm's bias a
        # gradient that is zero in exact arithmetic (the next BatchNorm
        # takes the mean out): rounding on both devices, which Adam turns
        # into steps of up to lr a step
        rounding = ['bn_dense_all.bias'] if run in ZOO_DENSE_VIA_BN else []
        flips = {}
        grad_err, g_rtol, g_atol = check_step1_grads(
            what, 'bfloat16', grads, rounding, PARAM_OUTLIERS, flips)
        loss_diff = {k: abs(fits['card'][1][k] - fits['cpu'][1][k])
                     for k in ('loss', 'val_loss')}
        for k, d in loss_diff.items():
            check(d <= 1e-2 * max(1.0, abs(fits['cpu'][1][k])),
                  f'{what}: card {k} {fits["card"][1][k]} vs CPU '
                  f'{fits["cpu"][1][k]}')
        params = check_params(what, fits['card'][0], fits['cpu'][0],
                              rounding, ZOO_ROUNDING_PARAM_ATOL)
        emit({'phase': 'zoo', 'run': run, 'nets': nets,
              'var_len': {'tokens': VARLEN_TOKENS, 'vocab': VARLEN_VOCAB,
                          'pooling': 'max'} if var_len else None,
              'dtype_policy': 'bfloat16', 'batch_size': TRAIN_BATCH,
              'steps': steps, 'step_ms': step_ms,
              'median_step_ms': sorted(step_ms)[len(step_ms) // 2],
              'logs': logs,
              'launches': {k: v for k, v in fit_launches.items() if v},
              'request': {'rows': ZOO_REQUEST, 'ms': request_ms,
                          'launches': {k: v for k, v in
                                       request_launches.items() if v}},
              'card_vs_cpu': {
                  'batch_size': cb, 'card': fits['card'][1],
                  'cpu': fits['cpu'][1], 'loss_diff': loss_diff,
                  'step1_grad_err_of_max_worst': max(grad_err.values()),
                  'params_max_abs_diff': max(p['max_abs_diff']
                                             for p in params.values()),
                  'params_worst_over_atol_share': max(
                      p['over_atol'] / p['elements']
                      for p in params.values()),
                  'rounding_gradients': rounding,
                  'grads_past_tolerance': flips,
                  'tolerance': {'grad_rtol': g_rtol,
                                'grad_atol_of_max': g_atol,
                                'grad_atol_of_model_max': ZOO_ROUNDING,
                                'grad_outlier_share': PARAM_OUTLIERS,
                                'grad_outlier_rel_l2': 1e-2,
                                'loss_atol_of_max_1': 1e-2,
                                'param_atol': PARAM_ATOL,
                                'param_outlier_share': PARAM_OUTLIERS,
                                'rounding_param_atol':
                                    ZOO_ROUNDING_PARAM_ATOL}},
              'nvidia_smi': smi})
        del grads, fits
        torch.cuda.empty_cache()
    return total


def determinism_runs(criteo, avazu, adult):
    """What the determinism phase fits: (name, dtype policy, steps, build,
    (train rows, labels), validation rows). Every model the script trains:
    DeepFM, xDeepFM (in both policies: bf16 and float32 K4/K3 designs),
    AutoInt plain and fused, Wide&Deep+DCN, at the train phase's three
    steps; then each ZOO net and the var-len DeepFM at DETERMINISM_ZOO_STEPS
    (an earlier path at a smaller depth). Each argument is (vocabularies,
    (rows, labels))."""
    runs = []
    for model, dtype_policy in (('DeepFM', 'bfloat16'),
                                ('xDeepFM', 'bfloat16'),
                                ('xDeepFM', 'float32'),
                                ('AutoInt', 'bfloat16'),
                                ('AutoInt-fused', 'bfloat16'),
                                (WDCN, 'bfloat16')):
        model_vocabs, (arrays, y) = (
            avazu if model in AUTOINT_MODELS else
            adult if model == WDCN else criteo)
        runs.append((model, dtype_policy, 3, functools.partial(
            make_model, model=model, dtype_policy=dtype_policy, device=None,
            vocabs=model_vocabs), (arrays, y)))
    vocabs, (arrays, y) = criteo
    for run in ZOO + (ZOO_VARLEN,):
        var_len = run == ZOO_VARLEN
        rows = dict(arrays)
        if var_len:
            rows['genres'] = varlen_ids(len(y), seed=500)
        runs.append((run, 'bfloat16', DETERMINISM_ZOO_STEPS, functools.partial(
            criteo_model, dtype_policy='bfloat16', device=None,
            vocabs=vocabs, nets=NETS['DeepFM'] if var_len else [run],
            var_len=var_len), (rows, y)))
    return runs


def determinism_phase(torch, port, kernel_fns, runs):
    """Two fits of each run from one seed on the card (``steps`` batches of
    8192 rows and a validation batch through ``DeepModel.fit``): a line a
    run with the parameter and BatchNorm tensors whose bits differ between
    the two fits (their largest difference) and the kernels' launches of
    both fits. Every line is printed before the check: every tensor of
    every run must be bit-equal. Returns the launches."""
    total = dict.fromkeys(kernel_fns, 0)
    failed = []
    for name, dtype_policy, steps, build, (arrays, y) in runs:
        n = steps * TRAIN_BATCH
        val = rows_of(arrays, n, n + TRAIN_BATCH), y[n:n + TRAIN_BATCH]
        states = []
        reset_launches(kernel_fns)
        t = time.perf_counter()
        for _ in range(2):
            model = build(port)
            module = model.build()
            model.fit(rows_of(arrays, 0, n), y[:n], batch_size=TRAIN_BATCH,
                      epochs=1, validation_data=val, verbose=0)
            states.append({k: v.detach().cpu().clone()
                           for k, v in module.state_dict().items()})
            del model, module
        fit_s = time.perf_counter() - t
        launches = read_launches(kernel_fns)
        for k, v in launches.items():
            total[k] += v
        first, second = states
        differ = {k: float((first[k].double() - second[k].double())
                           .abs().max())
                  for k in first if not torch.equal(first[k], second[k])}
        if differ:
            failed.append(name)
        emit({'phase': 'determinism', 'model': name,
              'dtype_policy': dtype_policy, 'steps': steps,
              'batch_size': TRAIN_BATCH, 'tensors': len(first),
              'differ': differ, 'two_fits_s': fit_s,
              'launches': {k: v for k, v in launches.items() if v}})
        torch.cuda.empty_cache()
    check(not failed, f'determinism: two fits from one seed differ for '
                      f'{failed}')
    return total


def dae_phase(torch, port, load_criteo_synthetic):
    """``fe.DAE()`` at its defaults (encoder 500/500, 20 features, relu,
    glorot_uniform, Adam at 1e-3) with ``noise_rate=0.1`` on the card, over
    DAE_ROWS rows of load_criteo_synthetic's 13 dense columns (log1p-scaled
    there), DAE_EPOCHS epochs of 128-row batches: the reconstruction mse of
    the clean rows before and after must fall; ``transform`` of a CUDA
    tensor must give (DAE_ROWS, 20) finite features on the card. Then one
    epoch over the first DAE_COMPARE_ROWS rows on the card and on the CPU's
    plain path from the same initial weights (both drawn from the seed) and
    the same noisy batches: the parameters by the train phase's rules."""
    from deeptables_torch.fe import DAE
    dense = load_criteo_synthetic(n_rows=DAE_ROWS, seed=41,
                                  return_arrays=True)[1]
    X = torch.from_numpy(dense).cuda()

    def mse(dae):
        with torch.no_grad():
            recon, _ = dae.module(X)
            return float(torch.mean((recon - X) ** 2))
    dae = DAE(noise_rate=0.1)
    dae.build(dense.shape[1], None)
    before = mse(dae)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dae.fit(dense, epochs=DAE_EPOCHS, verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    after = mse(dae)
    check(after < before, f'dae: the mse went {before} -> {after}')
    feats = dae.transform(X)
    check(feats.is_cuda and tuple(feats.shape) == (DAE_ROWS, 20)
          and bool(torch.isfinite(feats).all()),
          f'dae: transform gave {feats.device} {tuple(feats.shape)}')
    states = {}
    for where, device in (('card', None), ('cpu', 'cpu')):
        twin = DAE(noise_rate=0.1).fit(dense[:DAE_COMPARE_ROWS], epochs=1,
                                       verbose=0, device=device)
        states[where] = {k: v.detach().cpu()
                         for k, v in twin.module.state_dict().items()}
    params = check_params('dae', states['card'], states['cpu'])
    emit({'phase': 'dae', 'rows': DAE_ROWS, 'columns': dense.shape[1],
          'encoder_units': list(dae.encoder_units),
          'feature_units': dae.feature_units, 'noise_rate': 0.1,
          'epochs': DAE_EPOCHS, 'batch_size': 128, 'fit_s': fit_s,
          'mse_before': before, 'mse_after': after,
          'transform': {'shape': list(feats.shape),
                        'device': str(feats.device)},
          'card_vs_cpu': {
              'rows': DAE_COMPARE_ROWS, 'epochs': 1,
              'params_max_abs_diff': max(p['max_abs_diff']
                                         for p in params.values()),
              'params_worst_over_atol_share': max(
                  p['over_atol'] / p['elements'] for p in params.values()),
              'tolerance': {'param_atol': PARAM_ATOL,
                            'param_outlier_share': PARAM_OUTLIERS}}})


def deepfm_steps(port, vocabs, data, lo, hi, model=None, strategy=None):
    """DeepFM under 'bfloat16' at full criteo width (a new one from the
    seed, or ``model``) fitted on rows [lo, hi) in order, 8192 a step, with
    a validation batch."""
    arrays, y = data
    if model is None:
        model = criteo_model(port, 'bfloat16', None, vocabs,
                             distribute_strategy=strategy)
    val = rows_of(arrays, hi, hi + TRAIN_BATCH), y[hi:hi + TRAIN_BATCH]
    model.fit(rows_of(arrays, lo, hi), y[lo:hi], batch_size=TRAIN_BATCH,
              epochs=1, shuffle=False, validation_data=val, verbose=0)
    return model


def state_of(model):
    return {k: v.detach().cpu().clone()
            for k, v in model.module.state_dict().items()}


def bits_differ(torch, first, second):
    """The tensors of two state dicts whose bits differ."""
    return sorted(k for k in first if not torch.equal(first[k], second[k]))


def distributed_phase(torch, port, kernel_fns, vocabs, data, tmp):
    """An NCCL process group of one process over a ``file://`` store in
    ``tmp`` (no network), joined through ``parallel.initialize_distributed``;
    DeepFM (bf16, full criteo width) fitted DIST_STEPS steps of 8192 rows
    under ``DataParallel(num_devices=1)`` and plainly, from one seed: the
    parameters must be bit-equal and K1's and K2's launches the same.
    Returns the launches of both fits."""
    from deeptables_torch import parallel
    from datetime import timedelta
    info = parallel.initialize_distributed(
        init_method=f'file://{tmp}/nccl_store', num_processes=1,
        process_id=0, backend='nccl', timeout=timedelta(seconds=120))
    try:
        check(torch.distributed.get_backend() == 'nccl'
              and info['num_hosts'] == 1,
              f'distributed: backend {torch.distributed.get_backend()}, '
              f'{info}')
        n = DIST_STEPS * TRAIN_BATCH
        runs = {}
        total = dict.fromkeys(kernel_fns, 0)
        for name, strategy in (('plain', None),
                               ('data_parallel',
                                parallel.DataParallel(num_devices=1))):
            reset_launches(kernel_fns)
            torch.cuda.synchronize()
            t = time.perf_counter()
            model = deepfm_steps(port, vocabs, data, 0, n, strategy=strategy)
            torch.cuda.synchronize()
            runs[name] = {'fit_s': time.perf_counter() - t,
                          'launches': read_launches(kernel_fns),
                          'state': state_of(model)}
            for k, v in runs[name]['launches'].items():
                total[k] += v
            del model
        bad = bits_differ(torch, runs['plain']['state'],
                          runs['data_parallel']['state'])
        check(not bad, f'distributed: DataParallel(1) and the plain fit '
                       f'differ in {bad}')
        check(runs['plain']['launches'] == runs['data_parallel']['launches']
              and runs['plain']['launches']['emb_grad'] == DIST_STEPS,
              f'distributed: launches {runs["plain"]["launches"]} vs '
              f'{runs["data_parallel"]["launches"]}')
        emit({'phase': 'distributed', 'backend': 'nccl',
              'init_method': 'file://', 'host_info': parallel.host_info(),
              'world_size': torch.distributed.get_world_size(),
              'strategy': 'DataParallel(num_devices=1)', 'model': 'DeepFM',
              'dtype_policy': 'bfloat16', 'steps': DIST_STEPS,
              'batch_size': TRAIN_BATCH, 'bit_equal': True,
              'fit_s': {k: v['fit_s'] for k, v in runs.items()},
              'launches': {k: v for k, v in
                           runs['data_parallel']['launches'].items() if v}})
    finally:
        torch.distributed.destroy_process_group()
    return total


def checkpoint_phase(torch, port, kernel_fns, vocabs, data, tmp):
    """DeepFM (bf16, full criteo width: the 324,489 × 16 table and Adam's
    moments): two 8192-row steps, ``save_checkpoint``, a new model and
    optimizer restored by ``restore_checkpoint``, a third step; its
    parameters and BatchNorm statistics must equal an uninterrupted
    three-step fit's bit for bit. The checkpoint's bytes and the save and
    restore times (host clock, synchronised). Returns the launches."""
    from deeptables_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    B = TRAIN_BATCH
    reset_launches(kernel_fns)
    whole = state_of(deepfm_steps(port, vocabs, data, 0, 3 * B))
    first = deepfm_steps(port, vocabs, data, 0, 2 * B)
    path = os.path.join(tmp, 'deepfm_checkpoint')
    torch.cuda.synchronize()
    t = time.perf_counter()
    save_checkpoint(path, first)
    save_ms = 1e3 * (time.perf_counter() - t)
    nbytes = sum(f.stat().st_size for f in Path(path).rglob('*')
                 if f.is_file())
    fresh = criteo_model(port, 'bfloat16', None, vocabs)
    t = time.perf_counter()
    restore_checkpoint(path, fresh)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t)
    bad = bits_differ(torch, state_of(first), state_of(fresh))
    check(not bad, f'checkpoint: restored tensors differ: {bad}')
    deepfm_steps(port, vocabs, data, 2 * B, 3 * B, model=fresh)
    launches = read_launches(kernel_fns)
    bad = bits_differ(torch, whole, state_of(fresh))
    check(not bad, f'checkpoint: the resumed fit differs from the '
                   f'uninterrupted one in {bad}')
    table = first.module.emb_categorical_vars_all.embeddings_d16
    emit({'phase': 'checkpoint', 'model': 'DeepFM',
          'dtype_policy': 'bfloat16', 'table_rows': int(table.shape[0]),
          'optimizer': type(first.optimizer).__name__, 'bytes': nbytes,
          'save_ms': save_ms, 'restore_ms': restore_ms,
          'steps': {'before': 2, 'after': 1}, 'bit_equal': True,
          'launches': {k: v for k, v in launches.items() if v}})
    return launches


# the sharded phase: DeepFM bf16 at criteo width, its table row-sharded
# over a model axis of 2 (two ranks of a gloo group on the one card), three
# steps of each run
SHARDED_MESH = (1, 2)
SHARDED_STEPS = 3
SHARDED_RUNS = (('sharded', None), ('sharded_a2a', None),
                ('sharded_a2a', 1.5))
SHARDED_RANK_TIMEOUT_S = 400
SHARDED_BACKEND = 'gloo'


def sharded_data_file(tmp, data):
    """The phase's rows (SHARDED_STEPS training batches and a validation
    batch) in an .npz for the ranks."""
    arrays, y = data
    n = (SHARDED_STEPS + 1) * TRAIN_BATCH
    path = os.path.join(tmp, 'sharded_rows.npz')
    np.savez(path, y=y[:n], **{k: v[:n] for k, v in arrays.items()})
    return path


def sharded_rank(rank, world, tmp):
    """One rank of the sharded phase (``chip_smoke.py --sharded-rank``):
    joins a gloo group of ``world`` over a ``file://`` store in ``tmp``, and
    for each of SHARDED_RUNS builds DeepFM (bf16, full criteo width) under
    ``DataAndModelParallel(*SHARDED_MESH)``, holds its first batch's rows
    against the whole table's gather, then fits SHARDED_STEPS steps of
    8192 rows, each step timed (host clock, synchronised). Writes what it
    saw, and rank 0 the whole state after each exact run, to tmp."""
    import pickle
    from datetime import timedelta
    import torch
    sys.path.insert(0, str(ROOT))
    import deeptables_torch as port
    from deeptables_torch import parallel
    from deeptables_torch.ops.kernels import emb_grad as eg_module
    from deeptables_torch.ops.kernels import fm as fm_module
    from deeptables_torch.parallel import sharded_embedding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize_distributed(
        init_method=f'file://{tmp}/sharded_store', num_processes=world,
        process_id=rank, backend=SHARDED_BACKEND,
        timeout=timedelta(seconds=120))
    kernel_fns = {'fm_fwd': fm_module.fm, 'fm_bwd': fm_module.fm_backward,
                  'emb_grad': eg_module.emb_grad}
    with np.load(os.path.join(tmp, 'sharded_rows.npz')) as f:
        y = f['y']
        arrays = {k: f[k] for k in f.files if k != 'y'}
    with open(os.path.join(tmp, 'sharded_vocabs.json')) as f:
        vocabs = json.load(f)
    out = {'rank': rank, 'backend': torch.distributed.get_backend(),
           'runs': {}}
    try:
        for how, factor in SHARDED_RUNS:
            strategy = parallel.DataAndModelParallel(*SHARDED_MESH)
            model = criteo_model(
                port, 'bfloat16', None, vocabs,
                distribute_strategy=strategy, embedding_device_strategy=how,
                embedding_a2a_capacity_factor=factor)
            layer = model.build().emb_categorical_vars_all
            table = layer.embeddings_d16
            key = 'emb_categorical_vars_all.embeddings_d16'
            whole = model.full_state_dict()[key]
            ids = torch.from_numpy(arrays['cat'][:TRAIN_BATCH]).cuda()
            drops = sharded_embedding.sharded_lookup_a2a.drops
            with torch.no_grad():
                rows = layer(ids).stacked
                ref = whole[ids + layer.offsets_d16]
            zero = (rows == 0).all(dim=-1)
            forward_drops = sharded_embedding.sharded_lookup_a2a.drops - drops
            run = {'R': int(table.shape[0]),
                   'rows_equal': bool(torch.equal(rows[~zero], ref[~zero])),
                   'zero_rows': int(zero.sum()),
                   'forward_drops': forward_drops,
                   'row_sharding': hasattr(table, 'row_sharding')}
            step_s = []
            train_step = model._train_step

            def timed_step(*args, train_step=train_step):
                torch.cuda.synchronize()
                t = time.perf_counter()
                result = train_step(*args)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                return result
            model._train_step = timed_step
            drops = sharded_embedding.sharded_lookup_a2a.drops
            reset_launches(kernel_fns)
            deepfm_steps(port, vocabs, (arrays, y), 0,
                         SHARDED_STEPS * TRAIN_BATCH, model=model)
            torch.cuda.synchronize()
            run['launches'] = read_launches(kernel_fns)
            run['step_ms'] = [1e3 * t for t in step_s]
            run['drops'] = sharded_embedding.sharded_lookup_a2a.drops - drops
            run['loss'] = model.evaluate(
                rows_of(arrays, 0, TRAIN_BATCH), y[:TRAIN_BATCH],
                batch_size=TRAIN_BATCH)['loss']
            state = {k: v.detach().cpu().clone()
                     for k, v in model.full_state_dict().items()}
            if rank == 0 and factor is None:
                run['state'] = state
            out['runs'][f'{how}@{factor}'] = run
            del model, layer, table, whole
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(tmp, f'sharded_rank{rank}.pkl'), 'wb') as f:
        pickle.dump(out, f)
    return 0


def sharded_phase(torch, port, kernel_fns, vocabs, data, tmp):
    """DeepFM (bf16, full criteo width, 324,489 table rows) with its table
    row-sharded over a model axis of 2: two ranks of a gloo process group
    on the one card (``sharded_rank``, subprocesses with a time limit and
    a ``file://`` store; gloo takes the CUDA tensors of ``all_reduce``,
    ``all_gather`` and ``all_to_all_single`` through the host), three steps
    of each of SHARDED_RUNS. Checks: the first batch's rows equal the whole
    table's gather bit for bit (but for the dropped ids of the bounded
    run, which it counts); after three steps of each exact run every dense
    parameter and the table put back from its shards match a one-process
    replicated fit from the same seed by the train phase's rules; the
    bounded run drops ids and its loss is finite; K1 runs once a rank a
    step on the rank's R = 162,245 rows. Two ranks share one card, so the
    step times are no throughput; NCCL across cards is not exercised.
    Returns the launches, the ranks' and the reference fit's."""
    import pickle
    sharded_data_file(tmp, data)
    with open(os.path.join(tmp, 'sharded_vocabs.json'), 'w') as f:
        json.dump([int(v) for v in vocabs], f)
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / 'chip_smoke.py'), '--sharded-rank',
         str(rank), str(world), tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    logs, failed = [], False
    deadline = time.monotonic() + SHARDED_RANK_TIMEOUT_S
    try:
        for proc in procs:
            try:
                log, _ = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                failed = True
            logs.append(log.decode(errors='replace')[-4000:])
            failed = failed or proc.returncode != 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(not failed, 'sharded: a rank failed:\n' + '\n----\n'.join(logs))
    ranks = []
    for rank in range(world):
        with open(os.path.join(tmp, f'sharded_rank{rank}.pkl'), 'rb') as f:
            ranks.append(pickle.load(f))

    reset_launches(kernel_fns)
    reference = state_of(deepfm_steps(port, vocabs, data, 0,
                                      SHARDED_STEPS * TRAIN_BATCH))
    launches = read_launches(kernel_fns)
    R = -(-int(np.sum(np.asarray(vocabs) + 1)) // SHARDED_MESH[1])
    runs = []
    for how, factor in SHARDED_RUNS:
        name = f'{how}@{factor}'
        per_rank = [r['runs'][name] for r in ranks]
        for rank, run in enumerate(per_rank):
            check(run['R'] == R and run['row_sharding'],
                  f'sharded {name}: rank {rank} holds {run["R"]} rows, not '
                  f'{R}')
            check(run['rows_equal'], f'sharded {name}: rank {rank}\'s rows '
                                     f'differ from the whole table\'s gather')
            check(run['launches']['emb_grad'] == SHARDED_STEPS,
                  f'sharded {name}: rank {rank} launched K1 '
                  f'{run["launches"]["emb_grad"]} times in '
                  f'{SHARDED_STEPS} steps')
            check(math.isfinite(run['loss']),
                  f'sharded {name}: loss {run["loss"]}')
            for k, v in run['launches'].items():
                launches[k] += v
        line = {'phase': 'sharded', 'backend': ranks[0]['backend'],
                'ranks_on_one_card': world, 'mesh': list(SHARDED_MESH),
                'strategy': how, 'capacity_factor': factor, 'R': R,
                'model': 'DeepFM', 'dtype_policy': 'bfloat16',
                'batch_size': TRAIN_BATCH, 'steps': SHARDED_STEPS,
                'forward_zero_rows': per_rank[0]['zero_rows'],
                'forward_drops': per_rank[0]['forward_drops'],
                'drops': per_rank[0]['drops'],
                'loss': per_rank[0]['loss'],
                'step_ms': {f'rank{i}': r['step_ms']
                            for i, r in enumerate(per_rank)},
                'launches': {f'rank{i}': {k: v for k, v in
                                          r['launches'].items() if v}
                             for i, r in enumerate(per_rank)}}
        if factor is None:
            check(per_rank[0]['zero_rows'] == 0 and per_rank[0]['drops'] == 0,
                  f'sharded {name}: an exact lookup dropped ids')
            state = per_rank[0]['state']
            check(set(state) == set(reference),
                  f'sharded {name}: state keys differ')
            params = check_params(f'sharded {name}', state, reference)
            line['largest_difference'] = max(
                p['max_abs_diff'] for p in params.values())
            line['table_vs_replicated'] = params[
                'emb_categorical_vars_all.embeddings_d16']
        else:
            check(per_rank[0]['drops'] > 0
                  and per_rank[0]['forward_drops']
                  == per_rank[0]['zero_rows'] > 0,
                  f'sharded {name}: capacity {factor} dropped '
                  f'{per_rank[0]["drops"]} ids in training and '
                  f'{per_rank[0]["forward_drops"]} in the forward check')
            line['largest_difference'] = None
        emit(line)
        runs.append(line)
    return launches


def write_stream_tsv(path, n_rows, seed):
    """Criteo-format TSV as benchmarks/bench_ingest_e2e.py:32-53 writes it: a
    label, 13 integers of 0-4999 (10% blank) and 26 tokens of 8 hex digits,
    tab-separated. The first three columns draw their tokens from pools of
    STREAM_POOLS tokens, the rest uniformly from 2^32; the label comes from
    a fixed logistic model of the pooled tokens and of log1p of the first
    three integers (the bench's labels are random), so the loss can fall."""
    rng = np.random.default_rng(seed)
    truth = np.random.default_rng(1234)
    dense = rng.integers(0, 5000, (n_rows, N_DENSE))
    blank = rng.random((n_rows, N_DENSE)) < 0.1
    tokens = rng.integers(0, 1 << 32, (n_rows, F_CRITEO), dtype=np.uint64)
    score = np.zeros(n_rows)
    for j, size in enumerate(STREAM_POOLS):
        pool = truth.integers(0, 1 << 32, size, dtype=np.uint64)
        pick = rng.integers(0, size, n_rows)
        tokens[:, j] = pool[pick]
        score += truth.normal(size=size)[pick]
    logd = np.where(blank, 0., np.log1p(dense))
    for j in range(3):
        score += truth.normal() * (logd[:, j] - 7.5)
    label = rng.uniform(size=n_rows) < 1 / (1 + np.exp(-score))
    digits = np.frombuffer(b'0123456789abcdef', np.uint8)
    shifts = np.arange(28, -1, -4, dtype=np.uint64)
    numbers = np.array([str(v).encode() for v in range(5000)] + [b''],
                       dtype=object)
    with open(path, 'wb') as f:
        for lo in range(0, n_rows, 1 << 15):
            hi = min(lo + (1 << 15), n_rows)
            # the tokens' hex digits, a tab after each token, a newline last
            nibbles = (tokens[lo:hi, :, None] >> shifts) & np.uint64(15)
            text = np.empty((hi - lo, F_CRITEO, 9), np.uint8)
            text[..., :8] = digits[nibbles.astype(np.intp)]
            text[..., 8] = ord('\t')
            text[:, -1, 8] = ord('\n')
            text = text.reshape(hi - lo, -1)
            dense_text = numbers[np.where(blank[lo:hi], 5000,
                                          dense[lo:hi])].tolist()
            f.write(b''.join(
                b'%d\t%s\t%s' % (label[lo + i], b'\t'.join(dense_text[i]),
                                 text[i].tobytes())
                for i in range(hi - lo)))


def stream_shards(tmp):
    """The stream phase's shards in ``tmp``: {'train': [paths], 'val':
    [paths]}, and the seconds it took to write them."""
    t0 = time.perf_counter()
    paths, seed = {}, STREAM_SEED
    for split, sizes in STREAM_ROWS.items():
        paths[split] = []
        for i, n in enumerate(sizes):
            path = str(Path(tmp) / f'{split}_{i}.tsv')
            write_stream_tsv(path, n, seed)
            seed += 1
            paths[split].append(path)
    return paths, time.perf_counter() - t0


def ingest_phase(fast_ingest, paths, write_s):
    """The native parser: that it built, that it equals its Python twin on
    the first shard's first STREAM_PARSE_CHECK_ROWS rows, and its rate over
    the training shards alone (no device)."""
    check(fast_ingest.have_native(), 'the native TSV parser did not build: '
                                     'the stream phase would time Python')
    with open(paths['train'][0], 'rb') as f:
        head = b''.join(itertools.islice(f, STREAM_PARSE_CHECK_ROWS))
    native = fast_ingest.parse_criteo_tsv(head, hash_buckets=STREAM_BUCKETS)
    plain = fast_ingest._parse_criteo_py(
        head, N_DENSE, F_CRITEO, np.asarray(STREAM_BUCKETS, np.int64))
    for a, b, name in zip(native, plain, ('labels', 'dense', 'cats')):
        check(a.dtype == b.dtype and a.shape == b.shape
              and np.array_equal(a, b),
              f'the native parser differs from _parse_criteo_py: {name}')
    check(len(native[0]) == STREAM_PARSE_CHECK_ROWS, 'parse check rows')
    source = fast_ingest.CriteoTsvSource(paths['train'],
                                         hash_buckets=STREAM_BUCKETS,
                                         chunk_bytes=STREAM_CHUNK_BYTES)
    rows = chunks = 0
    t0 = time.perf_counter()
    for labels, _, _ in source.iter_chunks():
        rows += len(labels)
        chunks += 1
    parse_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(p) for p in paths['train'])
    check(rows == sum(STREAM_ROWS['train']), f'parsed {rows} rows')
    emit({'phase': 'ingest', 'native': True,
          'parse_equal_to_python_rows': STREAM_PARSE_CHECK_ROWS,
          'rows': rows, 'bytes': nbytes, 'files': len(paths['train']),
          'chunks': chunks, 'chunk_bytes': STREAM_CHUNK_BYTES,
          'parse_s': parse_s, 'rows_per_s': rows / parse_s,
          'mb_per_s': nbytes / 1e6 / parse_s, 'cpu_count': os.cpu_count(),
          'parse_threads': min(os.cpu_count() or 1, 16),
          'write_s': write_s})


def stream_model(port, criteo, dtype_policy, device):
    """DeepFM on the hashed Criteo schema of STREAM_BUCKETS."""
    cats, conts = criteo.criteo_columns(STREAM_BUCKETS, emb_dim=D_CRITEO,
                                        n_dense=N_DENSE)
    config = port.ModelConfig(
        nets=NETS['DeepFM'], metrics=['AUC'], task='binary',
        embedding_dropout=0, embeddings_output_dim=D_CRITEO,
        dnn_params={'hidden_units': ((1024, 0, False), (512, 0, False)),
                    'activation': 'relu'},
        dtype_policy=dtype_policy, earlystopping_patience=0)
    return port.DeepModel('binary', 2, config, cats, conts, device=device)


def stream_loaders(criteo, fast_ingest, paths):
    """(training loader, validation loader) over the shards: shuffled
    batches of 8192 from STREAM_SEED, the remainder of each chunk dropped;
    the validation rows in order, all of them."""
    def source(split):
        return fast_ingest.CriteoTsvSource(paths[split],
                                           hash_buckets=STREAM_BUCKETS,
                                           chunk_bytes=STREAM_CHUNK_BYTES)
    return (criteo.CriteoStreamLoader(source('train'), batch_size=TRAIN_BATCH,
                                      seed=STREAM_SEED),
            criteo.CriteoStreamLoader(source('val'), batch_size=TRAIN_BATCH,
                                      shuffle=False, drop_remainder=False))


def stream_card_vs_cpu(torch, port, criteo, fast_ingest, paths,
                       dtype_policy):
    """The same shards, STREAM_COMPARE_STEPS steps and the validation loader
    on the card and on the CPU's plain path from the same initial weights,
    by the train phase's rules: losses float32 rtol 1e-4, bfloat16 atol
    1e-2; float32 parameters by check_params."""
    fits, init_state = {}, None
    for run, device in (('card', None), ('cpu', 'cpu')):
        model = stream_model(port, criteo, dtype_policy, device)
        module = model.build()
        if init_state is None:
            init_state = {k: v.detach().cpu().clone()
                          for k, v in module.state_dict().items()}
        else:
            module.load_state_dict(init_state)
        train_loader, val_loader = stream_loaders(criteo, fast_ingest, paths)
        t0 = time.perf_counter()
        h = model.fit(train_loader, epochs=1,
                      steps_per_epoch=STREAM_COMPARE_STEPS,
                      validation_data=val_loader, verbose=0)
        fits[run] = ({k: v.detach().cpu() for k, v in
                      module.state_dict().items()},
                     {k: v[0] for k, v in h.history.data.items()},
                     time.perf_counter() - t0)
        del model, module
    (card_state, card_logs, card_s), (cpu_state, cpu_logs, cpu_s) = \
        fits['card'], fits['cpu']
    what = f'stream {dtype_policy}'
    loss_diff = {k: abs(card_logs[k] - cpu_logs[k])
                 for k in ('loss', 'val_loss')}
    params = None
    if dtype_policy == 'float32':
        for k, d in loss_diff.items():
            check(d <= 1e-4 * abs(cpu_logs[k]),
                  f'{what}: card {k} {card_logs[k]} vs CPU {cpu_logs[k]}')
        params = check_params(what, card_state, cpu_state)
        tolerance = {'loss_rtol': 1e-4, 'param_atol': PARAM_ATOL,
                     'param_outlier_share': PARAM_OUTLIERS}
    else:
        check(all(d <= 1e-2 for d in loss_diff.values()),
              f'{what}: card and CPU losses differ by {loss_diff}')
        tolerance = {'loss_atol': 1e-2}
    return {'dtype_policy': dtype_policy, 'steps': STREAM_COMPARE_STEPS,
            'card': card_logs, 'cpu': cpu_logs, 'loss_diff': loss_diff,
            'params_vs_cpu': params, 'tolerance': tolerance,
            'card_fit_s': card_s, 'cpu_fit_s': cpu_s}


def stream_phase(torch, port, kernel_fns, paths):
    """DeepFM trained from the TSV shards through the native parser,
    CriteoStreamLoader and ``DeepModel.fit`` on the card (STREAM_EPOCHS
    epochs, a validation loader), at the bench's ingest configuration. It
    checks the launches (K1, K2-bwd once a step, K2-fwd once a step and a
    validation batch; no other kernel), that the loss fell, streaming
    ``evaluate`` and ``predict`` against the in-memory ones on the same
    rows (STREAM_EVAL_ATOL), and the card against the CPU
    (stream_card_vs_cpu, both policies). Returns the fit's launches."""
    from deeptables_torch.data import criteo, fast_ingest
    from deeptables_torch.models.callbacks import LambdaCallback
    from deeptables_torch.utils import device as device_utils

    model = stream_model(port, criteo, 'bfloat16', None)
    train_loader, val_loader = stream_loaders(criteo, fast_ingest, paths)
    val_chunks = list(val_loader.source.iter_chunks())
    val_batches = sum(-(-len(c[0]) // TRAIN_BATCH) for c in val_chunks)
    step_s, val_s, epochs = [], [], []
    train_step, loader_logits = model._train_step, model._loader_logits

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    def timed_validation(loader):
        t = time.perf_counter()
        out = loader_logits(loader)
        val_s.append(time.perf_counter() - t)
        return out

    def epoch_begin(epoch, logs=None):
        torch.cuda.synchronize()
        epochs.append({'t': time.perf_counter(), 'first_step': len(step_s)})

    def epoch_end(epoch, logs=None):
        torch.cuda.synchronize()
        epochs[-1].update(s=time.perf_counter() - epochs[-1].pop('t'),
                          steps=len(step_s) - epochs[-1]['first_step'])
    model._train_step, model._loader_logits = timed_step, timed_validation
    reset_launches(kernel_fns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = model.fit(train_loader, epochs=STREAM_EPOCHS, verbose=0,
                        validation_data=val_loader,
                        callbacks=[LambdaCallback(on_epoch_begin=epoch_begin,
                                                  on_epoch_end=epoch_end)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches(kernel_fns)
    peak = device_utils.memory_stats()['allocated_bytes.all.peak']
    del model._train_step, model._loader_logits
    logs = {k: list(v) for k, v in history.history.data.items()}
    steps = len(step_s)
    per_epoch = [e['steps'] for e in epochs]
    check(len(per_epoch) == STREAM_EPOCHS and min(per_epoch) > 0
          and len(set(per_epoch)) == 1, f'stream steps by epoch {per_epoch}')
    check(all(math.isfinite(v) for vs in logs.values() for v in vs),
          f'stream: non-finite logs {logs}')
    check(logs['loss'][-1] < logs['loss'][0],
          f'stream: the loss did not fall: {logs["loss"]}')
    expected = dict.fromkeys(kernel_fns, 0)
    expected.update(emb_grad=steps, fm_bwd=steps,
                    fm_fwd=steps + STREAM_EPOCHS * val_batches)
    check(launches == expected, f'stream: {steps} steps and {STREAM_EPOCHS} '
                                f'validations of {val_batches} batches '
                                f'launched {launches}, expected {expected}')

    # streaming evaluate and predict against the in-memory ones
    labels, dense, cats = (np.concatenate(a) for a in zip(*val_chunks))
    arrays = {criteo.CAT_KEY: cats, criteo.DENSE_KEY: dense}
    scores = {'stream': dict(model.evaluate(val_loader)),
              'in_memory': dict(model.evaluate(arrays, labels,
                                               batch_size=TRAIN_BATCH))}
    proba = {'stream': model.predict(val_loader),
             'in_memory': model.predict(arrays, batch_size=TRAIN_BATCH)}
    check(proba['stream'].shape == (len(labels), 1)
          and np.isfinite(proba['stream']).all(),
          f'stream predict gave {proba["stream"].shape}')
    predict_diff = float(np.abs(proba['stream'] - proba['in_memory']).max())
    score_diff = {k: abs(v - scores['in_memory'][k])
                  for k, v in scores['stream'].items()}
    check(predict_diff <= STREAM_EVAL_ATOL
          and max(score_diff.values()) <= STREAM_EVAL_ATOL,
          f'stream evaluate/predict differ from the in-memory ones: '
          f'{score_diff}, predict {predict_diff}')
    del model
    torch.cuda.empty_cache()
    card_vs_cpu = [stream_card_vs_cpu(torch, port, criteo, fast_ingest, paths,
                                      policy)
                   for policy in ('bfloat16', 'float32')]
    later = sorted(step_s[per_epoch[0]:])
    emit({'phase': 'stream', 'model': 'DeepFM', 'dtype_policy': 'bfloat16',
          'hash_buckets': list(STREAM_BUCKETS),
          'table_rows': int(sum(STREAM_BUCKETS)), 'batch_size': TRAIN_BATCH,
          'rows': {k: list(v) for k, v in STREAM_ROWS.items()},
          'chunk_bytes': STREAM_CHUNK_BYTES, 'epochs': STREAM_EPOCHS,
          'steps_per_epoch': per_epoch, 'val_batches': val_batches,
          'fit_s': fit_s, 'epoch_s': [e['s'] for e in epochs],
          'validation_s': val_s,
          'examples_per_s': [TRAIN_BATCH * e['steps'] / (e['s'] - v)
                             for e, v in zip(epochs, val_s)],
          'median_step_ms': 1e3 * sorted(step_s)[steps // 2],
          'median_step_ms_after_epoch_1': 1e3 * later[len(later) // 2],
          'step_ms': [1e3 * t for t in step_s],
          'launches': launches,
          'launches_per_step': {k: (launches[k] - (
              STREAM_EPOCHS * val_batches if k == 'fm_fwd' else 0)) / steps
              for k in ('fm_fwd', 'fm_bwd', 'emb_grad')},
          'peak_allocated_bytes': peak, 'logs': logs,
          'val_auc': logs['val_auc'][-1],
          'evaluate': scores, 'evaluate_diff': score_diff,
          'predict_max_abs_diff': predict_diff,
          'eval_atol': STREAM_EVAL_ATOL, 'card_vs_cpu': card_vs_cpu})
    return launches


def stream_determinism_phase(torch, port, paths):
    """Two card fits of STREAM_DETERMINISM_STEPS shuffled steps from one
    seed: their parameters must be equal bit for bit (the loader's order is
    drawn on the iterating thread, K1 sums without atomics)."""
    from deeptables_torch.data import criteo, fast_ingest
    states = []
    for _ in range(2):
        model = stream_model(port, criteo, 'bfloat16', None)
        train_loader, _ = stream_loaders(criteo, fast_ingest, paths)
        model.fit(train_loader, epochs=1,
                  steps_per_epoch=STREAM_DETERMINISM_STEPS, verbose=0)
        states.append({k: v.detach().cpu().clone()
                       for k, v in model.module.state_dict().items()})
        del model
    first, second = states
    differ = {k: float((first[k].double() - second[k].double()).abs().max())
              for k in first if not torch.equal(first[k], second[k])}
    emit({'phase': 'stream_determinism', 'model': 'DeepFM',
          'dtype_policy': 'bfloat16', 'steps': STREAM_DETERMINISM_STEPS,
          'batch_size': TRAIN_BATCH, 'tensors': len(first),
          'differ': differ})
    check(not differ, f'two stream fits from one seed differ: {differ}')


def fold_launches(kernel_fns):
    """A fit callback that records each fit's kernel launches (the counts'
    growth from ``on_train_begin`` to ``on_train_end``) in ``folds``."""
    from deeptables_torch.models.callbacks import Callback

    class FoldLaunches(Callback):
        def __init__(self):
            super().__init__()
            self.folds = []
            self._start = None

        def on_train_begin(self, logs=None):
            self._start = {k: fn.launches for k, fn in kernel_fns.items()}

        def on_train_end(self, logs=None):
            self.folds.append({k: fn.launches - self._start[k]
                               for k, fn in kernel_fns.items()})

    return FoldLaunches()


def estimator_phase(torch, port, kernel_fns, tmp):
    """``DeepTable`` on the card with pandas and scikit-learn blocked (see
    the module's docstring, 10). Returns the launches of the runs on the
    card."""
    return blocked_run(_estimator_runs, torch, port, kernel_fns, tmp)


def blocked_run(run, *args, blocked=ESTIMATOR_BLOCKED):
    """``run(*args)`` with ``blocked`` (ESTIMATOR_BLOCKED) set to None in
    sys.modules, so that importing them fails; restored after."""
    saved = {name: sys.modules.get(name) for name in blocked}
    for name in blocked:
        sys.modules[name] = None
    try:
        return run(*args)
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def _estimator_runs(torch, port, kernel_fns, tmp):
    from deeptables_torch.data.columns import Columns
    from deeptables_torch.models import DeepTable, ModelConfig
    from deeptables_torch.serving import Predictor
    from deeptables_torch.tools import parity_quality as pq
    spec = pq.configs()['bank_deepfm']
    table = spec['loader']()
    check(isinstance(table, Columns), f'load_bank gave {type(table)} with '
                                      f'pandas blocked, not Columns')
    X_train, X_test, y_train, y_test = pq.split(table, spec['target'],
                                                'binary')
    launches = dict.fromkeys(kernel_fns, 0)

    def config(**extra):
        return ModelConfig(nets=spec['nets'], metrics=pq.TASK_METRICS['binary'],
                           earlystopping_patience=3, seed=0,
                           home_dir=os.path.join(tmp, 'dt'),
                           **dict(spec['conf'], **extra))

    # (a) the card against the CPU, three steps from one seed
    fits = {}
    for run, device in (('card', None), ('cpu', 'cpu')):
        reset_launches(kernel_fns)
        dt = DeepTable(config(embedding_dropout=0), device=device)
        t0 = time.time()
        _, history = dt.fit(X_train, y_train, epochs=1,
                            batch_size=pq.BATCH, verbose=0,
                            steps_per_epoch=ESTIMATOR_STEPS)
        fit_s = time.time() - t0
        proba = dt.predict_proba(X_test)
        evaluation = {k: float(v) for k, v in
                      dt.evaluate(X_test, y_test, verbose=0).items()}
        if run == 'card':
            counts = read_launches(kernel_fns)
            for name, count in counts.items():
                launches[name] += count
            check(all(counts[k] > 0 for k in ('emb_grad', 'fm_fwd', 'fm_bwd')),
                  f'DeepTable.fit on the card launched {counts}')
        fits[run] = (dt, {k: v.detach().cpu() for k, v in
                          dt.get_model().module.state_dict().items()},
                     {k: v[0] for k, v in history.history.data.items()},
                     proba, evaluation, fit_s)
    card_dt, card_state, card_logs, card_proba, card_eval, card_s = fits['card']
    _, cpu_state, cpu_logs, cpu_proba, cpu_eval, cpu_s = fits['cpu']
    loss_diff = {k: abs(card_logs[k] - cpu_logs[k])
                 for k in ('loss', 'val_loss')}
    for k, d in loss_diff.items():
        check(d <= 1e-4 * abs(cpu_logs[k]),
              f'estimator: card {k} {card_logs[k]} vs CPU {cpu_logs[k]}')
    # bank's raw dense columns (balance, duration: variances ~1e6) reach
    # the dense BatchNorm unscaled: its running statistics, sums of 512
    # rows in another order, are held to float32's relative rounding
    running = [k for k in cpu_state if '.running_' in k]
    params = check_params('estimator', card_state, cpu_state, loose=running,
                          loose_atol=PARAM_ATOL,
                          loose_rtol=ESTIMATOR_RUNNING_RTOL)
    proba_diff = float(np.abs(card_proba - cpu_proba).max())
    check(card_proba.shape == (len(y_test), 2)
          and np.isfinite(card_proba).all()
          and proba_diff <= ESTIMATOR_PROBA_ATOL,
          f'estimator: card and CPU predict_proba differ by {proba_diff}')
    emit({'phase': 'estimator', 'part': 'card_vs_cpu', 'row': 'bank_deepfm',
          'train_rows': len(y_train), 'test_rows': len(y_test),
          'steps': ESTIMATOR_STEPS, 'fit_s': {'card': card_s, 'cpu': cpu_s},
          'card': card_logs, 'cpu': cpu_logs, 'loss_diff': loss_diff,
          'params_over_atol': {k: v['over_atol'] for k, v in params.items()
                               if v['over_atol']},
          'params_max_abs_diff': max(v['max_abs_diff']
                                     for v in params.values()),
          'proba_max_abs_diff': proba_diff,
          'evaluate': {'card': card_eval, 'cpu': cpu_eval},
          'tolerance': {'loss_rtol': 1e-4, 'param_atol': PARAM_ATOL,
                        'param_outlier_share': PARAM_OUTLIERS,
                        'running_stats_rtol': ESTIMATOR_RUNNING_RTOL,
                        'proba_atol': ESTIMATOR_PROBA_ATOL},
          'blocked': list(ESTIMATOR_BLOCKED)})

    # (b) cross-validation on the card, K1 and K2 in every fold
    reset_launches(kernel_fns)
    folds = fold_launches(kernel_fns)
    dt = DeepTable(config(), device=None)
    t0 = time.time()
    oof, _, _ = dt.fit_cross_validation(
        X_train, y_train, num_folds=ESTIMATOR_FOLDS, epochs=1,
        batch_size=pq.BATCH, verbose=0, callbacks=[folds])
    cv_s = time.time() - t0
    for name, count in read_launches(kernel_fns).items():
        launches[name] += count
    check(oof.shape == (len(y_train), 2) and np.isfinite(oof).all(),
          f'estimator: out-of-fold probabilities of shape {oof.shape}')
    check(len(folds.folds) == ESTIMATOR_FOLDS and all(
        fold[k] > 0 for fold in folds.folds
        for k in ('emb_grad', 'fm_fwd', 'fm_bwd')),
        f'estimator: the folds launched {folds.folds}')
    emit({'phase': 'estimator', 'part': 'cv', 'folds': ESTIMATOR_FOLDS,
          'cv_s': cv_s, 'oof_shape': list(oof.shape),
          'fold_launches': [{k: v for k, v in fold.items() if v}
                            for fold in folds.folds]})

    # (c) save, Predictor.load on the card, bit-equal predictions
    reset_launches(kernel_fns)
    request = X_test.take(np.arange(ESTIMATOR_REQUEST))
    own = Predictor(card_dt).predict_proba(request)
    own_predict = card_dt.predict_proba(request, batch_size=ESTIMATOR_REQUEST)
    path = os.path.join(tmp, 'estimator_saved')
    card_dt.save(path)
    predictor = Predictor.load(path, device=None)
    t0 = time.perf_counter()
    served = predictor.predict_proba(request)
    torch.cuda.synchronize()
    request_ms = 1e3 * (time.perf_counter() - t0)
    for name, count in read_launches(kernel_fns).items():
        launches[name] += count
    check(served.shape == own.shape and np.array_equal(served, own),
          f'estimator: Predictor.load gives other predictions, largest '
          f'difference {float(np.abs(served - own).max())}')
    # DeepTable.predict_proba takes the sigmoid on the host
    predict_diff = float(np.abs(served - own_predict).max())
    check(predict_diff <= RTOL['float32'],
          f'estimator: the served and predict_proba probabilities differ '
          f'by {predict_diff}')
    check(str(predictor.model.device).startswith('cuda'),
          f'Predictor.load put the model on {predictor.model.device}')
    emit({'phase': 'estimator', 'part': 'serving', 'rows': ESTIMATOR_REQUEST,
          'bit_equal': True, 'vs_predict_proba_max_abs_diff': predict_diff,
          'request_ms': request_ms, 'files': sorted(os.listdir(path))})
    del predictor, card_dt, dt, fits
    torch.cuda.empty_cache()

    # (d) trained quality, seed 0, the kernel rows of the parity tool
    quality = {}
    specs = pq.configs()
    for name in ESTIMATOR_BASELINE:
        reset_launches(kernel_fns)
        out = pq.run(name, specs[name], 0, None, os.path.join(tmp, 'pq'))
        counts = read_launches(kernel_fns)
        for kernel, count in counts.items():
            launches[kernel] += count
        rows = {}
        for metric, (mean, sigma) in ESTIMATOR_BASELINE[name].items():
            check(math.isfinite(out[metric]),
                  f'quality: {name} {metric} is {out[metric]}')
            rows[metric] = {'card': out[metric], 'baseline': mean,
                            'sigma': sigma,
                            'within_sigma': abs(out[metric] - mean) <= sigma}
        same_table = out['table'] == ESTIMATOR_TABLES[name]
        mean, sigma = ESTIMATOR_BASELINE[name]['auc']
        floor = mean - 5 * sigma if same_table else (0.5 + mean) / 2
        check(out['auc'] > floor,
              f'quality: {name} AUC {out["auc"]} on the card, floor {floor}')
        quality[name] = dict(rows, fit_seconds=out['fit_seconds'],
                             epochs_run=out['epochs_run'],
                             table=out['table'], baseline_table=same_table,
                             auc_floor=floor,
                             launches={k: v for k, v in counts.items() if v})
        torch.cuda.empty_cache()
    emit({'phase': 'estimator', 'part': 'quality', 'seed': 0,
          'baseline': 'BASELINE.md (JAX package, TPU v5e, 3 seeds)',
          'rows': quality})
    return launches


def criteo_tokens(cat):
    """8-hex-digit tokens of a 32-bit hash (murmur3's finaliser) of each id
    and its column, as Criteo's public data writes its categories."""
    mask = np.uint64(0xffffffff)
    h = ((cat.astype(np.uint64) + np.uint64(1)) * np.uint64(0x9e3779b1)
         + (np.arange(cat.shape[1], dtype=np.uint64) + np.uint64(1))
         * np.uint64(0x85ebca6b)) & mask
    for shift, mult in ((16, 0x85ebca6b), (13, 0xc2b2ae35), (16, None)):
        h ^= h >> np.uint64(shift)
        if mult is not None:
            h = (h * np.uint64(mult)) & mask
    digits = np.frombuffer(b'0123456789abcdef', np.uint8)
    text = np.empty(h.shape + (8,), np.uint8)
    for k in range(8):
        text[..., k] = digits[((h >> np.uint64(28 - 4 * k))
                               & np.uint64(15)).astype(np.intp)]
    return text.view('S8')[..., 0].astype('U8')


def write_stream_csv(tmp, load_criteo_synthetic):
    """The stream_csv phase's shards in ``tmp``, written with the standard
    library's csv: {'train': [paths], 'val': [path]} and the seconds it
    took."""
    import csv
    t0 = time.perf_counter()
    n_train = STREAM_CSV_SHARDS * STREAM_CSV_ROWS
    cat, dense, y, _ = load_criteo_synthetic(
        n_rows=n_train + STREAM_CSV_VAL_ROWS, seed=STREAM_CSV_SEED,
        return_arrays=True)
    rng = np.random.default_rng(STREAM_CSV_SEED)
    dense_text = dense.astype(str)
    dense_text[rng.random(dense.shape) < STREAM_CSV_MISSING['dense']] = ''
    tokens = criteo_tokens(cat)
    tokens[rng.random(cat.shape) < STREAM_CSV_MISSING['categorical']] = ''
    table = np.concatenate([y.astype(np.int64).astype(str)[:, None],
                            dense_text, tokens], axis=1)
    header = (['label'] + [f'I{j}' for j in range(1, N_DENSE + 1)]
              + [f'C{j}' for j in range(1, F_CRITEO + 1)])
    paths = {'train': [], 'val': []}
    bounds = [(k * STREAM_CSV_ROWS, (k + 1) * STREAM_CSV_ROWS)
              for k in range(STREAM_CSV_SHARDS)] + [(n_train, len(y))]
    for k, (lo, hi) in enumerate(bounds):
        split = 'val' if k == STREAM_CSV_SHARDS else 'train'
        path = os.path.join(tmp, f'{split}_{k}.csv')
        with open(path, 'w', newline='') as f:
            writer = csv.writer(f, lineterminator='\n')
            writer.writerow(header)
            writer.writerows(table[lo:hi].tolist())
        paths[split].append(path)
    return paths, time.perf_counter() - t0


def stream_csv_config(port, tmp, **extra):
    """DeepFM at full criteo width on the CSV columns, the default policy."""
    return port.ModelConfig(
        nets=NETS['DeepFM'], metrics=['AUC'], embeddings_output_dim=D_CRITEO,
        categorical_columns=[f'C{j}' for j in range(1, F_CRITEO + 1)],
        dnn_params={'hidden_units': ((1024, 0, False), (512, 0, False)),
                    'activation': 'relu'},
        earlystopping_patience=0, home_dir=os.path.join(tmp, 'dt'), **extra)


def preprocessor_summary(pre):
    """A fitted preprocessor's column lists, vocabularies and imputation
    fills (a column's mean, or its constant), and the columns that take a
    mean: from the in-memory fit's ColumnTransformer of SimpleImputers or
    the streaming fit's FixedImputer."""
    encoders = pre.X_transformers['label_encoder'].encoders
    step = pre.X_transformers['imputation']
    fills, means = {}, set()
    if hasattr(step, 'means'):
        fills.update(step.means)
        fills.update({c: '' for c in step.obj_cats})
        fills.update({c: 0 for c in step.num_cats})
        means.update(step.means)
    else:
        for _, imputer, cols in step.transformer.transformers_:
            if isinstance(imputer, str):
                continue
            fills.update(zip(cols, imputer.statistics_.tolist()))
            if imputer.strategy == 'mean':
                means.update(cols)
    return {'categorical': [(c.name, c.vocabulary_size,
                             c.embeddings_output_dim)
                            for c in pre.categorical_columns],
            'continuous': [(c.name, list(c.column_names))
                           for c in pre.continuous_columns],
            'vocabularies': {c: np.asarray(e.classes_)
                             for c, e in encoders.items()},
            'fills': fills, 'means': means}


def stream_csv_phase(torch, port, kernel_fns, tmp, load_criteo_synthetic):
    """DeepTable from CSV shards on the card with pandas and scikit-learn
    blocked (see the module's docstring, 11). Returns the launches of the
    runs on the card."""
    t0 = time.perf_counter()
    launches = blocked_run(_stream_csv_runs, torch, port, kernel_fns, tmp,
                           load_criteo_synthetic)
    emit({'phase': 'stream_csv_wall', 's': time.perf_counter() - t0,
          'launches': {k: v for k, v in launches.items() if v}})
    return launches


def _stream_csv_runs(torch, port, kernel_fns, tmp, load_criteo_synthetic):
    from deeptables_torch.data import columns
    from deeptables_torch.data.streaming import (ChunkedSource,
                                                 StreamingDataLoader,
                                                 fit_preprocessor_streaming)
    from deeptables_torch.models import DeepModel, DeepTable
    from deeptables_torch.models.callbacks import LambdaCallback
    from deeptables_torch.models.deeptable import probe_evaluate
    from deeptables_torch.models.preprocessor import DefaultPreprocessor
    from deeptables_torch.ops import metrics as metrics_lib
    from deeptables_torch.utils.feature_importance import \
        get_score_importances
    launches = dict.fromkeys(kernel_fns, 0)

    def add(counts):
        for name, count in counts.items():
            launches[name] += count
        return counts

    paths, write_s = write_stream_csv(tmp, load_criteo_synthetic)
    n_train = STREAM_CSV_SHARDS * STREAM_CSV_ROWS
    nbytes = sum(os.path.getsize(p) for p in paths['train'])

    # (a) the exact streaming fit against DeepTable's in-memory one
    source = ChunkedSource(paths['train'], chunk_size=STREAM_CSV_CHUNK)
    pre = DefaultPreprocessor(stream_csv_config(port, tmp), use_cache=False)
    t = time.perf_counter()
    fit_preprocessor_streaming(pre, source, 'label')
    pre_s = time.perf_counter() - t
    t = time.perf_counter()
    table = columns.concat([columns.read_csv(p) for p in paths['train']])
    read_s = time.perf_counter() - t
    check(isinstance(table, columns.Columns) and len(table) == n_train,
          f'read_csv gave {type(table)} of {len(table)} rows')
    y = table.pop('label')
    reset_launches(kernel_fns)
    memory_dt = DeepTable(stream_csv_config(port, tmp), device=None,
                          preprocessor=DefaultPreprocessor(
                              stream_csv_config(port, tmp), use_cache=False))
    t = time.perf_counter()
    memory_dt.fit(table, y, epochs=1, batch_size=TRAIN_BATCH,
                  steps_per_epoch=1, verbose=0)
    memory_fit_s = time.perf_counter() - t
    add(read_launches(kernel_fns))
    streamed, in_memory = (preprocessor_summary(p)
                           for p in (pre, memory_dt.preprocessor))
    check(streamed['categorical'] == in_memory['categorical']
          and streamed['continuous'] == in_memory['continuous'],
          'stream_csv: the streamed and in-memory column lists differ')
    check(list(streamed['vocabularies']) == list(in_memory['vocabularies'])
          and all(np.array_equal(v, in_memory['vocabularies'][c])
                  for c, v in streamed['vocabularies'].items()),
          'stream_csv: the streamed and in-memory vocabularies differ')
    check(streamed['means'] == in_memory['means'] and set(streamed['fills'])
          == set(in_memory['fills']),
          'stream_csv: the imputed columns differ')
    mean_rel = 0.
    for c, fill in streamed['fills'].items():
        if c in streamed['means']:
            mean_rel = max(mean_rel, abs(fill - in_memory['fills'][c])
                           / abs(in_memory['fills'][c]))
        else:
            check(fill == in_memory['fills'][c],
                  f'stream_csv: the fill of {c}: {fill!r}, in memory '
                  f'{in_memory["fills"][c]!r}')
    check(mean_rel <= STREAM_CSV_MEAN_RTOL,
          f'stream_csv: imputation means differ by {mean_rel} (relative)')
    vocab = {c: len(v) for c, v in streamed['vocabularies'].items()}
    emit({'phase': 'stream_csv_pre', 'rows': n_train, 'bytes': nbytes,
          'files': len(paths['train']), 'chunk_rows': STREAM_CSV_CHUNK,
          'write_s': write_s, 'fit_preprocessor_streaming_s': pre_s,
          'pass_rows_per_s': n_train / pre_s, 'whole_read_s': read_s,
          'read_rows_per_s': n_train / read_s,
          'read_mb_per_s': nbytes / 1e6 / read_s,
          'memory_fit_s': memory_fit_s,
          'equal': {'columns': True, 'vocabularies': True, 'fills': True},
          'mean_max_rel_diff': mean_rel, 'mean_rtol': STREAM_CSV_MEAN_RTOL,
          'vocabulary_rows': int(sum(vocab.values())),
          'cpu_count': os.cpu_count()})
    del memory_dt, table
    torch.cuda.empty_cache()

    def loaders():
        train = StreamingDataLoader(source, pre, 'label',
                                    batch_size=TRAIN_BATCH,
                                    seed=STREAM_CSV_SEED)
        val = StreamingDataLoader(
            ChunkedSource(paths['val'], chunk_size=STREAM_CSV_CHUNK), pre,
            'label', batch_size=TRAIN_BATCH, shuffle_in_chunk=False,
            drop_remainder=False)
        return train, val

    # (b) the card against the CPU, three steps from one seed
    fits = {}
    for run, device in (('card', None), ('cpu', 'cpu')):
        reset_launches(kernel_fns)
        dt = DeepTable(stream_csv_config(port, tmp, embedding_dropout=0),
                       preprocessor=pre, device=device)
        train, val = loaders()
        t = time.perf_counter()
        _, history = dt.fit(train, epochs=1, verbose=0,
                            steps_per_epoch=STREAM_COMPARE_STEPS,
                            validation_data=val)
        fits[run] = ({k: v.detach().cpu() for k, v in
                      dt.get_model().module.state_dict().items()},
                     {k: v[0] for k, v in history.history.data.items()},
                     time.perf_counter() - t)
        if run == 'card':
            counts = add(read_launches(kernel_fns))
            check(all(counts[k] > 0 for k in ('emb_grad', 'fm_fwd',
                                              'fm_bwd')),
                  f'stream_csv: the card fit launched {counts}')
        del dt
    (card_state, card_logs, card_s), (cpu_state, cpu_logs, cpu_s) = \
        fits['card'], fits['cpu']
    loss_diff = {k: abs(card_logs[k] - cpu_logs[k])
                 for k in ('loss', 'val_loss')}
    for k, d in loss_diff.items():
        check(d <= 1e-4 * abs(cpu_logs[k]),
              f'stream_csv: card {k} {card_logs[k]} vs CPU {cpu_logs[k]}')
    params = check_params('stream_csv', card_state, cpu_state)
    emit({'phase': 'stream_csv_card_vs_cpu', 'dtype_policy': 'float32',
          'steps': STREAM_COMPARE_STEPS, 'card': card_logs, 'cpu': cpu_logs,
          'loss_diff': loss_diff, 'fit_s': {'card': card_s, 'cpu': cpu_s},
          'params_over_atol': {k: v['over_atol'] for k, v in params.items()
                               if v['over_atol']},
          'params_max_abs_diff': max(v['max_abs_diff']
                                     for v in params.values()),
          'tolerance': {'loss_rtol': 1e-4, 'param_atol': PARAM_ATOL,
                        'param_outlier_share': PARAM_OUTLIERS},
          'blocked': list(ESTIMATOR_BLOCKED)})
    del fits, card_state, cpu_state
    torch.cuda.empty_cache()

    # (c) two epochs on the card, step times on the host clock
    step_s, val_s, epochs = [], [], []
    train_step, loader_logits = DeepModel._train_step, \
        DeepModel._loader_logits

    def timed_step(self, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    def timed_validation(self, loader):
        t = time.perf_counter()
        out = loader_logits(self, loader)
        val_s.append(time.perf_counter() - t)
        return out

    def epoch_begin(epoch, logs=None):
        torch.cuda.synchronize()
        epochs.append({'t': time.perf_counter(), 'first_step': len(step_s)})

    def epoch_end(epoch, logs=None):
        torch.cuda.synchronize()
        epochs[-1].update(s=time.perf_counter() - epochs[-1].pop('t'),
                          steps=len(step_s) - epochs[-1]['first_step'])
    train, val = loaders()
    val_batches = -(-STREAM_CSV_VAL_ROWS // TRAIN_BATCH)
    reset_launches(kernel_fns)
    fit_dt = DeepTable(stream_csv_config(port, tmp), preprocessor=pre,
                       device=None)
    DeepModel._train_step, DeepModel._loader_logits = \
        timed_step, timed_validation
    try:
        t = time.perf_counter()
        _, history = fit_dt.fit(
            train, epochs=STREAM_CSV_EPOCHS, verbose=0, validation_data=val,
            callbacks=[LambdaCallback(on_epoch_begin=epoch_begin,
                                      on_epoch_end=epoch_end)])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    finally:
        DeepModel._train_step, DeepModel._loader_logits = \
            train_step, loader_logits
    counts = add(read_launches(kernel_fns))
    logs = {k: list(v) for k, v in history.history.data.items()}
    steps = len(step_s)
    per_epoch = [e['steps'] for e in epochs]
    check(len(per_epoch) == STREAM_CSV_EPOCHS and min(per_epoch) > 0,
          f'stream_csv steps by epoch {per_epoch}')
    check(all(math.isfinite(v) for vs in logs.values() for v in vs),
          f'stream_csv: non-finite logs {logs}')
    check(logs['loss'][-1] < logs['loss'][0],
          f'stream_csv: the loss did not fall: {logs["loss"]}')
    expected = dict.fromkeys(kernel_fns, 0)
    expected.update(emb_grad=steps, fm_bwd=steps,
                    fm_fwd=steps + STREAM_CSV_EPOCHS * val_batches)
    check(counts == expected, f'stream_csv: {steps} steps and '
                              f'{STREAM_CSV_EPOCHS} validations of '
                              f'{val_batches} batches launched {counts}, '
                              f'expected {expected}')
    emit({'phase': 'stream_csv_fit', 'model': 'DeepFM',
          'dtype_policy': 'float32', 'batch_size': TRAIN_BATCH,
          'train_rows': n_train, 'val_rows': STREAM_CSV_VAL_ROWS,
          'epochs': STREAM_CSV_EPOCHS, 'steps_per_epoch': per_epoch,
          'val_batches': val_batches, 'fit_s': fit_s,
          'epoch_s': [e['s'] for e in epochs], 'validation_s': val_s,
          'examples_per_s': [TRAIN_BATCH * e['steps'] / (e['s'] - v)
                             for e, v in zip(epochs, val_s)],
          'median_step_ms': 1e3 * sorted(step_s)[steps // 2],
          'step_ms': [1e3 * t for t in step_s], 'launches': counts,
          'logs': logs, 'table_rows': int(sum(
              c.vocabulary_size for c in pre.categorical_columns))})

    # (d) cross-validation over the first STREAM_CSV_CV_SHARDS shards, K1
    # and K2 in every fold
    reset_launches(kernel_fns)
    folds = fold_launches(kernel_fns)
    cv_dt = DeepTable(stream_csv_config(port, tmp), preprocessor=pre,
                      device=None)
    t = time.perf_counter()
    scores = cv_dt.fit_cross_validation_streaming(
        ChunkedSource(paths['train'][:STREAM_CSV_CV_SHARDS],
                      chunk_size=STREAM_CSV_CHUNK), 'label',
        num_folds=STREAM_CSV_FOLDS, batch_size=TRAIN_BATCH, epochs=1,
        verbose=0, callbacks=[folds])
    cv_s = time.perf_counter() - t
    add(read_launches(kernel_fns))
    check(len(scores) == STREAM_CSV_FOLDS and all(
        math.isfinite(v) for score in scores for v in score.values()),
        f'stream_csv: fold scores {scores}')
    check(len(folds.folds) == STREAM_CSV_FOLDS and all(
        fold[k] > 0 for fold in folds.folds
        for k in ('emb_grad', 'fm_fwd', 'fm_bwd')),
        f'stream_csv: the folds launched {folds.folds}')
    emit({'phase': 'stream_csv_cv', 'folds': STREAM_CSV_FOLDS,
          'rows': STREAM_CSV_CV_SHARDS * STREAM_CSV_ROWS, 'cv_s': cv_s,
          'scores': scores,
          'fold_launches': [{k: v for k, v in fold.items() if v}
                            for fold in folds.folds]})

    # (e) the leaderboards, the linear probe, permutation importances
    reset_launches(kernel_fns)
    boards = {'fit': fit_dt.leaderboard, 'cv': cv_dt.leaderboard}
    for name, board in boards.items():
        check(isinstance(board, columns.Columns),
              f'stream_csv: the {name} leaderboard is {type(board)}')
    check(list(boards['cv']['model']) == [
        f'{"+".join(NETS["DeepFM"])}-stream-kfold-{k}'
        for k in range(1, STREAM_CSV_FOLDS + 1)],
        f'stream_csv: the CV leaderboard {boards["cv"]["model"]}')
    val_table = columns.read_csv(paths['val'][0])
    val_y = val_table.pop('label')
    n_probe, n_test = STREAM_CSV_PROBE_ROWS
    t = time.perf_counter()
    probe = probe_evaluate(
        fit_dt, val_table.take(np.arange(n_probe)), val_y[:n_probe],
        val_table.take(np.arange(n_probe, n_probe + n_test)),
        val_y[n_probe:n_probe + n_test], layers=['dnn_nets_out'],
        score_fn={'auc': metrics_lib.auc, 'accuracy': metrics_lib.accuracy})
    probe_s = time.perf_counter() - t
    check(probe['dnn_nets_out']['auc'] > 0.5,
          f'stream_csv: the probe scored {probe}')
    rows = np.arange(STREAM_CSV_IMPORTANCE_ROWS)
    t = time.perf_counter()
    importances = get_score_importances(
        fit_dt, val_table.take(rows), val_y[rows], 'AUC', n_iter=1,
        mode='max')
    importance_s = time.perf_counter() - t
    values = importances[:, 1].astype(float)
    check(importances.shape == (N_DENSE + F_CRITEO, 2)
          and np.isfinite(values).all()
          and list(values) == sorted(values, reverse=True),
          f'stream_csv: importances {importances.tolist()}')
    add(read_launches(kernel_fns))
    emit({'phase': 'stream_csv_estimator',
          'leaderboards': {name: {'rows': len(board),
                                  'columns': board.columns}
                           for name, board in boards.items()},
          'probe': probe, 'probe_rows': list(STREAM_CSV_PROBE_ROWS),
          'probe_s': probe_s, 'importance_rows': len(rows),
          'importance_s': importance_s,
          'importances_top5': importances[:5].tolist()})
    del fit_dt, cv_dt
    torch.cuda.empty_cache()
    return launches


def loss_fell(losses) -> bool:
    """Whether the mean of the last third of one epoch's step losses is
    below that of the first third."""
    k = len(losses) // 3
    return k > 0 and all(map(math.isfinite, losses)) and \
        np.mean(losses[-k:]) < np.mean(losses[:k])


def gbm_config(ModelConfig, spec, gbm_params=None, **extra):
    """The parity row's ModelConfig with GBM leaf features (GBM_PARAMS
    unless ``gbm_params``)."""
    return ModelConfig(nets=spec['nets'], apply_gbm_features=True,
                       gbm_params=dict(gbm_params or GBM_PARAMS),
                       **dict(spec['conf'], **extra))


def gbm_leaf_digest(X, columns) -> str:
    """The first 16 hex digits of the sha256 of the ``columns`` of ``X``
    as one int32 array in C order."""
    leaves = np.column_stack([np.asarray(X[c]) for c in columns])
    return hashlib.sha256(np.ascontiguousarray(
        leaves.astype(np.int32)).tobytes()).hexdigest()[:16]


def gbm_leaves(DefaultPreprocessor, ModelConfig, pq, row, to_frame=None,
               gbm_params=None):
    """(table digest, leaf digest, leaf columns, fit seconds) of the parity
    row's preprocessor with GBM leaf features (``gbm_params``, else
    GBM_PARAMS) fitted on its train split (``to_frame`` converts the split
    for a DataFrame preprocessor)."""
    spec = pq.configs()[row]
    table = spec['loader']()
    digest = pq.table_digest(table)  # (split pops the target)
    X_train, _, y_train, _ = pq.split(table, spec['target'],
                                      spec.get('task', 'binary'))
    if to_frame is not None:
        X_train = to_frame(X_train)
    pre = DefaultPreprocessor(gbm_config(ModelConfig, spec, gbm_params),
                              use_cache=False)
    t0 = time.perf_counter()
    X, _ = pre.fit_transform(X_train, y_train)
    fit_s = time.perf_counter() - t0
    names = pre.X_transformers['gbm_features'].new_columns
    return digest, gbm_leaf_digest(X, names), len(names), fit_s


def columns_digest(pq, cols) -> str:
    """``table_digest`` of ``cols`` with its categoricals' categories and
    a stored index."""
    h = hashlib.sha256(pq.table_digest(cols).encode())
    for name in cols.columns:
        if name in cols.categories:
            h.update(repr((name, list(cols.categories[name]))).encode())
    index = None if cols.index is None else np.asarray(cols.index)
    if index is not None and not np.array_equal(index, np.arange(len(cols))):
        h.update(index.astype(np.int64).tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def timed_calls(owner, name):
    """Inside, each call of ``owner.name`` is timed: yields the list its
    seconds go to."""
    original = getattr(owner, name)
    seconds = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)
    setattr(owner, name, timed)
    try:
        yield seconds
    finally:
        setattr(owner, name, original)


def gbm_phase(torch, port, kernel_fns, tmp):
    """GBM leaf features on the card with pandas, scikit-learn, pyarrow and
    LightGBM blocked (see the module's docstring, 12). Returns the launches
    of the runs on the card."""
    from deeptables_torch.models.transformers import GbmLeavesEncoder
    t0 = time.perf_counter()
    with timed_calls(GbmLeavesEncoder, 'fit_transform') as gbm_fit_s:
        launches = blocked_run(_gbm_runs, torch, port, kernel_fns, tmp,
                               gbm_fit_s)
    emit({'phase': 'gbm_wall', 's': time.perf_counter() - t0,
          'launches': {k: v for k, v in launches.items() if v}})
    return launches


def _gbm_runs(torch, port, kernel_fns, tmp, gbm_fit_s):
    from deeptables_torch.data.columns import Columns
    from deeptables_torch.data.datasets import load_criteo_synthetic
    from deeptables_torch.models import DeepModel, DeepTable, ModelConfig
    from deeptables_torch.models import gbm
    from deeptables_torch.models.preprocessor import DefaultPreprocessor
    from deeptables_torch.tools import parity_quality as pq
    launches = dict.fromkeys(kernel_fns, 0)

    def add(counts):
        for name, count in counts.items():
            launches[name] += count
        return counts

    # (a) the leaves of the three tasks, bit-equal to scikit-learn's
    t = time.perf_counter()
    gbm.get_library()
    build_s = time.perf_counter() - t
    rows = {}
    for row in GBM_ROWS:
        del gbm_fit_s[:]
        table, leaves, n_leaves, fit_s = gbm_leaves(
            DefaultPreprocessor, ModelConfig, pq, row)
        check(table == GBM_TABLES[row],
              f'gbm_leaves: the {row} table is {table}, not '
              f'{GBM_TABLES[row]}')
        check(leaves == GBM_LEAF_DIGESTS[row],
              f'gbm_leaves: {row} leaves {leaves}, scikit-learn '
              f'{GBM_LEAF_DIGESTS[row]}')
        rows[row] = {'table': table, 'leaf_digest': leaves,
                     'leaf_columns': n_leaves, 'gbm_fit_s': gbm_fit_s[0],
                     'preprocessor_fit_s': fit_s}
    emit({'phase': 'gbm_leaves', 'params': GBM_PARAMS, 'build_s': build_s,
          'rows': rows, 'equal': True})

    # (a2) every option past the defaults, its leaves at the JAX package's
    options = {}
    for option, (option_rows, params) in GBM_OPTIONS.items():
        for row in option_rows:
            del gbm_fit_s[:]
            _, leaves, n_leaves, fit_s = gbm_leaves(
                DefaultPreprocessor, ModelConfig, pq, row,
                gbm_params=dict(GBM_PARAMS, **params))
            check(leaves == GBM_OPTION_DIGESTS[option][row],
                  f'gbm_options: {option} on {row}: leaves {leaves}, '
                  f'scikit-learn {GBM_OPTION_DIGESTS[option][row]}')
            options.setdefault(option, {'params': params})[row] = {
                'leaf_digest': leaves, 'leaf_columns': n_leaves,
                'gbm_fit_s': gbm_fit_s[0]}
    emit({'phase': 'gbm_options', 'options': options, 'equal': True})

    # (b) DeepTable with the leaves, card against CPU, three steps
    spec = pq.configs()['bank_deepfm']
    table = spec['loader']()
    check(isinstance(table, Columns), f'load_bank gave {type(table)}')
    X_train, X_test, y_train, y_test = pq.split(table, spec['target'],
                                                'binary')
    compared = {}
    runs = [(feature_type, feature_type, GBM_PARAMS)
            for feature_type in GBM_FEATURE_TYPES]
    runs.append(('options', 'embedding', dict(GBM_PARAMS, **GBM_FIT_OPTIONS)))
    for name, feature_type, gbm_params in runs:
        fits = {}
        for run, device in (('card', None), ('cpu', 'cpu')):
            reset_launches(kernel_fns)
            dt = DeepTable(gbm_config(
                ModelConfig, spec, gbm_params, gbm_feature_type=feature_type,
                embedding_dropout=0, metrics=pq.TASK_METRICS['binary'],
                earlystopping_patience=3, seed=0,
                home_dir=os.path.join(tmp, 'dt')), device=device)
            t = time.perf_counter()
            _, history = dt.fit(X_train, y_train, epochs=1,
                                batch_size=pq.BATCH, verbose=0,
                                steps_per_epoch=ESTIMATOR_STEPS)
            fit_s = time.perf_counter() - t
            if run == 'card':
                counts = add(read_launches(kernel_fns))
                check(all(counts[k] > 0 for k in ('emb_grad', 'fm_fwd',
                                                  'fm_bwd')),
                      f'gbm_card_vs_cpu: the card fit launched {counts}')
            fits[run] = ({k: v.detach().cpu() for k, v in
                          dt.get_model().module.state_dict().items()},
                         {k: v[0] for k, v in history.history.data.items()},
                         fit_s, len(dt.preprocessor.categorical_columns),
                         counts if run == 'card' else None)
            del dt
        (card_state, card_logs, card_s, n_cat, card_counts), \
            (cpu_state, cpu_logs, cpu_s, _, _) = fits['card'], fits['cpu']
        loss_diff = {k: abs(card_logs[k] - cpu_logs[k])
                     for k in ('loss', 'val_loss')}
        for k, d in loss_diff.items():
            check(d <= 1e-4 * abs(cpu_logs[k]),
                  f'gbm_card_vs_cpu ({name}): card {k} '
                  f'{card_logs[k]} vs CPU {cpu_logs[k]}')
        running = [k for k in cpu_state if '.running_' in k]
        params = check_params(f'gbm_card_vs_cpu ({name})',
                              card_state, cpu_state, loose=running,
                              loose_atol=PARAM_ATOL,
                              loose_rtol=ESTIMATOR_RUNNING_RTOL)
        compared[name] = {
            'gbm_params': gbm_params, 'launches': card_counts,
            'categorical_columns': n_cat, 'card': card_logs, 'cpu': cpu_logs,
            'loss_diff': loss_diff, 'fit_s': {'card': card_s, 'cpu': cpu_s},
            'params_over_atol': {k: v['over_atol'] for k, v in
                                 params.items() if v['over_atol']},
            'params_max_abs_diff': max(v['max_abs_diff']
                                       for v in params.values())}
    emit({'phase': 'gbm_card_vs_cpu', 'row': 'bank_deepfm',
          'steps': ESTIMATOR_STEPS, 'train_rows': len(y_train),
          'feature_types': compared,
          'tolerance': {'loss_rtol': 1e-4, 'param_atol': PARAM_ATOL,
                        'param_outlier_share': PARAM_OUTLIERS}})
    del fits, card_state, cpu_state
    torch.cuda.empty_cache()

    # (c) DeepFM at full criteo width with the leaves, one epoch
    table = load_criteo_synthetic(GBM_CRITEO_ROWS)
    y = np.asarray(table.pop('label'))
    step_s = []
    train_step = DeepModel._train_step

    def timed_step(self, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(out[0]))
        return out
    del gbm_fit_s[:]
    step_loss = []
    reset_launches(kernel_fns)
    dt = DeepTable(stream_csv_config(port, tmp, apply_gbm_features=True,
                                     gbm_params=dict(GBM_PARAMS)),
                   device=None)
    DeepModel._train_step = timed_step
    try:
        t = time.perf_counter()
        _, history = dt.fit(table, y, epochs=1, batch_size=TRAIN_BATCH,
                            verbose=0,
                            validation_split=GBM_CRITEO_VALIDATION)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    finally:
        DeepModel._train_step = train_step
    counts = add(read_launches(kernel_fns))
    logs = {k: list(v) for k, v in history.history.data.items()}
    steps = len(step_s)
    n_val = int(round(GBM_CRITEO_ROWS * GBM_CRITEO_VALIDATION))
    val_batches = -(-n_val // TRAIN_BATCH)
    n_leaf = len(dt.preprocessor.X_transformers['gbm_features'].new_columns)
    fields = len(dt.preprocessor.categorical_columns)
    check(n_leaf == GBM_PARAMS.get('n_estimators', 10) and
          fields == F_CRITEO + n_leaf,
          f'gbm_criteo: {n_leaf} leaf columns, {fields} embedding fields')
    check(all(math.isfinite(v) for vs in logs.values() for v in vs),
          f'gbm_criteo: non-finite logs {logs}')
    check(loss_fell(step_loss), f'gbm_criteo: the step losses {step_loss} '
                                f'did not fall')
    expected = dict.fromkeys(kernel_fns, 0)
    expected.update(emb_grad=steps, fm_bwd=steps,
                    fm_fwd=steps + val_batches)
    check(counts == expected, f'gbm_criteo: {steps} steps and '
                              f'{val_batches} validation batches launched '
                              f'{counts}, expected {expected}')
    train_rows = GBM_CRITEO_ROWS - n_val
    emit({'phase': 'gbm_criteo', 'model': 'DeepFM', 'dtype_policy':
          'float32', 'rows': GBM_CRITEO_ROWS, 'train_rows': train_rows,
          'val_rows': n_val, 'batch_size': TRAIN_BATCH,
          'leaf_columns': n_leaf, 'embedding_fields': fields,
          'gbm_fit_s': gbm_fit_s[0], 'fit_s': fit_s, 'steps': steps,
          'examples_per_s': TRAIN_BATCH * steps / sum(step_s),
          'median_step_ms': 1e3 * sorted(step_s)[steps // 2],
          'step_losses': step_loss, 'logs': logs,
          'val_auc': logs.get('val_auc', [None])[-1], 'launches': counts})
    del dt, table
    torch.cuda.empty_cache()
    return launches


def parquet_phase(torch, port, kernel_fns, tmp):
    """Parquet on the card with pandas, scikit-learn, pyarrow and LightGBM
    blocked (see the module's docstring, 13). Returns the launches of the
    runs on the card."""
    t0 = time.perf_counter()
    launches = blocked_run(_parquet_runs, torch, port, kernel_fns, tmp)
    emit({'phase': 'parquet_wall', 's': time.perf_counter() - t0,
          'launches': {k: v for k, v in launches.items() if v}})
    return launches


def _parquet_runs(torch, port, kernel_fns, tmp):
    from deeptables_torch.data import columns, parquet
    from deeptables_torch.data.streaming import (ChunkedSource,
                                                 StreamingDataLoader,
                                                 fit_preprocessor_streaming)
    from deeptables_torch.models import DeepModel, DeepTable, ModelConfig
    from deeptables_torch.models.hyper_dt import _read_table
    from deeptables_torch.models.preprocessor import DefaultPreprocessor
    from deeptables_torch.tools import parity_quality as pq
    launches = dict.fromkeys(kernel_fns, 0)
    # (a) every fixture read to its digest
    reads = {}
    for name, digest in PARQUET_DIGESTS.items():
        path = ROOT / PARQUET_DIR / name
        t = time.perf_counter()
        cols = columns.read_parquet(str(path))
        read_s = time.perf_counter() - t
        got = columns_digest(pq, cols)
        check(got == digest, f'parquet: {name} reads to {got}, '
                             f'pd.read_parquet to {digest}')
        reads[name] = {'rows': len(cols), 'columns': len(cols.columns),
                       'bytes': path.stat().st_size, 's': read_s,
                       'rows_per_s': len(cols) / read_s}
    bank = [str(ROOT / PARQUET_DIR / name) for name in PARQUET_BANK]
    bank_rows = sum(reads[name]['rows'] for name in PARQUET_BANK)
    bank_s = sum(reads[name]['s'] for name in PARQUET_BANK)
    table = _read_table(bank[0])
    check(isinstance(table, columns.Columns) and
          columns_digest(pq, table) == PARQUET_DIGESTS[PARQUET_BANK[0]],
          '_read_table: the parquet path read otherwise')
    emit({'phase': 'parquet_read', 'files': reads,
          'bank_rows_per_s': bank_rows / bank_s, 'equal': True})

    # (a2) each codec's read rate on the kinds files (best of three), and
    # the native decoders alone on the criteo shards' pages
    codecs = {}
    for codec, name in PARQUET_CODEC_FILES.items():
        path = ROOT / PARQUET_DIR / name
        best = math.inf
        for _ in range(3):
            t = time.perf_counter()
            columns.read_parquet(str(path))
            best = min(best, time.perf_counter() - t)
        codecs[codec] = {'file': name, 'rows': reads[name]['rows'],
                         'bytes': reads[name]['bytes'], 's': best,
                         'rows_per_s': reads[name]['rows'] / best,
                         'mb_per_s': reads[name]['bytes'] / 1e6 / best}
    decoders = {}
    for codec, names in ((6, PARQUET_CRITEO), (7, (PARQUET_CRITEO_VAL,)),
                         (4, (PARQUET_CODEC_FILES['BROTLI'],))):
        pages = [(c, body, size) for name in names
                 for c, body, size in parquet.compressed_pages(
                     str(ROOT / PARQUET_DIR / name)) if c == codec]
        packed = sum(len(body) for _, body, _ in pages)
        unpacked = sum(size for _, _, size in pages)
        best = math.inf
        for _ in range(3):
            t = time.perf_counter()
            for c, body, size in pages:
                parquet.native_decompress(c, body, size)
            best = min(best, time.perf_counter() - t)
        decoders[parquet.CODECS[codec]] = {
            'files': list(names), 'pages': len(pages),
            'compressed_bytes': packed, 'bytes': unpacked, 's': best,
            'out_mb_per_s': unpacked / 1e6 / best,
            'in_mb_per_s': packed / 1e6 / best}
    emit({'phase': 'parquet_codecs', 'read': codecs, 'decoders': decoders,
          'cpu_count': os.cpu_count()})

    # (b) a streaming fit of the bank_deepfm row over the two shards
    spec = pq.configs()['bank_deepfm']
    config = ModelConfig(nets=spec['nets'], metrics=['AUC'],
                         earlystopping_patience=0, seed=0,
                         home_dir=os.path.join(tmp, 'dt'), **spec['conf'])
    source = ChunkedSource(bank, chunk_size=PARQUET_CHUNK)
    check(source.n_rows() == bank_rows, f'parquet: n_rows '
                                        f'{source.n_rows()}')
    t = time.perf_counter()
    pre = fit_preprocessor_streaming(
        DefaultPreprocessor(config, use_cache=False), source,
        spec['target'])
    pre_s = time.perf_counter() - t
    train = StreamingDataLoader(source, pre, spec['target'],
                                batch_size=pq.BATCH, seed=0)
    step_s, step_loss = [], []
    train_step = DeepModel._train_step

    def timed_step(self, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(out[0]))
        return out
    reset_launches(kernel_fns)
    dt = DeepTable(config, preprocessor=pre, device=None)
    DeepModel._train_step = timed_step
    try:
        t = time.perf_counter()
        _, history = dt.fit(train, epochs=1, verbose=0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    finally:
        DeepModel._train_step = train_step
    counts = read_launches(kernel_fns)
    for name, count in counts.items():
        launches[name] += count
    steps = len(step_s)
    check(loss_fell(step_loss), f'parquet: the step losses {step_loss} did '
                                f'not fall')
    check(all(counts[k] == steps for k in ('emb_grad', 'fm_fwd', 'fm_bwd')),
          f'parquet: {steps} steps launched {counts}')
    emit({'phase': 'parquet_fit', 'row': 'bank_deepfm', 'rows': bank_rows,
          'chunk_rows': PARQUET_CHUNK, 'batch_size': pq.BATCH,
          'preprocessor_s': pre_s, 'fit_s': fit_s, 'steps': steps,
          'examples_per_s': pq.BATCH * steps / sum(step_s),
          'step_losses': step_loss,
          'logs': {k: list(v) for k, v in history.history.data.items()},
          'launches': counts})
    del dt
    torch.cuda.empty_cache()
    for name, count in parquet_criteo(torch, port, kernel_fns,
                                      tmp).items():
        launches[name] += count
    return launches


def parquet_criteo(torch, port, kernel_fns, tmp):
    """DeepFM at full criteo width through DeepTable from the ZSTD shards,
    validated on the LZ4_RAW one: the streamed preprocessor, the card
    against the CPU over three steps, then PARQUET_CRITEO_EPOCHS epochs
    with the read's share of each. Returns the launches on the card."""
    from deeptables_torch.data import columns
    from deeptables_torch.data.streaming import (ChunkedSource,
                                                 StreamingDataLoader,
                                                 fit_preprocessor_streaming)
    from deeptables_torch.models import DeepModel, DeepTable
    from deeptables_torch.models.callbacks import LambdaCallback
    from deeptables_torch.models.preprocessor import DefaultPreprocessor
    launches = dict.fromkeys(kernel_fns, 0)
    train_paths = [str(ROOT / PARQUET_DIR / n) for n in PARQUET_CRITEO]
    val_path = str(ROOT / PARQUET_DIR / PARQUET_CRITEO_VAL)
    source = ChunkedSource(train_paths, chunk_size=PARQUET_CRITEO_CHUNK)
    n_train = source.n_rows()
    t = time.perf_counter()
    pre = fit_preprocessor_streaming(
        DefaultPreprocessor(stream_csv_config(port, tmp), use_cache=False),
        source, 'label')
    pre_s = time.perf_counter() - t

    def loaders():
        train = StreamingDataLoader(source, pre, 'label',
                                    batch_size=TRAIN_BATCH,
                                    seed=STREAM_CSV_SEED)
        val = StreamingDataLoader(
            ChunkedSource([val_path], chunk_size=PARQUET_CRITEO_CHUNK), pre,
            'label', batch_size=TRAIN_BATCH, shuffle_in_chunk=False,
            drop_remainder=False)
        return train, val

    # (c) the card against the CPU, three steps from one seed
    fits = {}
    for run, device in (('card', None), ('cpu', 'cpu')):
        reset_launches(kernel_fns)
        dt = DeepTable(stream_csv_config(port, tmp, embedding_dropout=0),
                       preprocessor=pre, device=device)
        train, val = loaders()
        _, history = dt.fit(train, epochs=1, verbose=0,
                            steps_per_epoch=STREAM_COMPARE_STEPS,
                            validation_data=val)
        if run == 'card':
            counts = read_launches(kernel_fns)
            for name, count in counts.items():
                launches[name] += count
            check(all(counts[k] > 0 for k in ('emb_grad', 'fm_fwd',
                                              'fm_bwd')),
                  f'parquet_criteo: the card fit launched {counts}')
        fits[run] = ({k: v.detach().cpu() for k, v in
                      dt.get_model().module.state_dict().items()},
                     {k: v[0] for k, v in history.history.data.items()})
        del dt
    (card_state, card_logs), (cpu_state, cpu_logs) = fits['card'], \
        fits['cpu']
    loss_diff = {k: abs(card_logs[k] - cpu_logs[k])
                 for k in ('loss', 'val_loss')}
    for k, d in loss_diff.items():
        check(d <= 1e-4 * abs(cpu_logs[k]),
              f'parquet_criteo: card {k} {card_logs[k]} vs CPU '
              f'{cpu_logs[k]}')
    params = check_params('parquet_criteo', card_state, cpu_state)
    card_vs_cpu = {
        'steps': STREAM_COMPARE_STEPS, 'card': card_logs, 'cpu': cpu_logs,
        'loss_diff': loss_diff,
        'params_over_atol': {k: v['over_atol'] for k, v in params.items()
                             if v['over_atol']},
        'params_max_abs_diff': max(v['max_abs_diff']
                                   for v in params.values())}
    del fits, card_state, cpu_state
    torch.cuda.empty_cache()

    # (d) the epochs, each step and each read timed
    step_s, step_loss, epochs = [], [], []
    train_step = DeepModel._train_step

    def timed_step(self, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(out[0]))
        return out

    def epoch_begin(epoch, logs=None):
        torch.cuda.synchronize()
        epochs.append({'t': time.perf_counter(), 'first_step': len(step_s),
                       'first_read': len(read_s)})

    def epoch_end(epoch, logs=None):
        torch.cuda.synchronize()
        e = epochs[-1]
        e.update(s=time.perf_counter() - e.pop('t'),
                 steps=len(step_s) - e['first_step'],
                 read_s=sum(read_s[e.pop('first_read'):]))
    train, val = loaders()
    val_batches = -(-ChunkedSource([val_path]).n_rows() // TRAIN_BATCH)
    reset_launches(kernel_fns)
    dt = DeepTable(stream_csv_config(port, tmp), preprocessor=pre,
                   device=None)
    DeepModel._train_step = timed_step
    try:
        with timed_calls(columns, 'read_parquet') as read_s:
            t = time.perf_counter()
            _, history = dt.fit(
                train, epochs=PARQUET_CRITEO_EPOCHS, verbose=0,
                validation_data=val,
                callbacks=[LambdaCallback(on_epoch_begin=epoch_begin,
                                          on_epoch_end=epoch_end)])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t
    finally:
        DeepModel._train_step = train_step
    counts = read_launches(kernel_fns)
    for name, count in counts.items():
        launches[name] += count
    steps = len(step_s)
    logs = {k: list(v) for k, v in history.history.data.items()}
    check(steps == PARQUET_CRITEO_EPOCHS * (n_train // TRAIN_BATCH),
          f'parquet_criteo: {steps} steps')
    check(all(math.isfinite(v) for vs in logs.values() for v in vs),
          f'parquet_criteo: non-finite logs {logs}')
    check(loss_fell(step_loss), f'parquet_criteo: the step losses '
                                f'{step_loss} did not fall')
    expected = dict.fromkeys(kernel_fns, 0)
    expected.update(emb_grad=steps, fm_bwd=steps,
                    fm_fwd=steps + PARQUET_CRITEO_EPOCHS * val_batches)
    check(counts == expected, f'parquet_criteo: {steps} steps and '
                              f'{PARQUET_CRITEO_EPOCHS} validations of '
                              f'{val_batches} batches launched {counts}, '
                              f'expected {expected}')
    emit({'phase': 'parquet_criteo', 'model': 'DeepFM',
          'dtype_policy': 'float32', 'batch_size': TRAIN_BATCH,
          'train_files': list(PARQUET_CRITEO),
          'val_file': PARQUET_CRITEO_VAL, 'train_rows': n_train,
          'chunk_rows': PARQUET_CRITEO_CHUNK, 'preprocessor_s': pre_s,
          'card_vs_cpu': card_vs_cpu,
          'tolerance': {'loss_rtol': 1e-4, 'param_atol': PARAM_ATOL,
                        'param_outlier_share': PARAM_OUTLIERS},
          'epochs': PARQUET_CRITEO_EPOCHS, 'steps': steps, 'fit_s': fit_s,
          'epoch_s': [e['s'] for e in epochs],
          'read_share': [e['read_s'] / e['s'] for e in epochs],
          'examples_per_s': [TRAIN_BATCH * e['steps'] / e['s']
                             for e in epochs],
          'step_examples_per_s': TRAIN_BATCH * steps / sum(step_s),
          'median_step_ms': 1e3 * sorted(step_s)[steps // 2],
          'step_losses': step_loss, 'logs': logs, 'launches': counts,
          'table_rows': int(sum(c.vocabulary_size
                                for c in pre.categorical_columns))})
    del dt
    torch.cuda.empty_cache()
    return launches


def eda_phase():
    """``eda``'s helpers on the bank table as ``Columns`` with pandas,
    scikit-learn, pyarrow, LightGBM and the compression packages blocked
    (see the module's docstring, 14)."""
    return blocked_run(eda_runs)


def eda_runs():
    """(columns_info's digest, reduce_mem_usage's, the top categories, the
    seconds each took) on the bank_deepfm row's table as Columns."""
    from deeptables_torch.data.columns import Columns
    from deeptables_torch.eda import utils as eda
    from deeptables_torch.tools import parity_quality as pq
    table = pq.configs()['bank_deepfm']['loader']()
    check(isinstance(table, Columns), f'load_bank gave {type(table)}')
    t = time.perf_counter()
    info = eda.columns_info(table)
    info_s = time.perf_counter() - t
    check(isinstance(info, Columns) and list(info.index) == table.columns,
          f'columns_info gave {type(info)}')
    t = time.perf_counter()
    reduced = eda.reduce_mem_usage(table.copy(), verbose=False)
    reduce_s = time.perf_counter() - t
    top = eda.top_categories(table, *EDA_TOP).tolist()
    for name in ('Min', 'Mean', 'Max', 'Std'):
        info.set(name, [float(f'{v:.{EDA_DIGITS}g}') for v in info[name]],
                 info.kinds[name])
    return {'rows': len(table), 'columns': len(table.columns),
            'columns_info': pq.table_digest(info),
            'reduce_mem_usage': pq.table_digest(reduced),
            'reduced_kinds': {n: reduced.kinds[n] for n in reduced.columns
                              if reduced.kinds[n] != table.kinds[n]},
            'top_categories': top, 'columns_info_s': info_s,
            'reduce_mem_usage_s': reduce_s}


def explain_phase(torch, port, kernel_fns, tmp):
    """``DeepTablesExplainer`` on the card with pandas, scikit-learn and
    shap blocked (see the module's docstring, 14). Returns the launches of
    the runs on the card."""
    return blocked_run(_explain_runs, torch, port, kernel_fns, tmp,
                       blocked=EXPLAIN_BLOCKED)


def _enumerated_shapley(explainer, x, varying):
    """The Shapley values of v(S) = mean_b f(x_S, b_S') over every
    coalition of the varying features, from the explainer's own f."""
    from itertools import product
    M = len(varying)
    masks = np.array(list(product([0.0, 1.0], repeat=M)))
    y = explainer.predict_fn(explainer.synthetic_rows(x, varying, masks))
    v = y.astype(np.float64).reshape(len(masks), -1).mean(axis=1)
    index = {tuple(m): k for k, m in enumerate(masks)}
    phi = np.zeros(M)
    for k, mask in enumerate(masks):
        s = int(mask.sum())
        for i in np.flatnonzero(mask == 0.0):
            with_i = mask.copy()
            with_i[i] = 1.0
            w = math.factorial(s) * math.factorial(M - s - 1) \
                / math.factorial(M)
            phi[i] += w * (v[index[tuple(with_i)]] - v[k])
    return phi


def _explain_runs(torch, port, kernel_fns, tmp):
    from deeptables_torch.data.columns import Columns
    from deeptables_torch.models import DeepTable, ModelConfig
    from deeptables_torch.tools import parity_quality as pq
    from deeptables_torch.utils import shap
    check(not shap.have_shap, 'explain: shap imports with it blocked')
    wall = time.perf_counter()
    launches = dict.fromkeys(kernel_fns, 0)
    specs = pq.configs()
    out = {}
    for name in ('bank_deepfm', 'glass_multiclass'):
        spec = specs[name]
        task = spec.get('task', 'binary')
        table = spec['loader']()
        check(isinstance(table, Columns), f'explain: {name} gave '
                                          f'{type(table)}, not Columns')
        X_train, X_test, y_train, _ = pq.split(table, spec['target'], task)
        config = ModelConfig(nets=spec['nets'], metrics=pq.TASK_METRICS[task],
                             earlystopping_patience=3, seed=0,
                             home_dir=os.path.join(tmp, name), **spec['conf'])
        dt = DeepTable(config)
        t0 = time.perf_counter()
        dt.fit(X_train, y_train, epochs=pq.EPOCHS, batch_size=pq.BATCH,
               verbose=0)
        fit_s = time.perf_counter() - t0
        path = os.path.join(tmp, f'{name}_saved')
        dt.save(path)
        cpu_dt = DeepTable.load(path, device='cpu')
        rows = X_test.take(np.arange(EXPLAIN_ROWS))

        def explain(model):
            explainer = shap.DeepTablesExplainer(model, X_train)
            predict = explainer.predict_fn
            seen = []

            def recording(matrix):
                seen.append(predict(matrix))
                return seen[-1]
            explainer.predict_fn = recording
            t = time.perf_counter()
            values = explainer.get_shap_values(rows)
            return explainer, values, time.perf_counter() - t, seen

        reset_launches(kernel_fns)
        card, card_values, card_s, card_y = explain(dt)
        counts = read_launches(kernel_fns)
        for kernel, count in counts.items():
            launches[kernel] += count
        cpu, cpu_values, cpu_s, cpu_y = explain(cpu_dt)
        matrix = card._rows(rows)
        fx = card.predict_fn(matrix).astype(np.float64)
        classes = len(np.unique(card.predict_fn(card.background)))
        check(classes > 1, f'explain: {name} predicts one class for the '
                           f'whole background')
        background = card.background.shape[0]
        synthetic = sum(len(y) for y in card_y if len(y) > background)
        flips = sum(int(np.sum(a != b)) for a, b in zip(card_y, cpu_y))
        check(flips <= EXPLAIN_FLIP_SHARE * synthetic,
              f'explain: {name} flips {flips} of {synthetic} predictions')
        efficiency = float(np.max(np.abs(card_values.sum(axis=1)
                                         - (fx - card.expected_value))))
        check(efficiency <= EXPLAIN_ATOL,
              f'explain: {name} efficiency off by {efficiency}')
        card_vs_cpu = float(np.max(np.abs(card_values - cpu_values)))
        if flips == 0:
            check(card_vs_cpu <= EXPLAIN_ATOL,
                  f'explain: {name} card vs CPU {card_vs_cpu}')
        varying = [len(shap.varying_features(x, card.background))
                   for x in matrix]
        result = {'task': task, 'M': varying,
                  'background': background,
                  'nsamples': [min(2 * m + 2 ** 11, 2 ** m - 2)
                               for m in varying],
                  'explained_rows': EXPLAIN_ROWS, 'fit_s': fit_s,
                  'expected_value': card.expected_value,
                  'background_classes': classes,
                  'nonzero_values': [int(np.count_nonzero(v))
                                     for v in card_values],
                  'efficiency_max_abs_err': efficiency,
                  'card_vs_cpu_max_abs_diff': card_vs_cpu,
                  'flipped_predictions': flips,
                  'synthetic_predictions': synthetic,
                  'tolerance': {'atol': EXPLAIN_ATOL,
                                'flip_share': EXPLAIN_FLIP_SHARE},
                  'synthetic_rows_per_s': synthetic / card_s,
                  's_per_row': card_s / EXPLAIN_ROWS,
                  'cpu_s_per_row': cpu_s / EXPLAIN_ROWS,
                  'launches': {k: v for k, v in counts.items() if v}}
        if name == 'glass_multiclass':
            worst = 0.0
            for x, phi in zip(matrix, card_values):
                v = shap.varying_features(x, card.background)
                check(len(v) <= 11, f'explain: glass has {len(v)} features')
                exact = _enumerated_shapley(card, x, v)
                worst = max(worst, float(np.max(np.abs(phi[v] - exact))))
            check(worst <= EXPLAIN_ATOL,
                  f'explain: glass off the enumeration by {worst}')
            result['vs_enumeration_max_abs_err'] = worst
        else:
            check(counts['fm_fwd'] > 0,
                  f'explain: bank_deepfm launched {counts} on the card')
        check(np.count_nonzero(card_values) > 0,
              f'explain: {name} explains every row by zeros')
        out[name] = result
        del dt, cpu_dt, card, cpu
        torch.cuda.empty_cache()
    emit({'phase': 'explain', 'blocked': list(EXPLAIN_BLOCKED),
          'rows': out, 'wall_s': time.perf_counter() - wall})
    return launches


def main():
    import torch
    if sys.argv[1:2] == ['--sharded-rank']:
        return sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available; this script runs '
              'the port on a GPU only.', file=sys.stderr)
        return 1
    if not (ROOT / 'deeptables_torch' / 'csrc').is_dir():
        print(f'chip_smoke: no deeptables_torch package beside {__file__}; '
              'run it from the root of a checkout.', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import deeptables_torch as port
    from deeptables_torch.data import datasets
    from deeptables_torch.data.datasets import load_criteo_synthetic
    from deeptables_torch.ops.kernels import _build
    from deeptables_torch.ops.kernels import cin as cin_module
    from deeptables_torch.ops.kernels import emb_grad as eg_module
    from deeptables_torch.ops.kernels import field_attention as fa_module
    from deeptables_torch.ops.kernels import fm as fm_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, 'TF32 is on')

    smi = card_phase(torch, _build)
    rows = kernel_phase(torch, fm_module)
    vocabs = load_criteo_synthetic(n_rows=1, return_arrays=True)[3]
    bwd_rows = fm_bwd_kernel_phase(torch, fm_module)
    grad_rows = emb_grad_kernel_phase(torch, eg_module, vocabs,
                                      load_criteo_synthetic, datasets)
    cin_rows = cin_kernel_phase(torch, cin_module)
    fa_rows = fa_kernel_phase(torch, fa_module)

    requests = []
    for i, n in enumerate(REQUESTS):
        cat, dense, _, _ = load_criteo_synthetic(n_rows=n, seed=100 + i,
                                                 return_arrays=True)
        requests.append((n, {'cat': cat, 'input_continuous_all': dense}))
    kernel_fns = {'fm_fwd': fm_module.fm, 'fm_bwd': fm_module.fm_backward,
                  'emb_grad': eg_module.emb_grad,
                  'cin_fwd': cin_module.cin_fwd,
                  'cin_bwd': cin_module.cin_bwd,
                  'fa_fwd': fa_module.fa_fwd, 'fa_bwd': fa_module.fa_bwd,
                  'ab_fwd': fa_module.ab_fwd, 'ab_bwd': fa_module.ab_bwd}
    launches = dict.fromkeys(kernel_fns, 0)
    criteo = (vocabs, requests,
              train_data(load_criteo_synthetic, TRAIN_STEPS + 1, seed=7),
              TRAIN_STEPS)
    # AutoInt: the bench's rows, 7 batches to train on and 1 to validate;
    # requests drawn from them
    avazu_arrays, avazu_y, avazu_vocabs = avazu_data(datasets)
    avazu_requests = [
        (n, {'cat': avazu_arrays['cat'][
            np.random.default_rng(100 + i).choice(len(avazu_y), n)]})
        for i, n in enumerate(REQUESTS)]
    avazu = (avazu_vocabs, avazu_requests, (avazu_arrays, avazu_y),
             AVAZU_BATCHES - 1)
    # Wide&Deep+DCN: its own rows, 8 batches to train on and 1 to validate
    adult = (ADULT_VOCABS,
             [(n, adult_data(n, seed=100 + i)[0])
              for i, n in enumerate(REQUESTS)],
             adult_data((TRAIN_STEPS + 1) * TRAIN_BATCH, seed=7),
             TRAIN_STEPS)
    for model_name in ('DeepFM', 'xDeepFM', 'AutoInt', 'AutoInt-fused',
                       WDCN):
        model_vocabs, model_requests, data, steps = \
            avazu if model_name in AUTOINT_MODELS else \
            adult if model_name == WDCN else criteo
        for dtype_policy in ('bfloat16', 'float32'):
            predictor, count = serving_phase(torch, port, kernel_fns,
                                             dtype_policy, model_vocabs,
                                             model_requests, model_name)
            if SERVING_KERNEL[model_name][0]:
                launches[SERVING_KERNEL[model_name][0]] += count
            if dtype_policy == HEADLINE[0]:
                profile_phase(torch, predictor, dict(model_requests)[4096],
                              4096, model_name)
            del predictor
            torch.cuda.empty_cache()
        for dtype_policy in ('bfloat16', 'float32'):
            for name, count in train_phase(torch, port, kernel_fns,
                                           dtype_policy, model_vocabs, data,
                                           model_name, steps).items():
                launches[name] += count
            torch.cuda.empty_cache()

    for name, count in heads_phase(torch, port, kernel_fns, vocabs,
                                   criteo[2], smi).items():
        launches[name] += count
    torch.cuda.empty_cache()

    for name, count in zoo_phase(torch, port, kernel_fns, vocabs,
                                 criteo[2], smi).items():
        launches[name] += count
    torch.cuda.empty_cache()

    for name, count in determinism_phase(torch, port, kernel_fns, determinism_runs(
            (vocabs, criteo[2]), (avazu_vocabs, avazu[2]),
            (ADULT_VOCABS, adult[2]))).items():
        launches[name] += count
    torch.cuda.empty_cache()

    dae_phase(torch, port, load_criteo_synthetic)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dist_') as tmp:
        for phase in (distributed_phase, checkpoint_phase, sharded_phase):
            for name, count in phase(torch, port, kernel_fns, vocabs,
                                     criteo[2], tmp).items():
                launches[name] += count
            torch.cuda.empty_cache()

    from deeptables_torch.data import fast_ingest
    with tempfile.TemporaryDirectory(prefix='chip_smoke_stream_') as tmp:
        paths, write_s = stream_shards(tmp)
        ingest_phase(fast_ingest, paths, write_s)
        for name, count in stream_phase(torch, port, kernel_fns,
                                        paths).items():
            launches[name] += count
        torch.cuda.empty_cache()
        stream_determinism_phase(torch, port, paths)
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix='chip_smoke_estimator_') as tmp:
        for name, count in estimator_phase(torch, port, kernel_fns,
                                           tmp).items():
            launches[name] += count
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix='chip_smoke_stream_csv_') as tmp:
        for name, count in stream_csv_phase(torch, port, kernel_fns, tmp,
                                            load_criteo_synthetic).items():
            launches[name] += count
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix='chip_smoke_gbm_') as tmp:
        for name, count in gbm_phase(torch, port, kernel_fns, tmp).items():
            launches[name] += count
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix='chip_smoke_parquet_') as tmp:
        for name, count in parquet_phase(torch, port, kernel_fns,
                                         tmp).items():
            launches[name] += count
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix='chip_smoke_explain_') as tmp:
        for name, count in explain_phase(torch, port, kernel_fns,
                                         tmp).items():
            launches[name] += count
        torch.cuda.empty_cache()

    got = eda_phase()
    for key, digest in EDA_DIGESTS.items():
        check(got[key] == digest, f'eda: {key} {got[key]}, recorded '
                                  f'{digest}')
    emit(dict(phase='eda', blocked=list(ESTIMATOR_BLOCKED), equal=True,
              **got))

    head = next(r for r in rows if (r['dtype'], r['B'], r['F'],
                                    r['x_offset']) == (*HEADLINE, F_CRITEO, 0))
    fm_fgcnn = {r['dtype']: {k: r[k] for k in (
        'B', 'F', 'design', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
        'bound_by')} for r in rows if r['F'] == F_FGCNN}
    bwd = next(r for r in bwd_rows if (r['dtype'], r['B']) == TRAIN_HEADLINE)
    grad, grad_avazu, grad_adult, grad_stream, grad_shard = (
        next(r for r in grad_rows if (r['ids'], r['B'], r['g_offset'])
             == (ids, TRAIN_HEADLINE[1], 0))
        for ids in ('criteo', 'avazu', 'adult', 'stream', 'shard'))
    cin_keys = ('dtype', 'layer', 'B', 'F', 'G', 'L', 'design', 'max_abs_err',
                'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
                'split_floor_ms', 'simt_bound_ms')
    cin_fgcnn = {name: [{k: r[k] for k in cin_keys}
                        for r in cin_rows[name]
                        if r['layer'] in CIN_FGCNN_LAYERS]
                 for name in cin_rows}
    # float32 at the training batch, every layer, and the CUDA-core row
    cin_f32 = {name: [{k: r[k] for k in cin_keys + ('simt_ms', 'designs')
                       if k in r} for r in cin_rows[name]
                      if r['dtype'] == 'float32'
                      and r['B'] in (TRAIN_BATCH, CIN_SIMT_EDGE[4])]
               for name in cin_rows}
    cin_head = {name: next(r for r in cin_rows[name]
                           if (r['dtype'], r['layer'], r['B']) == CIN_HEADLINE)
                for name in cin_rows}
    train_at = {'B': TRAIN_HEADLINE[1], 'F': F_CRITEO, 'D': D_CRITEO}
    cin_at = dict(zip(('dtype', 'layer', 'B'), CIN_HEADLINE))
    cin_at.update(zip(('F', 'G', 'L'), CIN_LAYERS[CIN_HEADLINE[1]]),
                  D=D_CRITEO)
    emit({'phase': 'profiler', 'incomplete_windows': INCOMPLETE_WINDOWS})
    emit({'kernels': [{
        'name': 'fm_fwd', 'route': 'cuda',
        'source': 'deeptables_torch/csrc/fm.cu',
        'replaces': 'deeptables_tpu/ops/kernels/fm.py:22',
        'launches': launches['fm_fwd'], 'max_abs_err': head['max_abs_err'],
        'ms': head['ms'], 'plain_ms': head['plain_ms'],
        'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
        'library_ms': None,
        'library_note': 'no single PyTorch call computes FM pooling',
        'design': head['design'],
        'at': {'dtype': HEADLINE[0], 'B': HEADLINE[1], 'F': F_CRITEO,
               'D': D_CRITEO},
        'fgcnn': fm_fgcnn}, {
        'name': 'fm_bwd', 'route': 'cuda',
        'source': 'deeptables_torch/csrc/fm.cu',
        'replaces': 'deeptables_tpu/ops/kernels/fm.py:29',
        'launches': launches['fm_bwd'], 'max_abs_err': bwd['max_abs_err'],
        'ms': bwd['ms'], 'plain_ms': bwd['plain_ms'],
        'bound_ms': bwd['bound_ms'], 'bound_by': bwd['bound_by'],
        'library_ms': None,
        'library_note': 'no single PyTorch call computes the FM gradient',
        'at': dict(train_at, dtype=TRAIN_HEADLINE[0])}, {
        'name': 'emb_grad', 'route': 'cuda',
        'source': 'deeptables_torch/csrc/emb_grad.cu',
        'replaces': 'deeptables_tpu/ops/kernels/emb_grad.py:37',
        'launches': launches['emb_grad'], 'max_abs_err': grad['max_abs_err'],
        'ms': grad['ms'], 'plain_ms': grad['plain_ms'],
        'bound_ms': grad['bound_ms'], 'bound_by': grad['bound_by'],
        'library_ms': grad['library_ms'],
        'library_note': 'torch.zeros(V, D).index_add_(0, ids, g)',
        'library_deterministic_ms': grad['library_deterministic_ms'],
        'sort_ms': grad['sort_ms'], 'segment_ms': grad['segment_ms'],
        'fill_ms': grad['fill_ms'],
        'design': grad['design'],
        'at': dict(train_at, ids='criteo', dtype='float32'),
        **{ids: {k: r[k] for k in (
            'B', 'N', 'V', 'design', 'max_abs_err', 'ms', 'plain_ms',
            'library_ms', 'library_deterministic_ms', 'sort_ms',
            'segment_ms', 'fill_ms', 'bound_ms', 'bound_by')}
           for ids, r in (('avazu', grad_avazu), ('adult', grad_adult),
                          ('stream', grad_stream), ('shard', grad_shard))}},
        {
        'name': 'cin_fwd', 'route': 'cuda',
        'source': 'deeptables_torch/csrc/cin.cu',
        'replaces': 'deeptables_tpu/ops/kernels/cin_bwd.py:148',
        'launches': launches['cin_fwd'],
        'max_abs_err': cin_head['cin_fwd']['max_abs_err'],
        'ms': cin_head['cin_fwd']['ms'],
        'plain_ms': cin_head['cin_fwd']['plain_ms'],
        'bound_ms': cin_head['cin_fwd']['bound_ms'],
        'bound_by': cin_head['cin_fwd']['bound_by'],
        'library_ms': cin_head['cin_fwd']['library_ms'],
        'library_note': "torch.einsum('bfd,bgd,lfg->bld', x0, h, w)",
        'design': cin_head['cin_fwd']['design'],
        'simt_bound_ms': cin_head['cin_fwd']['simt_bound_ms'],
        'at': cin_at, 'fgcnn': cin_fgcnn['cin_fwd'],
        'float32': cin_f32['cin_fwd']}, {
        'name': 'cin_bwd', 'route': 'cuda',
        'source': 'deeptables_torch/csrc/cin.cu',
        'replaces': 'deeptables_tpu/ops/kernels/cin_bwd.py:42',
        'launches': launches['cin_bwd'],
        'max_abs_err': cin_head['cin_bwd']['max_abs_err'],
        'ms': cin_head['cin_bwd']['ms'],
        'plain_ms': cin_head['cin_bwd']['plain_ms'],
        'bound_ms': cin_head['cin_bwd']['bound_ms'],
        'bound_by': cin_head['cin_bwd']['bound_by'],
        'library_ms': cin_head['cin_bwd']['library_ms'],
        'library_note': 'autograd: torch.autograd.grad of that einsum '
                        '(several kernels, not one call)',
        'design': cin_head['cin_bwd']['design'],
        'simt_bound_ms': cin_head['cin_bwd']['simt_bound_ms'],
        'at': cin_at, 'fgcnn': cin_fgcnn['cin_bwd'],
        'float32': cin_f32['cin_bwd']}] + [fa_entry(name, fa_rows[name], launches[name])
                          for name in FA_KERNELS]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
