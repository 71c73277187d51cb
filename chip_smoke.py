#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``i2rnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with CUDA

Phases, one line each (any failure exits non-zero):

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels of ``i2rnet_tpu_torch/csrc`` from this checkout;
3. Kernel A (masked MHSA) against its plain PyTorch version on the card,
   f32 (TF32 off) and bf16: ragged (suffix) masks with a fully padded image
   at the W48 (S=1344, C=96) and HRT (S=768, C=78) shapes, no mask and
   scattered (non-suffix) padding at S=1344, and S=130 in 8 heads of dim 3;
4. Kernel B (encoder FFN tail) against its plain version, f32 and bf16, at
   (rows, C, F) = (10752, 96, 192) (W48), (6144, 78, 192) (HRT) and (1003,
   16, 32);
5. the W48-pure-en6 model at full width (seeded random weights, BatchNorm
   statistics calibrated so activations stay O(1)), one f32 forward at
   B=8, N=7 with the kernels on and off;
6. the serving path: requests served through ``serving.Predictor`` in bf16
   (batch 8, person buckets 2/4/7, 480x640 canvas, one image chunked), with
   Kernels A and B's launches counted from zero over that run;
7. timing, for information: eval-protocol persons/s (2 forwards + decode) at
   B=16, N=7, bf16, kernels on and off, a ``torch.profiler`` breakdown of
   the kernels-on step (device busy, idle share, launches, Kernels A's and
   B's ms and launches per step), and each kernel beside its plain version
   and its bound at the main-path shapes, as device time per call
   (``plain_kernel_sdpa``) with the event-timed ms beside them; Kernel A
   beside SDPA too;
8. Kernel C (training MHSA with attention-weight dropout) forward and
   backward (dQ, dK, dV) against its plain version, f32 and bf16, at
   (B, S, C, H) = (8, 1344, 96, 1) with ragged, scattered and no masks, the
   HRT training shape (12, 384, 78, 1) and a small multi-head shape (2, 130,
   24, 8), rate 0.1 in bits and in seed mode (the plain version draws the
   same Philox bits), a fully padded image finite; the seed-mode keep
   fraction printed;
9. Kernel D (training FFN tail, both dropouts) forward and backward (dx and
   the eight parameter gradients) likewise at phase 4's shapes, and two bf16
   backward calls at the W48 shape bit-equal;
10. the training path: W48-pure-en6 at full width, seeded as the JAX package
    initialises it, bf16, B=8 images x N=7 slots with ragged person counts,
    trained through ``core.trainer.train_loop`` on one repeated synthetic raw
    batch (numpy, ``data.synthetic``) for 8 steps with Kernels C and D: the
    losses finite and falling, each training kernel launched in this run
    (counts from zero), the checkpoint written and restored by AUTO_RESUME;
    then one f32 step at dropout 0 with the kernels on vs off (loss and every
    gradient within the stated bounds);
11. timing, for information: the train step (ms, persons/s) kernels on and
    off, a ``torch.profiler`` breakdown of the kernels-on step (device busy,
    idle share, launches, top kernels, Kernel D's forward and backward ms and
    launches per step), and each training kernel beside its plain version
    at the main-path shapes, bf16, seed mode, as device time per call (a
    backward timed alone, on a graph recorded once; Kernel C's forward and
    backward beside SDPA's too), and the plain forwards again handed their
    bits;
12-14. Kernels E (HRFormer window-attention half block), F (its MlpDWBN half
    block) and G (MlpDWBN alone) against their plain versions, f32 and bf16,
    at HRFormer-B's four branch maps of a 256x192 input (P = 32 persons),
    384x288's branch 0 and an odd small map; two f32 calls of G at branch 0
    bit-equal;
15. the HRFormer-B I²R-Net (``hrt_interformer``) at full width, seeded and
    calibrated as phase 5: one f32 forward at B=8, N=4 with ragged counts,
    kernels on (E, F, A, B) vs off; the same on Kernel G's route
    (FUSED_MLP_EVAL on, FUSED_BLOCK_EVAL off); requests served through
    ``Predictor`` in bf16 (buckets 2/4/7), E and F launched in that run;
16. timing, for information: its eval protocol at B=8, N=4, bf16, kernels on
    and off, a ``torch.profiler`` breakdown of the kernels-on step (E's and
    F's ms and calls per step among them); the same step on Kernel G's route
    with G's ms and calls per step; and E, F and G beside their plain
    versions at each branch map, by CUDA events, with their device time per
    call and launch plans beside;
17. kernel 9 (the HRFormer window-attention half block for training)
    forward and backward (dx and the ten parameter gradients) against its
    plain version, f32 and bf16, at HRFormer-B's four branch maps (P = 24
    persons) and an odd small map, droppath scales including zeros;
18. the HRFormer-B I²R-Net's training path: ``train_loop`` on
    ``hrt_interformer`` at full width, seeded as the JAX package initialises
    it, bf16, B=12 images x N=2 slots (the recipe's batch and MAX_PATCH)
    with ragged counts and an empty image, 8 steps on one repeated synthetic
    raw batch: losses finite and falling, kernel 9 and Kernels C and D
    launched in this run (counts from zero), the checkpoint resumed; then
    one f32 step at dropout 0 and drop path 0 with the kernels on vs off;
19. timing, for information: that train step kernels on and off, a
    ``torch.profiler`` breakdown of the kernels-on step with its peak
    memory, and kernel 9's forward and backward beside their plain versions
    at each branch map, the forward's device time per call and plan beside;
20. kernel 7 (the HRFormer block in one cooperative launch) against its
    plain version at every map of phases 12-14, f32 and bf16, and against
    Kernel E then Kernel F on the same input (bit-equal when both sum in the
    same order, as they share their bodies), with the grid it launches;
21. the HRFormer-B I²R-Net built with ``FUSED_BLOCK_EVAL_ONEPASS`` on, at full
    width: one f32 forward at B=8, N=4 kernels on (kernel 7, A, B) vs off;
    requests served through ``Predictor`` in bf16 at 256x192 (buckets 2/4/7)
    and at 384x288 (``hrt_interformer((288, 384))``, batch 4, bucket 2: its
    96x72 branch-0 map too); kernel 7 launched and E, F, G not, in each run;
22. timing, for information: the eval protocol at B=8, N=4, bf16 on the
    one-pass route, on E + F and kernels off, a ``torch.profiler`` breakdown
    of the one-pass step, and kernel 7 beside its plain version, E then F and
    its bound at each branch map, with kernel 7's and E then F's device time
    per call beside;
23. evaluation on the COCO-format fixture (``i2rnet_tpu_torch/data/fixtures/
    coco_synth``, 32 images, up to 7 persons each) with W48-pure-en6 at full
    width, B=16: every JPEG decoded by ``data/jpeg.py`` to the bytes
    ``cv2.imread`` gives (SHA-256 against ``decoded.sha256``); ``validate``
    with the GT-heatmap oracle (targets rendered and DARK-decoded on the
    card) against the JAX validate's AP stats (``expected.json``, within
    1e-3, AP > 0.95, the same results per image); ``validate`` with the
    seeded, calibrated model in bf16, kernels on then off: Kernels A and B
    launched 12 times a batch (6 layers, 2 forwards) with them on and never
    with them off, the same result entries, keypoints within phase 6's bound;
    and, for information, the time split per batch (JPEG decode,
    ``make_raw_batch``, device time by CUDA events, ``evaluate``) and
    persons/s including host IO; then ``validate`` with the seeded, calibrated
    TPH I²R-Net (``tph_interformer``) likewise, A and B launched 20 times a
    batch (6 intra + 4 inter layers, 2 forwards);
24. Kernels A and B at the TransPose-H intra encoder's shapes against their
    plain versions, f32 and bf16: A over [P, S, 96] with no key mask at P=64,
    S=3072 (64x48 tokens), at a ragged S=3000, and at the recipe's test batch
    P=448 held per 64-person chunk; B at R=64*3072 rows; then, bf16, each
    shape's device time per call beside its plain version's, its bound, and
    for A one SDPA call without a mask;
25. the TPH I²R-Net at full width (``tph_interformer``, 256x192, seeded and
    calibrated as phase 5): one f32 forward at B=2, N=4 with ragged counts,
    kernels on vs off within phase 15's bound, A and B launched 10 times each
    (6 intra + 4 inter layers) and nothing else; requests served through
    ``Predictor`` in bf16 (buckets 2/4), A and B launched 20 times a serve
    call (the flip test's second forward);
26. timing, for information: the TPH eval protocol at B=16, N=4, bf16,
    kernels on and off in turns, and a ``torch.profiler`` breakdown of the
    kernels-on step with Kernels A's and B's ms and launches per step split
    between the intra and the inter encoder;
27. Kernels C and D at the TPH training shapes against their plain
    versions, f32 and bf16, bits and seed mode, forward and backward: C over
    [P, 3072, 96] with no key mask at P=16 (the COCO recipe's 4 x 4) and
    P=24 (the CrowdPose and OCHuman recipes' 4 x 6 and 8 x 3), q scaled so
    outputs are of order 1, held per 8-person chunk, and at the inter shape
    [4, 768, 96] with a ragged person mask; the plain version without its
    last key tile breaks the bound at each; the seed-mode keep fraction over
    a whole [16, 3072, 3072] draw; D at R = 16 * 3072 and 24 * 3072 rows;
    then, bf16 seed mode, C at P=16 and D at R=49152 as device time per call
    beside their plain versions, their bounds and, for C, SDPA with dropout
    0.1, forward and backward;
28. the TPH I²R-Net's training path: ``train_loop`` on ``tph_interformer``
    at full width and depth, seeded as the JAX package initialises it,
    bf16, B=4 images x N=4 slots with ragged counts, 8 steps on one repeated
    synthetic raw batch: losses finite and falling, Kernels C and D launched
    by both encoders (each launch labelled by the encoder that made it, its
    forward by module hooks, its backward by tensor hooks), the checkpoint
    resumed; then one f32 step at dropout 0 with the kernels on vs off, each
    route twice, every gradient within TPH_GRAD_BOUND;
29. timing, for information: the TPH train step kernels on and off, its
    peak memory and a ``torch.profiler`` breakdown of the kernels-on step,
    with C's and D's forward and backward ms and launches per step split
    between the intra and the inter encoder;
30. the training data path on the training fixtures of the COCO, CrowdPose
    and OCHuman W48 recipes (``i2rnet_tpu_torch/data/fixtures``, written by
    ``tests/torch_fixture.py``): every training JPEG decoded to cv2.imread's
    bytes (one wider than the recipe's 640x640 raster, so it is pre-scaled);
    the first batches of epoch 0 as ``train_loop`` composes them at WORKERS
    0 equal to the JAX package's (``expected_train.json``: the items, the
    SHA-256 of images, person_valid and joints_vis, the float arrays within
    RECORD_ATOL); ``device_batch`` of a rotated, flipped batch on the card
    against the same call on the CPU (crops within CROP_ATOL); for
    information, host images/s of the batch assembly at WORKERS 0 and 8;
31. W48 COCO trained from those JPEGs by the dataset-driven ``train_loop``
    (bf16, kernels on, WORKERS 8, the recipe's B=8 x N=7) for one epoch and
    validated on the fixture's val2017 at its end: finite losses, Kernels C
    and D launched in training and A and B 12 times a validation batch
    (counts from zero over the run), the checkpoint resumed bit for bit; then
    two more epochs, with the step's wait on the prefetch queue beside the
    step's time;
32. the CrowdPose W48 recipe (14 joints, B=32 x N=5): Kernels C and D against
    their plain versions at [32, 960, 96] with a ragged person mask and
    R=30720 rows, f32 and bf16, bits and seed mode, within phases 8-9's
    tolerances, then timed beside SDPA with dropout 0.1; A and B likewise at
    the test batch's [64, 960, 96] and R=61440; ``train_loop`` from the
    fixture for TRAIN_EPOCHS one-step epochs at the recipe's batch (halved,
    and the cut logged, where the card runs out of memory), validated at the
    end, the launches counted from zero, peak memory and step time;
    ``validate`` on the test split with the GT oracle against the JAX stats
    (AP and AP easy, medium and hard) and with the seeded model kernels on
    vs off within phase 6's bound;
33. the OCHuman W48 recipe (``USE_MULTI_POS`` false: no position
    embedding, B=32 x N=3) likewise at [32, 576, 96], R=18432 and the test
    batch's [128, 576, 96];
34. the ten recipes under ``experiments/`` read by the port's own YAML
    reader and config merge (``config/config.py::load_config``, no PyYAML
    here) as the port config the JAX reader gives
    (``i2rnet_tpu_torch/config/expected_recipes.json``);
35-39. the five recipes no earlier phase ran, each from its YAML through
    ``tools.train.main`` and ``tools.test.main`` at full width and depth:
    the CrowdPose and OCHuman TPH recipes, the CrowdPose and OCHuman HRT
    recipes and COCO HRT at 384x288, with ``DATASET.ROOT`` at a fixture,
    ``MODEL.SINGLE_MODEL`` a first stage of another seed written by the
    phase (loaded into the first stage bit for bit), one epoch of at most
    RECIPE_STEPS steps, and ``TEST.MODEL_FILE`` the run's final state:
    finite losses, each step's ms, peak memory, AP, and the launches counted
    from zero (TPH: A, B, C, D; HRT: C and D in training, E and F in the
    test, kernel 9 only under ``TPU.FUSED_BLOCK_TRAIN True``, which the
    384x288 run sets). Before its recipe, each new kernel shape is held
    against its plain version and timed: A and B at the CrowdPose TPH test
    batch [96, 3072, 96] and R=96*3072 (phase 35), E and F and kernel 9 at
    P=16 on the HRT maps (phase 37, which also times one step on modules
    and on kernel 9 in turns), kernel 9 forward and backward at P=8 on the
    four 384x288 branch maps (phase 39), and in each HRT phase (37-39) C
    and D at its inter encoder's training shapes: C over [4, 768, 78],
    [8, 576, 78] and [4, 864, 78] (a ragged last key tile) with a person
    mask, f32 and bf16, the plain version without the last key tile
    breaking the bound, and D over their 3072, 4608 and 3456 rows;
40. MPII (``i2rnet_tpu_torch/data/fixtures/mpii_synth``): ``validate`` with
    the GT-heatmap oracle against the JAX PCKh table, and a seeded 16-joint
    W48 in bf16 kernels on vs off within phase 6's bound, A and B launched;
41. the serving artifacts: the COCO W48, TPH and HRT recipes' models,
    seeded and calibrated as phase 5, saved as checkpoints; five artifacts
    exported by ``tools.export`` from them, each in a process of its own, all
    at once (seconds and MB each): W48 (bf16, kernels on, buckets 2/4/7,
    B=8, 480x640 canvas), W48 ``--no-kernels`` (bucket 7), W48 at phase 42's
    geometry, TPH (B=16, bucket 4) and HRT on E + F (B=8, bucket 4); the W48
    artifact served by ``probes/serve_artifact.py`` in a fresh process that
    imports only the port (phase 6's requests, 1-9 boxes an image, every
    bucket hit) within phase 6's bound of the in-process ``Predictor``, A
    and B 12 launches a serve call and no other kernel, no model module
    imported, a request refused with the kernel library unavailable; while
    it loads, this process loads the other four; the ``--no-kernels``
    artifact launches no kernel and serves within the bound of the model
    served in process with its kernels off (bucket 7);
42. for information: the W48 artifact and the in-process ``Predictor`` in
    turns at B=16, bucket 7, 256x320 (host clock, images/s and persons/s,
    the device's busy time and idle share from a profile); Kernel A's host
    cost a call through the registered op and launched directly;
43. for information: ``MicroBatcher`` in the fresh process over the phase-41
    artifact, 100 single-image requests of 1-7 boxes offered as a Poisson
    stream at half phase 42's rate (max_delay_ms 5): latency p50 and p99,
    requests/s and persons/s; each result within phase 6's bound of the
    request served alone;
44. ``hub.i2rnet_w48_pure`` with phase 41's checkpoint serving as phase 41's
    model; the TPH and HRT artifacts within phase 6's bound (phases 15 and 25
    serve under it) of their models served in process, launching a serve
    call A and B 20 times (TPH), E and F 88 and A and B 4 times (HRT) and
    nothing else;
45. ``DEVICE.REMAT``: one bf16 training step (dropout and drop path on) of
    the W48 (B=8 x N=7), TPH (B=4 x N=4) and HRT (B=12 x N=2, kernel 9's
    route) models, from one seeded state, under ``none``, ``layers``,
    ``dots`` and ``full``, with ``torch.use_deterministic_algorithms(True)``:
    the loss, every gradient, the post-Adam parameters and the BatchNorm
    statistics of each mode bit-equal to ``none``'s; Kernels C and D and
    kernel 9 launched once a layer or block forward and backward with REMAT
    off, and their forwards twice under each mode (the backward recomputes
    every region); for information each mode's peak memory and step ms (a
    second step, host clock);
46. ``TEST.DETAIL_EVAL`` and ``DEBUG.DEBUG``: ``validate`` with the GT
    oracle on ``coco_synth`` and ``ochuman_synth`` with the crowd report on,
    its levels and stats those of the fixture's ``expected_detail.json`` and
    its AP that of ``expected.json``, ``res_eval.txt`` written; the seeded
    W48 in bf16 with both options on against both off: the same results
    file, AP and A and B launches, the first batch's three debug images
    written; one ``train_loop`` step with ``DEBUG.DEBUG`` on writing its
    three images;
47. the analysis tools: ``tools.compute_flops`` of the COCO W48 preset at
    B=8 x N=7 (GFLOPs per person, the hand kernels counted through their
    ``i2r::`` ops, beside the forward's ms), ``tools.visualize`` on one
    fixture image from the W48 recipe's YAML (six layers' weights recorded
    through Kernel A's plain version, Kernel B launched), and
    ``tools.profile`` of two W48 train steps (a Chrome trace that holds
    Kernels C and D);
48. data parallelism (``parallel/dist.py``): one f32 W48 step (dropout 0,
    kernels on) over two ``gloo`` ranks, each a process on this card (NCCL
    refuses two ranks on one GPU) with B=4 x N=7 of phase 10's global
    batch, against the step on the global batch in a process without a
    group: the global loss, every summed gradient within phase 10's f32
    bounds, the parameters after Adam within 2.2 lr, the BatchNorm
    statistics (a masked sync-BN), C and D launched 6 + 6 a rank, the two
    ranks bit-equal;
49. one bf16 W48 step with dropout on in an ``nccl`` group of world size
    1, bit-equal to the step without a group (deterministic algorithms);
50. ``validate`` over two ``gloo`` ranks on ``coco_synth`` at phase 23's
    global batch: the GT oracle's stats equal to one process's, the seeded
    W48 in f32 within phase 6's bound of one process's results, A and B
    12 launches a global batch on each rank, the same results file on
    every rank;
51. ``Predictor.call_sharded`` over [cuda:0, cuda:0] (an f32 W48 batch of
    8 images x 7 slots, half on each replica) within phase 6's bound of the
    whole call, A and B 12 launches a replica; for information the W48
    forward on the whole batch against its halves in f32 and bf16, kernels
    on and off (in bf16 the batch size alone moves the random model's
    heatmaps by a tenth of their largest value, so phases 50-51 hold f32);
52. the end-to-end models ``interformer_e2e`` and ``interformer_e2e_new``
    at full width (``presets.e2e_w48``, seeded and calibrated as phase 5):
    an f32 forward at B=8 x N=4 kernels on vs off (A and B 6 launches each:
    4 intra layers over 3072 tokens a person, 2 inter), one f32 training
    step at B=4 x N=4, dropout 0, kernels on vs off (C and D 6 + 6), requests
    served through ``Predictor`` in bf16 (buckets 2/4); for information the
    bf16 eval protocol and train step of ``interformer_e2e_new`` with
    profiles; then A and B at the e2e eval batch's intra shape (P=32, S=3072;
    R=32*3072) against their plain versions and timed as phase 24 times
    them.

Every ``torch.profiler`` breakdown counts all device events but user
annotations and step markers, and logs how many of them carry a ``#`` in
their name (torch's lambda-named elementwise and copy kernels, which an
earlier filter left out of the launches, busy time and idle share).

Then a JSON line of the kernels (each with its main-path launches, its error
against the plain version, its time, the plain version's, the bound the card
sets for the same work and, where one PyTorch call computes the same
function, that call's time; device time per call for Kernels A-E and
kernel 9, their plain versions and the SDPA calls, CUDA events for the
rest; for C and D also ``tph``: the same fields at phase 27's P=16 shape and
phase 28's launches by encoder; for A-D ``coco_jpeg``: phase 31's launches,
and ``crowdpose`` and ``ochuman``: the same fields at phases 32-33's shapes
with the launches of their ``train_loop``; ``crowdpose_tph_test`` for A and
B, ``crowdpose_hrt_p16`` for E, F and kernel 9, ``coco_hrt_288`` for kernel 9
and ``{crowdpose_hrt,ochuman_hrt,coco_hrt_288}_inter`` for C and D: the
fields at phases 35-39's new shapes; for every kernel ``recipes``: its
launches in each recipe run's training and test, and MPII's ``validate``
for A and B; ``served_artifact_{w48,tph,hrt}``: its launches in phases 41's
and 44's served runs; for C, D and kernel 9 ``remat``: its launches in
phase 45's step of each model under each REMAT value; for A-D ``ddp``:
its launches on a rank of each run of phases 48-50 and in phase 51's sharded
call (both replicas), and ``e2e``: its
launches in each e2e model's forward (A, B) or step (C, D) of phase 52 and
the fields at the e2e shapes, A and B at P=32 x 3072 from phase 52, C and D
at the training step's intra shape P=16 x 3072 from phase 27, which times
that shape), and last ``{"ok": true, "device": {...}}``.
TF32 is off throughout, so the float32 parts (crops, decode) stay float32.
Training writes its checkpoints, and validation its results JSONs, under
``output/chip_smoke/`` of this checkout.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import hashlib
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from i2rnet_tpu_torch import hub, presets
from i2rnet_tpu_torch.config.config import load_config, to_port
from i2rnet_tpu_torch.core import trainer as trainer_module
from i2rnet_tpu_torch.core.pretrained import NOT_LOADED
from i2rnet_tpu_torch.core.train import compute_losses, make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.trainer import epoch_batches, raw_to_device, train_loop
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.data.jpeg import imread
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.data.train_record import compare_records, train_records
from i2rnet_tpu_torch.models.encoder import INTRA_OFFSET_BASE, TransformerEncoder
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.layers import MaskedBatchNorm, max_pool_3x3_s2
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.ops.cuda import KERNELS, build, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.dropout import threshold
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import _layer_norm, encoder_ffn_fused, encoder_ffn_torch
from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import (encoder_ffn_train_fused,
                                                         encoder_ffn_train_torch, ffn_bits)
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (attn_plan, full_block_fused,
                                                      full_block_torch, mlp_block_fused,
                                                      mlp_block_torch, pack_attn,
                                                      window_attn_block_fused,
                                                      window_attn_block_torch)
from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (attn_bwd_plan,
                                                            window_attn_block_train_fused,
                                                            window_attn_block_train_torch)
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused, masked_mhsa_torch
from i2rnet_tpu_torch.ops.cuda.mhsa_train import (attention_bits, masked_mhsa_train_fused,
                                                  masked_mhsa_train_torch)
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import (DTYPE_CODES, device_plan, mlp32_plan,
                                                mlp_dwbn_fused, mlp_dwbn_torch, mlp_plan,
                                                pack_mlp, pack_mlp32, sm_count)
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.parallel import dist
from i2rnet_tpu_torch.probes.ddp_rank import case_step, run_ranks
from i2rnet_tpu_torch.registry import get_dataset_class
from i2rnet_tpu_torch.serving import Predictor, load_predictor, make_eval_fn
from i2rnet_tpu_torch.tools import compute_flops, profile as profile_tool, visualize
from i2rnet_tpu_torch.tools.test import main as test_main
from i2rnet_tpu_torch.tools.train import main as train_main
from i2rnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

T_START = time.perf_counter()
SEED = 0
DEV = "cuda:0"
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # (atol, rtol)
HEAT_REL_BOUND = 1e-3
SOURCES = {
    "masked_mhsa": ("i2rnet_tpu_torch/csrc/mhsa.cu", "i2rnet_tpu/ops/pallas/mhsa.py:51"),
    "encoder_ffn": ("i2rnet_tpu_torch/csrc/encoder_ffn.cu",
                    "i2rnet_tpu/ops/pallas/encoder_ffn.py:103"),
    "mhsa_train_fwd": ("i2rnet_tpu_torch/csrc/mhsa_train.cu",
                       "i2rnet_tpu/ops/pallas/mhsa_train.py:182"),
    "mhsa_train_bwd": ("i2rnet_tpu_torch/csrc/mhsa_train.cu",
                       "i2rnet_tpu/ops/pallas/mhsa_train.py:207"),
    "encoder_ffn_train_fwd": ("i2rnet_tpu_torch/csrc/encoder_ffn_train.cu",
                              "i2rnet_tpu/ops/pallas/encoder_ffn_train.py:249"),
    "encoder_ffn_train_bwd": ("i2rnet_tpu_torch/csrc/encoder_ffn_train.cu",
                              "i2rnet_tpu/ops/pallas/encoder_ffn_train.py:280"),
    "window_attn_block": ("i2rnet_tpu_torch/csrc/window_attn_block.cu",
                          "i2rnet_tpu/ops/pallas/hrformer_block.py:279"),
    "mlp_block": ("i2rnet_tpu_torch/csrc/mlp_dwbn.cu", "i2rnet_tpu/ops/pallas/hrformer_block.py:361"),
    "mlp_dwbn": ("i2rnet_tpu_torch/csrc/mlp_dwbn.cu", "i2rnet_tpu/ops/pallas/mlp_dwbn.py:99"),
    "window_attn_block_train_fwd": ("i2rnet_tpu_torch/csrc/window_attn_block.cu",
                                    "i2rnet_tpu/ops/pallas/hrformer_block_train.py:355"),
    "window_attn_block_train_bwd": ("i2rnet_tpu_torch/csrc/window_attn_block_train.cu",
                                    "i2rnet_tpu/ops/pallas/hrformer_block_train.py:411"),
    "full_block": ("i2rnet_tpu_torch/csrc/full_block.cu",
                   "i2rnet_tpu/ops/pallas/hrformer_block.py:317"),
}
EVAL_KERNELS = ("masked_mhsa", "encoder_ffn")
HRT_KERNELS = ("window_attn_block", "mlp_block", "masked_mhsa", "encoder_ffn")
#: the one-pass route's eval kernels, and the block kernels it must not launch
ONEPASS_KERNELS = ("full_block", "masked_mhsa", "encoder_ffn")
NOT_ONEPASS = ("window_attn_block", "mlp_block", "mlp_dwbn")
#: persons per image of the HRT model's f32 checks: B=8 images x N=4 slots
HRT_COUNTS = [4, 3, 1, 2, 4, 0, 2, 3]
#: HRFormer-B's branch maps (P, H, W, C, heads): 256x192's four at P=32
#: persons, then 384x288's branch 0 and an odd small map
HRT_SHAPES = [(32, 64, 48, 78, 2), (32, 32, 24, 156, 4), (32, 16, 12, 312, 8),
              (32, 8, 6, 624, 16), (8, 96, 72, 78, 2), (3, 7, 6, 24, 3)]
#: Kernels E, F, G vs plain: max |err| / max |ref|. f32: summation order;
#: bf16: the same rounding points, so a value differs only where two f32
#: sums straddle a bf16 boundary (one bf16 step, 2^-8 of the value)
HRT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: the H100 SXM's published dense peaks (data sheet) for the bound: bytes/s
#: of HBM3 and operations/s by input type (f32 outside the tensor cores);
#: TF32 on the tensor cores, which does f32-accurate products in three passes
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
#: device time per call (``device_ms``): the wait, in clock cycles (about
#: 20 ms at the H100's 1.98 GHz), that holds the card while the host queues
#: the timed calls
QUEUE_CYCLES = 40_000_000
#: profiles taken again where ``torch.profiler`` came back without device work
PROFILE_TRIES = 3
#: train steps under the profiler in ``step_timing``
PROFILED_STEPS = 2
TRAIN_KERNELS = ("mhsa_train_fwd", "mhsa_train_bwd", "encoder_ffn_train_fwd",
                 "encoder_ffn_train_bwd")
OUT_DIR = Path(__file__).resolve().parent / "output" / "chip_smoke"
ROOT = Path(__file__).resolve().parent
#: persons per image of the training batch: B=8 images x N=7 slots, ragged
TRAIN_COUNTS = [7, 5, 3, 1, 7, 2, 6, 4]
TRAIN_STEPS = 8
#: f32 training step, kernels on vs off: loss relative, and each gradient's
#: max |difference| over its max |value| (two f32 summation orders in the
#: encoder, amplified by the BatchNorms after it)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-4, 1e-3
#: kernel 9's maps (P, H, W, C, heads): 256x192's four branches at P = 24
#: persons (B=12 x N=2), then an odd small map
HRT_TRAIN_SHAPES = [(24, 64, 48, 78, 2), (24, 32, 24, 156, 4), (24, 16, 12, 312, 8),
                    (24, 8, 6, 624, 16), (3, 7, 6, 24, 3)]
HRT_TRAIN_NAMES = ("x", "ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
#: persons per image of the HRT training batch: B=12 images x N=2 slots
HRT_TRAIN_COUNTS = [2, 1, 2, 0, 2, 2, 1, 2, 2, 1, 2, 2]
HRT_TRAIN_KERNELS = ("window_attn_block_train_fwd", "window_attn_block_train_bwd") + TRAIN_KERNELS
#: the f32 HRT training step kernels on vs off: each gradient's max |diff| over
#: its max |value| and its relative L2 error, and the relative L2 error of all
#: gradients together. A ReLU input of the fusions within f32 noise of zero
#: takes either branch: one such element moves a fusion's weight gradients by
#: 16% in the tiny CPU model, and at full width the two routes differ by 2.0e-2
#: (max), 4.7e-3 (L2) at the worst leaf and 1.2e-3 overall, where two runs of
#: one route agree within 5e-5 (measured on the card; the phase prints both);
#: kernel 9 itself is held at 1e-4 in phase 17
HRT_GRAD_BOUND = {"max": 5e-2, "l2": 1e-2, "all_l2": 5e-3}
#: HRT gradients that are 0 in exact arithmetic, held against their module's
#: weight gradient: biases ahead of a BatchNorm's mean subtraction (MlpDWBN's
#: convs, LN2, the fusion's depthwise BN) and the key bias (softmax ignores a
#: bias shared by every key)
#: kernel 9's bf16 backward kernels in the phase 19 profile: (label, name substrings)
KERNEL9_BWD = (("pass 1", ("attn_bwd_mma_kernel",)), ("pass 2", ("dt2_mma_kernel",)),
               ("K2", ("ln_bwd_kernel",)), ("weight gradients", ("dw_mma_kernel", "bwd_sum_kernel")))
#: Kernels B and D's bf16 kernels in the phase 7 and 11 profiles (name substrings)
KERNEL_B = ("ffn::fwd_kernel",)
KERNEL_D = (("Kernel D forward", ("ffn::fwd_kernel",)),
            ("Kernel D backward", ("ffn::bwd_rows_kernel", "ffn::dw_kernel", "ffn::bwd_sum_kernel")))
#: the COCO-format fixture validated in phase 23 (``tests/torch_fixture.py``)
FIXTURE = Path(__file__).resolve().parent / "i2rnet_tpu_torch" / "data" / "fixtures" / "coco_synth"
#: the oracle's AP stats against the JAX validate's (``expected.json``), and its least AP
ORACLE_TOL, ORACLE_MIN_AP = 1e-3, 0.95
VAL_BATCH = 16
#: persons per image of the TPH model's f32 check: B=2 images x N=4 slots
TPH_COUNTS = [4, 2]
#: Kernels A and B at the TPH intra encoder's shapes (phase 24): A over
#: [P, S, 96] with no key mask at P = 64 persons (the eval protocol's B=16 x
#: N=4) of S = 3072 tokens (64x48), at a ragged S = 3000, and at the recipe's
#: test batch P = 448 (64 images x 7 persons), held against its plain version
#: per chunk of TPH_CHUNK persons; B over R = 64 * 3072 rows of C = 96, F = 192
TPH_ATTN = [(64, 3072), (64, 3000), (448, 3072)]
TPH_CHUNK = 64
#: deviation of the TPH checks' logits q.k/sqrt(C): a softmax peaked on a few
#: of S keys, so outputs are of order |v| and every key tile moves some rows
TPH_PEAK = 4.0
#: keys per tile of Kernel A (``csrc/attn_mma.cuh::kTile``, ``mhsa.cu::kBlockK``)
KEY_TILE = 64
TPH_FFN = (64 * 3072, 96, 192)
#: Kernels A's and B's launches in one TPH forward: 6 intra + 4 inter layers
TPH_LAUNCHES = 10
#: the TPH intra encoder's tokens a person (64x48 at 256x192)
TPH_TOKENS = 3072
#: Kernel C at the TPH training shapes (phase 27), [P, S, 96]: the intra
#: encoder's, unmasked, at the COCO recipe's P = 16 (4 images x 4 slots) and
#: the CrowdPose and OCHuman recipes' P = 24 (4 x 6, 8 x 3); the inter
#: encoder's 4 images of 4 slots x 192 tokens, with its person mask of
#: TPH_TRAIN_COUNTS persons an image
TPH_TRAIN_ATTN = [(16, TPH_TOKENS), (24, TPH_TOKENS), (4, 768)]
TPH_TRAIN_COUNTS = [4, 2, 3, 1]
#: persons a chunk of Kernel C's plain version ([P, S, S] logits, bits and
#: Philox rounds in int64)
TPH_TRAIN_CHUNK = 8
#: Kernel D at the TPH intra encoder's rows, P = 16 and 24 persons
TPH_TRAIN_FFN = (16 * TPH_TOKENS, 24 * TPH_TOKENS)
#: the seed-mode key of phase 27's draws (an intra encoder's offset)
TPH_SEED, TPH_OFFSET = 1234, 130
#: persons per image of the TPH training batch: B=4 images x N=4 slots
TPH_TRAIN_PERSONS = [4, 2, 3, 1]
#: the f32 TPH training step kernels on vs off (phase 28), as HRT_GRAD_BOUND.
#: Measured on the card at full width: the two routes differ by 1.5e-4 (max),
#: 1.0e-4 (L2) at the worst leaf and 4.8e-5 overall (C's and D's f32 sums
#: over 3072 keys in another order than the plain version's, carried through
#: the trunk's BatchNorms), where two runs of one route differ by 2.2e-5,
#: 8.5e-6 and 2.0e-6; the bounds sit about 5 times above the routes'
#: difference. Kernels C and D themselves are held at TRAIN_TOL in phase 27
TPH_GRAD_BOUND = {"max": 1e-3, "l2": 5e-4, "all_l2": 2.5e-4}
#: the training fixtures of phases 30-33 (``tests/torch_fixture.py``): each
#: dataset's tree, its training split's decoded digests and image folder
FIXTURES = FIXTURE.parent
TRAIN_TREES = {"coco": ("coco_synth", "decoded_train2017.sha256", "images/train2017"),
               "crowdpose": ("crowdpose_synth", "decoded.sha256", "images"),
               "OCHuman": ("ochuman_synth", "decoded.sha256", "images")}
#: the JAX records' floats (``expected_train.json``) against the port's
RECORD_ATOL = 1e-5
#: ``device_batch`` on the card against the CPU: the crops' atol, as
#: ``tests/test_torch_train_data.py::CROP_ATOL`` (1e-4 plus a float32 ulp of a
#: source coordinate on a 640-pixel raster times a full-range step over the
#: least ImageNet std: the two devices may round the inverse affine apart)
CROP_ATOL = 1e-4 + 2.0 ** -14 / 0.224
#: host batch assembly (phase 30): epochs of the fixture timed at each WORKERS
HOST_WORKERS, HOST_EPOCHS = (0, 8), 4
#: epochs of phases 32-33's train_loop (one step each: a fixture split holds
#: fewer images than the recipe's batch, so its one batch wraps)
TRAIN_EPOCHS = 3
#: the recipes (phase 34 reads all ten; ``tests/torch_fixture.py`` wrote the
#: port configs the JAX reader gives them)
EXPERIMENTS = Path(__file__).resolve().parent / "experiments"
RECIPES_JSON = Path(__file__).resolve().parent / "i2rnet_tpu_torch" / "config" / "expected_recipes.json"
#: the five recipes trained and tested from their YAML (phases 35-39): phase,
#: YAML under experiments/, fixture tree, TEST.BATCH_SIZE_PER_GPU (the
#: fixture's test split where it holds fewer images than the recipe's batch)
#: and further overrides
RECIPE_RUNS = (
    (35, "crowdpose/interformer_crowdpose_tph_192_p6_b4.yaml", "crowdpose_synth", 6, ()),
    (36, "OCHuman/interformer_ochuman_tph_192_p3_b8.yaml", "ochuman_synth", 6, ()),
    (37, "crowdpose/interformer_crowdpose_hrt_192_p4_b4.yaml", "crowdpose_synth", 6, ()),
    (38, "OCHuman/interformer_ochuman_hrt_192_p3_b8.yaml", "ochuman_synth", 6, ()),
    (39, "coco/interformer_coco_hrt_288_p2_b4.yaml", "coco_synth", 32,
     ("TPU.FUSED_BLOCK_TRAIN", "True")),
)
#: each recipe run: one epoch of at most RECIPE_STEPS steps (``--max-epochs``,
#: ``--max-steps-per-epoch``), then ``tools.test``
RECIPE_STEPS = 2
#: the seed of the first stage written as each run's MODEL.SINGLE_MODEL (the
#: trainer initialises the model from SEED before it loads the file)
SINGLE_MODEL_SEED = SEED + 100
#: new shapes held before their recipe trains: A and B at the CrowdPose TPH
#: test batch (16 images x MAX_PATCH 6 persons of 3072 tokens); E and F at
#: P = 16 on the HRT maps at 256x192 (CrowdPose HRT, 4 x 4); kernel 9 at P = 8
#: (4 x 2) on the four 384x288 branch maps
CROWDPOSE_TPH_ATTN = [(96, TPH_TOKENS)]
HRT_P16_SHAPES = [(16,) + shape[1:] for shape in HRT_SHAPES[:4]]
HRT288_TRAIN_SHAPES = [(8, 96, 72, 78, 2), (8, 48, 36, 156, 4), (8, 24, 18, 312, 8),
                       (8, 12, 9, 624, 16)]
#: the HRT recipe phases, whose inter encoder's C and D shapes are held
#: before they train, and the label of those shapes in the kernels line
HRT_RECIPES = {37: "crowdpose_hrt_inter", 38: "ochuman_hrt_inter", 39: "coco_hrt_288_inter"}
#: the MPII fixture (phase 40) and its batch
MPII = FIXTURES / "mpii_synth"
MPII_BATCH = 4
#: the serving slice (phases 41-44): the W48 artifact's person buckets, batch
#: and canvas, written with the other artifacts and the checkpoints under
#: ARTIFACT_DIR
ARTIFACT_BUCKETS, ARTIFACT_BATCH, ARTIFACT_HW = (2, 4, 7), 8, (480, 640)
ARTIFACT_DIR = OUT_DIR / "artifacts"
#: phase 42's geometry (the JAX ``tools/bench_serving.py``'s): B=16 images,
#: bucket 7, a 256x320 canvas; calls of each route in turns
RATE_BATCH, RATE_BUCKET, RATE_HW, RATE_ITERS = 16, 7, (256, 320), 10
#: the artifacts of phases 41-44, each exported by ``tools.export`` in a
#: process of its own: name -> (recipe under experiments/, checkpoint, B,
#: person buckets, canvas, further flags); TPH and HRT one bucket each at
#: their recipes' test geometry
EXPORTS = {
    "w48": ("coco/interformer_coco_w48_pure_en6.yaml", "w48", ARTIFACT_BATCH, ARTIFACT_BUCKETS,
            ARTIFACT_HW, ()),
    "w48_plain": ("coco/interformer_coco_w48_pure_en6.yaml", "w48", ARTIFACT_BATCH,
                  ARTIFACT_BUCKETS[-1:], ARTIFACT_HW, ("--no-kernels",)),
    "w48_rate": ("coco/interformer_coco_w48_pure_en6.yaml", "w48", RATE_BATCH, (RATE_BUCKET,),
                 RATE_HW, ()),
    "tph": ("coco/interformer_coco_tph_192_p4_b4.yaml", "tph", 16, (4,), ARTIFACT_HW, ()),
    "hrt": ("coco/interformer_coco_hrt_192_p2_b12.yaml", "hrt", 8, (4,), ARTIFACT_HW, ()),
}
#: seconds the exports may take together, and the fresh process
EXPORT_TIMEOUT, CHILD_TIMEOUT = 900, 900
#: Kernels A's and B's launches a W48 serve call: 6 layers, 2 forwards
W48_SERVE_LAUNCHES = 12
#: launches a serve call of the TPH artifact (A and B: 6 intra + 4 inter
#: layers, 2 forwards) and of the HRT artifact on E + F (E and F: HRFormer-B's
#: 44 blocks, 2 forwards; A and B: 2 inter layers)
SERVED_LAUNCHES = {"tph": {"masked_mhsa": 20, "encoder_ffn": 20},
                   "hrt": {"window_attn_block": 88, "mlp_block": 88, "masked_mhsa": 4,
                           "encoder_ffn": 4}}
#: phase 43: single-image requests offered to a MicroBatcher
POISSON_REQUESTS, POISSON_DELAY_MS = 100, 5.0
ZERO_GRADS = re.compile(r"(k_proj|mlp\.(fc1|dw3x3|fc2)|norm2|fuse_layers\.\d+\.\d+\.\d+\.1)\.bias$")


def log(msg: str) -> None:
    """Print ``msg``; a phase's first line with the seconds since the start."""
    if msg.startswith("phase"):
        msg += f" [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops, dtype):
    """(ms, what bounds it): the least time the card takes to move
    ``n_bytes`` and do ``n_ops`` operations on inputs of ``dtype``."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_f32_products(n_bytes, mm_ops, other_ops):
    """``bound`` of f32 work whose ``mm_ops`` matrix-product operations the
    card can do either on the CUDA cores or as three TF32 passes on the
    tensor cores (Kernel G), the ``other_ops`` on the CUDA cores: the bytes
    time against the lesser of the two operation times."""
    f32 = (mm_ops + other_ops) / PEAK_OPS[torch.float32] * 1e3
    tf32x3 = (3 * mm_ops / PEAK_TF32 + other_ops / PEAK_OPS[torch.float32]) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= min(f32, tf32x3) else (min(f32, tf32x3), "operations")


def timing(plain_ms, ms, bound_, library_ms=None):
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_[0], "bound_by": bound_[1],
            "library_ms": library_ms}


def attention_ops(mask, c, matmuls):
    """Multiply-add operations of ``matmuls`` [S, kv] x [kv, C]-sized products
    per image, over the keys each image's mask leaves (at least one)."""
    b, s = mask.shape
    kv = (~mask).sum(1).clamp_min(1).double()
    return float(2 * matmuls * s * c * kv.sum())


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def flip_pairs(cfg):
    k = cfg["MODEL"]["NUM_JOINTS"]
    return [p for p in presets.COCO_FLIP_PAIRS if max(p) < k]


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def randn(*shape, g, dtype=torch.float32):
    return torch.randn(*shape, generator=g).to(DEV, dtype)


def compare(got, ref, dtype, what):
    """max |got - ref|; raises unless finite and within the stated tolerance."""
    atol, rtol = TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside atol={atol} "
                             f"rtol={rtol}, max |err| {err.max().item():.3g}")
    return err.max().item()


def ragged_mask(b, s, per_person, g):
    """[B, S] key-padding mask of images with 0..7 valid persons (image 0
    fully padded), or random padding with a fully padded row when S is not
    a whole number of persons."""
    if s % per_person == 0:
        n = s // per_person
        valid = torch.randint(1, n + 1, (b,), generator=g)
        valid[0] = 0
        mask = torch.arange(n).repeat_interleave(per_person)[None, :] >= valid[:, None]
    else:
        mask = torch.rand(b, s, generator=g) > 0.7
        mask[0] = True
    return mask.to(DEV)


def scattered_mask(b, s, per_person, g):
    """[B, S] key-padding mask that pads whole persons anywhere, not only a
    suffix: image 0 fully padded, image 1 only its last person real, the
    others a random half of their persons (at least one real)."""
    n = s // per_person
    real = torch.rand(b, n, generator=g) > 0.5
    real[:, 0] |= ~real.any(1)
    real[0] = False
    real[1] = torch.arange(n) == n - 1
    return (~real).repeat_interleave(per_person, dim=1).to(DEV)


def attention_masks(b, s, g):
    """The key-padding masks Kernels A and C are held to at (B, S): ragged
    suffixes (or token-level padding off the person grid), and at S=1344 no
    mask and scattered persons too."""
    masks = [("ragged", ragged_mask(b, s, 192, g))]
    if s == 1344:
        masks += [("none", None), ("scattered", scattered_mask(b, s, 192, g))]
    return masks


#: Kernel A vs plain (B, S, C, heads): W48's (ragged, none and scattered
#: masks), HRT's, and a small multi-head shape
MHSA_SHAPES = ((8, 1344, 96, 1), (8, 768, 78, 1), (2, 130, 24, 8))


def phase_mhsa(g, shapes=MHSA_SHAPES):
    """Kernel A against its plain version at ``shapes``, f32 and bf16; returns
    the bf16 max |err| of the first shape's ragged mask."""
    main_err = None
    for b, s, c, h in shapes:
        for kind, mask in attention_masks(b, s, g):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (randn(b, s, c, g=g, dtype=dt) for _ in range(3))
                got = masked_mhsa_fused(q, k, v, h, mask)
                torch.cuda.synchronize()
                err = compare(got, masked_mhsa_torch(q, k, v, h, mask), dt,
                              f"masked_mhsa {(b, s, c, h)} {kind} {dt}")
                if (b, s, kind, dt) == (*shapes[0][:2], "ragged", torch.bfloat16):
                    main_err = err
                log(f"  masked_mhsa B={b} S={s} C={c} H={h} {kind} mask {str(dt)[6:]}: max|err| "
                    f"{err:.3g} (atol/rtol {TOL[dt][0]:g}/{TOL[dt][1]:g}), finite")
    return main_err


def ffn_params(c, f, g):
    return [1 + 0.2 * randn(c, g=g), 0.1 * randn(c, g=g),
            randn(f, c, g=g) / math.sqrt(c), 0.1 * randn(f, g=g),
            randn(c, f, g=g) / math.sqrt(f), 0.1 * randn(c, g=g),
            1 + 0.2 * randn(c, g=g), 0.1 * randn(c, g=g)]


#: Kernels B and D vs plain (rows, C, F): W48's encoder tokens (B=8, S=1344),
#: HRT's (B=8, S=768, C=78) and a small ragged shape
FFN_SHAPES = ((8 * 1344, 96, 192), (8 * 768, 78, 192), (1003, 16, 32))


def phase_ffn(g, shapes=FFN_SHAPES):
    """Kernel B against its plain version at ``shapes``, f32 and bf16; returns
    the bf16 max |err| of the first shape."""
    main_err = None
    for rows, c, f in shapes:
        p = ffn_params(c, f, g)
        for dt in (torch.float32, torch.bfloat16):
            x = (2 * randn(rows, c, g=g) + 0.5).to(dt)
            got = encoder_ffn_fused(x, *p)
            torch.cuda.synchronize()
            err = compare(got, encoder_ffn_torch(x, *p), dt, f"encoder_ffn {(rows, c, f)} {dt}")
            if (rows, dt) == (shapes[0][0], torch.bfloat16):
                main_err = err
            log(f"  encoder_ffn rows={rows} C={c} F={f} {str(dt)[6:]}: max|err| {err:.3g} "
                f"(atol/rtol {TOL[dt][0]:g}/{TOL[dt][1]:g}), finite")
    return main_err


#: kernel vs plain in training, as a share of the reference's largest
#: magnitude plus a relative part: (scaled atol, rtol). f32: two summation
#: orders; bf16: the plain version rounds its products' outputs (dP, the
#: gradients of its f32 casts) where the kernels keep f32, as the JAX kernels do.
TRAIN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}
RATE = 0.1


def compare_scaled(got, ref, dtype, what):
    """max |got - ref| / max |ref|; raises unless finite and within TRAIN_TOL."""
    atol, rtol = TRAIN_TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    ref = ref.float()
    scale = ref.abs().max().clamp_min(1e-30)
    err = (got.float() - ref).abs()
    bad = err > atol * scale + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside {atol:g}*max|ref| + "
                             f"{rtol:g}*|ref|, max |err|/max|ref| {(err.max() / scale).item():.3g}")
    return err.max().item(), (err.max() / scale).item()


def fwd_bwd(fn, inputs, cot):
    """fn(*inputs) and the gradients of <fn(*inputs), cot> w.r.t. inputs."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, cot)
    return out.detach(), grads


#: Kernel C vs plain (B, S, C, heads): W48's, HRT's and a small multi-head shape
MHSA_TRAIN_SHAPES = ((8, 1344, 96, 1), (12, 384, 78, 1), (2, 130, 24, 8))


def phase_mhsa_train(g, shapes=MHSA_TRAIN_SHAPES, keep_fraction=True):
    """Kernel C forward and backward vs plain at ``shapes``: bits and seed
    modes, f32 and bf16; returns the bf16 seed-mode max |err| of the first
    shape's ragged mask; the seed-mode keep fraction where asked."""
    errs = {}
    for b, s, c, h in shapes:
        bits = torch.randint(0, 2 ** 32, (b * h, s, s), generator=g, dtype=torch.int64).to(DEV)
        for kind, mask in attention_masks(b, s, g):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v, cot = (randn(b, s, c, g=g, dtype=dt) for _ in range(4))
                for mode in ("bits", "seed"):
                    kw = ({"dropout_bits": bits} if mode == "bits"
                          else {"dropout_seed": 1234, "dropout_offset": 7})

                    def run(fn):
                        return fwd_bwd(lambda q_, k_, v_: fn(q_, k_, v_, h, mask, RATE, **kw),
                                       (q, k, v), cot)

                    got, gk = run(masked_mhsa_train_fused)
                    torch.cuda.synchronize()
                    ref, gr = run(masked_mhsa_train_torch)
                    what = f"mhsa_train {(b, s, c, h)} {kind} mask {str(dt)[6:]} {mode}"
                    e_f, r_f = compare_scaled(got, ref, dt, what + " out")
                    e_b = [compare_scaled(x, y, dt, f"{what} d{n}")
                           for n, x, y in zip("qkv", gk, gr)]
                    if mask is not None and mask[0].all() and not torch.isfinite(got[0]).all():
                        raise AssertionError(f"{what}: the fully padded image is not finite")
                    if (b, s, kind, dt, mode) == (*shapes[0][:2], "ragged", torch.bfloat16,
                                                  "seed"):
                        errs = {"fwd": e_f, "bwd": max(e for e, _ in e_b)}
                    log(f"  {what}: out max|err| {e_f:.3g} ({r_f:.2g} of max), dq/dk/dv "
                        + " ".join(f"{e:.3g} ({r:.2g})" for e, r in e_b))
    if not keep_fraction:
        return errs
    bits = attention_bits(1234, 7, 8, 1344, DEV)
    keep = (bits >= threshold(RATE)).float().mean().item()
    log(f"  seed-mode keep fraction over {bits.numel()} draws: {keep:.5f} (1 - rate = {1 - RATE})")
    if abs(keep - (1 - RATE)) > 1e-3:
        raise AssertionError(f"keep fraction {keep} strays from {1 - RATE}")
    return errs


def away_from_kink(x, p, g, eps=1e-4):
    """``x`` with each row redrawn until no linear1 pre-activation lies within
    ``eps`` of the ReLU kink, where two summation orders may take two branches
    (one flipped gate moves a whole row of dx)."""
    for _ in range(50):
        n = _layer_norm(x, p[0], p[1], 1e-5).to(x.dtype).float()
        h = n @ p[2].to(x.dtype).float().t() + p[3]
        near = (h.abs() < eps).any(-1)
        if not near.any():
            return x
        x = torch.where(near[:, None], (2 * randn(*x.shape, g=g) + 0.5).to(x.dtype), x)
    raise AssertionError("could not draw rows away from the ReLU kink")


def phase_ffn_train(g, shapes=FFN_SHAPES):
    """Kernel D forward and backward (dx + 8 parameter grads) vs plain at
    ``shapes``, and two bf16 backward calls bit-equal (seed mode, the first
    shape); returns the bf16 seed-mode max |err| of the first shape."""
    errs = {}
    for rows, c, f in shapes:
        p = ffn_params(c, f, g)
        bits = (torch.randint(0, 2 ** 32, (rows, f), generator=g, dtype=torch.int64).to(DEV),
                torch.randint(0, 2 ** 32, (rows, c), generator=g, dtype=torch.int64).to(DEV))
        for dt in (torch.float32, torch.bfloat16):
            x = away_from_kink((2 * randn(rows, c, g=g) + 0.5).to(dt), p, g)
            cot = randn(rows, c, g=g, dtype=dt)
            for mode in ("bits", "seed"):
                kw = ({"dropout_bits": bits} if mode == "bits"
                      else {"dropout_seed": 99, "dropout_offset": 2})

                def run(fn):
                    return fwd_bwd(lambda *a: fn(*a, dropout_rate=RATE, **kw), (x, *p), cot)

                got, gk = run(encoder_ffn_train_fused)
                torch.cuda.synchronize()
                ref, gr = run(encoder_ffn_train_torch)
                what = f"encoder_ffn_train rows={rows} C={c} F={f} {str(dt)[6:]} {mode}"
                if rows == shapes[0][0] and dt == torch.bfloat16 and mode == "seed":
                    again = run(encoder_ffn_train_fused)[1]
                    if not all(torch.equal(a, b) for a, b in zip(gk, again)):
                        raise AssertionError(f"{what}: two backward calls differ")
                    log(f"  {what}: two backward calls give the same bits")
                e_f, r_f = compare_scaled(got, ref, dt, what + " out")
                names = ("x", "ln1_w", "ln1_b", "w1", "b1", "w2", "b2", "ln2_w", "ln2_b")
                e_b = [compare_scaled(a, r, dt, f"{what} d{n}") for n, a, r in zip(names, gk, gr)]
                if rows == shapes[0][0] and dt == torch.bfloat16 and mode == "seed":
                    errs = {"fwd": e_f, "bwd": max(e for e, _ in e_b)}
                log(f"  {what}: out max|err| {e_f:.3g} ({r_f:.2g}), grads max of max|err|/max|ref| "
                    f"{max(r for _, r in e_b):.2g}")
    return errs


def person_inputs(cfg, b, n, counts, g):
    """Normalised crops, box position masks and validity for a [B, N] batch."""
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    images = randn(b, n, h, w, 3, g=g)
    pos = torch.zeros(b, n, h, w, 1)
    corners = torch.randint(0, min(h, w) // 2, (b, n, 2), generator=g).tolist()
    for i in range(b):
        for j in range(n):
            y0, x0 = corners[i][j]
            pos[i, j, y0:y0 + h // 2, x0:x0 + w // 2] = 1.0
    valid = torch.arange(n)[None, :] < torch.as_tensor(counts)[:, None]
    return images, pos.to(DEV), valid.to(DEV)


def random_model(cfg, g):
    """The recipe's model at full width with seeded random weights; each
    BatchNorm's running statistics set from its input on a calibration batch,
    so every layer's output is O(1)."""
    model = build_model(cfg, use_kernels=False, device=DEV)
    model.compute_dtype = torch.float32
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.5 + torch.rand(p.shape, generator=g))

    def calibrate(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate)
             for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    try:
        with torch.no_grad():
            model(*person_inputs(cfg, 2, 3, [3, 3], g))
    finally:
        for hk in hooks:
            hk.remove()
    return model


def phase_model(model, cfg, g):
    images, pos, valid = person_inputs(cfg, 8, 7, [7, 5, 3, 1, 7, 2, 6, 0], g)
    reset_launches()
    with torch.no_grad():
        model.global_encoder.use_kernels = True
        heat_on = model(images, pos, valid)
        torch.cuda.synchronize()
        counts = {k: launch_counts()[k] for k in EVAL_KERNELS}
        model.global_encoder.use_kernels = False
        heat_off = model(images, pos, valid)
    if not torch.isfinite(heat_on).all():
        raise AssertionError("model forward with kernels: non-finite heatmaps")
    if heat_on[~valid].abs().max() != 0:
        raise AssertionError("padded persons' heatmaps are not zero")
    scale = heat_off.abs().max().item()
    rel = (heat_on - heat_off).abs().max().item() / scale
    if rel > HEAT_REL_BOUND or scale < 1e-3 or min(counts.values()) < 1:
        raise AssertionError(f"model: rel {rel:.3g} (bound {HEAT_REL_BOUND}), max|heat| "
                             f"{scale:.3g}, launches {counts}")
    log(f"  heatmaps {tuple(heat_on.shape)}: max|heat| {scale:.4g}, max|dheat|/max|heat| "
        f"{rel:.3g} (bound {HEAT_REL_BOUND:g}); launches in the kernel forward {counts}")


def requests(rng, n_images=12):
    """Synthetic uint8 images up to 480x640 with 1-9 person boxes each (one
    image with 9, more than the largest bucket, so it is chunked)."""
    images, boxes = [], []
    for i in range(n_images):
        h, w = int(rng.randint(240, 481)), int(rng.randint(320, 641))
        images.append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        n = 9 if i == 0 else int(rng.randint(1, 10))
        bw, bh = rng.uniform(40, w / 2, n), rng.uniform(80, h / 1.5, n)
        x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes.append(np.stack([x0, y0, bw, bh], 1).tolist())
    return images, boxes


def phase_serve(model, cfg, set_kernels, kernels=EVAL_KERNELS, batch_images=8,
                n_buckets=(2, 4, 7), absent=(), per_call=None):
    """Requests served in bf16 with the kernels on: each of ``kernels``
    launched (``per_call`` times a serve call, where given) and none of
    ``absent`` in the counted run; the results against the same requests
    served with the kernels off."""
    rng = np.random.RandomState(SEED)
    images, boxes = requests(rng)
    model.compute_dtype = torch.bfloat16
    set_kernels(True)
    pred = Predictor(model, cfg, flip_pairs(cfg), batch_images=batch_images, n_buckets=n_buckets,
                     raw_hw=(480, 640))
    pred.predict(images[:2], boxes[:2])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    calls, serve = [], pred.serve

    def counted(*args):
        calls.append(1)
        return serve(*args)

    pred.serve = counted
    reset_launches()
    t0 = time.perf_counter()
    out = pred.predict(images, boxes)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pred.serve = serve
    counts = {k: launch_counts()[k] for k in kernels}
    stray = {k: launch_counts()[k] for k in absent if launch_counts()[k]}
    for i, (kp, bxs) in enumerate(zip(out, boxes)):
        if kp.shape != (len(bxs), cfg["MODEL"]["NUM_JOINTS"], 3) or not np.isfinite(kp).all():
            raise AssertionError(f"image {i}: result {kp.shape}, finite {np.isfinite(kp).all()}")
    if min(counts.values()) < 1:
        raise AssertionError(f"the served path launched a kernel no time: {counts}")
    if per_call is not None and counts != dict.fromkeys(kernels, per_call * len(calls)):
        raise AssertionError(f"the served path launched {counts} in {len(calls)} serve calls, "
                             f"want {per_call} a call")
    if stray:
        raise AssertionError(f"the served path launched kernels of another route: {stray}")
    set_kernels(False)
    plain = pred.predict(images, boxes)
    log(f"  {len(images)} images, {sum(map(len, boxes))} persons -> results "
        f"[n_i, {cfg['MODEL']['NUM_JOINTS']}, 3], "
        f"finite; host clock {dt * 1e3:.1f} ms (with host packing and copies); "
        f"launches {counts} in {len(calls)} serve calls")
    check_served(out, plain, "bf16 kernels vs bf16 plain", "bf16 serving with kernels strays "
                 "from the plain path")
    return counts


def check_served(out, ref, what, fault):
    """Phase 6's bound between two servings of the same requests: the largest
    confidence difference within 5% of the largest confidence, the median
    keypoint within 1 px; returns the largest |difference|."""
    conf = np.concatenate([k[..., 2] for k in out])
    conf_ref = np.concatenate([k[..., 2] for k in ref])
    xy_err = np.concatenate([np.abs(a[..., :2] - b[..., :2]).max(-1) for a, b in zip(out, ref)])
    conf_err = np.abs(conf - conf_ref).max() / np.abs(conf_ref).max()
    log(f"  {what} on the same requests: max|dconf|/max|conf| "
        f"{conf_err:.3g}, |dxy| median {np.median(xy_err):.3g} px, "
        f"share within 1 px {np.mean(xy_err <= 1.0):.3f}")
    if conf_err > 0.05 or np.median(xy_err) > 1.0:
        raise AssertionError(fault)
    return max(float(np.abs(a - b).max()) for a, b in zip(out, ref))


def time_cuda(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """ms of device time per call of ``fn`` over ``iters`` back-to-back calls,
    by CUDA events, with the host's launch time hidden: the calls are queued
    behind a kernel that spins for ``QUEUE_CYCLES``, and count only if the
    start event is still pending when the last call is in the stream, so the
    events time the card running them one after another. Where they were not
    (the launch queue filled, or a call waits on the card), fewer calls are
    timed, down to one call timed as it runs."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    asked = iters
    while True:
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued or iters == 1:
            break
        iters = max(1, iters // 4)
    if iters < asked:
        log(f"  (device_ms: {asked} calls did not queue behind the wait; {iters} timed"
            + ("" if queued else ", as it ran: the host's time is in it") + ")")
    return start.elapsed_time(end) / iters


def in_turns(fns, iters):
    """ms of each of ``fns``, timed in order and then in reverse order (a, b,
    b, a for two); the mean of each one's two runs."""
    ts = [0.0] * len(fns)
    for i in [*range(len(fns)), *reversed(range(len(fns)))]:
        ts[i] += time_cuda(fns[i], iters) / 2
    return ts


def plain_kernel_sdpa(name, fns, iters, card):
    """(plain, kernel[, SDPA]) ms of ``fns`` as device time per call
    (``device_ms``, the calls queued behind a wait): at these sizes a loop
    of Python calls timed with CUDA events measures the host as much as the
    card. The event-timed ms (order plain, kernel[, SDPA, SDPA], kernel,
    plain) are logged beside them."""
    host = in_turns(fns, iters)
    dev = [device_ms(f, iters) for f in fns]

    def text(t):
        sdpa = f", SDPA {t[2] * 1e3:.1f} us (kernel/SDPA {t[1] / t[2]:.2f})" if len(t) > 2 else ""
        return f"kernel {t[1] * 1e3:.1f} us, plain {t[0] * 1e3:.1f} us{sdpa}"

    log(f"  {name}: device time per call {text(dev)}; CUDA events over back-to-back calls "
        f"{text(host)} [{card}]")
    return tuple(dev)


def alternate(a, b, iters):
    """ms of ``a`` and ``b`` timed in the order a, b, b, a; the mean of each pair."""
    return tuple(in_turns((a, b), iters))


def train_cfg(dtype: str, use_kernels: bool, preset=presets.w48_pure_en6):
    cfg = preset()
    cfg["DEVICE"].update(COMPUTE_DTYPE=dtype, USE_KERNELS=use_kernels)
    cfg["PRINT_FREQ"] = 1
    return cfg


def seeded_model(cfg):
    """The model of ``cfg`` initialised as the JAX package does, on the card."""
    model = build_model(cfg, device="cpu")  # initialised from a CPU generator, then moved
    init_weights(model, gen(SEED))
    return model.to(DEV)


def phase_train(cfg, persons, kernels, name):
    """A main training path: ``train_loop`` at full width (the config's
    dtype and kernels, its dropout and drop path) on one repeated synthetic
    batch of ``persons`` per image; the launches of ``kernels`` counted from
    zero over it; then AUTO_RESUME from its checkpoint."""
    raw = synthetic_raw_batch(cfg, persons, np.random.RandomState(SEED))
    out = OUT_DIR / name
    shutil.rmtree(out, ignore_errors=True)
    losses = []
    reset_launches()
    t0 = time.perf_counter()
    state = train_loop(cfg, str(out), lambda epoch: [raw] * TRAIN_STEPS, max_epochs=1,
                       device=DEV, on_step=lambda e, i, m: losses.append(
                           {k: float(v) for k, v in m.items() if k.startswith("loss")}))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: launch_counts()[k] for k in kernels}
    total = [v["loss"] for v in losses]
    log(f"  {TRAIN_STEPS} steps, B={len(persons)} images x N={cfg['DATASET']['MAX_PATCH']} "
        f"(persons {persons}), {cfg['DEVICE']['COMPUTE_DTYPE']}: losses ({', '.join(losses[0])}) "
        + " ".join("(" + ", ".join(f"{x:.6f}" for x in v.values()) + ")" for v in losses)
        + f"; host clock {dt:.2f} s with build and init; launches {counts}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for v in losses for x in v.values()):
        raise AssertionError(f"training losses {losses}")
    if not np.mean(total[-3:]) < np.mean(total[:3]):
        raise AssertionError(f"the loss does not fall on a repeated batch: {total}")
    if min(counts.values()) < 1:
        raise AssertionError(f"the training path launched a kernel no time: {counts}")
    check_resume(cfg, out, state, lambda epoch: [raw] * TRAIN_STEPS)
    return counts, raw


def check_resume(cfg, out, state, batches=None, epochs=1):
    """AUTO_RESUME from the newest checkpoint under ``out`` after ``epochs``
    epochs: a ``train_loop`` with nothing left to train restores the
    trained weights, optimizer state and step bit for bit."""
    ckpt = latest_checkpoint(str(out))
    payload = load_checkpoint(ckpt)
    resumed = train_loop(cfg, str(out), batches, max_epochs=epochs, device=DEV)
    same = all(torch.equal(v.cpu(), payload["state_dict"][k])
               for k, v in resumed.model.state_dict().items())
    same &= all(torch.equal(v.cpu(), state.model.state_dict()[k].cpu())
                for k, v in resumed.model.state_dict().items())
    same &= all(torch.equal(a.cpu(), b.cpu()) for k in state.optimizer.state_dict()["state"]
                for a, b in zip(state.optimizer.state_dict()["state"][k].values(),
                                resumed.optimizer.state_dict()["state"][k].values()))
    if (not same or resumed.step != state.step or payload["epoch"] != epochs - 1
            or payload["meta"]["model"] != cfg["MODEL"]["NAME"]):
        raise AssertionError(f"AUTO_RESUME from {ckpt} did not restore the trained state")
    log(f"  checkpoint {Path(ckpt).name} written; AUTO_RESUME restores its weights, optimizer "
        f"state and step {resumed.step} bit for bit")


def grads_on_off(model, cfg, raw, images, set_kernels, routes=(True, False)):
    """One f32 training step's losses and gradients on the first ``images`` of
    ``raw`` with the kernels on or off, for each of ``routes``: a list of
    (losses, {name: gradient}, launch counts)."""
    m = cfg["MODEL"]
    batch = device_preprocess(raw_to_device({k: v[:images] for k, v in raw.items()}, DEV),
                              tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    res = []
    for on in routes:
        set_kernels(on)
        model.zero_grad(set_to_none=True)
        reset_launches()
        out = model(batch["images"], batch["pos_masks"], batch["person_valid"], train=True)
        outputs = out if isinstance(out, dict) else {"single": None, "multi": out}
        loss, parts = compute_losses(outputs, batch, m["LOSS_WEIGHTS"], True)
        loss.backward()
        torch.cuda.synchronize()
        res.append(({k: v.item() for k, v in (("loss", loss), *parts.items())},
                    {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None},  # unused branches have none
                    launch_counts()))
    return res


def phase_train_on_off(raw):
    """One f32 W48 training step at dropout 0 (2 images, 12 persons) with the
    kernels on and off: the loss and every gradient."""
    cfg = train_cfg("float32", True)
    model = seeded_model(cfg)
    model.global_encoder.dropout_rate = 0.0
    (l_on, g_on, _), (l_off, g_off, _) = grads_on_off(model, cfg, raw, 2, model.set_kernels)
    loss_rel = abs(l_on["loss"] - l_off["loss"]) / abs(l_off["loss"])
    grad_rel = {n: ((g_on[n] - g_off[n]).abs().max() / g_off[n].abs().max().clamp_min(1e-30)).item()
                for n in g_off}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"  loss {l_on['loss']:.8f} vs {l_off['loss']:.8f} (rel {loss_rel:.3g}, bound "
        f"{TRAIN_LOSS_REL:g}); {len(grad_rel)} gradients, worst max|dg|/max|g| "
        f"{grad_rel[worst]:.3g} at {worst} (bound {TRAIN_GRAD_REL:g})")
    if loss_rel > TRAIN_LOSS_REL or grad_rel[worst] > TRAIN_GRAD_REL:
        raise AssertionError("f32 training step with kernels strays from the plain path")


def busy_ms(events):
    """ms in which at least one of ``events`` (profiler device events) ran."""
    if not events:
        return 0.0
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return (busy + cur_e - cur_s) / 1e3


def profile_steps(fn, steps, keep=None):
    """Device busy time, idle share, launches and the top kernels over
    ``steps`` calls of ``fn``, from ``torch.profiler``; the device events
    themselves appended to ``keep``, where given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):  # the profiler has come back empty now and then
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # every device event but user annotations and the profiler's step
        # markers: torch names its elementwise and copy kernels
        # "...{lambda()#N}...", so a "#" does not mark a non-kernel
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("ProfilerStep#")]
        if kernels:
            if keep is not None:
                keep.extend(kernels)
            break
    else:
        log(f"  torch.profiler recorded no device activity in {PROFILE_TRIES} tries: the "
            f"breakdown below is not measured (nan)")
        return wall / steps, math.nan, math.nan, []
    hashed = {}
    for e in kernels:
        hashed[e.name] = hashed.get(e.name, 0) + ("#" in e.name)
    hashed = sorted(((c, n) for n, c in hashed.items() if c), reverse=True)
    busy = busy_ms(kernels)
    unhashed = [e for e in kernels if "#" not in e.name]
    log(f"  profile count: {len(kernels) / steps:.0f} device events/step, busy {busy / steps:.2f} "
        f"ms/step; without the {sum(c for c, _ in hashed) / steps:.0f}/step in {len(hashed)} "
        f"kernels whose name holds '#' (an earlier filter left them out): "
        f"{len(unhashed) / steps:.0f}/step, busy {busy_ms(unhashed) / steps:.2f} ms/step; "
        + "; ".join(f"{c / steps:.0f}x {n[:90]}" for c, n in hashed[:6]))
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return wall / steps, busy / steps, len(kernels) / steps, [(n, t / steps, c / steps)
                                                               for n, (t, c) in ranked]


def step_timing(cfg, raw, persons, set_kernels, card, breakdown=(), keep=None):
    """The train step at full width (the config's dtype, dropout and drop
    path) kernels on and off, in ms and persons/s, their peak memory, and a
    profile of the kernels-on step with its kernel calls; ``breakdown``:
    (label, name substrings) of kernels whose ms and launches per step the
    profile also sums. The profile's device events of its PROFILED_STEPS
    are appended to ``keep``, where given; returns the kernels-on step."""
    model = seeded_model(cfg)
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), 1000))
    step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"])
    m = cfg["MODEL"]
    batch = device_preprocess(raw_to_device(raw, DEV), tuple(m["IMAGE_SIZE"]),
                              tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    dropout_gen = gen(SEED + 1)
    kernels = set_kernels(model)

    def run(on):
        def go():
            kernels(on)
            step(batch, dropout_gen)
        return go

    n = sum(persons)
    torch.cuda.reset_peak_memory_stats()
    t_off, t_on = alternate(run(False), run(True), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  train step B={len(persons)} N={cfg['DATASET']['MAX_PATCH']} ({n} persons) "
        f"{cfg['DEVICE']['COMPUTE_DTYPE']}: kernels on {t_on:.2f} ms = {n / t_on * 1e3:.1f} "
        f"persons/s; kernels off {t_off:.2f} ms = {n / t_off * 1e3:.1f} persons/s [{card}]")
    reset_launches()
    wall, busy, launches, top = profile_steps(run(True), PROFILED_STEPS, keep)
    per_step = {k: v // (PROFILED_STEPS + 1) for k, v in launch_counts().items()
                if v}  # warm-up + the profiled steps
    log(f"  profile, kernels on: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step; peak memory over the timed steps {peak:.1f} GiB; kernel calls per "
        f"step {per_step}; top kernels (ms/step, launches/step):")
    for name, t, c in top[:12]:
        log(f"    {t:8.3f} {c:6.0f}  {name[:110]}")
    for label, parts in breakdown:
        hits = [(t, c) for name, t, c in top if any(p in name for p in parts)]
        log(f"  {label}: {sum(t for t, _ in hits):.3f} ms/step in {sum(c for _, c in hits):.0f} "
            f"launches/step")
    return run(True)


def backward_only(fn, inputs, cot):
    """A call that takes the gradient of one graph of ``fn``, recorded here
    once: timing it times the backward alone."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    return lambda: torch.autograd.grad(out, xs, cot, retain_graph=True)


def phase_train_kernel_timing(g, card, b=8, s=1344, c=96, f=192, per_person=192):
    """Kernels C and D forward and backward beside their plain versions at
    (B, S, C) (the main path's by default), a ragged mask of ``per_person``
    tokens a person, D over B * S rows of C and hidden F, bf16, seed mode;
    ms as (plain, kernel) pairs."""
    q, k, v, cot = (randn(b, s, c, g=g, dtype=torch.bfloat16) for _ in range(4))
    mask = ragged_mask(b, s, per_person, g)
    kw = {"dropout_seed": 5, "dropout_offset": 0}

    def attn(fn):
        return lambda q_, k_, v_: fn(q_, k_, v_, 1, mask, RATE, **kw)

    # the one PyTorch call for the same attention: SDPA with the key mask and
    # dropout 0.1 on the weights (it draws its own bits), forward and backward
    def sdpa(q_, k_, v_):
        heads = [t.view(b, s, 1, c).transpose(1, 2) for t in (q_, k_, v_)]
        return torch.nn.functional.scaled_dot_product_attention(
            *heads, attn_mask=~mask[:, None, None, :], dropout_p=RATE)

    times = {}
    with torch.no_grad():
        times["mhsa_train_fwd"] = plain_kernel_sdpa(
            "mhsa_train_fwd", [lambda: attn(masked_mhsa_train_torch)(q, k, v),
                               lambda: attn(masked_mhsa_train_fused)(q, k, v),
                               lambda: sdpa(q, k, v)], 10, card)
    times["mhsa_train_bwd"] = plain_kernel_sdpa(
        "mhsa_train_bwd", [backward_only(attn(masked_mhsa_train_torch), (q, k, v), cot),
                           backward_only(attn(masked_mhsa_train_fused), (q, k, v), cot),
                           backward_only(sdpa, (q, k, v), cot.view(b, s, 1, c).transpose(1, 2))],
        10, card)
    p = ffn_params(c, f, g)
    x = away_from_kink(randn(b * s, c, g=g, dtype=torch.bfloat16), p, g)
    cot2 = randn(b * s, c, g=g, dtype=torch.bfloat16)

    def tail(fn):
        return lambda *a: fn(*a, dropout_rate=RATE, **kw)

    with torch.no_grad():
        times["encoder_ffn_train_fwd"] = plain_kernel_sdpa(
            "encoder_ffn_train_fwd", [lambda: tail(encoder_ffn_train_torch)(x, *p),
                                      lambda: tail(encoder_ffn_train_fused)(x, *p)], 20, card)
    times["encoder_ffn_train_bwd"] = plain_kernel_sdpa(
        "encoder_ffn_train_bwd", [backward_only(tail(encoder_ffn_train_torch), (x, *p), cot2),
                                  backward_only(tail(encoder_ffn_train_fused), (x, *p), cot2)],
        20, card)
    bf = torch.bfloat16
    lse = b * s * 4
    io = nbytes(q, k, v, mask)
    plain, ms, lib = times["mhsa_train_fwd"]
    times["mhsa_train_fwd"] = timing(plain, ms, bound(
        io + nbytes(q) + b * s * c * 4 + 2 * lse, attention_ops(mask, c, 2), bf), lib)
    plain, ms, lib = times["mhsa_train_bwd"]
    times["mhsa_train_bwd"] = timing(plain, ms, bound(
        io + nbytes(cot) + b * s * c * 4 + 2 * lse + 3 * nbytes(q), attention_ops(mask, c, 5), bf),
        lib)
    wts = (2 * c * f + 4 * c + f) * 4  # f32, as the kernels take them
    times["encoder_ffn_train_fwd"] = timing(*times["encoder_ffn_train_fwd"], bound(
        2 * nbytes(x) + wts, 4.0 * b * s * c * f, bf))
    times["encoder_ffn_train_bwd"] = timing(*times["encoder_ffn_train_bwd"], bound(
        3 * nbytes(x) + 2 * wts, 12.0 * b * s * c * f, bf))
    for name in TRAIN_KERNELS:
        t = times[name]
        lib = "" if t["library_ms"] is None else (f", SDPA {t['library_ms'] * 1e3:.1f} us "
                                                  f"(kernel/SDPA {t['ms'] / t['library_ms']:.2f})")
        log(f"  {name} B={b} S={s} C={c} bf16 seed mode (device time): kernel "
            f"{t['ms'] * 1e3:.1f} us, plain "
            f"{t['plain_ms'] * 1e3:.1f} us{lib}, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}) [{card}]")
    # the plain forwards again with their bits drawn beforehand: their own
    # arithmetic, without the Philox rounds in int64 tensor ops
    bits_a = attention_bits(5, 0, b, s, DEV)
    bits_f = (ffn_bits(5, 0, b * s, f, DEV), ffn_bits(5, 1, b * s, c, DEV))
    with torch.no_grad():
        t_a = time_cuda(lambda: masked_mhsa_train_torch(q, k, v, 1, mask, RATE,
                                                        dropout_bits=bits_a), 10)
        t_f = time_cuda(lambda: encoder_ffn_train_torch(x, *p, dropout_rate=RATE,
                                                        dropout_bits=bits_f), 20)
    log(f"  plain forwards given their bits: mhsa_train {t_a * 1e3:.1f} us, encoder_ffn_train "
        f"{t_f * 1e3:.1f} us [{card}]")
    return times


def eval_steps(model, cfg, set_kernels, b, n, g):
    """The eval protocol (2 forwards + DARK decode) at (B, N) in bf16, as a
    call that takes ``on`` and returns the step with the kernels on or off."""
    model.compute_dtype = torch.bfloat16
    images, pos, valid = person_inputs(cfg, b, n, [n] * b, g)
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    centers = torch.tensor([[w / 2, h / 2]], device=DEV).repeat(b * n, 1)
    scales = torch.tensor([[1.2, 1.6]], device=DEV).repeat(b * n, 1)
    evaluate = make_eval_fn(cfg, model, flip_pairs(cfg))

    def step(on):
        def run():
            set_kernels(on)
            evaluate(images, pos, valid, centers, scales)
        return run

    return step


def eval_timing(step, b, n, iters, card):
    t_off, t_on = alternate(step(False), step(True), iters)
    log(f"  eval protocol B={b} N={n} bf16 (2 forwards + DARK decode): kernels on "
        f"{t_on:.2f} ms = {b * n / t_on * 1e3:.1f} persons/s; kernels off {t_off:.2f} ms = "
        f"{b * n / t_off * 1e3:.1f} persons/s [{card}]")


def phase_timing_mhsa(g, card, b=16, s=1344, c=96):
    """Kernel A at the W48 eval shape, bf16, ragged mask, beside its plain
    version and one SDPA call (device time per call)."""
    bf = torch.bfloat16
    q, k, v = (randn(b, s, c, g=g, dtype=bf) for _ in range(3))
    mask = ragged_mask(b, s, 192, g)
    heads = [t.view(b, s, 1, c).transpose(1, 2) for t in (q, k, v)]
    with torch.no_grad():
        plain, ms, lib = plain_kernel_sdpa(
            "masked_mhsa", [lambda: masked_mhsa_torch(q, k, v, 1, mask),
                            lambda: masked_mhsa_fused(q, k, v, 1, mask),
                            lambda: torch.nn.functional.scaled_dot_product_attention(
                                *heads, attn_mask=~mask[:, None, None, :])], 20, card)
    return {"masked_mhsa": timing(plain, ms, bound(4 * nbytes(q) + nbytes(mask),
                                                   attention_ops(mask, c, 2), bf), lib)}


def phase_timing(model, cfg, g, card):
    b, n = 16, 7
    step = eval_steps(model, cfg, model.set_kernels, b, n, g)
    eval_timing(step, b, n, 3, card)
    reset_launches()
    wall, busy, launches, top = profile_steps(step(True), 2)
    a_ms = sum(t for name, t, _ in top if "mhsa_fwd" in name)
    b_ms = sum(t for name, t, _ in top if any(k in name for k in KERNEL_B))
    calls = launch_counts()
    log(f"  profile, kernels on: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step; Kernel A {a_ms:.3f} ms/step in {calls['masked_mhsa'] // 3} "
        f"launches/step; Kernel B {b_ms:.3f} ms/step in {calls['encoder_ffn'] // 3} "
        f"launches/step; top kernels (ms/step, launches/step):")
    for name, t, c in top[:12]:
        log(f"    {t:8.3f} {c:6.0f}  {name[:110]}")
    s = n * 192
    times = {**phase_timing_mhsa(g, card, b, s), **ffn_timing(g, card, b * s)}
    log_eval_times(times, b, s, card)
    return times


def ffn_timing(g, card, rows, c=96, f=192):
    """Kernel B over ``rows`` rows, bf16, beside its plain version (device
    time per call) and its bound."""
    bf = torch.bfloat16
    x = randn(rows, c, g=g, dtype=bf)
    p = ffn_params(c, f, g)
    with torch.no_grad():
        plain, ms = plain_kernel_sdpa(f"encoder_ffn rows={rows}",
                                      [lambda: encoder_ffn_torch(x, *p),
                                       lambda: encoder_ffn_fused(x, *p)], 20, card)
    return {"encoder_ffn": timing(plain, ms, bound(2 * nbytes(x) + (2 * c * f + 5 * c + f) * 4,
                                                   4.0 * rows * c * f, bf))}


def log_eval_times(times, b, s, card, c=96):
    """Kernels A and B at an eval shape (B images of S tokens) beside their
    plain versions, bounds and, for A, SDPA."""
    for name, t in times.items():
        lib = "" if t["library_ms"] is None else (f", SDPA {t['library_ms'] * 1e3:.1f} us "
                                                  f"(kernel/SDPA {t['ms'] / t['library_ms']:.2f})")
        log(f"  {name} B={b} S={s} C={c} bf16 (device time): kernel {t['ms'] * 1e3:.1f} us, plain "
            f"{t['plain_ms'] * 1e3:.1f} us{lib}, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}) [{card}]")


def hrt_kernel_args(c, heads, g):
    """Random weights of one HRFormer block at width C: Kernel E's (LN1 and
    the four projections, torch layouts) and the folded MlpDWBN's (LN2, w1
    [4C, C], b1, dw [4C, 3, 3], bdw, w2 [C, 4C], b2)."""
    d = 4 * c
    ln = [1 + 0.2 * randn(c, g=g), 0.1 * randn(c, g=g)]
    attn = []
    for _ in range(4):
        attn += [randn(c, c, g=g) / math.sqrt(c), 0.1 * randn(c, g=g)]
    mlp = [randn(d, c, g=g) / math.sqrt(c), 0.1 * randn(d, g=g), randn(d, 3, 3, g=g) / 3,
           0.1 * randn(d, g=g), randn(c, d, g=g) / math.sqrt(d), 0.1 * randn(c, g=g)]
    return ln, attn, mlp


def hrt_kernel_calls(shape, g):
    """{name: (kernel, plain, args after x)} of Kernels E, F, G at one map."""
    _, _, _, c, heads = shape
    ln, attn, mlp = hrt_kernel_args(c, heads, g)
    return {"window_attn_block": (lambda x, *a, **kw: window_attn_block_fused(x, *a, heads=heads,
                                                                              **kw),
                                  lambda x, *a: window_attn_block_torch(x, *a, heads),
                                  (*ln, *attn)),
            "mlp_block": (mlp_block_fused, mlp_block_torch, (*ln, *mlp)),
            "mlp_dwbn": (mlp_dwbn_fused, mlp_dwbn_torch, tuple(mlp))}


#: the activation dtype each of E, F, G takes on the model's path (G gets
#: LN2's f32 output)
PATH_DTYPE = {"window_attn_block": torch.bfloat16, "mlp_block": torch.bfloat16,
              "mlp_dwbn": torch.float32}


def phase_hrt_kernels(g, shapes=HRT_SHAPES, names=None):
    """Kernels E, F and G (or those of ``names``) vs their plain versions,
    f32 and bf16, at each map: {kernel: max |err| at the first map in its
    path's dtype}."""
    errs = {}
    for shape in shapes:
        calls = hrt_kernel_calls(shape, g)
        for dt in (torch.float32, torch.bfloat16):
            x = (2 * randn(*shape[:4], g=g)).to(dt)
            line = []
            for name, (kernel, plain, args) in calls.items():
                if names is not None and name not in names:
                    continue
                got = kernel(x, *args)
                torch.cuda.synchronize()
                ref = plain(x, *args).float()
                if not torch.isfinite(got).all() or got.shape != x.shape or got.dtype != dt:
                    raise AssertionError(f"{name} {shape} {dt}: {got.dtype} {tuple(got.shape)}")
                err = (got.float() - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                if rel > HRT_TOL[dt]:
                    raise AssertionError(f"{name} {shape} {dt}: max|err|/max|ref| {rel:.3g} "
                                         f"(bound {HRT_TOL[dt]:g})")
                if shape == shapes[0] and dt == PATH_DTYPE[name]:
                    errs[name] = err
                line.append(f"{name} {err:.3g} ({rel:.2g})")
                if (name, shape, dt) == ("mlp_dwbn", HRT_SHAPES[0], torch.float32):
                    if not torch.equal(kernel(x, *args), got):
                        raise AssertionError(f"mlp_dwbn {shape}: two f32 calls differ")
                    line[-1] += ", two calls bit-equal"
            log(f"  (P, H, W, C, heads) = {shape} {str(dt)[6:]}: max|err| (of max|ref|) "
                + ", ".join(line) + f"; bound {HRT_TOL[dt]:g} of max|ref|")
    return errs


def hrt_kernels(model):
    """Kernel routes of the HRT model: on = E, F, A, B in eval, kernel 9, C, D
    in training; off = modules and plain versions."""
    return lambda on: model.set_kernels(on, True, False, on)


def check_heatmaps(on, off, valid, label, counts):
    """The HRT model's ``multi`` and ``single`` heatmaps kernels on vs off:
    finite, padded persons exactly 0, within HEAT_REL_BOUND of max|heat|."""
    rels = []
    for key in ("multi", "single"):
        if not torch.isfinite(on[key]).all() or on[key][~valid].abs().max() != 0:
            raise AssertionError(f"{label}: {key} heatmaps non-finite or padded not zero")
        scale = off[key].abs().max().item()
        rels.append((on[key] - off[key]).abs().max().item() / scale)
        if rels[-1] > HEAT_REL_BOUND or scale < 1e-3:
            raise AssertionError(f"{label} {key}: rel {rels[-1]:.3g} (bound "
                                 f"{HEAT_REL_BOUND}), max|heat| {scale:.3g}")
    log(f"  route {label}: heatmaps {tuple(on['multi'].shape)}, max|dheat|/max|heat| multi "
        f"{rels[0]:.3g}, single {rels[1]:.3g} (bound {HEAT_REL_BOUND:g}); launches {counts}")


def phase_hrt_model(cfg, g):
    """The full-width HRFormer-B I²R-Net in f32: kernels on vs off on both
    kernel routes (E + F, and G), heatmaps multi and single; then returns
    the G route's launches, counted from zero over its forward."""
    model = random_model(cfg, g)
    images, pos, valid = person_inputs(cfg, 8, 4, HRT_COUNTS, g)
    with torch.no_grad():
        model.set_kernels(False)
        off = model(images, pos, valid)
    counts = {}
    for label, route in (("E + F", (True, True, False)), ("G", (True, False, True))):
        reset_launches()
        with torch.no_grad():
            model.set_kernels(*route)
            on = model(images, pos, valid)
            torch.cuda.synchronize()
        counts[label] = {k: v for k, v in launch_counts().items() if v}
        check_heatmaps(on, off, valid, label, counts[label])
    need = {"E + F": ("window_attn_block", "mlp_block", "masked_mhsa", "encoder_ffn"),
            "G": ("mlp_dwbn", "masked_mhsa", "encoder_ffn")}
    for label, names in need.items():
        if any(counts[label].get(k, 0) < 1 for k in names):
            raise AssertionError(f"route {label} launched a kernel no time: {counts[label]}")
    if (counts["G"].get("window_attn_block") or counts["E + F"].get("mlp_dwbn")
            or any(c.get("full_block") for c in counts.values())):
        raise AssertionError(f"the routes mixed their kernels: {counts}")
    return model, {"mlp_dwbn": counts["G"]["mlp_dwbn"]}


def hrt_bound(name, shape, dtype):
    """Bound of Kernel E, F, G or 7 at one map: the map read and written once
    plus the weights as the kernel takes them; the products' multiply-adds
    (E over the 7-padded windows, q/k/v/out projections and attention; F and
    G the two 1x1 convolutions and the depthwise 3x3; 7 E's and F's). G
    computes in f32 whatever x's dtype: its 1x1 products count at the lesser
    of the f32 and three-pass TF32 times (``bound_f32_products``)."""
    p, h, w, c, heads = shape
    el = torch.empty((), dtype=dtype).element_size()
    hw, d = h * w, 4 * c
    tp = (h + (-h) % 7) * (w + (-w) % 7)
    attn = (p * (8.0 * tp * c * c + 4.0 * 49 * tp * c), 4 * c * c * el + (6 * c) * 4)
    mm, dwk = p * 4.0 * hw * c * d, p * 18.0 * hw * d
    mlp = (mm + dwk, 2 * c * d * (8 if name == "mlp_dwbn" else el) + (11 * d + 3 * c) * 4)
    parts = {"window_attn_block": [attn], "full_block": [attn, mlp]}.get(name, [mlp])
    n_bytes = 2 * p * hw * c * el + sum(wb for _, wb in parts)
    if name == "mlp_dwbn":  # G's weights: TF32 hi and lo fragments
        return bound_f32_products(n_bytes, mm, dwk)
    return bound(n_bytes, sum(o for o, _ in parts), dtype)


def plan_text(plan):
    """F's bf16 launch plan as phase 16 and ``probes/mlp_probe.py`` print it."""
    return (f"{plan.th}x{plan.tw} tiles, {plan.slices} hidden slice(s), grid {plan.grid} = "
            f"{plan.blocks} blocks, {plan.smem} B shared, partials {plan.partial_bytes / 1e6:.1f} MB")


def attn_plan_text(plan):
    """E's bf16 launch plan as phases 16, 19 and ``probes/attn_probe.py`` print it."""
    text = (f"G={plan.group} heads a block, pass 1 grid {plan.grid1} = {plan.blocks1} blocks, "
            f"{plan.smem1} B shared; ")
    if plan.fused:
        return text + "no pass 2 (pass 1 runs the out-projection)"
    return text + (f"pass 2 {plan.cols} n-tiles a block, grid {plan.grid2} = {plan.blocks2} "
                   f"blocks, {plan.smem2} B shared")


def e_plan_text(x, heads):
    return attn_plan_text(attn_plan(*x.shape, heads, sm_count(x.device.index or 0)))


def phase_g_route_timing(model, cfg, g, card):
    """The eval protocol at B=8, N=4 in bf16 on Kernel G's route
    (FUSED_MLP_EVAL: A, B and G; the attention halves on modules), kernels
    on and off, and a profile of the kernels-on step with G's ms and calls
    per step."""
    step = eval_steps(model, cfg, lambda on: model.set_kernels(on, False, on), 8, 4, g)
    log("  Kernel G's route:")
    eval_timing(step, 8, 4, 3, card)
    reset_launches()
    wall, busy, launches, top = profile_steps(step(True), 2)
    g_ms = sum(t for name, t, _ in top if "mlp32_kernel" in name or "mlp32_finish" in name)
    calls = launch_counts()
    log(f"  profile, G's route, kernels on: wall {wall:.2f} ms/step under the profiler, device "
        f"busy {busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step; Kernel G {g_ms:.3f} ms/step in {calls['mlp_dwbn'] // 3} calls/step "
        f"(E {calls['window_attn_block']}, F {calls['mlp_block']} calls in all); top kernels "
        f"(ms/step, launches/step):")
    for name, t, c in top[:12]:
        log(f"    {t:8.3f} {c:6.0f}  {name[:110]}")
    if calls["mlp_dwbn"] < 3 or calls["window_attn_block"] or calls["mlp_block"]:
        raise AssertionError(f"G's route launched other kernels than G's: {calls}")


def phase_hrt_kernel_timing(g, card, shapes=HRT_SHAPES[:4], names=None):
    """E, F and G beside their plain versions at 256x192's branch maps, each
    in its path's dtype (E, F bf16; G f32), with the kernels' weights packed
    once as the model keeps them, by CUDA events, with their device time per
    call (``device_ms``, their plain versions' too) and launch plans beside.
    E falls below 100 us a call, where events over a loop of calls time the
    host: the kernels line takes E's and G's (and their plain versions')
    device time, and the events for F (at 0.2-0.5 ms a call the two agree)."""
    times = {}
    for shape in shapes:
        calls = hrt_kernel_calls(shape, g)
        line = []
        for name, (kernel, plain, args) in calls.items():
            if names is not None and name not in names:
                continue
            dt = PATH_DTYPE[name]
            x = randn(*shape[:4], g=g, dtype=dt)
            d, sms = 4 * shape[3], sm_count(x.device.index or 0)
            if name == "window_attn_block":
                packed = pack_attn(*args[2:], shape[4], dt, x.device)
                plan = e_plan_text(x, shape[4])
            elif name == "mlp_block":
                packed, plan = pack_mlp(*args[-6:], dt, x.device), plan_text(device_plan(x, d))
            else:
                packed = pack_mlp32(*args, x.device)
                plan = plan_text(mlp32_plan(*shape[:4], d, sms))
            fns = (lambda: plain(x, *args), lambda: kernel(x, *args, packed=packed))
            with torch.no_grad():
                t = timing(*alternate(*fns, 10), hrt_bound(name, shape, dt))
                dev = [device_ms(f, 10) for f in fns]
            text = (f"{name} {str(dt)[6:]} kernel {t['ms'] * 1e3:.1f} us, plain "
                    f"{t['plain_ms'] * 1e3:.1f} us by events (device time per call: kernel "
                    f"{dev[1] * 1e3:.1f} us, plain {dev[0] * 1e3:.1f} us); plan {plan}")
            if name != "mlp_block":
                t.update(ms=dev[1], plain_ms=dev[0])
            if shape == shapes[0]:
                times[name] = t
            line.append(f"{text}, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
        log(f"  {shape}: " + "; ".join(line) + f" [{card}]")
    return times


def phase_hrt_train_kernels(g, shapes=HRT_TRAIN_SHAPES):
    """Kernel 9 forward and backward vs its plain version, f32 and bf16, at
    each map: max |err| / max |ref| of out, dx and the ten parameter
    gradients (dbk, 0 in exact arithmetic, over the scale of dbq); a sample
    with s = 0 exactly x and dy; in bf16 two backward calls on the same
    inputs bit-equal (every sum in a fixed order, no atomics)."""
    errs = {}
    for shape in shapes:
        p, h, w, c, heads = shape
        ln, attn, _ = hrt_kernel_args(c, heads, g)
        s = torch.tensor([(0.0 if i % 4 == 1 else 1.25) for i in range(p)], device=DEV)
        for dt in (torch.float32, torch.bfloat16):
            x = (2 * randn(p, h, w, c, g=g)).to(dt)
            cot = randn(p, h, w, c, g=g, dtype=dt)

            def run(fn):
                return fwd_bwd(lambda x_, *prm: fn(x_, s, *prm, heads=heads), (x, *ln, *attn), cot)

            got, gk = run(window_attn_block_train_fused)
            torch.cuda.synchronize()
            same = "" if dt == torch.float32 else "; two backward calls bit-equal"
            if same and not all(torch.equal(a, b) for a, b in
                                zip(gk, run(window_attn_block_train_fused)[1])):
                raise AssertionError(f"kernel 9 {shape} {dt}: two backward calls differ")
            ref, gr = run(window_attn_block_train_torch)
            rels, abs_errs = {}, {}
            for name, a, r in zip(("out",) + HRT_TRAIN_NAMES, (got, *gk), (ref, *gr)):
                if not torch.isfinite(a).all() or a.shape != r.shape:
                    raise AssertionError(f"kernel 9 {shape} {dt} {name}: non-finite or shape")
                scale = (gr[4] if name == "bk" else r).float().abs().max().item()
                abs_errs[name] = (a.float() - r.float()).abs().max().item()
                rels[name] = abs_errs[name] / scale
            worst = max(rels, key=rels.get)
            if rels[worst] > HRT_TOL[dt]:
                raise AssertionError(f"kernel 9 {shape} {dt}: {worst} max|err|/max|ref| "
                                     f"{rels[worst]:.3g} (bound {HRT_TOL[dt]:g})")
            if not (torch.equal(got[1], x[1]) and torch.equal(gk[0][1], cot[1])):
                raise AssertionError(f"kernel 9 {shape} {dt}: a sample with s = 0 is not x, dy")
            if shape == shapes[0] and dt == torch.bfloat16:
                errs = {"window_attn_block_train_fwd": abs_errs["out"],
                        "window_attn_block_train_bwd": max(v for k, v in abs_errs.items()
                                                           if k != "out")}
            log(f"  {shape} {str(dt)[6:]}: max|err|/max|ref| out {rels['out']:.2g}, "
                + " ".join(f"d{k} {rels[k]:.2g}" for k in HRT_TRAIN_NAMES)
                + f"; s = 0 exact{same}; bound {HRT_TOL[dt]:g}")
    return errs


def hrt_train_cfg(dtype: str, use_kernels: bool):
    cfg = presets.hrt_interformer()
    cfg["DEVICE"].update(COMPUTE_DTYPE=dtype, USE_KERNELS=use_kernels,
                         FUSED_BLOCK_TRAIN=use_kernels)
    cfg["PRINT_FREQ"] = 1
    return cfg


def phase_hrt_train_on_off(raw):
    """One f32 HRT training step at dropout 0 and drop path 0 (4 images, 5
    persons) with the kernels on and off: the losses and every gradient,
    kernel 9 launched with the kernels on only."""
    cfg = hrt_train_cfg("float32", True)
    model = seeded_model(cfg)
    model.multi_global_encoder.dropout_rate = 0.0
    for blk in model.singleformer.blocks():
        blk.drop_path = 0.0
    (l_on, g_on, c_on), (l_off, g_off, c_off), (_, g_off2, _) = grads_on_off(
        model, cfg, raw, 4, hrt_kernels(model), routes=(True, False, False))
    if c_on["window_attn_block_train_bwd"] < 1 or c_off["window_attn_block_train_bwd"]:
        raise AssertionError(f"kernel 9 with the kernels on {c_on}, off {c_off}")
    loss_rel = max(abs(l_on[k] - l_off[k]) / abs(l_off[k]) for k in l_off)
    diff, spread = grad_diff(g_on, g_off), grad_diff(g_off2, g_off)
    log(f"  losses on {l_on} vs off {l_off} (worst rel {loss_rel:.3g}, bound {TRAIN_LOSS_REL:g}); "
        f"{len(g_off)} gradients: " + describe_diff(diff) + f" (bounds {HRT_GRAD_BOUND}); two "
        "runs of the route off: " + describe_diff(spread))
    if loss_rel > TRAIN_LOSS_REL or any(diff[k][0] > HRT_GRAD_BOUND[k] for k in diff):
        raise AssertionError("f32 HRT training step with kernels strays from the plain path")


def grad_diff(got, ref):
    """{"max", "l2", "all_l2": (value, leaf)}: the worst leaf's max |dg| over
    max |g| and |dg| over |g|, and |dg| over |g| of all leaves together; the
    leaves in ZERO_GRADS over their module's weight gradient."""
    names = [n for n in ref if ref[n].abs().max() > 0]
    scale = {n: ref[n[:-4] + "weight" if ZERO_GRADS.search(n) else n] for n in names}
    rel = {"max": {n: ((got[n] - ref[n]).abs().max() / scale[n].abs().max()).item()
                   for n in names},
           "l2": {n: ((got[n] - ref[n]).norm() / scale[n].norm()).item() for n in names}}
    out = {k: (v[max(v, key=v.get)], max(v, key=v.get)) for k, v in rel.items()}
    out["all_l2"] = (math.sqrt(sum(((got[n] - ref[n]).double() ** 2).sum().item() for n in names)
                               / sum((scale[n].double() ** 2).sum().item() for n in names)), "all")
    return out


def describe_diff(diff):
    return (f"worst max|dg|/max|g| {diff['max'][0]:.3g} at {diff['max'][1]}, worst |dg|/|g| "
            f"{diff['l2'][0]:.3g} at {diff['l2'][1]}, all together {diff['all_l2'][0]:.3g}")


def hrt_train_bound(shape, dtype, backward: bool):
    """Bound of kernel 9 at one map over the 7-padded windows: the map (x,
    out; backward x, dy, dx), the window tokens t2 and the weights once, and
    the products' multiply-adds: forward q/k/v and out projections and the
    attention (Kernel E's count); backward the q/k/v recompute, dO and dt2
    (7 C^2 per token), the four weight gradients (4 C^2) and six attention
    products per head (6 * 49 * C per token)."""
    p, h, w, c, heads = shape
    el = torch.empty((), dtype=dtype).element_size()
    tp = (h + (-h) % 7) * (w + (-w) % 7)
    weights = 4 * c * c * el + 6 * c * 4
    if not backward:
        return bound(2 * p * h * w * c * el + p * tp * c * el + weights,
                     p * (8.0 * tp * c * c + 4.0 * 49 * tp * c), dtype)
    grads = (4 * c * c + 6 * c) * 4
    return bound(3 * p * h * w * c * el + p * tp * c * el + weights + grads,
                 p * (2.0 * 11 * tp * c * c + 2.0 * 6 * 49 * tp * c), dtype)


def bwd_plan_text(plan):
    """Kernel 9's bf16 backward plan as phase 19 and ``probes/kernel9_probe.py`` print it."""
    return (f"G={plan.group} heads a block, pass 1 {plan.blocks1} blocks, {plan.smem1} B shared; "
            f"pass 2 {plan.cols} n-tiles a block, {plan.blocks2} blocks; weight gradients "
            f"{plan.grid_w[1]} row slices, {plan.blocks_w} blocks")


def phase_hrt_train_kernel_timing(g, card, shapes=HRT_TRAIN_SHAPES[:4]):
    """Kernel 9 forward and backward beside its plain version at 256x192's
    branch maps (bf16, P=24): device time per call (``device_ms``) of each
    and of its plain version, CUDA events over back-to-back calls beside
    them, the forward's plan (E's) and the backward's. The kernels line
    takes the device times (both fall where events over a loop of Python
    calls time the host)."""
    times = {}
    for shape in shapes:
        p, h, w, c, heads = shape
        ln, attn, _ = hrt_kernel_args(c, heads, g)
        x = randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        cot = randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        s = torch.full((p,), 1.25, device=DEV)

        def call(fn):
            return lambda x_, *prm: fn(x_, s, *prm, heads=heads)

        fwd_fns = (lambda: call(window_attn_block_train_torch)(x, *ln, *attn),
                   lambda: call(window_attn_block_train_fused)(x, *ln, *attn))
        with torch.no_grad():
            fwd = timing(*alternate(*fwd_fns, 10), hrt_train_bound(shape, torch.bfloat16, False))
            dev = [device_ms(f, 10) for f in fwd_fns]
        bwd_fns = [backward_only(call(fn), (x, *ln, *attn), cot)
                   for fn in (window_attn_block_train_torch, window_attn_block_train_fused)]
        bwd = timing(*alternate(*bwd_fns, 10), hrt_train_bound(shape, torch.bfloat16, True))
        dev_b = [device_ms(f, 10) for f in bwd_fns]
        log(f"  kernel 9 {shape} bf16: forward device time per call kernel {dev[1] * 1e3:.1f} us, "
            f"plain {dev[0] * 1e3:.1f} us (events {fwd['ms'] * 1e3:.1f}, "
            f"{fwd['plain_ms'] * 1e3:.1f} us; plan {e_plan_text(x, heads)}), bound "
            f"{fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']}); backward device time per call "
            f"kernel {dev_b[1] * 1e3:.1f} us, plain {dev_b[0] * 1e3:.1f} us (events "
            f"{bwd['ms'] * 1e3:.1f}, {bwd['plain_ms'] * 1e3:.1f} us; plan "
            f"{bwd_plan_text(attn_bwd_plan(*shape, sm_count(0)))}), bound "
            f"{bwd['bound_ms'] * 1e3:.2f} us ({bwd['bound_by']}) [{card}]")
        fwd.update(ms=dev[1], plain_ms=dev[0])
        bwd.update(ms=dev_b[1], plain_ms=dev_b[0])
        if shape == shapes[0]:
            times = {"window_attn_block_train_fwd": fwd, "window_attn_block_train_bwd": bwd}
    return times


def full_block_args(c, heads, g):
    """Random weights of one HRFormer block in kernel 7's order: LN1, the four
    projections, LN2, the folded MlpDWBN's (see ``hrt_kernel_args``)."""
    ln, attn, mlp = hrt_kernel_args(c, heads, g)
    return (*ln, *attn, 1 + 0.2 * randn(c, g=g), 0.1 * randn(c, g=g), *mlp)


def kernel7_plan(shape, dtype):
    """(blocks per SM, grid, shared memory bytes, MLP tile rows and columns,
    hidden slices) of kernel 7's cooperative launch at one map, as the kernel
    library computes it: E's and F's plans (``attn_plan``, ``mlp_plan``) in
    bf16; in f32 the CUDA-core templates' own items and one slice."""
    p, h, w, c, heads = shape
    group, cols, th, tw, slices = 0, 0, 0, 0, 1
    if dtype == torch.bfloat16:
        plan = mlp_plan(p, h, w, c, 4 * c, sm_count(0))
        th, tw, slices = plan.th, plan.tw, plan.slices
        e_plan = attn_plan(p, h, w, c, heads, sm_count(0))
        group, cols = e_plan.group, e_plan.cols
    out = (ctypes.c_int * 5)()
    build.check(build.library().i2r_full_block_plan(p, h, w, c, heads, 4 * c, group, cols, th, tw,
                                                    slices, DTYPE_CODES[dtype], out),
                "full_block plan")
    return (*out, slices)


def phase_full_block(g):
    """Kernel 7 vs its plain version at each map, f32 and bf16, and vs E then
    F on the same input: both within HRT_TOL of max|ref|; returns the main
    map's bf16 error and the largest |difference| from E then F."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main_err, worst = None, 0.0
    for shape in HRT_SHAPES:
        p, h, w, c, heads = shape
        args = full_block_args(c, heads, g)
        for dt in (torch.float32, torch.bfloat16):
            x = (2 * randn(p, h, w, c, g=g)).to(dt)
            got = full_block_fused(x, *args, heads=heads)
            two = mlp_block_fused(window_attn_block_fused(x, *args[:10], heads=heads), *args[10:])
            torch.cuda.synchronize()
            ref = full_block_torch(x, *args, heads).float()
            if not torch.isfinite(got).all() or got.shape != x.shape or got.dtype != dt:
                raise AssertionError(f"full_block {shape} {dt}: {got.dtype} {tuple(got.shape)}")
            scale = ref.abs().max().item()
            err = (got.float() - ref).abs().max().item()
            diff = (got.float() - two.float()).abs().max().item()
            if err / scale > HRT_TOL[dt] or diff / scale > HRT_TOL[dt]:
                raise AssertionError(f"full_block {shape} {dt}: max|err|/max|ref| {err / scale:.3g}"
                                     f", vs E then F {diff / scale:.3g} (bound {HRT_TOL[dt]:g})")
            worst = max(worst, diff)
            if (shape, dt) == (HRT_SHAPES[0], torch.bfloat16):
                main_err = err
            per_sm, grid, smem, th, tw, slices = kernel7_plan(shape, dt)
            same = "bit-equal" if torch.equal(got, two) else f"max|diff| {diff:.3g}"
            log(f"  {shape} {str(dt)[6:]}: max|err| {err:.3g} ({err / scale:.2g} of max|ref|, "
                f"bound {HRT_TOL[dt]:g}); vs E then F: {same}; grid {grid} blocks ({sms} SMs x "
                f"{per_sm} resident), {smem} B shared; MLP phase {th}x{tw} tiles, "
                f"{slices} hidden slice(s)")
    return main_err, worst


def onepass_cfg(image_size=(192, 256)):
    """``hrt_interformer`` at ``image_size`` with FUSED_BLOCK_EVAL_ONEPASS on."""
    cfg = presets.hrt_interformer(image_size)
    cfg["DEVICE"]["FUSED_BLOCK_EVAL_ONEPASS"] = True
    return cfg


def use_kernels(model):
    """DEVICE.USE_KERNELS on or off in the HRT model, every block keeping the
    routes its config chose."""
    def switch(on):
        model.multi_global_encoder.use_kernels = on
        for blk in model.singleformer.blocks():
            blk.use_kernels = on
    return switch


def phase_onepass_model(cfg, g):
    """The full-width HRFormer-B I²R-Net built from ``cfg`` (one-pass knob on)
    in f32, kernels on vs off: kernel 7, A and B launched, E, F, G not."""
    model = random_model(cfg, g)
    if not all(blk.fused_block and blk.fused_onepass for blk in model.singleformer.blocks()):
        raise AssertionError("FUSED_BLOCK_EVAL_ONEPASS did not reach the blocks")
    images, pos, valid = person_inputs(cfg, 8, 4, HRT_COUNTS, g)
    switch = use_kernels(model)
    with torch.no_grad():
        switch(False)
        off = model(images, pos, valid)
        reset_launches()
        switch(True)
        on = model(images, pos, valid)
        torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    check_heatmaps(on, off, valid, "one-pass", counts)
    if any(counts.get(k, 0) < 1 for k in ONEPASS_KERNELS) or any(k in counts for k in NOT_ONEPASS):
        raise AssertionError(f"the one-pass route launched {counts}")
    return model


def phase_onepass_timing(model, cfg, g, card):
    """The eval protocol on the one-pass route, on E + F and kernels off; a
    profile of the one-pass step; kernel 7 per branch map (bf16, weights
    packed once) beside its plain version, E then F and its bound, by CUDA
    events, with kernel 7's and E then F's device time per call beside."""
    routes = {"one-pass": (True, True, False, True, True), "E + F": (True, True, False, True),
              "off": (False,)}
    step = eval_steps(model, cfg, lambda route: model.set_kernels(*routes[route]), 8, 4, g)
    t = dict(zip(routes, in_turns([step(r) for r in routes], 3)))
    log("  eval protocol B=8 N=4 bf16 (2 forwards + DARK decode), order one-pass, E + F, off, "
        "off, E + F, one-pass: " + ", ".join(f"{r} {v:.2f} ms = {32 / v * 1e3:.1f} persons/s"
                                             for r, v in t.items()) + f" [{card}]")
    wall, busy, launches, top = profile_steps(step("one-pass"), 2)
    log(f"  profile, one-pass: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step; top kernels (ms/step, launches/step):")
    for name, ms, c in top[:12]:
        log(f"    {ms:8.3f} {c:6.0f}  {name[:110]}")
    times = {}
    bf = torch.bfloat16
    for shape in HRT_SHAPES[:4]:
        p, h, w, c, heads = shape
        args = full_block_args(c, heads, g)
        x = randn(p, h, w, c, g=g, dtype=bf)
        pa, pm = pack_attn(*args[2:10], heads, bf, x.device), pack_mlp(*args[12:], bf, x.device)
        fns = [lambda: full_block_torch(x, *args, heads),
               lambda: full_block_fused(x, *args, heads=heads, packed=(pa, pm)),
               lambda: mlp_block_fused(window_attn_block_fused(x, *args[:10], heads=heads,
                                                               packed=pa), *args[10:], packed=pm)]
        with torch.no_grad():
            plain, ms, two = in_turns(fns, 10)
            dev = [device_ms(f, 10) for f in fns[1:]]
        tm = timing(plain, ms, hrt_bound("full_block", shape, bf))
        if shape == HRT_SHAPES[0]:
            times["full_block"] = tm
        log(f"  kernel 7 {shape} bf16: kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, E "
            f"then F {two * 1e3:.1f} us by events (device time per call: kernel "
            f"{dev[0] * 1e3:.1f} us, E then F {dev[1] * 1e3:.1f} us), bound "
            f"{tm['bound_ms'] * 1e3:.2f} us ({tm['bound_by']}) [{card}]")
    return times


def fixture_cfg():
    """W48-pure-en6 reading the fixture, B=16 (two batches of its 32 images)."""
    cfg = presets.w48_pure_en6()
    cfg["DATASET"]["ROOT"] = str(FIXTURE)
    cfg["TEST"]["BATCH_SIZE_PER_GPU"] = VAL_BATCH
    return cfg


def phase_decode(card, digests=FIXTURE / "decoded.sha256", folder=FIXTURE / "images" / "val2017"):
    """Every fixture JPEG under ``folder`` decoded by ``data/jpeg.py``; each
    digest must equal cv2.imread's (``digests``). Returns ms per image."""
    import PIL

    want = {}
    for line in digests.read_text().splitlines():
        digest, name = line.split()
        want[name] = digest
    paths = sorted(folder.glob("*.jpg"))
    if [p.name for p in paths] != sorted(want):
        raise AssertionError(f"fixture images {[p.name for p in paths]} vs digests {sorted(want)}")
    images = [imread(str(p)) for p in paths]
    bad = [p.name for p, img in zip(paths, images)
           if hashlib.sha256(img.tobytes()).hexdigest() != want[p.name]]
    if bad:
        raise AssertionError(f"decoded bytes differ from cv2.imread's: {bad}")
    t0 = time.perf_counter()
    for p in paths:  # again, the files read once
        imread(str(p))
    ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    sizes = sorted({f"{img.shape[1]}x{img.shape[0]}" for img in images})
    log(f"  {len(paths)} JPEGs of {', '.join(sizes)} under {folder.relative_to(FIXTURE.parent)} "
        f"decoded with Pillow {PIL.__version__}: every SHA-256 equals cv2.imread's; {ms:.3f} ms "
        f"per image (host clock, second pass) [{card}]")
    return ms


def timed_evaluate(ds):
    """Wrap ``ds.evaluate`` (NMS, results JSON, evaluator): its host seconds
    are appended to the returned list."""
    spent, evaluate = [], ds.evaluate

    def timed(*args):
        t0 = time.perf_counter()
        out = evaluate(*args)
        spent.append(time.perf_counter() - t0)
        return out

    ds.evaluate = timed
    return spent


def validate_run(cfg, ds, model, name, **kw):
    """``validate`` into ``OUT_DIR / name``: (name_value, results, host seconds
    of the whole call, of its ``evaluate``)."""
    out = OUT_DIR / name
    shutil.rmtree(out, ignore_errors=True)
    spent = timed_evaluate(ds)
    t0 = time.perf_counter()
    name_value, _ = validate(cfg, ds, model, str(out), device=DEV, **kw)
    wall = time.perf_counter() - t0
    del ds.evaluate
    results = json.loads((out / "results" / f"keypoints_{ds.image_set}_results.json").read_text())
    return name_value, results, wall, spent[0]


def per_image(results):
    counts = {}
    for r in results:
        counts[str(r["image_id"])] = counts.get(str(r["image_id"]), 0) + 1
    return counts


def phase_validate_oracle(cfg, ds, fixture=FIXTURE, name="validate_oracle"):
    """``validate`` with the GT-heatmap oracle (targets rendered and decoded on
    the card) against the JAX validate's result on the fixture."""
    expected = json.loads((fixture / "expected.json").read_text())
    name_value, results, _, _ = validate_run(cfg, ds, None, name,
                                             eval_step_fn=lambda _model, batch: batch["target"])
    diff = {k: abs(name_value[k] - v) for k, v in expected["stats"].items()}
    bands = "".join(f", {k} {name_value[k]:.6f}" for k in ("AP (easy)", "AP (medium)", "AP (hard)")
                    if k in name_value)
    log(f"  GT oracle: AP {name_value['AP']:.6f}, AR {name_value['AR']:.6f}{bands}, "
        f"{len(results)} results; largest |stat - JAX stat| {max(diff.values()):.3g} "
        f"(bound {ORACLE_TOL:g})")
    if (set(name_value) != set(expected["stats"]) or max(diff.values()) > ORACLE_TOL
            or name_value["AP"] <= ORACLE_MIN_AP
            or per_image(results) != expected["results_per_image"]):
        raise AssertionError(f"oracle validate {dict(name_value)} vs {expected['stats']}; "
                             f"results per image {per_image(results)}")


def phase_validate_model(cfg, ds, g, card, name="validate"):
    """``validate`` with the seeded, calibrated model of ``cfg`` in bf16,
    kernels on then off: A and B launched once a layer of each encoder and
    forward (W48: 12 times a batch, 6 layers and 2 forwards; TPH: 20, 6 + 4
    layers) with them on, never with them off; the same results within phase
    6's bound."""
    model = random_model(cfg, g)
    model.compute_dtype = torch.bfloat16
    n_batches = len(list(ds.eval_batches(VAL_BATCH)))
    switch = model.set_kernels
    want = 2 * sum(len(encoder.layers) for encoder in model.encoders()) * n_batches
    runs = {}
    switch(True)
    validate_run(cfg, ds, model, f"{name}_warmup")  # first calls at these shapes
    for on in (True, False):
        switch(on)
        torch.cuda.synchronize()
        reset_launches()
        runs[on] = validate_run(cfg, ds, model, f"{name}_{'on' if on else 'off'}")
        torch.cuda.synchronize()
        counts = {k: launch_counts()[k] for k in EVAL_KERNELS}
        if counts != {k: want if on else 0 for k in EVAL_KERNELS}:
            raise AssertionError(f"kernels {'on' if on else 'off'}: launches {counts}, want "
                                 f"{want if on else 0} each ({n_batches} batches)")
        runs[on] += (counts,)
    (nv_on, res_on, wall, eval_s, counts), (nv_off, res_off, *_) = runs[True], runs[False]
    persons = sum(len(r["annos"]) for r in ds.db)
    log(f"  seeded model, bf16: {len(res_on)} results; launches per batch with the kernels on "
        f"{ {k: v // n_batches for k, v in counts.items()} }, none off; AP kernels on "
        f"{nv_on['AP']:.6f}, off {nv_off['AP']:.6f}; "
        + results_diff(res_on, res_off, "validate with the kernels strays from the plain path"))
    log(f"  validate, kernels on: {persons} persons in {wall * 1e3:.1f} ms, of which evaluate "
        f"(NMS, results JSON, evaluator) {eval_s * 1e3:.1f} ms; {persons / (wall - eval_s):.1f} "
        f"persons/s including host IO, evaluate excluded [{card}]")
    return model


def results_diff(got, ref, fault):
    """Phase 6's bound between two results files of ``validate``: the same
    entries (image, center, scale), the largest confidence difference within
    5% of the largest confidence, the median keypoint within 1 px; raises
    ``fault`` otherwise, else returns the differences as text."""
    def keyed(results):
        return {(r["image_id"], *r["center"], *r["scale"]): r for r in results}

    a, b = keyed(got), keyed(ref)
    if len(a) != len(got) or set(a) != set(b):
        raise AssertionError(f"results JSONs hold other entries: {len(got)} vs {len(ref)}, "
                             f"{len(set(a) ^ set(b))} differ")
    kp_a = np.array([a[k]["keypoints"] for k in a]).reshape(len(a), -1, 3)
    kp_b = np.array([b[k]["keypoints"] for k in a]).reshape(len(a), -1, 3)
    conf_err = np.abs(kp_a[..., 2] - kp_b[..., 2]).max() / np.abs(kp_b[..., 2]).max()
    xy_err = np.abs(kp_a[..., :2] - kp_b[..., :2]).max(-1)
    text = (f"max|dconf|/max|conf| {conf_err:.3g}, |dxy| median {np.median(xy_err):.3g} px, "
            f"max {xy_err.max():.3g} px, share within 1 px {np.mean(xy_err <= 1.0):.3f}")
    if conf_err > 0.05 or np.median(xy_err) > 1.0:
        raise AssertionError(f"{fault}: {text}")
    return text


def phase_validate_split(model, cfg, ds, decode_ms, card):
    """The time per batch of the host and device parts of validate, kernels on."""
    model.global_encoder.use_kernels = True
    evaluate = make_eval_fn(cfg, model, ds.flip_pairs)
    raw_ms, dev_ms = [], []
    for items, nb in ds.eval_batches(VAL_BATCH):
        t0 = time.perf_counter()
        raw, meta = ds.make_raw_batch(items, nb)
        raw_ms.append((time.perf_counter() - t0) * 1e3)
        b, n = raw["person_valid"].shape
        centers = torch.from_numpy(meta["center"].reshape(b * n, 2)).to(DEV)
        scales = torch.from_numpy(meta["scale"].reshape(b * n, 2)).to(DEV)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        batch = ds.device_batch(raw, DEV)
        evaluate(batch["images"], batch["pos_masks"], batch["person_valid"], centers, scales)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end))
    log(f"  per batch of {VAL_BATCH} images: JPEG decode {decode_ms * VAL_BATCH:.1f} ms "
        f"({decode_ms:.3f} ms an image), make_raw_batch {np.mean(raw_ms):.1f} ms (decode "
        f"included; {', '.join(f'{t:.1f}' for t in raw_ms)}), device {np.mean(dev_ms):.2f} ms "
        f"by CUDA events (copy in, preprocess, 2 forwards, decode; "
        f"{', '.join(f'{t:.2f}' for t in dev_ms)}) [{card}]")


def device_randn(*shape, seed, dtype):
    """Normal values made on the card from ``seed`` (the larger inputs)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=DEV).to(dtype)


def chunked(fn, p, size=TPH_CHUNK):
    """``fn(q, k, v, first)`` over persons in chunks of ``size`` from person
    ``first`` (where the plain version's [P, S, S] logits would not fit at
    once)."""
    return lambda q, k, v: torch.cat([fn(q[i:i + size], k[i:i + size], v[i:i + size], i)
                                      for i in range(0, p, size)])


def tail_tile_matters(plain, ref, check, mask, what):
    """Raises unless ``plain(key mask)``, the plain version with the last tile
    of keys (KEY_TILE, or the ragged rest of S) masked besides ``mask``,
    fails ``check`` (a comparison with ``ref`` that raises): a kernel that
    dropped that tile would fail it too."""
    p, s = ref.shape[:2]
    tail = s - (s - 1) // KEY_TILE * KEY_TILE
    dropped = torch.zeros(p, s, dtype=torch.bool, device=ref.device)
    dropped[:, -tail:] = True
    if mask is not None:
        dropped |= mask
    try:
        check(plain(dropped))
    except AssertionError:
        return
    raise AssertionError(f"{what}: dropping the last {tail} keys stays within the bound, so "
                         "the check could not see it")


def phase_tph_kernels(card, attn=TPH_ATTN, rows=TPH_FFN[0]):
    """Kernels A and B at the TPH intra encoder's shapes against their plain
    versions, f32 and bf16 (A over [P, S, 96] for each (P, S) of ``attn``
    without a key mask, held per TPH_CHUNK persons; B at ``rows``); then, in
    bf16, each shape's device time per call beside its plain version's, its
    bound and, for A, one SDPA call (no mask). Returns ({shape label:
    timing}, {shape label: bf16 max |err|})."""
    c, f = 96, 192
    times, errs = {}, {}
    for p, s in attn:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (device_randn(p, s, c, seed=SEED + i, dtype=dt) for i in range(3))
            q = q * TPH_PEAK  # logits of deviation TPH_PEAK: outputs of order |v|
            got = masked_mhsa_fused(q, k, v, 1)
            torch.cuda.synchronize()
            err, ref_max = 0.0, 0.0
            for i in range(0, p, TPH_CHUNK):
                qi, ki, vi = q[i:i + TPH_CHUNK], k[i:i + TPH_CHUNK], v[i:i + TPH_CHUNK]
                ref = masked_mhsa_torch(qi, ki, vi, 1)
                what = f"masked_mhsa P={p} S={s} {dt} persons {i}.."
                err = max(err, compare(got[i:i + TPH_CHUNK], ref, dt, what))
                ref_max = max(ref_max, ref.abs().max().item())
                if i == 0:
                    tail_tile_matters(lambda m: masked_mhsa_torch(qi, ki, vi, 1, m), ref,
                                      lambda miss: compare(miss, ref, dt, what), None, what)
                del ref
            errs[f"A P={p} S={s}"] = err
            log(f"  masked_mhsa P={p} S={s} C={c} no mask {str(dt)[6:]}: max|err| {err:.3g}, "
                f"max|ref| {ref_max:.3g}, bound atol {TOL[dt][0]:g} + rtol {TOL[dt][1]:g}*|ref|"
                + (f" per {TPH_CHUNK}-person chunk" if p > TPH_CHUNK else "")
                + "; the plain version without the last key tile breaks that bound; finite")
            del q, k, v, got
        torch.cuda.empty_cache()
    p_ffn = ffn_params(c, f, gen(SEED))
    for dt in (torch.float32, torch.bfloat16):
        x = (2 * device_randn(rows, c, seed=SEED + 3, dtype=torch.float32) + 0.5).to(dt)
        got = encoder_ffn_fused(x, *p_ffn)
        torch.cuda.synchronize()
        err = compare(got, encoder_ffn_torch(x, *p_ffn), dt, f"encoder_ffn rows={rows} {dt}")
        errs[f"B R={rows}"] = err
        log(f"  encoder_ffn rows={rows} C={c} F={f} {str(dt)[6:]}: max|err| {err:.3g} "
            f"(atol/rtol {TOL[dt][0]:g}/{TOL[dt][1]:g}), finite")
    bf = torch.bfloat16
    for p, s in attn:
        q, k, v = (device_randn(p, s, c, seed=SEED + 4 + i, dtype=bf) for i in range(3))
        heads = [t.view(p, s, 1, c).transpose(1, 2) for t in (q, k, v)]
        plain = chunked(lambda q_, k_, v_, _: masked_mhsa_torch(q_, k_, v_, 1), p)
        with torch.no_grad():
            t_plain, ms, lib = plain_kernel_sdpa(
                f"masked_mhsa P={p} S={s} no mask", [
                    lambda: plain(q, k, v), lambda: masked_mhsa_fused(q, k, v, 1),
                    lambda: torch.nn.functional.scaled_dot_product_attention(*heads)],
                10 if p <= TPH_CHUNK else 3, card)
        no_mask = torch.zeros(p, s, dtype=torch.bool)
        times[f"A P={p} S={s}"] = timing(t_plain, ms, bound(4 * nbytes(q),
                                                            attention_ops(no_mask, c, 2), bf), lib)
        del q, k, v, heads
        torch.cuda.empty_cache()
    x = device_randn(rows, c, seed=SEED + 7, dtype=bf)
    with torch.no_grad():
        t_plain, ms = plain_kernel_sdpa(f"encoder_ffn rows={rows}",
                                        [lambda: encoder_ffn_torch(x, *p_ffn),
                                         lambda: encoder_ffn_fused(x, *p_ffn)], 10, card)
    times[f"B R={rows}"] = timing(t_plain, ms, bound(2 * nbytes(x) + (2 * c * f + 5 * c + f) * 4,
                                                     4.0 * rows * c * f, bf))
    for name, t in times.items():
        lib = "" if t["library_ms"] is None else (f", SDPA {t['library_ms'] * 1e3:.1f} us "
                                                  f"(kernel/SDPA {t['ms'] / t['library_ms']:.2f})")
        log(f"  {name} C={c} bf16 (device time): kernel {t['ms'] * 1e3:.1f} us, plain "
            f"{t['plain_ms'] * 1e3:.1f} us{lib}, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}) [{card}]")
    return times, errs


def phase_tph_model(cfg, g):
    """The full-width TPH I²R-Net in f32, B=2 x N=4 with ragged persons:
    kernels on vs off, heatmaps multi and single within phase 15's bound, A and
    B launched TPH_LAUNCHES times each in the forward and nothing else."""
    model = random_model(cfg, g)
    images, pos, valid = person_inputs(cfg, 2, 4, TPH_COUNTS, g)
    with torch.no_grad():
        model.set_kernels(False)
        off = model(images, pos, valid)
        reset_launches()
        model.set_kernels(True)
        on = model(images, pos, valid)
        torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    check_heatmaps(on, off, valid, "A + B", counts)
    if counts != dict.fromkeys(EVAL_KERNELS, TPH_LAUNCHES):
        raise AssertionError(f"the TPH forward launched {counts}, want {TPH_LAUNCHES} of each "
                             f"of {EVAL_KERNELS}")
    return model


def phase_tph_timing(model, cfg, g, card):
    """The TPH eval protocol at B=16 x N=4 in bf16, kernels on and off in
    turns; a profile of the kernels-on step with Kernels A's and B's ms and
    launches per step split between the intra and the inter encoder
    (``split_by_encoder``)."""
    b, n = 16, 4
    step = eval_steps(model, cfg, model.set_kernels, b, n, g)
    eval_timing(step, b, n, 3, card)
    with encoder_launches(EVAL_KERNELS) as order:
        step(True)()
        torch.cuda.synchronize()
    events, steps = [], 2
    wall, busy, launches, top = profile_steps(step(True), steps, events)
    log(f"  profile, kernels on: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step; top kernels (ms/step, launches/step):")
    for name, t, c in top[:12]:
        log(f"    {t:8.3f} {c:6.0f}  {name[:110]}")
    split_by_encoder(events, order, (("masked_mhsa", ("mhsa_fwd",)), ("encoder_ffn", KERNEL_B)),
                     steps, card)


def person_key_mask(counts, tokens, n=None):
    """[B, N * tokens] key-padding mask of B = len(counts) images with
    ``counts`` valid persons of N slots (N = B unless given; the inter
    encoder's, ``models/interformer.py``)."""
    n = len(counts) if n is None else n
    valid = torch.arange(n)[None, :] < torch.as_tensor(counts)[:, None]
    return (~valid).repeat_interleave(tokens, dim=1).to(DEV)


def check_tph_attention_train(p, s, mask, dt, bits, c=96):
    """Kernel C forward and backward on [P, S, C] (q scaled by TPH_PEAK)
    against its plain version per TPH_TRAIN_CHUNK persons, in bits and seed
    mode; the plain version without the last key tile breaks the bound.
    Returns {mode: (max|err| out, its share of max|ref|, max over dq/dk/dv)}."""
    q, k, v, cot = (device_randn(p, s, c, seed=SEED + 10 + i, dtype=dt) for i in range(4))
    q = q * TPH_PEAK  # logits of deviation TPH_PEAK: outputs of order |v|
    res = {}
    for mode in ("bits", "seed"):
        kw = ({"dropout_bits": bits} if mode == "bits"
              else {"dropout_seed": TPH_SEED, "dropout_offset": TPH_OFFSET})
        got, gk = fwd_bwd(lambda *a: masked_mhsa_train_fused(*a, 1, mask, RATE, **kw),
                          (q, k, v), cot)
        torch.cuda.synchronize()
        e_f, r_f, e_b = 0.0, 0.0, 0.0
        for i in range(0, p, TPH_TRAIN_CHUNK):
            j = min(p, i + TPH_TRAIN_CHUNK)
            cb = (bits[i:j] if mode == "bits"
                  else attention_bits(TPH_SEED, TPH_OFFSET, j - i, s, DEV, first=i))
            mk = None if mask is None else mask[i:j]
            ref, gr = fwd_bwd(lambda *a: masked_mhsa_train_torch(*a, 1, mk, RATE, dropout_bits=cb),
                              (q[i:j], k[i:j], v[i:j]), cot[i:j])
            what = f"mhsa_train P={p} S={s} {str(dt)[6:]} {mode} persons {i}..{j - 1}"
            e, r = compare_scaled(got[i:j], ref, dt, what + " out")
            e_f, r_f = max(e_f, e), max(r_f, r)
            e_b = max([e_b] + [compare_scaled(x[i:j], y, dt, f"{what} d{n}")[0]
                               for n, x, y in zip("qkv", gk, gr)])
            if i == 0:
                tail_tile_matters(
                    lambda m: masked_mhsa_train_torch(q[i:j], k[i:j], v[i:j], 1, m, RATE,
                                                      dropout_bits=cb),
                    ref, lambda miss: compare_scaled(miss, ref, dt, what), mk, what)
            del ref, gr, cb
        res[mode] = (e_f, r_f, e_b)
        del got, gk
    return res


def phase_tph_train_kernels(card):
    """Kernels C and D at the TPH training shapes against their plain
    versions, f32 and bf16, bits and seed mode (C per TPH_TRAIN_CHUNK
    persons); the seed-mode keep fraction over a whole intra-encoder draw;
    then, bf16 seed mode, C at P=16 and D at P=16 x 3072 rows as device time
    per call beside their plain versions, their bounds and, for C, SDPA with
    dropout 0.1. Returns ({kernel: TPH-shape fields for the kernels line},
    {kernel: max|err| in bf16 seed mode at P=16})."""
    c, f = 96, 192
    dgen = torch.Generator(device=DEV).manual_seed(SEED)
    errs = {}
    for p, s in TPH_TRAIN_ATTN:
        mask = None if s == TPH_TOKENS else person_key_mask(TPH_TRAIN_COUNTS, s // 4)
        bits = torch.randint(0, 2 ** 32, (p, s, s), generator=dgen, device=DEV,
                             dtype=torch.int64)
        for dt in (torch.float32, torch.bfloat16):
            res = check_tph_attention_train(p, s, mask, dt, bits)
            for mode, (e_f, r_f, e_b) in res.items():
                log(f"  mhsa_train P={p} S={s} C={c} "
                    f"{'no mask' if mask is None else 'person mask ' + str(TPH_TRAIN_COUNTS)} "
                    f"{str(dt)[6:]} {mode}: out max|err| {e_f:.3g} ({r_f:.2g} of max|ref|), "
                    f"dq/dk/dv max|err| {e_b:.3g}; bound {TRAIN_TOL[dt][0]:g}*max|ref| + "
                    f"{TRAIN_TOL[dt][1]:g}*|ref|; the plain version without the last key tile "
                    "breaks it")
            if (p, dt) == (TPH_TRAIN_ATTN[0][0], torch.bfloat16):
                errs["mhsa_train_fwd"], _, errs["mhsa_train_bwd"] = res["seed"]
        del bits
        torch.cuda.empty_cache()
    kept, total = 0, 0
    p0, s0 = TPH_TRAIN_ATTN[0]
    for i in range(0, p0, TPH_TRAIN_CHUNK):
        b = attention_bits(TPH_SEED, TPH_OFFSET, min(p0 - i, TPH_TRAIN_CHUNK), s0, DEV, first=i)
        kept += int((b >= threshold(RATE)).sum())
        total += b.numel()
        del b
    log(f"  seed-mode keep fraction over the [{p0}, {s0}, {s0}] draw ({total} bits): "
        f"{kept / total:.6f} (1 - rate = {1 - RATE})")
    if abs(kept / total - (1 - RATE)) > 1e-3:
        raise AssertionError(f"keep fraction {kept / total} strays from {1 - RATE}")
    g = gen(SEED + 5)
    for rows in TPH_TRAIN_FFN:
        prm = ffn_params(c, f, g)
        bits = (torch.randint(0, 2 ** 32, (rows, f), generator=dgen, device=DEV, dtype=torch.int64),
                torch.randint(0, 2 ** 32, (rows, c), generator=dgen, device=DEV, dtype=torch.int64))
        for dt in (torch.float32, torch.bfloat16):
            x = away_from_kink((2 * randn(rows, c, g=g) + 0.5).to(dt), prm, g)
            cot = randn(rows, c, g=g, dtype=dt)
            for mode in ("bits", "seed"):
                kw = ({"dropout_bits": bits} if mode == "bits"
                      else {"dropout_seed": TPH_SEED, "dropout_offset": TPH_OFFSET + 2})

                def run(fn):
                    return fwd_bwd(lambda *a: fn(*a, dropout_rate=RATE, **kw), (x, *prm), cot)

                got, gk = run(encoder_ffn_train_fused)
                torch.cuda.synchronize()
                ref, gr = run(encoder_ffn_train_torch)
                what = f"encoder_ffn_train rows={rows} C={c} F={f} {str(dt)[6:]} {mode}"
                e_f, r_f = compare_scaled(got, ref, dt, what + " out")
                names = ("x", "ln1_w", "ln1_b", "w1", "b1", "w2", "b2", "ln2_w", "ln2_b")
                e_b = [compare_scaled(a, r, dt, f"{what} d{n}") for n, a, r in zip(names, gk, gr)]
                if (rows, dt, mode) == (TPH_TRAIN_FFN[0], torch.bfloat16, "seed"):
                    errs["encoder_ffn_train_fwd"] = e_f
                    errs["encoder_ffn_train_bwd"] = max(e for e, _ in e_b)
                log(f"  {what}: out max|err| {e_f:.3g} ({r_f:.2g}), grads max of "
                    f"max|err|/max|ref| {max(r for _, r in e_b):.2g}")
        del bits
    torch.cuda.empty_cache()
    return tph_train_kernel_timing(card), errs


def tph_train_kernel_timing(card):
    """C over [16, 3072, 96] unmasked and D over 16 x 3072 rows, bf16, seed
    mode: device time per call of the kernel, its plain version (C per
    TPH_TRAIN_CHUNK persons, its bits drawn per chunk) and, for C, SDPA with
    dropout 0.1 (its own bits), forward and backward; with their bounds."""
    p, s = TPH_TRAIN_ATTN[0]
    c, f = 96, 192
    bf = torch.bfloat16
    q, k, v, cot = (device_randn(p, s, c, seed=SEED + 20 + i, dtype=bf) for i in range(4))
    kw = {"dropout_seed": TPH_SEED, "dropout_offset": TPH_OFFSET}

    def kernel(q_, k_, v_):
        return masked_mhsa_train_fused(q_, k_, v_, 1, None, RATE, **kw)

    # its seed-mode bits drawn a chunk at a time, as phase 27 checks it
    plain = chunked(lambda q_, k_, v_, first: masked_mhsa_train_torch(
        q_, k_, v_, 1, None, RATE,
        dropout_bits=attention_bits(TPH_SEED, TPH_OFFSET, q_.shape[0], s, DEV, first=first)),
        p, TPH_TRAIN_CHUNK)

    def sdpa(q_, k_, v_):
        heads = [t.view(p, s, 1, c).transpose(1, 2) for t in (q_, k_, v_)]
        return torch.nn.functional.scaled_dot_product_attention(*heads, dropout_p=RATE)

    times = {}
    with torch.no_grad():
        times["mhsa_train_fwd"] = plain_kernel_sdpa(
            f"mhsa_train_fwd P={p} S={s} no mask", [lambda: plain(q, k, v), lambda: kernel(q, k, v),
                                                   lambda: sdpa(q, k, v)], 3, card)
    times["mhsa_train_bwd"] = plain_kernel_sdpa(
        f"mhsa_train_bwd P={p} S={s} no mask",
        [backward_only(plain, (q, k, v), cot), backward_only(kernel, (q, k, v), cot),
         backward_only(sdpa, (q, k, v), cot.view(p, s, 1, c).transpose(1, 2))], 3, card)
    rows = TPH_TRAIN_FFN[0]
    prm = ffn_params(c, f, gen(SEED + 6))
    x = device_randn(rows, c, seed=SEED + 30, dtype=bf)
    cot2 = device_randn(rows, c, seed=SEED + 31, dtype=bf)

    def tail(fn):
        return lambda *a: fn(*a, dropout_rate=RATE, dropout_seed=TPH_SEED,
                             dropout_offset=TPH_OFFSET + 2)

    with torch.no_grad():
        times["encoder_ffn_train_fwd"] = plain_kernel_sdpa(
            f"encoder_ffn_train_fwd rows={rows}", [lambda: tail(encoder_ffn_train_torch)(x, *prm),
                                                   lambda: tail(encoder_ffn_train_fused)(x, *prm)],
            10, card)
    times["encoder_ffn_train_bwd"] = plain_kernel_sdpa(
        f"encoder_ffn_train_bwd rows={rows}",
        [backward_only(tail(encoder_ffn_train_torch), (x, *prm), cot2),
         backward_only(tail(encoder_ffn_train_fused), (x, *prm), cot2)], 10, card)
    lse = p * s * 4
    io = nbytes(q, k, v)
    no_mask = torch.zeros(p, s, dtype=torch.bool)
    wts = (2 * c * f + 4 * c + f) * 4
    bounds = {
        "mhsa_train_fwd": bound(io + nbytes(q) + p * s * c * 4 + 2 * lse,
                                attention_ops(no_mask, c, 2), bf),
        "mhsa_train_bwd": bound(io + nbytes(cot) + p * s * c * 4 + 2 * lse + 3 * nbytes(q),
                                attention_ops(no_mask, c, 5), bf),
        "encoder_ffn_train_fwd": bound(2 * nbytes(x) + wts, 4.0 * rows * c * f, bf),
        "encoder_ffn_train_bwd": bound(3 * nbytes(x) + 2 * wts, 12.0 * rows * c * f, bf)}
    out = {}
    for name in TRAIN_KERNELS:
        t = timing(*times[name][:2], bounds[name], *times[name][2:])
        shape = f"P={p} S={s} C={c}" if name.startswith("mhsa") else f"R={rows} C={c} F={f}"
        lib = "" if t["library_ms"] is None else (f", SDPA {t['library_ms'] * 1e3:.1f} us "
                                                  f"(kernel/SDPA {t['ms'] / t['library_ms']:.2f})")
        log(f"  {name} {shape} bf16 seed mode (device time): kernel {t['ms'] * 1e3:.1f} us, "
            f"plain {t['plain_ms'] * 1e3:.1f} us{lib}, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}) [{card}]")
        out[name] = {"shape": shape, **t}
    return out


@contextlib.contextmanager
def encoder_launches(kernels):
    """Which encoder made each launch of ``kernels`` inside the block, for
    every ``TransformerEncoder`` that runs (global module hooks; the TPH
    intra encoder is the one whose dropout offsets start at
    INTRA_OFFSET_BASE): yields {kernel: [label, ...]} in launch order. A
    forward's launches fall between the encoder's forward hooks; its
    backward's between the gradient reaching its output and leaving its
    input (tensor hooks), one encoder's backward after the other's."""
    from torch.nn.modules.module import (register_module_forward_hook,
                                         register_module_forward_pre_hook)

    order = {k: [] for k in kernels}
    marks = {}

    def begin(key):
        marks[key] = launch_counts()

    def end(key, label):
        start, now = marks.pop(key), launch_counts()
        for k in kernels:
            order[k].extend([label] * (now[k] - start[k]))

    def label(module):
        return "intra" if module.offset_base == INTRA_OFFSET_BASE else "inter"

    def pre(module, args):
        if isinstance(module, TransformerEncoder):
            begin(("fwd", id(module)))
            if torch.is_grad_enabled() and args[0].requires_grad:
                args[0].register_hook(lambda g, m=module: end(("bwd", id(m)), label(m)))

    def post(module, args, out):
        if isinstance(module, TransformerEncoder):
            end(("fwd", id(module)), label(module))
            if out.requires_grad:
                out.register_hook(lambda g, m=module: begin(("bwd", id(m))))

    hooks = [register_module_forward_pre_hook(pre), register_module_forward_hook(post)]
    try:
        yield order
    finally:
        for hk in hooks:
            hk.remove()


def split_by_encoder(events, order, parts, steps, card):
    """Each kernel's profiled ms and launches per step split between the
    intra and the inter encoder: ``parts`` are (kernel, name substrings of
    its device kernels, each launched once a call); the launches of each
    part, in time order over ``steps`` steps, take the labels of
    ``encoder_launches``' ``order`` of one step."""
    if not events:
        log("  the intra/inter split is not measured (no profile)")
        return
    events = sorted(events, key=lambda e: e.time_range.start)
    for kernel, names in parts:
        split = {}
        for part in names:
            calls = [e for e in events if part in e.name]
            if len(calls) != steps * len(order[kernel]):
                log(f"  {kernel} {part}: {len(calls)} profiled launches for {steps} steps of "
                    f"{len(order[kernel])} calls: its split is not measured")
                continue
            for e, label in zip(calls, order[kernel] * steps):
                ms, cnt = split.get(label, (0.0, 0))
                split[label] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
        log(f"  {kernel} per step: " + "; ".join(
            f"{label} encoder {ms / steps:.3f} ms in {cnt / steps:.0f} device launches "
            f"({order[kernel].count(label)} calls)"
            for label, (ms, cnt) in sorted(split.items(), reverse=True)) + f" [{card}]")


def phase_tph_train(raw_persons):
    """``train_loop`` on the TPH recipe at full width (bf16, kernels on,
    dropout 0.1) through ``phase_train``, Kernels C and D launched by each
    encoder counted from zero over the run."""
    cfg = train_cfg("bfloat16", True, presets.tph_interformer)
    with encoder_launches(TRAIN_KERNELS) as order:
        counts, raw = phase_train(cfg, raw_persons, TRAIN_KERNELS, "train_tph")
    split = {k: {label: labels.count(label) for label in ("intra", "inter")}
             for k, labels in order.items()}
    log(f"  launches by encoder over the run: {split}")
    if any(n < 1 for per in split.values() for n in per.values()):
        raise AssertionError(f"an encoder launched a training kernel no time: {split}")
    if {k: sum(v.values()) for k, v in split.items()} != counts:
        raise AssertionError(f"the encoders' launches {split} do not add up to {counts}")
    return counts, split, raw


def phase_tph_train_on_off(raw):
    """One f32 TPH training step at dropout 0 (2 images, their persons) with
    the kernels on and off, each route twice: the losses, and every gradient
    against TPH_GRAD_BOUND, beside the spread of two runs of one route."""
    cfg = train_cfg("float32", True, presets.tph_interformer)
    model = seeded_model(cfg)
    for encoder in model.encoders():
        encoder.dropout_rate = 0.0
    (l_on, g_on, c_on), (l_off, g_off, c_off), (_, g_off2, _), (_, g_on2, _) = grads_on_off(
        model, cfg, raw, 2, model.set_kernels, routes=(True, False, False, True))
    if min(c_on[k] for k in TRAIN_KERNELS) < 1 or any(c_off[k] for k in TRAIN_KERNELS):
        raise AssertionError(f"Kernels C and D with the kernels on {c_on}, off {c_off}")
    loss_rel = max(abs(l_on[k] - l_off[k]) / abs(l_off[k]) for k in l_off)
    diff = grad_diff(g_on, g_off)
    log(f"  losses on {l_on} vs off {l_off} (worst rel {loss_rel:.3g}, bound {TRAIN_LOSS_REL:g}); "
        f"{len(g_off)} gradients, on vs off: " + describe_diff(diff)
        + f" (bounds {TPH_GRAD_BOUND}); two runs off: " + describe_diff(grad_diff(g_off2, g_off))
        + "; two runs on: " + describe_diff(grad_diff(g_on2, g_on)))
    if loss_rel > TRAIN_LOSS_REL or any(diff[k][0] > TPH_GRAD_BOUND[k] for k in diff):
        raise AssertionError("f32 TPH training step with kernels strays from the plain path")


#: Kernels C's and D's bf16 device kernels, each launched once a call:
#: (kernel, name substrings), for the TPH step's intra/inter split
TRAIN_KERNEL_PARTS = (("mhsa_train_fwd", ("keep_bits_kernel", "mhsa_train_fwd_mma")),
                      ("mhsa_train_bwd", ("rowdot_kernel", "mhsa_train_dkdv_mma",
                                          "mhsa_train_dq_mma")),
                      ("encoder_ffn_train_fwd", ("ffn::fwd_kernel",)),
                      ("encoder_ffn_train_bwd", ("ffn::bwd_rows_kernel", "ffn::dw_kernel",
                                                 "ffn::bwd_sum_kernel")))


def phase_tph_train_timing(raw, persons, card):
    """The TPH train step (``step_timing``: kernels on and off in turns, peak
    memory, the profile of the kernels-on step with C's and D's ms and
    launches per step), then C's and D's ms and launches per step split
    between the intra and the inter encoder (``split_by_encoder``)."""
    events = []
    step = step_timing(train_cfg("bfloat16", True, presets.tph_interformer), raw, persons,
                       lambda m: m.set_kernels, card,
                       [(f"Kernel {'C' if k.startswith('mhsa') else 'D'} "
                         f"{'forward' if k.endswith('fwd') else 'backward'}", parts)
                        for k, parts in TRAIN_KERNEL_PARTS], keep=events)
    with encoder_launches(TRAIN_KERNELS) as order:
        step()
        torch.cuda.synchronize()
    split_by_encoder(events, order, TRAIN_KERNEL_PARTS, PROFILED_STEPS, card)


def dataset_cfg(dataset):
    """The W48 recipe of ``dataset`` reading its training fixture (phases
    30-33): the recipe's batch, MAX_PATCH, WORKERS, bf16 and kernels on,
    ``TEST.BATCH_SIZE_PER_GPU`` VAL_BATCH, a step's loss read at every step."""
    cfg = presets.w48_pure_en6(dataset)
    cfg["DATASET"]["ROOT"] = str(FIXTURES / TRAIN_TREES[dataset][0])
    cfg["TEST"]["BATCH_SIZE_PER_GPU"] = VAL_BATCH
    cfg["PRINT_FREQ"] = 1
    return cfg


def fixture_dataset(cfg, split):
    """The dataset of ``cfg``'s ``split`` ("TRAIN_SET" or "TEST_SET")."""
    d = cfg["DATASET"]
    return get_dataset_class(d["DATASET"])(cfg, d["ROOT"], d[split],
                                           is_train=split == "TRAIN_SET")


def host_rate(cfg, ds, batch_images, workers, epochs=HOST_EPOCHS):
    """Images a second that ``epoch_batches`` assembles on the host (decode,
    pre-scale, augmentation, raster) at ``workers`` threads, over ``epochs``."""
    images = 0
    t0 = time.perf_counter()
    for epoch in range(epochs):
        for raw in epoch_batches({**cfg, "WORKERS": workers}, ds, epoch, batch_images):
            images += raw["images"].shape[0]
    return images / (time.perf_counter() - t0)


def phase_train_data(card):
    """The training data path: each training split's JPEGs decoded to
    cv2.imread's bytes; its first batches of epoch 0 (``train_loop``'s
    composition at WORKERS 0) equal to the JAX package's
    (``expected_train.json``); ``device_batch`` of a rotated batch on the
    card against the same call on the CPU; host images/s at WORKERS 0 and 8."""
    for dataset, (tree, digests, folder) in TRAIN_TREES.items():
        root = FIXTURES / tree
        phase_decode(card, root / digests, root / folder)
        cfg = dataset_cfg(dataset)
        ds = fixture_dataset(cfg, "TRAIN_SET")
        want = json.loads((root / "expected_train.json").read_text())
        got = train_records(cfg, ds, want["batch_images"], len(want["batches"]))
        worst = compare_records(got, want["batches"], atol=RECORD_ATOL)
        log(f"  {dataset} {ds.image_set}: {len(ds)} images; the first {len(got)} batches of "
            f"epoch 0 at B={want['batch_images']} equal JAX's: items, buckets, SHA-256 of images, "
            f"person_valid and joints_vis; floats within {worst:.3g} (bound {RECORD_ATOL:g})")
    cfg = dataset_cfg("coco")
    ds = fixture_dataset(cfg, "TRAIN_SET")
    items, nb = next(ds.train_batches(8, np.random.RandomState(SEED)))
    for seed in range(20):  # the first augmentation that rotates and flips
        raw, meta = ds.make_raw_batch(items, nb, np.random.RandomState(seed))
        if (np.abs(meta["rotation"]).max() > 1
                and (raw["crop_affines"][raw["person_valid"]][:, 0, 0] < 0).any()):
            break
    on_card = ds.device_batch(raw, DEV)
    on_cpu = ds.device_batch(raw, "cpu")
    errs = {}
    for k, ref in on_cpu.items():
        got = on_card[k].cpu()
        if ref.dtype == torch.bool:
            if not torch.equal(got, ref):
                raise AssertionError(f"device_batch {k}: the card's differs from the CPU's")
            continue
        atol = CROP_ATOL if k == "images" else 1e-5
        err = (got - ref).abs()
        errs[k] = err.max().item()
        if not torch.isfinite(got).all() or (err > atol + 1e-4 * ref.abs()).any():
            raise AssertionError(f"device_batch {k}: card vs CPU max |err| {errs[k]:.3g} "
                                 f"(atol {atol:.3g}, rtol 1e-4)")
    log(f"  device_batch of a rotated, flipped batch (B=8 N={nb}, rotations "
        f"{np.round(meta['rotation'], 1).tolist()}), card vs CPU: max|err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (crops atol {CROP_ATOL:.3g}, the rest 1e-5; rtol 1e-4); validity equal")
    for dataset, batch_images in (("coco", 8), ("crowdpose", 32)):
        cfg = dataset_cfg(dataset)
        ds = fixture_dataset(cfg, "TRAIN_SET")
        rates = {w: host_rate(cfg, ds, batch_images, w) for w in HOST_WORKERS}
        log(f"  make_raw_batch via epoch_batches, {dataset} B={batch_images}: "
            + ", ".join(f"WORKERS {w} {r:.1f} images/s" for w, r in rates.items())
            + f" (host clock, {HOST_EPOCHS} epochs of the fixture) [{card}]")


def run_train_loop(cfg, name, max_epochs, validate_every=1, fresh=True):
    """``train_loop`` from the dataset of ``cfg`` into ``OUT_DIR / name`` on the
    card, the launches counted from zero over the run: (state, per-step
    (loss, data ms, step ms, index in its epoch), launch counts, peak GiB,
    host seconds)."""
    out = OUT_DIR / name
    if fresh:
        shutil.rmtree(out, ignore_errors=True)
    steps = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_loop(cfg, str(out), max_epochs=max_epochs, device=DEV,
                       validate_every=validate_every,
                       on_step=lambda e, i, m: steps.append(
                           (float(m["loss"]), m["data_time"] * 1e3, m["batch_time"] * 1e3, i)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (state, steps, launch_counts(), torch.cuda.max_memory_allocated() / 2 ** 30, wall)


def check_train_run(cfg, steps, counts, val_batches, what):
    """Finite losses, Kernels C and D launched, A and B launched once a layer
    and forward of each validation batch (6 layers, 2 forwards)."""
    want_eval = 2 * cfg["MODEL"]["ENCODER_LAYERS"] * val_batches
    got = {k: counts[k] for k in TRAIN_KERNELS + EVAL_KERNELS}
    if not steps or not all(math.isfinite(step[0]) for step in steps):
        raise AssertionError(f"{what}: training losses {[s[0] for s in steps]}")
    if min(got[k] for k in TRAIN_KERNELS) < 1 or any(got[k] != want_eval for k in EVAL_KERNELS):
        raise AssertionError(f"{what}: launches {got}; want C and D > 0, A and B {want_eval} "
                             f"each ({val_batches} validation batches)")
    return got


def step_ms_text(steps):
    """The steps' host times after the run's first: the step's ms and its wait
    on the prefetch queue, the wait split between an epoch's first step (its
    batch assembled after the epoch began) and the others (assembled while
    earlier steps ran)."""
    later = steps[1:] or steps
    ahead = [d for _, d, _, i in later if i > 0]
    return (f"step {np.mean([b for _, _, b, _ in later]):.2f} ms, waiting on the prefetch "
            f"queue {np.mean([d for _, d, _, _ in later]):.2f} ms (mean of steps "
            f"2-{len(steps)}: an epoch's first step "
            f"{np.mean([d for _, d, _, i in later if i == 0] or [math.nan]):.2f} ms, the "
            + (f"others {np.mean(ahead):.2f} ms" if ahead else "others not measured: none")
            + f"; the run's first step {steps[0][2]:.2f} ms, of it {steps[0][1]:.2f} waiting)")


def phase_train_jpegs(card):
    """W48 COCO trained from the fixture's JPEGs by the dataset-driven
    ``train_loop`` (bf16, kernels on, WORKERS 8, B=8 x N=7) for one epoch,
    validated at its end; the checkpoint resumed; then two more epochs for
    the step's wait on the prefetch queue beside its time."""
    cfg = dataset_cfg("coco")
    val_batches = len(list(fixture_dataset(cfg, "TEST_SET").eval_batches(VAL_BATCH)))
    state, steps, counts, peak, wall = run_train_loop(cfg, "train_jpeg", 1)
    got = check_train_run(cfg, steps, counts, val_batches, "W48 COCO from JPEGs")
    perf = load_checkpoint(latest_checkpoint(str(OUT_DIR / "train_jpeg")))["perf"]
    log(f"  1 epoch, {len(steps)} steps of B={cfg['TRAIN']['BATCH_SIZE_PER_GPU']} x "
        f"N={cfg['DATASET']['MAX_PATCH']}: losses " + " ".join(f"{s[0]:.6f}" for s in steps)
        + f"; validation AP {perf:.6f}; launches {got} (C and D in training, A and B in "
        f"validate: {val_batches} batches); peak {peak:.1f} GiB; host clock {wall:.2f} s")
    check_resume(cfg, OUT_DIR / "train_jpeg", state)
    _, steps, *_ = run_train_loop(cfg, "train_jpeg", 3, validate_every=1000, fresh=False)
    log(f"  epochs 1-2 resumed, {len(steps)} steps, WORKERS {cfg['WORKERS']}: "
        f"{step_ms_text(steps)} [{card}]")
    return got


def hold_kernels(b, s, tb, g):
    """Kernels C and D against their plain versions at Kernel C's [B, S, 96]
    with a ragged person mask and D's B * S rows (phases 8-9's checks and
    tolerances), and A and B at the test batch's [TB, S, 96] and TB * S rows
    (phases 3-4's): {kernel: its bf16 max |err|} (C and D in seed mode)."""
    c_err = phase_mhsa_train(g, ((b, s, 96, 1),), keep_fraction=False)
    d_err = phase_ffn_train(g, ((b * s, 96, 192),))
    return {"mhsa_train_fwd": c_err["fwd"], "mhsa_train_bwd": c_err["bwd"],
            "encoder_ffn_train_fwd": d_err["fwd"], "encoder_ffn_train_bwd": d_err["bwd"],
            "masked_mhsa": phase_mhsa(g, ((tb, s, 96, 1),)),
            "encoder_ffn": phase_ffn(g, ((tb * s, 96, 192),))}


def train_largest_batch(cfg, name, epochs, card):
    """``run_train_loop`` at the recipe's batch, halved while the card runs out
    of memory (each cut logged, CUT in the line): (batch, its run)."""
    batch = cfg["TRAIN"]["BATCH_SIZE_PER_GPU"]
    while True:
        cfg["TRAIN"]["BATCH_SIZE_PER_GPU"] = batch
        try:
            return batch, run_train_loop(cfg, name, epochs, validate_every=epochs)
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            log(f"  CUT: B={batch} x N={cfg['DATASET']['MAX_PATCH']} does not fit the card "
                f"({str(e).splitlines()[0][:160]}); trying B={batch // 2} [{card}]")
            if batch == 1:
                raise
            batch //= 2


def phase_dataset_recipe(dataset, g, card):
    """A W48 recipe of another dataset at its own shapes (phases 32-33):
    Kernels C and D against their plain versions at the training batch's
    [B, N * 192, 96] with a ragged mask and B * N * 192 rows, A and B at the
    test batch's shapes (``hold_kernels``), then timed beside their plain
    versions, their bounds and SDPA (with dropout 0.1 for C); ``train_loop``
    from the fixture for TRAIN_EPOCHS epochs of one step, validated at the
    end, launches counted from zero, the peak memory and step time;
    ``validate`` on the test split with the GT oracle (against
    ``expected.json``) and with the seeded model kernels on vs off.
    Returns {kernel: the fields of these shapes for the kernels line}."""
    cfg = dataset_cfg(dataset)
    b, n = cfg["TRAIN"]["BATCH_SIZE_PER_GPU"], cfg["DATASET"]["MAX_PATCH"]
    s = n * 192
    tb = presets.w48_pure_en6(dataset)["TEST"]["BATCH_SIZE_PER_GPU"]
    errs = hold_kernels(b, s, tb, g)
    torch.cuda.empty_cache()
    times = phase_train_kernel_timing(g, card, b, s)
    torch.cuda.empty_cache()
    eval_times = {**phase_timing_mhsa(g, card, tb, s), **ffn_timing(g, card, tb * s)}
    log_eval_times(eval_times, tb, s, card)
    times.update(eval_times)
    torch.cuda.empty_cache()

    test_ds = fixture_dataset(cfg, "TEST_SET")
    val_batches = len(list(test_ds.eval_batches(VAL_BATCH)))
    batch, (state, steps, counts, peak, wall) = train_largest_batch(cfg, f"train_{dataset}",
                                                                    TRAIN_EPOCHS, card)
    got = check_train_run(cfg, steps, counts, val_batches, f"W48 {dataset}")
    has_pos = state.model.position_embedding is not None
    if has_pos != cfg["MODEL"]["USE_MULTI_POS"]:
        raise AssertionError(f"{dataset}: the model has a position embedding: {has_pos}")
    perf = load_checkpoint(latest_checkpoint(str(OUT_DIR / f"train_{dataset}")))["perf"]
    cut = "" if batch == b else f", CUT from the recipe's B={b}"
    log(f"  train_loop, {len(steps)} steps of B={batch} x N={n}{cut} "
        f"({'with' if has_pos else 'without'} a position embedding): losses "
        + " ".join(f"{x[0]:.6f}" for x in steps) + f"; validation AP {perf:.6f}; launches {got}; "
        f"peak memory {peak:.1f} GiB; {step_ms_text(steps)}; host clock {wall:.2f} s [{card}]")
    del state
    torch.cuda.empty_cache()
    phase_validate_oracle(cfg, test_ds, FIXTURES / TRAIN_TREES[dataset][0],
                          f"validate_oracle_{dataset}")
    phase_validate_model(cfg, test_ds, g, card, f"validate_{dataset}")
    torch.cuda.empty_cache()
    c_shape, d_shape = f"B={b} S={s} C=96 ragged mask", f"R={b * s} C=96 F=192"
    shapes = {"mhsa_train_fwd": c_shape, "mhsa_train_bwd": c_shape,
              "encoder_ffn_train_fwd": d_shape, "encoder_ffn_train_bwd": d_shape,
              "masked_mhsa": f"B={tb} S={s} C=96 ragged mask", "encoder_ffn": f"R={tb * s} C=96"}
    return {k: {"shape": shapes[k], **times[k], "max_abs_err": errs[k], "launches": got[k],
                "train_batch": batch} for k in shapes}


def tph_fixture_cfg():
    """The TPH recipe reading the fixture, B=16."""
    cfg = presets.tph_interformer()
    cfg["DATASET"]["ROOT"] = str(FIXTURE)
    cfg["TEST"]["BATCH_SIZE_PER_GPU"] = VAL_BATCH
    return cfg


def phase_read_recipes():
    """Every recipe under ``experiments/`` read by ``config.load_config`` (the
    port's YAML reader) as the port config the JAX reader gives
    (``expected_recipes.json``)."""
    want = json.loads(RECIPES_JSON.read_text())
    paths = sorted(EXPERIMENTS.glob("*/*.yaml"))
    names = [str(p.relative_to(EXPERIMENTS)) for p in paths]
    if names != sorted(want):
        raise AssertionError(f"recipes {names} vs {sorted(want)} in {RECIPES_JSON.name}")
    t0 = time.perf_counter()
    for path, name in zip(paths, names):
        got = json.loads(json.dumps(to_port(load_config(str(path)))))
        if got != want[name]:
            bad = [sec for sec in want[name] if got.get(sec) != want[name][sec]]
            raise AssertionError(f"{name}: the port's config differs from JAX's in {bad}")
    log(f"  {len(paths)} recipes read with yaml_lite and merged over the defaults: every port "
        f"config equals the JAX reader's ({RECIPES_JSON.name}); "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms in all (host clock)")


def write_first_stage(cfg, path):
    """A first-stage checkpoint for MODEL.SINGLE_MODEL: the ``singleformer``
    state dict of the model of ``cfg`` initialised from SINGLE_MODEL_SEED."""
    model = build_model(cfg, device="cpu")
    init_weights(model, gen(SINGLE_MODEL_SEED))
    sd = {k: v.clone() for k, v in model.singleformer.state_dict().items()}
    torch.save(sd, path)
    return sd


@contextlib.contextmanager
def first_stage_checked(want, seen):
    """Within the block, every ``load_pretrained`` of the trainer is checked:
    the model's first stage must equal ``want`` bit for bit once it returns
    (the entries the loader does not take left out); ``seen`` counts them."""
    original = trainer_module.load_pretrained

    def checked(cfg, model):
        out = original(cfg, model)
        got = model.singleformer.state_dict()
        keys = [k for k in want if not k.endswith(NOT_LOADED)]
        bad = [k for k in keys if not torch.equal(got[k].cpu(), want[k])]
        if set(got) != set(want) or bad:
            raise AssertionError(f"SINGLE_MODEL not loaded bit for bit: {bad[:5]}, "
                                 f"{sorted(set(got) ^ set(want))[:5]}")
        seen.append(len(keys))
        return out

    trainer_module.load_pretrained = checked
    try:
        yield
    finally:
        trainer_module.load_pretrained = original


def recipe_opts(tree, single_model, test_batch, extra):
    return ["DATASET.ROOT", str(FIXTURES / tree), "MODEL.SINGLE_MODEL", str(single_model),
            "TEST.BATCH_SIZE_PER_GPU", str(test_batch), "PRINT_FREQ", "1", *extra]


def fused_train_timing(cfg, card):
    """One train step of the recipe's model (bf16, kernels on) on the
    fixture's first batch with ``FUSED_BLOCK_TRAIN`` off (the HRFormer
    blocks on modules) and on (their attention halves on kernel 9), in the
    order off, on, on, off: (off ms, on ms)."""
    model = seeded_model(cfg)
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), 1000))
    step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"])
    ds = fixture_dataset(cfg, "TRAIN_SET")
    b = cfg["TRAIN"]["BATCH_SIZE_PER_GPU"]
    batch = ds.device_batch(next(iter(epoch_batches({**cfg, "WORKERS": 0}, ds, 0, b))), DEV)
    dropout_gen = gen(SEED + 1)

    def run(fused):
        def go():
            model.set_kernels(True, True, False, fused)
            step(batch, dropout_gen)
        return go

    t_off, t_on = alternate(run(False), run(True), 3)
    n = int(batch["person_valid"].sum())
    log(f"  train step B={b} x N={cfg['DATASET']['MAX_PATCH']} ({n} persons), bf16, kernels "
        f"on: FUSED_BLOCK_TRAIN false (modules) {t_off:.2f} ms, true (kernel 9) {t_on:.2f} ms; "
        f"faster on the card: {'kernel 9' if t_on < t_off else 'modules'} (CUDA events, in "
        f"turns) [{card}]")
    return t_off, t_on


def phase_recipe(number, recipe, tree, test_batch, extra, g, card):
    """A recipe from its YAML: the first stage of another seed written as its
    MODEL.SINGLE_MODEL, ``tools.train.main`` for one epoch of at most
    RECIPE_STEPS steps (the file loaded bit for bit, finite losses, the step
    ms, peak memory, launches counted from zero), then ``tools.test.main`` with
    TEST.MODEL_FILE the run's ``final_state.pth`` (the recipe's names a
    released file the repository does not hold): AP and launches. TPH: A, B, C and D launched; HRT: C and
    D in training, E and F in the test, kernel 9 only under the
    FUSED_BLOCK_TRAIN override. Returns {"train": counts, "test": counts,
    "step_ms": [...], "peak_gib", "ap"}."""
    path = EXPERIMENTS / recipe
    out = OUT_DIR / "recipes" / path.stem
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    opts = recipe_opts(tree, out / "first_stage.pth", test_batch, extra)
    cfg = to_port(load_config(str(path), opts))
    want = write_first_stage(cfg, out / "first_stage.pth")
    dirs = ["--modelDir", str(out / "output"), "--logDir", str(out / "log"), "--device", DEV]
    steps, seen = [], []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with first_stage_checked(want, seen):
        state, output_dir = train_main(
            ["--cfg", str(path), *dirs, "--max-epochs", "1", "--max-steps-per-epoch",
             str(RECIPE_STEPS), *opts],
            on_step=lambda e, i, m: steps.append((float(m["loss"]), m["batch_time"] * 1e3)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    train_counts = {k: v for k, v in launch_counts().items() if v}
    if len(seen) != 1:
        raise AssertionError(f"{recipe}: load_pretrained ran {len(seen)} times")
    if not steps or not all(math.isfinite(x) for x, _ in steps):
        raise AssertionError(f"{recipe}: training losses {steps}")
    del state
    torch.cuda.empty_cache()
    reset_launches()
    t1 = time.perf_counter()
    model_file = Path(output_dir) / "final_state.pth"  # the recipe names a released file
    name_value, perf = test_main(["--cfg", str(path), *dirs, *opts, "TEST.MODEL_FILE",
                                  str(model_file)])
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - t1
    test_counts = {k: v for k, v in launch_counts().items() if v}
    m = cfg["MODEL"]
    tph = m["SINGLEFORMER"] == "transpose_h"
    fused_train = cfg["DEVICE"]["FUSED_BLOCK_TRAIN"]
    need_train = TRAIN_KERNELS + (("window_attn_block_train_fwd", "window_attn_block_train_bwd")
                                  if fused_train else ())
    need_test = EVAL_KERNELS + (() if tph else ("window_attn_block", "mlp_block"))
    absent = () if tph or fused_train else ("window_attn_block_train_fwd",
                                            "window_attn_block_train_bwd")
    if (any(train_counts.get(k, 0) < 1 for k in need_train)
            or any(test_counts.get(k, 0) < 1 for k in need_test)
            or any(train_counts.get(k, 0) for k in absent)):
        raise AssertionError(f"{recipe}: launches in training {train_counts}, in the test "
                             f"{test_counts}; want {need_train} > 0 in training, {need_test} in "
                             f"the test, {absent} never")
    stats = json.loads((FIXTURES / tree / "expected.json").read_text())["stats"]
    if not math.isfinite(perf) or set(name_value) != set(stats):
        raise AssertionError(f"{recipe}: test metrics {dict(name_value)}")
    b, n = cfg["TRAIN"]["BATCH_SIZE_PER_GPU"], cfg["DATASET"]["MAX_PATCH"]
    log(f"  {recipe} ({m['NAME']}, first stage {m['SINGLEFORMER']}, {m['NUM_JOINTS']} joints, "
        f"{m['IMAGE_SIZE'][0]}x{m['IMAGE_SIZE'][1]}, upsampling {m['UPSAMPLE_TYPE']}, position "
        f"embedding {m['MULTI_POS_EMBEDDING'] if m['USE_MULTI_POS'] else 'none'}, "
        f"FUSED_BLOCK_TRAIN {fused_train}): SINGLE_MODEL (seed {SINGLE_MODEL_SEED}) loaded into "
        f"the first stage bit for bit ({seen[0]} tensors); tools.train.main {len(steps)} steps of "
        f"B={b} x N={n}: losses " + " ".join(f"{x:.6f}" for x, _ in steps)
        + "; step ms " + " ".join(f"{t:.2f}" for _, t in steps)
        + f" (the first with its first calls); peak memory {peak:.1f} GiB; host clock "
        f"{wall:.2f} s with build, load and the epoch's validation; launches {train_counts}")
    log(f"  tools.test.main with TEST.MODEL_FILE {Path(output_dir).name}/{model_file.name}, "
        f"TEST.BATCH_SIZE_PER_GPU {test_batch}: AP {perf:.6f} ("
        + ", ".join(f"{k} {v:.4f}" for k, v in name_value.items())
        + f"); launches {test_counts}; host clock {test_wall:.2f} s [{card}]")
    return {"train": train_counts, "test": test_counts, "step_ms": [t for _, t in steps],
            "peak_gib": peak, "ap": float(perf), "cfg": cfg}


def inter_tokens(cfg):
    """Tokens a person in the inter encoder of ``cfg``'s model: the
    heatmap-sized first-stage map pooled as ``models/interformer.py`` pools it."""
    w, h = cfg["MODEL"]["HEATMAP_SIZE"]
    feat = torch.zeros(1, 1, h, w)
    for _ in range(int(math.log2(w // cfg["MODEL"]["TRANS_SIZE"][1]))):
        feat = max_pool_3x3_s2(feat)
    return feat.shape[2] * feat.shape[3]


def phase_inter_train_kernels(cfg, g, card):
    """Kernels C and D at the training shapes of the inter encoder of an HRT
    recipe (``cfg``): C over [B, N * tokens, DIM_MODEL] with a person mask of
    ragged counts, forward and backward, f32 and bf16, bits and seed mode,
    the plain version without the last key tile (ragged at 384x288) breaking
    the bound (``check_tph_attention_train``); D over its B * N * tokens rows
    (phase 9's checks); then both timed beside their plain versions, their
    bounds and SDPA (``phase_train_kernel_timing``). Returns {kernel: its
    fields for the kernels line}."""
    m = cfg["MODEL"]
    if m["N_HEAD"] != 1:
        raise AssertionError(f"the inter encoder has {m['N_HEAD']} heads; the check holds one")
    b, n = cfg["TRAIN"]["BATCH_SIZE_PER_GPU"], cfg["DATASET"]["MAX_PATCH"]
    tokens, c, f = inter_tokens(cfg), m["DIM_MODEL"], m["DIM_FEEDFORWARD"]
    s = n * tokens
    counts = [n - i % n for i in range(b)]
    mask = person_key_mask(counts, tokens, n)
    dgen = torch.Generator(device=DEV).manual_seed(SEED)
    bits = torch.randint(0, 2 ** 32, (b, s, s), generator=dgen, device=DEV, dtype=torch.int64)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        res = check_tph_attention_train(b, s, mask, dt, bits, c)
        for mode, (e_f, r_f, e_b) in res.items():
            log(f"  mhsa_train B={b} S={s} C={c} person mask {counts} ({tokens} tokens a person) "
                f"{str(dt)[6:]} {mode}: out max|err| {e_f:.3g} ({r_f:.2g} of max|ref|), dq/dk/dv "
                f"max|err| {e_b:.3g}; bound {TRAIN_TOL[dt][0]:g}*max|ref| + {TRAIN_TOL[dt][1]:g}"
                f"*|ref|; the plain version without the last {s - (s - 1) // KEY_TILE * KEY_TILE} "
                "keys breaks it")
        if dt == torch.bfloat16:
            errs["mhsa_train_fwd"], _, errs["mhsa_train_bwd"] = res["seed"]
    del bits
    d_err = phase_ffn_train(g, ((b * s, c, f),))
    errs.update(encoder_ffn_train_fwd=d_err["fwd"], encoder_ffn_train_bwd=d_err["bwd"])
    torch.cuda.empty_cache()
    times = phase_train_kernel_timing(g, card, b, s, c, f, tokens)
    labels = {"mhsa_train": f"B={b} S={s} C={c} person mask",
              "encoder_ffn_train": f"R={b * s} C={c} F={f}"}
    return {k: {"shape": labels[k.rsplit("_", 1)[0]], **times[k], "max_abs_err": errs[k]}
            for k in TRAIN_KERNELS}


def phase_recipes(g, card, recipe_runs=RECIPE_RUNS):
    """Phases 35-39: the new kernel shapes held (and timed) before the
    recipe that runs them, then each recipe from its YAML. Returns (the
    runs by YAML stem, {kernel: {label: fields for the kernels line}})."""
    runs, shapes = {}, {}

    def held(label, errs, times, shape):
        for name in errs:
            shapes.setdefault(name, {})[label] = {"shape": shape, **times[name],
                                                  "max_abs_err": errs[name]}

    for number, recipe, tree, test_batch, extra in recipe_runs:
        stem = Path(recipe).stem
        log(f"phase {number} {recipe} from its YAML through tools.train and tools.test"
            + (f" ({' '.join(extra)})" if extra else "") + ":")
        if number == 35:
            log("  Kernels A and B at the CrowdPose TPH test batch, [96, 3072, 96] unmasked "
                f"and R={96 * TPH_TOKENS}:")
            times, errs = phase_tph_kernels(card, CROWDPOSE_TPH_ATTN, 96 * TPH_TOKENS)
            a, b = f"A P=96 S={TPH_TOKENS}", f"B R={96 * TPH_TOKENS}"
            held("crowdpose_tph_test", {"masked_mhsa": errs[a]}, {"masked_mhsa": times[a]},
                 f"P=96 S={TPH_TOKENS} C=96 no mask")
            held("crowdpose_tph_test", {"encoder_ffn": errs[b]}, {"encoder_ffn": times[b]},
                 f"R={96 * TPH_TOKENS} C=96 F=192")
        elif number == 37:
            log("  Kernels E and F at P=16 on the HRT maps (CrowdPose HRT, 4 x 4):")
            names = ("window_attn_block", "mlp_block")
            held("crowdpose_hrt_p16", phase_hrt_kernels(g, HRT_P16_SHAPES, names),
                 phase_hrt_kernel_timing(g, card, HRT_P16_SHAPES, names),
                 "P=16 H=64 W=48 C=78 heads 2")
            log("  kernel 9 forward and backward at P=16 on the same maps (the step timed with "
                "FUSED_BLOCK_TRAIN after the recipe):")
            held("crowdpose_hrt_p16", phase_hrt_train_kernels(g, HRT_P16_SHAPES),
                 phase_hrt_train_kernel_timing(g, card, HRT_P16_SHAPES),
                 "P=16 H=64 W=48 C=78 heads 2")
        elif number == 39:
            log("  kernel 9 forward and backward at P=8 on the four 384x288 branch maps:")
            held("coco_hrt_288", phase_hrt_train_kernels(g, HRT288_TRAIN_SHAPES),
                 phase_hrt_train_kernel_timing(g, card, HRT288_TRAIN_SHAPES),
                 "P=8 H=96 W=72 C=78 heads 2")
        torch.cuda.empty_cache()
        if number in HRT_RECIPES:
            log("  Kernels C and D at the recipe's inter encoder in training:")
            cfg = to_port(load_config(str(EXPERIMENTS / recipe), list(extra)))
            for name, fields in phase_inter_train_kernels(cfg, g, card).items():
                shapes.setdefault(name, {})[HRT_RECIPES[number]] = fields
            torch.cuda.empty_cache()
        runs[stem] = phase_recipe(number, recipe, tree, test_batch, extra, g, card)
        torch.cuda.empty_cache()
        if number == 37:
            runs[stem]["fused_block_train_ms"] = fused_train_timing(runs[stem]["cfg"], card)
            torch.cuda.empty_cache()
    return runs, shapes


def phase_mpii(g, card):
    """MPII (phase 40): ``validate`` with the GT-heatmap oracle against the
    JAX PCKh table (``expected.json``), then a seeded 16-joint W48 in bf16
    kernels on vs off: A and B launched 12 times a batch on and never off,
    the predictions (every joint's position and confidence) within phase
    6's bound."""
    cfg = presets.w48_pure_en6()
    cfg["MODEL"]["NUM_JOINTS"] = 16
    cfg["DATASET"].update(DATASET="mpii", ROOT=str(MPII), TEST_SET="valid")
    cfg["TEST"]["BATCH_SIZE_PER_GPU"] = MPII_BATCH
    ds = get_dataset_class("mpii")(cfg, str(MPII), "valid", is_train=False)
    expected = json.loads((MPII / "expected.json").read_text())["stats"]
    nv, _ = validate(cfg, ds, None, str(OUT_DIR / "mpii_oracle"), device=DEV,
                     eval_step_fn=lambda _model, batch: batch["target"])
    diff = {k: abs(float(nv[k]) - v) for k, v in expected.items()}
    log(f"  GT oracle on {len(ds)} images: PCKh " + ", ".join(f"{k} {float(v):.4f}"
                                                             for k, v in nv.items())
        + f"; largest |stat - JAX stat| {max(diff.values()):.3g} (bound {ORACLE_TOL:g})")
    if set(nv) != set(expected) or max(diff.values()) > ORACLE_TOL:
        raise AssertionError(f"MPII oracle {dict(nv)} vs {expected}")
    model = random_model(cfg, g)
    model.compute_dtype = torch.bfloat16
    n_batches = len(list(ds.eval_batches(MPII_BATCH)))
    want = 2 * len(model.global_encoder.layers) * n_batches
    preds, evaluate = {}, ds.evaluate
    runs = {}
    for on in (True, False):
        model.set_kernels(on)
        ds.evaluate = lambda c, p, *a, on=on: (preds.__setitem__(on, np.asarray(p)),
                                               evaluate(c, p, *a))[1]
        reset_launches()
        runs[on] = validate(cfg, ds, model, str(OUT_DIR / f"mpii_{'on' if on else 'off'}"),
                            device=DEV)
        torch.cuda.synchronize()
        counts = {k: launch_counts()[k] for k in EVAL_KERNELS}
        if counts != {k: want if on else 0 for k in EVAL_KERNELS}:
            raise AssertionError(f"MPII kernels {'on' if on else 'off'}: launches {counts}, "
                                 f"want {want if on else 0} each")
    del ds.evaluate
    conf_err = (np.abs(preds[True][..., 2] - preds[False][..., 2]).max()
                / np.abs(preds[False][..., 2]).max())
    xy_err = np.abs(preds[True][..., :2] - preds[False][..., :2]).max(-1)
    log(f"  seeded 16-joint W48, bf16: A and B {want // n_batches} launches a batch with the "
        f"kernels on, none off; PCKh Mean on {float(runs[True][1]):.4f}, off "
        f"{float(runs[False][1]):.4f}; max|dconf|/max|conf| {conf_err:.3g}, |dxy| median "
        f"{np.median(xy_err):.3g} px, share within 1 px {np.mean(xy_err <= 1.0):.3f} [{card}]")
    if conf_err > 0.05 or np.median(xy_err) > 1.0:
        raise AssertionError("MPII validate with the kernels strays from the plain path")
    return want


def box_requests(rng, counts, hw):
    """Uint8 images of at least half of ``hw`` (h, w) each way, with
    ``counts[i]`` random person boxes (x, y, w, h) inside image i."""
    images, boxes = [], []
    for n in counts:
        h, w = int(rng.randint(hw[0] // 2, hw[0] + 1)), int(rng.randint(hw[1] // 2, hw[1] + 1))
        images.append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        bw, bh = rng.uniform(16, w / 2, n), rng.uniform(32, h / 1.5, n)
        x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes.append(np.stack([x0, y0, bw, bh], 1).tolist())
    return images, boxes


def save_requests(path, images, boxes, **extra):
    """Requests as ``probes/serve_artifact.py`` reads them, written whole
    (a temporary name, then moved: the process waiting for it sees it
    complete)."""
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, boxes=json.dumps(boxes), **{f"image_{i}": im for i, im in enumerate(images)},
             **extra)
    tmp.replace(path)


def artifact_header(path):
    """An artifact's JSON header (``serving.save_artifact``'s layout)."""
    with open(path, "rb") as f:
        if f.read(4) != b"I2RX":
            raise AssertionError(f"{path}: not an i2rx artifact")
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n))


def seeded_checkpoint(cfg, g, name):
    """The recipe's model seeded and calibrated as phase 5, in its compute
    dtype, and its weights saved as ARTIFACT_DIR/<name>.pth: (model, path)."""
    model = random_model(cfg, g)
    model.compute_dtype = getattr(torch, cfg["DEVICE"]["COMPUTE_DTYPE"])  # the recipe's: bf16
    path = ARTIFACT_DIR / f"{name}.pth"
    torch.save({"state_dict": model.state_dict()}, path)
    return model, path


def export_all(ckpts):
    """Every artifact of EXPORTS through ``tools.export``, each in a process
    of its own, all at once: {name: path}; logs each one's seconds (start to
    exit, alongside the others) and MB, and the ops its programs call."""
    procs = {}
    for name, (recipe, ckpt, b, buckets, hw, flags) in EXPORTS.items():
        out = ARTIFACT_DIR / f"{name}.i2rx"
        cmd = [sys.executable, "-m", "i2rnet_tpu_torch.tools.export", "--cfg",
               str(EXPERIMENTS / recipe), "--checkpoint", str(ckpts[ckpt]), "--out", str(out),
               "--batch", str(b), "--persons", *map(str, buckets), "--raw-hw", *map(str, hw),
               "--device", torch.device(DEV).type, *flags]
        logf = open(ARTIFACT_DIR / f"{name}.export.log", "w")
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT),
                       out, logf)
    t0, seconds = time.perf_counter(), {}
    try:
        while len(seconds) < len(procs):
            for name, (proc, _, _) in procs.items():
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > EXPORT_TIMEOUT:
                raise AssertionError(f"exports unfinished after {EXPORT_TIMEOUT} s")
            time.sleep(0.2)
    finally:
        for proc, _, logf in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            logf.close()
    failed = {name: proc.returncode for name, (proc, _, _) in procs.items() if proc.returncode}
    if failed:
        tails = "".join(f"\n{name}: {(ARTIFACT_DIR / f'{name}.export.log').read_text()[-3000:]}"
                        for name in failed)
        raise AssertionError(f"tools.export failed: {failed}{tails}")
    for name, (_, out, _) in procs.items():
        recipe, _, b, buckets, hw, flags = EXPORTS[name]
        log(f"  tools.export {recipe}{''.join(' ' + f for f in flags)} (B={b}, buckets {buckets}, "
            f"{hw[0]}x{hw[1]} canvas): {seconds[name]:.1f} s, "
            f"{out.stat().st_size / 1e6:.1f} MB; programs call {artifact_header(out)['kernels']}")
    return {name: out for name, (_, out, _) in procs.items()}


def loaded(path):
    """``load_predictor`` then ``warmup``: (predictor, load s, warmup s)."""
    t0 = time.perf_counter()
    pred = load_predictor(str(path), DEV)
    t1 = time.perf_counter()
    pred.warmup()
    return pred, t1 - t0, time.perf_counter() - t1


def counting(pred):
    """Counts the serve calls of ``pred`` (its programs' calls) per bucket;
    returns the dict, filled as the predictor serves."""
    calls, serve = {}, pred.serve

    def counted(*args):
        n = int(args[4].shape[1])
        calls[n] = calls.get(n, 0) + 1
        return serve(*args)

    pred.serve = counted
    return calls


def wait_for(path, child, timeout):
    """Wait until ``path`` exists; raise if ``child`` exits first with an
    error or ``timeout`` seconds pass."""
    t0 = time.perf_counter()
    while not path.exists():
        if child.poll() not in (None, 0) or time.perf_counter() - t0 > timeout:
            raise AssertionError(f"the fresh process (exit {child.poll()}) wrote no {path.name}:"
                                 f"\n{(ARTIFACT_DIR / 'serve_artifact.log').read_text()[-4000:]}")
        time.sleep(0.1)


def check_fresh(rec, served, ref):
    """Phase 41's checks of the fresh process's record and results."""
    calls = {int(n): c for n, c in rec["calls"].items()}
    want = {k: (W48_SERVE_LAUNCHES * sum(calls.values()) if k in EVAL_KERNELS else 0)
            for k in KERNELS}
    log(f"  fresh process: load {rec['load_s']:.1f} s, warmup {rec['warmup_s']:.1f} s, "
        f"{len(served)} images / {sum(len(r) for r in served)} persons served in "
        f"{rec['serve_s'] * 1e3:.1f} ms; calls per bucket {calls}; launches "
        f"{ {k: v for k, v in rec['launches'].items() if v} }; model modules imported "
        f"{rec['models_imported']}; without the kernel library: "
        f"{rec['refused_without_library']!r}")
    if set(calls) != set(ARTIFACT_BUCKETS) or rec["launches"] != want:
        raise AssertionError(f"the fresh process served calls {calls} with launches "
                             f"{rec['launches']}, want {want}")
    if rec["models_imported"] or (torch.device(DEV).type == "cuda"
                                  and not rec["refused_without_library"]):
        raise AssertionError("the fresh process imported a model module, or served without "
                             "the kernel library")
    diff = check_served(served, ref, "artifact in a fresh process vs in-process Predictor",
                        "the W48 artifact strays from the in-process Predictor")
    log(f"  max|difference| {diff:.3g}")


def check_no_kernels(plain, model, cfg, images, boxes, ref):
    """Phase 41's ``--no-kernels`` artifact: no kernel launched, within phase
    6's bound of the model served in process with its kernels off in the
    same bucket; beside it, for information, the in-process plain path in
    buckets 2/4/7 and the kernels' results."""
    reset_launches()
    out = plain.predict(images, boxes)
    torch.cuda.synchronize()
    stray = {k: v for k, v in launch_counts().items() if v}
    if stray:
        raise AssertionError(f"the --no-kernels artifact launched {stray}")
    model.set_kernels(False)
    try:
        same = Predictor(model, cfg, flip_pairs(cfg), batch_images=ARTIFACT_BATCH,
                         n_buckets=(ARTIFACT_BUCKETS[-1],), raw_hw=ARTIFACT_HW)
        local = Predictor(model, cfg, flip_pairs(cfg), batch_images=ARTIFACT_BATCH,
                          n_buckets=ARTIFACT_BUCKETS, raw_hw=ARTIFACT_HW)
        want, layout = same.predict(images, boxes), local.predict(images, boxes)
    finally:
        model.set_kernels(True)
    diff = check_served(out, want, f"--no-kernels artifact vs in-process plain, bucket "
                        f"{ARTIFACT_BUCKETS[-1]}", "the --no-kernels artifact strays from "
                        "the in-process plain path")
    log(f"  max|difference| {diff:.3g}; launches {stray}; for information, in-process plain in "
        f"bucket {ARTIFACT_BUCKETS[-1]} vs buckets {ARTIFACT_BUCKETS}, and in buckets "
        f"{ARTIFACT_BUCKETS} kernels on vs off (phase 6's comparison):")
    for a, b, what in ((want, layout, "bucket layout"), (ref, layout, "kernels vs plain")):
        conf = np.concatenate([k[..., 2] for k in a])
        conf_ref = np.concatenate([k[..., 2] for k in b])
        xy = np.concatenate([np.abs(u[..., :2] - v[..., :2]).max(-1) for u, v in zip(a, b)])
        log(f"    {what}: max|dconf|/max|conf| "
            f"{np.abs(conf - conf_ref).max() / np.abs(conf_ref).max():.3g}, |dxy| median "
            f"{np.median(xy):.3g} px, share within 1 px {np.mean(xy <= 1.0):.3f}")


def host_us(fn, calls=500, rounds=3):
    """Host microseconds a call of ``fn`` takes to return (its launch queued,
    not waited for): the median of ``rounds`` loops of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def phase_serving_rate(art, model, cfg, card):
    """Phase 42, for information: the W48 model served from its artifact and
    in process in turns at B=16, bucket 7, on a 256x320 canvas (host clock,
    and the device's busy time from a profile), and the registered op's host
    cost per call against the direct launch. Returns the artifact's images/s
    and the op's extra host microseconds a call."""
    local = Predictor(model, cfg, flip_pairs(cfg), batch_images=RATE_BATCH,
                      n_buckets=(RATE_BUCKET,), raw_hw=RATE_HW)
    local.warmup()
    rng = np.random.RandomState(SEED + 1)
    images, boxes = box_requests(rng, rng.randint(1, RATE_BUCKET + 1, RATE_BATCH), RATE_HW)
    persons = sum(map(len, boxes))
    fns = {"artifact": lambda: art.predict(images, boxes),
           "in-process": lambda: local.predict(images, boxes)}
    walls = {k: [] for k in fns}
    for _ in range(RATE_ITERS):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    log(f"  one call of {RATE_BATCH} images, {persons} persons, in turns x{RATE_ITERS} [{card}]:")
    rates = {}
    for k, fn in fns.items():
        ms = float(np.median(walls[k]))
        wall, busy, launches, _ = profile_steps(fn, 2)
        rates[k] = RATE_BATCH / ms * 1e3
        log(f"    {k:10s} {ms:8.2f} ms/call (host clock, median), {rates[k]:8.1f} images/s, "
            f"{persons / ms * 1e3:8.1f} persons/s; under the profiler {wall:.2f} ms/call, "
            f"device busy {busy:.2f} ms/call, idle share {1 - busy / wall:.3f}, "
            f"{launches:.0f} device launches/call")
    check_served(fns["artifact"](), fns["in-process"](), "artifact vs in-process",
                 "the rate artifact strays from the in-process Predictor")
    q = torch.randn(1, 16, 96, device=DEV, dtype=torch.bfloat16)
    op = host_us(lambda: torch.ops.i2r.masked_mhsa(q, q, q, 1, None))
    direct = host_us(lambda: masked_mhsa_fused(q, q, q, 1, None))
    extra = op - direct
    share = 2 * W48_SERVE_LAUNCHES * extra / 1e3 / float(np.median(walls["in-process"]))
    log(f"  host cost of Kernel A per call: the registered op {op:.1f} us, the direct launch "
        f"{direct:.1f} us (extra {extra:.1f} us); the {2 * W48_SERVE_LAUNCHES} kernel calls of "
        f"a W48 serve call through the op would add {100 * share:.2f}% to its in-process "
        f"wall (eager calls launch directly; only exported programs take the op)")
    return rates["artifact"], extra


def poisson_stream(rate):
    """Phase 43's requests: POISSON_REQUESTS images of 1-7 boxes and their
    arrival times at half ``rate`` (a Poisson stream)."""
    rng = np.random.RandomState(SEED + 2)
    images, boxes = box_requests(rng, rng.randint(1, 8, POISSON_REQUESTS), ARTIFACT_HW)
    return images, boxes, np.cumsum(rng.exponential(2.0 / rate, POISSON_REQUESTS))


def report_stream(res, boxes, rate, card):
    """Phase 43's numbers from the fresh process's stream run, and its
    batched results against the same requests served alone."""
    submitted, done, groups = res["submitted"], res["done"], res["groups"]
    lat = (done - submitted) * 1e3
    span = done.max() - submitted[0]
    persons = sum(map(len, boxes))
    log(f"  {POISSON_REQUESTS} requests of 1-7 boxes ({persons} persons) offered at "
        f"{rate / 2:.1f} requests/s (half of phase 42's {rate:.1f} images/s), max_delay_ms "
        f"{POISSON_DELAY_MS:g} [{card}]:")
    log(f"    latency p50 {np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms, "
        f"max {lat.max():.2f} ms; achieved {POISSON_REQUESTS / span:.2f} requests/s, "
        f"{persons / span:.2f} persons/s; {len(groups)} predict calls, "
        f"{groups.mean():.2f} images a call")
    n = len(boxes)
    diff = check_served([res[f"batched_{i}"] for i in range(n)],
                        [res[f"alone_{i}"] for i in range(n)],
                        "MicroBatcher vs each request served alone",
                        "MicroBatcher results stray from sequential predict")
    log(f"  max|difference| {diff:.3g}")


def check_model_artifact(label, pred, model, cfg, images, boxes, op_extra_us, card):
    """Phase 44: a TPH or HRT artifact loaded here against its model served
    in process, each kernel launched its count a serve call; the share of a
    serve call's wall that ``op_extra_us`` a kernel call would add. Returns
    the launches."""
    recipe, _, b, (n,), hw, _ = EXPORTS[label]
    per_call = SERVED_LAUNCHES[label]
    local = Predictor(model, cfg, flip_pairs(cfg), batch_images=b, n_buckets=(n,), raw_hw=hw)
    local.warmup()
    calls = counting(pred)
    reset_launches()
    t0 = time.perf_counter()
    out = pred.predict(images, boxes)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in launch_counts().items() if v}
    want = {k: c * calls[n] for k, c in per_call.items()}
    per_call_ms, extra_ms = wall / calls[n], sum(per_call.values()) * op_extra_us / 1e3
    log(f"  {label.upper()} artifact ({recipe}, B={b}, bucket {n}): {calls[n]} serve calls in "
        f"{wall:.1f} ms (host clock) [{card}]; launches {launches}; its "
        f"{sum(per_call.values())} kernel calls a serve call through the op: {extra_ms:.3f} "
        f"ms of host time more than launched directly, {100 * extra_ms / per_call_ms:.2f}% "
        f"of its {per_call_ms:.1f} ms")
    if launches != want:
        raise AssertionError(f"the {label} artifact launched {launches}, want {want}")
    diff = check_served(out, local.predict(images, boxes),
                        f"{label.upper()} artifact vs in-process Predictor",
                        f"the {label} artifact strays from the in-process Predictor")
    log(f"  max|difference| {diff:.3g}")
    return launches


def phase_serving(g, card):
    """Phases 41-44 (the module docstring): the seeded W48, TPH and HRT
    models saved as checkpoints; every artifact exported by ``tools.export``
    at once; the W48 artifact served by a fresh process
    (``probes/serve_artifact.py``) while this one loads the others; the
    serving rate; the fresh process's ``MicroBatcher`` stream; the hub's W48,
    the TPH and HRT artifacts. Returns each served artifact's launches."""
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    for stale in ARTIFACT_DIR.glob("*.npz"):
        stale.unlink()
    cfgs = {"w48": presets.w48_pure_en6(), "tph": presets.tph_interformer(),
            "hrt": presets.hrt_interformer()}
    models, ckpts = {}, {}
    for name, routes in (("w48", lambda m: m.set_kernels), ("tph", lambda m: m.set_kernels),
                         ("hrt", hrt_kernels)):
        models[name], ckpts[name] = seeded_checkpoint(cfgs[name], g, name)
        routes(models[name])(True)
    log("phase 41 the serving artifacts through tools.export, one process each, all at once:")
    paths = export_all(ckpts)
    images, boxes = requests(np.random.RandomState(SEED))
    req, out = ARTIFACT_DIR / "requests.npz", ARTIFACT_DIR / "served.npz"
    stream, stream_out = ARTIFACT_DIR / "stream.npz", ARTIFACT_DIR / "stream_out.npz"
    save_requests(req, images, boxes)
    logf = open(ARTIFACT_DIR / "serve_artifact.log", "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "i2rnet_tpu_torch.probes.serve_artifact", str(paths["w48"]),
         str(req), str(out), "--device", DEV, "--stream", str(stream), "--stream-out",
         str(stream_out)], cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
    try:
        preds = {}
        for name in ("w48_plain", "w48_rate", "tph", "hrt"):  # while the fresh process loads
            preds[name], load_s, warm_s = loaded(paths[name])
            log(f"  {name} loaded in this process: {load_s:.1f} s, warmup {warm_s:.1f} s")
        local = Predictor(models["w48"], cfgs["w48"], flip_pairs(cfgs["w48"]),
                          batch_images=ARTIFACT_BATCH, n_buckets=ARTIFACT_BUCKETS,
                          raw_hw=ARTIFACT_HW)
        local.warmup()
        ref = local.predict(images, boxes)
        wait_for(out, child, CHILD_TIMEOUT)
        res = np.load(out)
        rec = json.loads(str(res["record"]))
        check_fresh(rec, [res[f"result_{i}"] for i in range(len(images))], ref)
        check_no_kernels(preds.pop("w48_plain"), models["w48"], cfgs["w48"], images, boxes, ref)

        log(f"phase 42 serving rate, artifact vs in-process [{card}]:")
        rate, op_extra_us = phase_serving_rate(preds.pop("w48_rate"), models["w48"],
                                               cfgs["w48"], card)
        torch.cuda.empty_cache()
        log(f"phase 43 MicroBatcher in the fresh process under a Poisson stream [{card}]:")
        s_images, s_boxes, arrivals = poisson_stream(rate)
        save_requests(stream, s_images, s_boxes, arrivals=arrivals,
                      max_delay_ms=POISSON_DELAY_MS)
        if child.wait(timeout=CHILD_TIMEOUT) != 0:
            raise AssertionError(f"the fresh process exited {child.returncode}:\n"
                                 f"{(ARTIFACT_DIR / 'serve_artifact.log').read_text()[-4000:]}")
        report_stream(np.load(stream_out), s_boxes, rate, card)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        logf.close()

    log("phase 44 the hub's W48, and the TPH and HRT artifacts:")
    hub_model = hub.i2rnet_w48_pure("coco", checkpoint=str(ckpts["w48"]), device=DEV)
    got = Predictor(hub_model, cfgs["w48"], flip_pairs(cfgs["w48"]),
                    batch_images=ARTIFACT_BATCH, n_buckets=ARTIFACT_BUCKETS,
                    raw_hw=ARTIFACT_HW).predict(images, boxes)
    diff = check_served(got, ref, "hub.i2rnet_w48_pure(checkpoint) vs phase 41's model",
                        "the hub's W48 serves otherwise than the model it was saved from")
    log(f"  max|difference| {diff:.3g}")
    del hub_model, local
    launches = {"w48": rec["launches"]}
    for label in ("tph", "hrt"):
        launches[label] = check_model_artifact(label, preds.pop(label), models.pop(label),
                                               cfgs[label], images, boxes, op_extra_us, card)
        torch.cuda.empty_cache()
    return launches


REMAT_MODES = ("none", "layers", "dots", "full")
#: phase 45's models: (label, config, persons per image of the raw batch)
REMAT_RUNS = (("w48", lambda: train_cfg("bfloat16", True), TRAIN_COUNTS),
              ("tph", lambda: train_cfg("bfloat16", True, presets.tph_interformer),
               TPH_TRAIN_PERSONS),
              ("hrt", lambda: hrt_train_cfg("bfloat16", True), HRT_TRAIN_COUNTS))
REMAT_KERNELS = TRAIN_KERNELS + ("window_attn_block_train_fwd", "window_attn_block_train_bwd")
CUBLAS_DETERMINISTIC = ":4096:8"


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` (cuDNN's deterministic
    algorithms; cuBLAS under the workspace setting torch asks for), restored
    after; yields the operations torch warns have no deterministic version."""
    kept = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC
    torch.use_deterministic_algorithms(True, warn_only=True)
    seen = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
        seen.extend(sorted({str(w.message).split("\n")[0][:160] for w in caught
                            if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(False)
        if kept is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = kept


def remat_step(cfg, init, batch, mode):
    """One training step under ``mode`` from the state dict ``init``: (loss,
    gradients, post-step state dict, launches), then a second step's host ms
    and the peak memory over it in GiB."""
    cfg = copy.deepcopy(cfg)
    cfg["DEVICE"]["REMAT"] = mode
    model = build_model(cfg, device="cpu")
    model.load_state_dict(init)
    model.to(DEV)
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), 1000))
    step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"], remat=mode)
    torch.cuda.synchronize()
    reset_launches()
    loss = step(batch, gen(SEED + 1))["loss"]
    torch.cuda.synchronize()
    launches = {k: launch_counts()[k] for k in REMAT_KERNELS}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(batch, gen(SEED + 2))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step, model
    return loss.detach().clone(), grads, after, launches, ms, peak


def remat_want(model, mode):
    """The training kernels' launches in one step: a forward and a backward a
    layer (C, D) and block (kernel 9), the forward twice under REMAT."""
    layers = sum(len(e.layers) for e in model.encoders())
    stage = getattr(model, "singleformer", None)
    blocks = sum(b.use_kernels and b.fused_train
                 for b in (stage.blocks() if hasattr(stage, "blocks") else []))
    k = 1 if mode == "none" else 2
    return {"mhsa_train_fwd": k * layers, "mhsa_train_bwd": layers,
            "encoder_ffn_train_fwd": k * layers, "encoder_ffn_train_bwd": layers,
            "window_attn_block_train_fwd": k * blocks, "window_attn_block_train_bwd": blocks}


def first_difference(ref, got):
    """The first name whose tensors are not bit-equal, or None."""
    if ref.keys() != got.keys():
        return f"names {sorted(set(ref) ^ set(got))[:3]}"
    return next((k for k in ref if not torch.equal(ref[k], got[k])), None)


def phase_remat(card):
    """Phase 45 (module docstring): {model: {mode: launches}}."""
    out = {}
    with deterministic_algorithms() as nondeterministic:
        for label, make_cfg, persons in REMAT_RUNS:
            cfg = make_cfg()
            model = seeded_model(cfg)
            init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            m = cfg["MODEL"]
            raw = synthetic_raw_batch(cfg, persons, np.random.RandomState(SEED))
            batch = device_preprocess(raw_to_device(raw, DEV), tuple(m["IMAGE_SIZE"]),
                                      tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
            ref = None
            out[label] = {}
            for mode in REMAT_MODES:
                loss, grads, after, launches, ms, peak = remat_step(cfg, init, batch, mode)
                want = {k: v for k, v in remat_want(model, mode).items() if k in launches}
                out[label][mode] = launches
                if ref is None:
                    ref = (loss, grads, after)
                    diff = None
                else:
                    diff = (None if torch.equal(loss, ref[0]) else "loss") or \
                        first_difference(ref[1], grads) or first_difference(ref[2], after)
                log(f"  {label} B={len(persons)} x N={cfg['DATASET']['MAX_PATCH']} REMAT "
                    f"{mode}: loss {loss.item():.6f}, {len(grads)} gradients and "
                    f"{len(after)} state tensors "
                    + ("(the reference)" if mode == "none" else
                       "bit-equal to none's" if diff is None else f"DIFFER at {diff}")
                    + f"; launches {launches}; peak {peak:.2f} GiB, step {ms:.2f} ms [{card}]")
                if diff is not None:
                    raise AssertionError(f"{label} under REMAT {mode} is not the step without it")
                if launches != want:
                    raise AssertionError(f"{label} REMAT {mode}: launches {launches}, want {want}")
            del model, init, batch, ref
            torch.cuda.empty_cache()
    log(f"  operations torch reports without a deterministic version: {nondeterministic or 'none'}")
    return out


def detail_cfg(tree):
    """Phase 46's W48 config reading ``tree`` (a fixture under FIXTURES),
    ``TEST.DETAIL_EVAL`` on: COCO val2017 at B=16, or the OCHuman recipe's."""
    cfg = fixture_cfg() if tree == "coco_synth" else dataset_cfg("OCHuman")
    cfg["TEST"]["DETAIL_EVAL"] = True
    return cfg


DEBUG_FILES = ("gt", "hm_gt", "hm_pred")


def check_debug_files(folder, prefix):
    """The three dump files of ``prefix`` under ``folder``: their sizes."""
    from PIL import Image

    sizes = []
    for kind in DEBUG_FILES:
        path = folder / f"{prefix}_{kind}.jpg"
        if not path.exists():
            raise AssertionError(f"DEBUG.DEBUG wrote no {path.name}")
        sizes.append(Image.open(path).size)
    return sizes


def phase_detail_debug(g, card):
    """Phase 46 (module docstring)."""
    for tree in ("coco_synth", "ochuman_synth"):
        cfg = detail_cfg(tree)
        ds = fixture_dataset(cfg, "TEST_SET")
        want = json.loads((FIXTURES / tree / "expected_detail.json").read_text())
        stats = json.loads((FIXTURES / tree / "expected.json").read_text())["stats"]
        name_value, _, _, _ = validate_run(cfg, ds, None, f"detail_{tree}",
                                           eval_step_fn=lambda _model, batch: batch["target"])
        levels = {k: v for k, v in name_value.items() if k.startswith("AP(c")}
        report = (OUT_DIR / f"detail_{tree}" / "results" / "res_eval.txt").read_text()
        classes = [x for x in report.splitlines() if x.startswith("Class ")]
        err = max(abs(name_value[k] - v) for k, v in want["name_value"].items())
        log(f"  {tree}, GT oracle, TEST.DETAIL_EVAL: {levels}; AP {name_value['AP']:.6f} "
            f"(expected.json {stats['AP']:.6f}); largest |stat - expected_detail| {err:.3g}; "
            f"res_eval.txt {classes}")
        if (sorted(name_value) != sorted(want["name_value"]) or err > ORACLE_TOL
                or abs(name_value["AP"] - stats["AP"]) > ORACLE_TOL
                or classes != want["res_eval_levels"]):
            raise AssertionError(f"detail report of {tree} {dict(name_value)} vs {want}")

    cfg = fixture_cfg()
    model = random_model(cfg, g)
    model.compute_dtype = torch.bfloat16
    model.set_kernels(True)
    runs = {}
    for on in (False, True):  # deterministic algorithms: both runs do the same arithmetic
        run_cfg = copy.deepcopy(cfg)
        run_cfg["TEST"]["DETAIL_EVAL"] = on
        run_cfg["DEBUG"] = {"DEBUG": on, "SAVE_BATCH_IMAGES_GT": on, "SAVE_HEATMAPS_GT": on,
                            "SAVE_HEATMAPS_PRED": on}
        ds = COCODataset(run_cfg, str(FIXTURE), "val2017", is_train=False)
        torch.cuda.synchronize()
        reset_launches()
        with deterministic_algorithms():
            name_value, results, wall, _ = validate_run(run_cfg, ds, model, f"debug_{on}")
        torch.cuda.synchronize()
        runs[on] = (name_value, results, {k: launch_counts()[k] for k in EVAL_KERNELS}, wall)
    (nv_off, res_off, l_off, w_off), (nv_on, res_on, l_on, w_on) = runs[False], runs[True]
    sizes = check_debug_files(OUT_DIR / "debug_True" / "debug", "val_0")
    levels = {k: round(v, 6) for k, v in nv_on.items() if k.startswith("AP(c")}
    log(f"  seeded W48, bf16, TEST.DETAIL_EVAL and DEBUG.DEBUG on vs off: AP {nv_on['AP']:.6f} "
        f"vs {nv_off['AP']:.6f}, levels {levels}, results equal {res_on == res_off}, launches "
        f"{l_on} vs {l_off}; debug images val_0 {dict(zip(DEBUG_FILES, sizes))}; host "
        f"{w_on * 1e3:.1f} vs {w_off * 1e3:.1f} ms [{card}]")
    if res_on != res_off or nv_on["AP"] != nv_off["AP"] or l_on != l_off or not levels:
        raise AssertionError("validate with DETAIL_EVAL and DEBUG moved its results")
    del model
    torch.cuda.empty_cache()

    cfg = train_cfg("bfloat16", True)
    cfg["DEBUG"] = {"DEBUG": True, "SAVE_BATCH_IMAGES_GT": True, "SAVE_HEATMAPS_GT": True,
                    "SAVE_HEATMAPS_PRED": True}
    raw = synthetic_raw_batch(cfg, TRAIN_COUNTS, np.random.RandomState(SEED))
    out = OUT_DIR / "train_debug"
    shutil.rmtree(out, ignore_errors=True)
    train_loop(cfg, str(out), lambda epoch: [raw], max_epochs=1, device=DEV)
    sizes = check_debug_files(out / "debug", "train_0_0")
    log(f"  one W48 train_loop step with DEBUG.DEBUG on: {dict(zip(DEBUG_FILES, sizes))}")


def phase_tools(card):
    """Phase 47 (module docstring)."""
    cfg = presets.w48_pure_en6("coco")
    layers = cfg["MODEL"]["ENCODER_LAYERS"]
    reset_launches()
    report = compute_flops.measure(cfg, 8, 7, 10, DEV)
    torch.cuda.synchronize()
    counts = {k: launch_counts()[k] for k in EVAL_KERNELS}
    log(f"  compute_flops, COCO W48 preset, B=8 x N=7 {report['input']}: "
        f"{report['gflops_per_person']} GFLOPs/person, {report['gflops_per_batch']} a batch, "
        f"forward {report['latency_ms']} ms ({report['persons_per_sec']} persons/s, "
        f"{report['tflops_per_sec']} TFLOP/s), {report['hbm_gb_per_batch']} GB moved by the "
        f"eager ops; A and B launched {counts} over the count and 20 timed calls [{card}]")
    if not report["gflops_per_person"] > 0 or counts != {k: layers * 21 for k in EVAL_KERNELS}:
        raise AssertionError(f"compute_flops: {report}, launches {counts}")

    image = sorted((FIXTURE / "images" / "val2017").glob("*.jpg"))[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / "attention_vis.jpg"
    recipe = EXPERIMENTS / "coco" / "interformer_coco_w48_pure_en6.yaml"
    layers = to_port(load_config(str(recipe)))["MODEL"]["ENCODER_LAYERS"]
    reset_launches()
    records, grid = visualize.main(["--cfg", str(recipe), "--image", str(image), "--out",
                                    str(out), "--device", DEV, "TEST.MODEL_FILE", ""])
    torch.cuda.synchronize()
    counts = {k: launch_counts()[k] for k in EVAL_KERNELS}
    sums = max(float(np.abs(r.sum(-1) - 1.0).max()) for r in records)
    log(f"  visualize {image.name}: {len(records)} layers of {records[0].shape} weights, "
        f"largest |row sum - 1| {sums:.3g}; grid {grid.shape}; launches {counts}")
    if (len(records) != layers or sums > 1e-3 or not out.exists()
            or counts != {k: layers * (k == "encoder_ffn") for k in EVAL_KERNELS}):
        raise AssertionError(f"visualize did not record the {layers} layers")

    cfg = train_cfg("bfloat16", True)
    folder = OUT_DIR / "profile"
    shutil.rmtree(folder, ignore_errors=True)
    profile_tool.trace(cfg, str(folder), 2, True, 8, 7, DEV)
    events = json.loads((folder / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    held = {label: sum(any(p in e.get("name", "") for p in parts) for e in kernels)
            for label, parts in TRAIN_KERNEL_PARTS}
    log(f"  profile, two W48 train steps: trace.json {(folder / 'trace.json').stat().st_size} "
        f"bytes, {len(kernels)} kernel events; Kernels C and D among them {held}")
    if not all(held.values()):
        raise AssertionError(f"the trace holds no launch of a training kernel: {held}")


#: each rank process's time limit (start, build load, model, step or validate)
DDP_RANK_TIMEOUT = 300.0
#: Kernels C and D in one W48 training step, forward and backward: one a layer
DDP_STEP_LAUNCHES = 6
#: the two-rank step's gradients against the one-process step's
#: (``grad_diff``): twice the worst of the readings on the H100 (NVIDIA H100
#: 80GB HBM3, 700 W) of the two ranks and of the one-process step with its
#: images in another order, which gave the same spread (max 0.116 at
#: stage3.1.branches.2.0.conv1, L2 0.0146, all together 0.0088): both only
#: reorder f32 sums (the BatchNorms' over the batch), and a trunk ReLU input
#: within f32 noise of zero then flips a conv's gradient (6.5% of its largest
#: value on the tiny model on the CPU, either way). Phase 10's
#: TRAIN_GRAD_REL holds a path whose trunk sums run in one order.
DDP_GRAD_BOUND = {"max": 0.232, "l2": 0.029, "all_l2": 0.0176}
#: a gradient entry resolved across the two sides of phase 48: above twice
#: its leaf's largest move under the reordering, and above a thousand times
#: Adam's eps (1e-8), so that Adam's first step moves the parameter by
#: lr * sign(g) within 1e-3 lr on both sides
ADAM_RESOLVED_G = 1e-5
#: the parameters after Adam at resolved entries, two ranks vs one process
DDP_PARAM_LR = 1e-2
#: the end-to-end models' eval batch (B x N, ragged) and training batch
E2E_COUNTS = [4, 3, 1, 2, 4, 0, 2, 3]
E2E_TRAIN_COUNTS = [4, 2, 3, 1]
#: Kernels A and B in one e2e forward, and C and D in one step: 4 intra + 2 inter layers
E2E_LAYERS = 6
#: the f32 e2e step kernels on vs off (``grad_diff``): twice the worst of two
#: calls on the H100, which gave the same values (``interformer_e2e_new``: max
#: 8.6e-4 at an inter layer's linear1 bias, L2 4.9e-4 at the box-mask
#: embedding's first conv, 1.1e-4 all together; ``interformer_e2e`` 1.8e-4,
#: 1.4e-4, 6.4e-5): the inter encoder's f32 sums on C and D against the
#: plain path's reach the embedding behind it; C and D are held at 1e-4 in
#: phases 8-9 and 27
E2E_GRAD_BOUND = {"max": 2e-3, "l2": 1e-3, "all_l2": 2.5e-4}


def state_job(cfg, model, batch, dropout):
    """A ``probes/ddp_rank.py`` step job: the config, the model's weights and
    the global device batch, on the host."""
    return {"cfg": cfg, "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "batch": {k: v.detach().cpu() for k, v in batch.items()}, "dropout": dropout}


def global_batch(cfg, counts):
    """Phase 10's synthetic raw batch of ``counts`` persons an image, preprocessed."""
    m = cfg["MODEL"]
    raw = synthetic_raw_batch(cfg, counts, np.random.RandomState(SEED))
    return device_preprocess(raw_to_device(raw, DEV), tuple(m["IMAGE_SIZE"]),
                             tuple(m["HEATMAP_SIZE"]), m["SIGMA"])


def rank_launches(ranks, kernels, want):
    """Each rank's launches of ``kernels``; raises unless every rank launched
    each ``want`` times and no other kernel."""
    per_rank = [{k: v for k, v in r["launches"].items() if v} for r in ranks]
    if any(lc != dict.fromkeys(kernels, want) for lc in per_rank):
        raise AssertionError(f"launches per rank {per_rank}, want {want} of each of {kernels}")
    return per_rank[0]


def phase_ddp_step(card):
    """Phase 48: one f32 W48 step (dropout 0, kernels on) over two ``gloo``
    ranks on this card, each B=4 x N=7 of phase 10's global batch, against
    the step on the global batch in this process: the global loss within
    TRAIN_LOSS_REL, the BatchNorm statistics (the masked sync-BN) within
    1e-4 of their largest value, the summed gradients (``grad_diff``)
    within DDP_GRAD_BOUND, and the parameters after the Adam step within
    DDP_PARAM_LR lr at every gradient entry that the one-process step
    resolves against itself on the batch's images in another order
    (ADAM_RESOLVED_G; Adam's first step moves each parameter by lr times the
    sign of its gradient there, so a flipped or lost gradient shows as 2 lr
    or 1 lr); C and D launched DDP_STEP_LAUNCHES times a rank forward and
    backward; both ranks holding the same bits."""
    cfg = train_cfg("float32", True)
    batch = global_batch(cfg, TRAIN_COUNTS)
    job = state_job(cfg, seeded_model(cfg), batch, 0.0)
    t0 = time.perf_counter()
    ranks = run_ranks("step", job, 2, OUT_DIR / "ddp_step", device=DEV, backend="gloo",
                      timeout=DDP_RANK_TIMEOUT)
    t_ranks = time.perf_counter() - t0
    one = case_step(job, DEV)
    half = len(TRAIN_COUNTS) // 2  # rank 1's images first: the sums in another order
    order = torch.cat([torch.arange(half, 2 * half), torch.arange(half)])
    reordered = case_step({**job, "batch": {k: v[order] for k, v in job["batch"].items()}}, DEV)
    launches = rank_launches(ranks, TRAIN_KERNELS, DDP_STEP_LAUNCHES)
    loss_rel = abs(ranks[0]["metrics"]["loss"] - one["metrics"]["loss"]) / abs(
        one["metrics"]["loss"])
    g_ref, g_got = one["grads"], ranks[0]["grads"]
    if set(g_ref) != set(g_got):
        raise AssertionError(f"gradients of {set(g_ref) ^ set(g_got)} on one side only")
    diff, spread = grad_diff(g_got, g_ref), grad_diff(reordered["grads"], g_ref)
    lr = cfg["TRAIN"]["LR"]
    sd_ref, sd_got = one["state_dict"], ranks[0]["state_dict"]
    param_d, resolved, entries = 0.0, 0, 0
    for n, g in g_ref.items():
        noise = (reordered["grads"][n] - g).abs().max()
        sure = g.abs() > torch.clamp(2 * noise, min=ADAM_RESOLVED_G)
        resolved, entries = resolved + int(sure.sum()), entries + g.numel()
        if sure.any():
            param_d = max(param_d, (sd_got[n] - sd_ref[n])[sure].abs().max().item() / lr)
    stat_rel = max(((sd_got[k] - sd_ref[k]).abs().max() / sd_ref[k].abs().max()).item()
                   for k in sd_ref if "running" in k)
    same = ranks[0]["same"] and ranks[1]["same"] and all(
        torch.equal(v, ranks[1]["state_dict"][k]) for k, v in sd_got.items())
    log(f"  2 gloo ranks on {DEV}, B=4 x N=7 each: global loss {ranks[0]['metrics']['loss']:.8f} "
        f"vs one process {one['metrics']['loss']:.8f} (rel {loss_rel:.3g}, bound "
        f"{TRAIN_LOSS_REL:g}); acc {ranks[0]['metrics']['acc']:.4f} vs "
        f"{one['metrics']['acc']:.4f}; BN statistics max rel {stat_rel:.3g} (bound 1e-4); "
        f"parameters after Adam at {resolved} of {entries} gradient entries resolved: "
        f"max|dp| {param_d:.3g} lr (bound {DDP_PARAM_LR:g} lr); ranks "
        f"bit-equal {same}; launches per rank {launches}; host clock of the two ranks "
        f"{t_ranks:.1f} s (process start, kernel load, step)")
    log(f"  {len(g_ref)} gradients, two ranks vs one process: {describe_diff(diff)}; one process "
        f"with its images reordered vs as they were: {describe_diff(spread)}; bounds "
        + ", ".join(f"{k} {v:.3g}" for k, v in DDP_GRAD_BOUND.items()))
    if (loss_rel > TRAIN_LOSS_REL or any(diff[k][0] > DDP_GRAD_BOUND[k] for k in diff)
            or not resolved or param_d > DDP_PARAM_LR or stat_rel > 1e-4 or not same):
        raise AssertionError("the two-rank step strays from the one-process step")
    return launches


def phase_ddp_nccl(card):
    """Phase 49: one bf16 W48 step with dropout 0.1 and the kernels on in a
    process group of ``nccl`` at world size 1, bit-equal to the same step
    without a group (both in this process under deterministic algorithms):
    the metrics, every parameter and statistic after the step; then the
    step's gradients all-reduced through the group, which NCCL returns
    unchanged at world 1."""
    cfg = train_cfg("bfloat16", True)
    batch = global_batch(cfg, TRAIN_COUNTS)
    job = state_job(cfg, seeded_model(cfg), batch, RATE)
    rendezvous = OUT_DIR / "ddp_nccl_rendezvous"
    rendezvous.unlink(missing_ok=True)
    with deterministic_algorithms():
        alone = case_step(job, DEV)
        dist.init(num_processes=1, process_id=0, backend="nccl", device=DEV,
                  init_method=dist.file_init_method(rendezvous))
        try:
            backend = torch.distributed.get_backend()
            nccl = case_step(job, DEV)
            # a real collective through the group (the port's helpers do
            # nothing at world 1): the step's gradients all-reduced over one
            # rank come back as they went
            flat = torch.cat([g.reshape(-1).float() for g in nccl["grads"].values()]).to(DEV)
            reduced = flat.clone()
            t0 = time.perf_counter()
            torch.distributed.all_reduce(reduced)
            torch.cuda.synchronize()
            t_reduce = time.perf_counter() - t0
            reduced_same = torch.equal(reduced, flat)
        finally:
            dist.destroy()
    launches = rank_launches([nccl], TRAIN_KERNELS, DDP_STEP_LAUNCHES)
    differ = [k for k, v in alone["state_dict"].items() if not torch.equal(v, nccl["state_dict"][k])]
    log(f"  {backend} world 1: metrics {nccl['metrics']} vs no group {alone['metrics']}; "
        f"{len(alone['state_dict']) - len(differ)} of {len(alone['state_dict'])} state tensors "
        f"bit-equal; launches {launches}; all_reduce of the {flat.numel()} gradient values "
        f"(f32) unchanged {reduced_same}, {t_reduce * 1e3:.2f} ms host clock (the first "
        f"collective, which builds the communicator)")
    if backend != "nccl" or nccl["metrics"] != alone["metrics"] or differ or not reduced_same:
        raise AssertionError(f"the nccl world of one differs from the undistributed step: "
                             f"{differ[:5]}")
    return launches


def phase_ddp_validate(g, card):
    """Phase 50: ``validate`` over two ``gloo`` ranks on the COCO fixture at
    phase 23's global batch (8 rows a rank): the GT oracle's ``name_value``
    equal to the one-process run's, and the seeded W48 in f32 (kernels on)
    within phase 6's bound of the one-process results, A and B launched
    12 times a global batch on each rank; every rank the same results. f32:
    a bf16 forward of half a batch differs from the whole batch's by a tenth
    of the largest heat on the plain path alone (phase 51 shows it), which
    moves the random model's keypoints past any bound."""
    cfg = fixture_cfg()
    cfg["DEVICE"]["COMPUTE_DTYPE"] = "float32"
    ds = COCODataset(cfg, str(FIXTURE), "val2017", is_train=False)
    n_batches = len(list(ds.eval_batches(VAL_BATCH)))
    oracle_nv, oracle_res, *_ = validate_run(cfg, ds, None, "ddp_oracle_one",
                                             eval_step_fn=lambda _m, batch: batch["target"])
    model = random_model(cfg, g)
    model.set_kernels(True)
    model_nv, model_res, *_ = validate_run(cfg, ds, model, "ddp_model_one")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    rows = copy.deepcopy(cfg)
    rows["TEST"]["BATCH_SIZE_PER_GPU"] = VAL_BATCH // 2
    job = {"cfg": rows, "root": str(FIXTURE),
           "runs": [{"out": str(OUT_DIR / "ddp_oracle")},
                    {"out": str(OUT_DIR / "ddp_model"), "state_dict": sd}]}
    ranks = run_ranks("validate", job, 2, OUT_DIR / "ddp_validate", device=DEV, backend="gloo",
                      timeout=DDP_RANK_TIMEOUT)
    oracle = [r["runs"][0] for r in ranks]
    runs = [r["runs"][1] for r in ranks]
    if any(o["name_value"] != dict(oracle_nv) for o in oracle):
        raise AssertionError(f"two-rank oracle {oracle[0]['name_value']} vs {dict(oracle_nv)}")
    if oracle[0]["results"] != oracle[1]["results"] or runs[0]["results"] != runs[1]["results"]:
        raise AssertionError("the ranks wrote different results files")
    launches = rank_launches(runs, EVAL_KERNELS, 2 * 6 * n_batches)
    diff = results_diff(json.loads(runs[0]["results"]), model_res,
                        "the two-rank validate strays from the one-process one")
    log(f"  GT oracle over 2 ranks: AP {oracle[0]['name_value']['AP']:.6f}, every stat equal to "
        f"the one-process run's; seeded W48 f32 over 2 ranks: AP {runs[0]['perf']:.6f} vs one "
        f"process {model_nv['AP']:.6f}, {diff}; launches per rank {launches} over {n_batches} "
        f"global batches; every rank the same results file")
    return launches


def phase_call_sharded(g, card):
    """Phase 51: ``Predictor.call_sharded`` over [cuda:0, cuda:0] (each half
    of an f32 W48 batch of 8 images x 7 slots on its replica, the kernels on)
    against the unsharded call: within phase 6's bound, A and B launched 12
    times a replica call. For information, the model's forward on the whole
    batch against its two halves, f32 and bf16, kernels on and off: what
    the batch size alone moves."""
    cfg = presets.w48_pure_en6()
    model = random_model(cfg, g)
    images, pos, valid = person_inputs(cfg, 8, 7, TRAIN_COUNTS, g)
    for dt in (torch.float32, torch.bfloat16):
        model.compute_dtype = dt
        for on in (True, False):
            model.set_kernels(on)
            with torch.no_grad():
                whole = model(images, pos, valid)
                halves = torch.cat([model(images[:4], pos[:4], valid[:4]),
                                    model(images[4:], pos[4:], valid[4:])])
            log(f"  W48 forward, {str(dt)[6:]}, kernels {'on' if on else 'off'}: max|whole batch "
                f"- its halves|/max|heat| {(whole - halves).abs().max().item() / whole.abs().max().item():.3g}")
    model.compute_dtype = torch.float32
    model.set_kernels(True)
    pred = Predictor(model, cfg, flip_pairs(cfg), batch_images=8, n_buckets=(7,),
                     raw_hw=(480, 640))
    images, boxes = requests(np.random.RandomState(SEED + 1), 8)
    args = pred.pack(7, [(i, 0, img, bxs[:7]) for i, (img, bxs) in enumerate(zip(images, boxes))])
    want = pred.call_raw(*args)
    pred.call_sharded([DEV, DEV], *args)  # the replica's first call, outside the count
    torch.cuda.synchronize()
    reset_launches()
    got = pred.call_sharded([DEV, DEV], *args)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    if counts != dict.fromkeys(EVAL_KERNELS, 2 * 12):
        raise AssertionError(f"call_sharded launched {counts}, want 12 of A and B a replica")
    valid = args[4].reshape(-1).cpu().numpy()
    kp = [torch.cat(o, -1).cpu().numpy()[valid] for o in (got, want)]
    check_served([kp[0]], [kp[1]], "call_sharded over 2 replicas vs the whole call, f32",
                 "call_sharded strays from the unsharded call")
    log(f"  {int(valid.sum())} persons; launches {counts}")
    return counts


def e2e_train_cfg(name, dtype):
    """The e2e model's training config at B=4 x N=4 (``MAX_PATCH`` 4)."""
    cfg = train_cfg(dtype, True, lambda: presets.e2e_w48(name))
    cfg["DATASET"]["MAX_PATCH"] = 4
    return cfg


def phase_e2e(name, g, card):
    """Phase 52, one model name: the end-to-end model at full width, seeded
    and calibrated as phase 5. An f32 forward at B=8 x N=4 (ragged), kernels
    on vs off within phase 15's bound, A and B launched E2E_LAYERS times each
    and nothing else; one f32 training step at B=4 x N=4 at dropout 0 from
    the JAX initialisation, kernels on vs off (losses within TRAIN_LOSS_REL,
    gradients within E2E_GRAD_BOUND), C and D launched E2E_LAYERS times each
    forward and backward; requests
    served through ``Predictor`` in bf16 (buckets 2/4), A and B 2 x
    E2E_LAYERS launches a serve call. Returns the launches."""
    cfg = presets.e2e_w48(name)
    model = random_model(cfg, g)  # f32 (compute_dtype) until phase_serve
    images, pos, valid = person_inputs(cfg, 8, 4, E2E_COUNTS, g)
    with torch.no_grad():
        model.set_kernels(False)
        off = model(images, pos, valid)
        reset_launches()
        model.set_kernels(True)
        on = model(images, pos, valid)
        torch.cuda.synchronize()
    eval_counts = {k: v for k, v in launch_counts().items() if v}
    check_heatmaps(on, off, valid, f"{name} A + B", eval_counts)
    if eval_counts != dict.fromkeys(EVAL_KERNELS, E2E_LAYERS):
        raise AssertionError(f"the {name} forward launched {eval_counts}, want {E2E_LAYERS} "
                             f"of each of {EVAL_KERNELS}")
    del on, off
    log(f"  {name}: one f32 training step at dropout 0, kernels on vs off (B=4 x N=4, "
        f"persons {E2E_TRAIN_COUNTS}):")
    tcfg = e2e_train_cfg(name, "float32")
    raw = synthetic_raw_batch(tcfg, E2E_TRAIN_COUNTS, np.random.RandomState(SEED))
    tmodel = seeded_model(tcfg)
    for encoder in tmodel.encoders():
        encoder.dropout_rate = 0.0
    (l_on, g_on, c_on), (l_off, g_off, c_off) = grads_on_off(tmodel, tcfg, raw, 4,
                                                             tmodel.set_kernels)
    train_counts = {k: c_on[k] for k in TRAIN_KERNELS}
    if train_counts != dict.fromkeys(TRAIN_KERNELS, E2E_LAYERS) or any(
            c_off[k] for k in TRAIN_KERNELS):
        raise AssertionError(f"Kernels C and D with the kernels on {c_on}, off {c_off}")
    loss_rel = max(abs(l_on[k] - l_off[k]) / abs(l_off[k]) for k in l_off)
    diff = grad_diff(g_on, g_off)
    log(f"  losses on {l_on} vs off {l_off} (worst rel {loss_rel:.3g}, bound {TRAIN_LOSS_REL:g}); "
        f"{len(g_off)} gradients: " + describe_diff(diff) + f" (bounds {E2E_GRAD_BOUND}); "
        f"launches {train_counts}")
    if loss_rel > TRAIN_LOSS_REL or any(diff[k][0] > E2E_GRAD_BOUND[k] for k in diff):
        raise AssertionError(f"f32 {name} training step with kernels strays from the plain path")
    del tmodel, g_on, g_off
    torch.cuda.empty_cache()
    log(f"  {name} served through Predictor (bf16, batch 8, buckets 2/4):")
    phase_serve(model, cfg, model.set_kernels, batch_images=8, n_buckets=(2, 4),
                per_call=2 * E2E_LAYERS)
    return model, cfg, {"eval_forward": eval_counts, "train_step": train_counts}


def phase_e2e_timing(model, cfg, g, card):
    """For information: the e2e eval protocol at B=8 x N=4 and its train step
    at B=4 x N=4, bf16, kernels on and off in turns, with a profile of each
    kernels-on step."""
    step = eval_steps(model, cfg, model.set_kernels, 8, 4, g)
    eval_timing(step, 8, 4, 3, card)
    wall, busy, launches, top = profile_steps(step(True), 2)
    log(f"  eval profile, kernels on: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step; top kernels (ms/step, launches/step):")
    for name, t, c in top[:8]:
        log(f"    {t:8.3f} {c:6.0f}  {name[:110]}")
    tcfg = e2e_train_cfg(cfg["MODEL"]["NAME"], "bfloat16")
    raw = synthetic_raw_batch(tcfg, E2E_TRAIN_COUNTS, np.random.RandomState(SEED))
    step_timing(tcfg, raw, E2E_TRAIN_COUNTS, lambda m: m.set_kernels, card,
                [(f"Kernel {'C' if k.startswith('mhsa') else 'D'} "
                  f"{'forward' if k.endswith('fwd') else 'backward'}", parts)
                 for k, parts in TRAIN_KERNEL_PARTS])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 1 device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(card)

    t0 = time.perf_counter()
    so = build.build()
    build.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {so.name}")

    g = gen(SEED)
    log("phase 3 masked_mhsa kernel vs plain:")
    mhsa_err = phase_mhsa(g)
    log("phase 4 encoder_ffn kernel vs plain:")
    ffn_err = phase_ffn(g)

    cfg = presets.w48_pure_en6()
    model = random_model(cfg, g)
    log("phase 5 W48-pure-en6 full width, f32, B=8 N=7, kernels on vs off:")
    phase_model(model, cfg, g)
    log("phase 6 serving through Predictor (bf16, batch 8, buckets 2/4/7):")
    counts = phase_serve(model, cfg, model.set_kernels)
    log(f"phase 7 timing [{card}]:")
    times = phase_timing(model, cfg, g, card)
    del model
    torch.cuda.empty_cache()

    log("phase 8 mhsa_train (Kernel C) forward and backward vs plain:")
    c_err = phase_mhsa_train(g)
    log("phase 9 encoder_ffn_train (Kernel D) forward and backward vs plain:")
    d_err = phase_ffn_train(g)
    log("phase 10 training W48-pure-en6 through train_loop (bf16, B=8 N=7, kernels on):")
    train_counts, raw = phase_train(train_cfg("bfloat16", True), TRAIN_COUNTS, TRAIN_KERNELS,
                                    "train")
    log("  one f32 step at dropout 0, kernels on vs off (2 images, 12 persons):")
    phase_train_on_off(raw)
    log(f"phase 11 training timing [{card}]:")
    step_timing(train_cfg("bfloat16", True), raw, TRAIN_COUNTS, lambda m: m.set_kernels, card,
                KERNEL_D)
    times.update(phase_train_kernel_timing(g, card))

    torch.cuda.empty_cache()

    log("phases 12-14 window_attn_block (E), mlp_block (F), mlp_dwbn (G) kernels vs plain:")
    errs = phase_hrt_kernels(g)
    cfg = presets.hrt_interformer()
    log("phase 15 HRFormer-B I²R-Net full width, f32, B=8 N=4, kernels on vs off:")
    model, g_counts = phase_hrt_model(cfg, g)
    log("  serving through Predictor (bf16, batch 8, buckets 2/4/7):")
    hrt_counts = phase_serve(model, cfg, hrt_kernels(model), HRT_KERNELS)
    log(f"phase 16 HRT timing [{card}]:")
    step = eval_steps(model, cfg, hrt_kernels(model), 8, 4, g)
    eval_timing(step, 8, 4, 3, card)
    reset_launches()
    wall, busy, launches, top = profile_steps(step(True), 2)
    f_ms = sum(t for name, t, _ in top if "mlp_mma_kernel" in name or "mlp_finish_kernel" in name)
    e_ms = sum(t for name, t, _ in top if "attn_mma_kernel" in name or "attn_out_kernel" in name)
    calls = launch_counts()
    log(f"  profile, kernels on: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step; Kernel E {e_ms:.3f} ms/step in {calls['window_attn_block'] // 3} "
        f"calls/step; Kernel F {f_ms:.3f} ms/step in {calls['mlp_block'] // 3} "
        f"calls/step; top kernels (ms/step, launches/step):")
    for name, t, c in top[:12]:
        log(f"    {t:8.3f} {c:6.0f}  {name[:110]}")
    wall, busy, launches, _ = profile_steps(step(False), 2)
    log(f"  profile, kernels off: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step")
    phase_g_route_timing(model, cfg, g, card)
    times.update(phase_hrt_kernel_timing(g, card))
    del model, step
    torch.cuda.empty_cache()

    log("phase 17 kernel 9 (HRFormer window-attention training block) forward and backward "
        "vs plain:")
    errs.update(phase_hrt_train_kernels(g))
    log("phase 18 training the HRFormer-B I²R-Net through train_loop (bf16, B=12 N=2, "
        "kernels on):")
    hrt_train_counts, hrt_raw = phase_train(hrt_train_cfg("bfloat16", True), HRT_TRAIN_COUNTS,
                                            HRT_TRAIN_KERNELS, "train_hrt")
    log("  one f32 step at dropout 0 and drop path 0, kernels on vs off (4 images, "
        f"{sum(HRT_TRAIN_COUNTS[:4])} persons):")
    phase_hrt_train_on_off(hrt_raw)
    torch.cuda.empty_cache()
    log(f"phase 19 HRT training timing [{card}]:")
    step_timing(hrt_train_cfg("bfloat16", True), hrt_raw, HRT_TRAIN_COUNTS, hrt_kernels, card,
                [(f"kernel 9 backward {label}", parts) for label, parts in KERNEL9_BWD])
    times.update(phase_hrt_train_kernel_timing(g, card))
    torch.cuda.empty_cache()

    log("phase 20 kernel 7 (HRFormer block in one pass) vs plain and vs E then F:")
    errs["full_block"], k7_diff = phase_full_block(g)
    log(f"  largest |difference| from E then F over the maps: {k7_diff:.3g}")
    cfg = onepass_cfg()
    log("phase 21 HRFormer-B I²R-Net built with FUSED_BLOCK_EVAL_ONEPASS, full width, f32, "
        "B=8 N=4, kernels on vs off:")
    model = phase_onepass_model(cfg, g)
    log("  serving through Predictor at 256x192 (bf16, batch 8, buckets 2/4/7):")
    onepass_counts = phase_serve(model, cfg, use_kernels(model), ONEPASS_KERNELS,
                                 absent=NOT_ONEPASS)
    cfg288 = onepass_cfg((288, 384))
    model288 = random_model(cfg288, g)
    log("  serving through Predictor at 384x288 (bf16, batch 4, bucket 2; branch 0 96x72):")
    phase_serve(model288, cfg288, use_kernels(model288), ONEPASS_KERNELS, batch_images=4,
                n_buckets=(2,), absent=NOT_ONEPASS)
    del model288
    torch.cuda.empty_cache()
    log(f"phase 22 one-pass timing [{card}]:")
    times.update(phase_onepass_timing(model, cfg, g, card))

    del model
    torch.cuda.empty_cache()
    log("phase 23 validate on the COCO-format fixture (W48-pure-en6, full width, B=16):")
    decode_ms = phase_decode(card)
    cfg = fixture_cfg()
    ds = COCODataset(cfg, str(FIXTURE), "val2017", is_train=False)
    phase_validate_oracle(cfg, ds)
    model = phase_validate_model(cfg, ds, g, card)
    phase_validate_split(model, cfg, ds, decode_ms, card)
    del model
    torch.cuda.empty_cache()
    log("  the TPH I²R-Net (full width, B=16) on the same fixture:")
    cfg = tph_fixture_cfg()
    ds = COCODataset(cfg, str(FIXTURE), "val2017", is_train=False)
    phase_validate_model(cfg, ds, g, card, "validate_tph")
    torch.cuda.empty_cache()

    log("phase 24 Kernels A and B at the TPH intra encoder's shapes vs plain:")
    phase_tph_kernels(card)
    torch.cuda.empty_cache()
    cfg = presets.tph_interformer()
    log("phase 25 TPH I²R-Net full width, f32, B=2 N=4, kernels on vs off:")
    model = phase_tph_model(cfg, g)
    log("  serving through Predictor (bf16, batch 8, buckets 2/4):")
    phase_serve(model, cfg, model.set_kernels, batch_images=8, n_buckets=(2, 4),
                per_call=2 * TPH_LAUNCHES)
    log(f"phase 26 TPH timing [{card}]:")
    phase_tph_timing(model, cfg, g, card)
    del model
    torch.cuda.empty_cache()

    log("phase 27 Kernels C and D at the TPH training shapes vs plain:")
    tph_times, tph_errs = phase_tph_train_kernels(card)
    torch.cuda.empty_cache()
    log("phase 28 training the TPH I²R-Net through train_loop (bf16, B=4 N=4, kernels on):")
    _, tph_split, tph_raw = phase_tph_train(TPH_TRAIN_PERSONS)
    log(f"  one f32 step at dropout 0, kernels on vs off (2 images, "
        f"{sum(TPH_TRAIN_PERSONS[:2])} persons):")
    phase_tph_train_on_off(tph_raw)
    torch.cuda.empty_cache()
    log(f"phase 29 TPH training timing [{card}]:")
    phase_tph_train_timing(tph_raw, TPH_TRAIN_PERSONS, card)
    torch.cuda.empty_cache()

    log("phase 30 the training data path on the COCO, CrowdPose and OCHuman fixtures:")
    phase_train_data(card)
    log("phase 31 training W48 COCO from JPEGs through train_loop (bf16, B=8 N=7, WORKERS 8):")
    jpeg_counts = phase_train_jpegs(card)
    torch.cuda.empty_cache()
    log("phase 32 the CrowdPose W48 recipe (B=32 N=5, 14 joints):")
    recipes = {"crowdpose": phase_dataset_recipe("crowdpose", g, card)}
    log("phase 33 the OCHuman W48 recipe without a position embedding (B=32 N=3):")
    recipes["ochuman"] = phase_dataset_recipe("OCHuman", g, card)
    torch.cuda.empty_cache()

    log("phase 34 the ten recipes read from their YAML:")
    phase_read_recipes()
    recipe_runs, recipe_shapes = phase_recipes(g, card)
    log("phase 40 MPII (PCKh):")
    mpii_launches = phase_mpii(g, card)
    torch.cuda.empty_cache()

    served = phase_serving(g, card)

    t_new = time.perf_counter()
    log(f"phase 45 DEVICE.REMAT, one bf16 step of each model under each value, deterministic "
        f"algorithms [{card}]:")
    remat_launches = phase_remat(card)
    log("phase 46 TEST.DETAIL_EVAL and DEBUG.DEBUG:")
    phase_detail_debug(g, card)
    torch.cuda.empty_cache()
    log("phase 47 the analysis tools (compute_flops, visualize, profile):")
    phase_tools(card)
    log(f"  phases 45-47: {time.perf_counter() - t_new:.1f} s; phases 2-47: "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t_new = time.perf_counter()
    log(f"phase 48 one f32 W48 step over two gloo ranks on this card vs one process [{card}]:")
    ddp = {"step_f32_gloo_2_ranks": phase_ddp_step(card)}
    log("phase 49 one bf16 W48 step over nccl at world size 1 vs no process group:")
    ddp["step_bf16_nccl_world_1"] = phase_ddp_nccl(card)
    log("phase 50 validate over two gloo ranks on the COCO fixture vs one process:")
    ddp["validate_2_ranks"] = phase_ddp_validate(g, card)
    torch.cuda.empty_cache()
    log("phase 51 Predictor.call_sharded over [cuda:0, cuda:0] vs the whole call:")
    ddp["call_sharded"] = phase_call_sharded(g, card)
    torch.cuda.empty_cache()
    log(f"phase 52 the end-to-end models at full width (B=8 N=4 eval, B=4 N=4 training) "
        f"[{card}]:")
    e2e_launches = {}
    for name in ("interformer_e2e", "interformer_e2e_new"):
        model, e2e_cfg, e2e_launches[name] = phase_e2e(name, g, card)
        if name == "interformer_e2e_new":
            log(f"  {name} timing [{card}]:")
            phase_e2e_timing(model, e2e_cfg, g, card)
        del model
        torch.cuda.empty_cache()
    log("  Kernels A and B at the e2e eval batch's intra shape (P=32 persons of 3072 tokens):")
    e2e_ab_times, e2e_ab_errs = phase_tph_kernels(card, attn=[(32, TPH_TOKENS)],
                                                  rows=32 * TPH_TOKENS)
    log(f"  phases 48-52: {time.perf_counter() - t_new:.1f} s; phases 2-52: "
        f"{time.perf_counter() - t0:.1f} s")

    counts.update(train_counts)
    counts.update({k: hrt_train_counts[k] for k in ("window_attn_block_train_fwd",
                                                    "window_attn_block_train_bwd")})
    counts.update({k: hrt_counts[k] for k in ("window_attn_block", "mlp_block")}, **g_counts)
    counts["full_block"] = onepass_counts["full_block"]
    errs.update({"masked_mhsa": mhsa_err, "encoder_ffn": ffn_err,
                 "mhsa_train_fwd": c_err["fwd"], "mhsa_train_bwd": c_err["bwd"],
                 "encoder_ffn_train_fwd": d_err["fwd"], "encoder_ffn_train_bwd": d_err["bwd"]})
    # Kernels C and D at the TPH shapes (phases 27-28): their times, error and
    # the launches of each encoder in phase 28's run
    tph = {name: {**tph_times[name], "max_abs_err": tph_errs[name], "launches": tph_split[name]}
           for name in TRAIN_KERNELS}
    # phases 31-33: the launches of W48 COCO trained from JPEGs and validated,
    # and each kernel of the CrowdPose and OCHuman recipes at their shapes
    new_shapes = {name: {"coco_jpeg": {"launches": jpeg_counts[name]},
                         **{k: v[name] for k, v in recipes.items()}} for name in jpeg_counts}
    # phases 35-40: each kernel's launches in each recipe's training and test
    # runs (and MPII's validate), and the fields of the new shapes held there
    for name, fields in recipe_shapes.items():
        new_shapes.setdefault(name, {}).update(fields)
    for name in KERNELS:
        new_shapes.setdefault(name, {})["recipes"] = {
            stem: {"train": run["train"].get(name, 0), "test": run["test"].get(name, 0)}
            for stem, run in recipe_runs.items()}
    for name in EVAL_KERNELS:
        new_shapes[name]["recipes"]["mpii_validate"] = mpii_launches
    # phases 41 and 44: each kernel's launches in each served artifact's run
    for name in KERNELS:
        new_shapes.setdefault(name, {}).update(
            {f"served_artifact_{label}": {"launches": run.get(name, 0)}
             for label, run in served.items()})
    # phase 45: each training kernel's launches in each model's step under each REMAT value
    for name in REMAT_KERNELS:
        new_shapes.setdefault(name, {})["remat"] = {
            label: {mode: runs[mode][name] for mode in REMAT_MODES}
            for label, runs in remat_launches.items()}
    # phases 48-51: each of A-D's launches on a rank of each data-parallel run
    # (phase 51: in the sharded call, both replicas);
    # phase 52: the e2e models' launches, and the fields at the e2e shapes (A
    # and B at P=32 x 3072 measured there; C and D's training shapes, P=16 x
    # 3072 intra, are phase 27's)
    e2e_fields = {"masked_mhsa": {**e2e_ab_times[f"A P=32 S={TPH_TOKENS}"],
                                  "max_abs_err": e2e_ab_errs[f"A P=32 S={TPH_TOKENS}"],
                                  "shape": f"P=32 S={TPH_TOKENS} C=96"},
                  "encoder_ffn": {**e2e_ab_times[f"B R={32 * TPH_TOKENS}"],
                                  "max_abs_err": e2e_ab_errs[f"B R={32 * TPH_TOKENS}"],
                                  "shape": f"R={32 * TPH_TOKENS} C=96 F=192"},
                  **{name: {k: v for k, v in tph[name].items() if k != "launches"}
                     for name in TRAIN_KERNELS}}
    for name, fields in e2e_fields.items():
        part = "eval_forward" if name in EVAL_KERNELS else "train_step"
        new_shapes.setdefault(name, {})["e2e"] = {
            **fields, "launches": {m: run[part][name] for m, run in e2e_launches.items()}}
        new_shapes[name]["ddp"] = {"launches": {run: c.get(name, 0) for run, c in ddp.items()}}
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": counts[name],
                "max_abs_err": errs[name], **times[name],
                **({"tph": tph[name]} if name in tph else {}), **new_shapes.get(name, {})}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
