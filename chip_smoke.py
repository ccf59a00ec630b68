"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each ending with a line that gives its elapsed seconds:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the port's five CUDA kernels, one nvcc call; ptxas's registers
              and spills and the HGMMA count in the SASS of each
              instantiation of the tensor-core kernels (K-B: block 1's
              kernel and the warp-specialised one for every other width,
              at C = 128 and at any other C, with its shared memory, its
              weight ring's stages and its cluster size; K-D and K-E,
              which share one kernel: bf16 or f32 store, weights resident
              or streamed);
  3. kernels  each kernel against its plain PyTorch version on the card, at
              edge shapes (NMS: random, exact-threshold, K = 1024, 2048 and
              4096 rows, a NaN first score, keep_top_k 0, disjoint boxes
              (all kept), identical ones (one kept) and overlaps within a
              few ulps of the threshold; conv: ragged tiles, f32 and bf16
              inputs, K-D/K-E at 12 channels); K-B beyond block 1 (VGG
              block 2, 64 -> 128, the kernels API): on the RON-320 model's
              own pool1 of the batch (K-B block 1) with its conv2_1/conv2_2,
              bf16 and f32 x, at [32, 160, 160, 64] and cropped to a ragged
              [3, 36, 52] at 64 -> 128 and 8 -> 8, each against its plain
              version; block 1 chained into block 2 against the model's
              pool2; a torch.profiler pass over one block-2 call (its own
              kernel, no cuDNN or cuBLAS one) and its peak memory (below
              one [B, H, W, C] intermediate); then K-A and K-C on rows
              wider than MAX_K (the kernel's wide-row cluster path):
              seeded [2, 8732], [2, 21250] and [2, 24564] rows, 'min' and
              'union', K-C capped at 20 and 200, each mask bit-equal to its
              plain version (K-A's run a row at a time and freed; K-C's
              at cap 20 the first 20 kept of its cap-200 mask), each
              launch's device ms (torch.profiler) beside its bound, with
              its kept count, steps and cluster size;
  4. main     full-width RON-320 with the trained weights packed in
              tests/fixtures/e2e_parity_trained.npz, pixels to boxes:
              (a) float32, TF32 off, against the fixture's reference
              detections, through the fixpoint NMS (the Detector's) and
              again through `nms_sorted_kernel(method='scan')`, then once
              more under torch's default flags (cuDNN TF32 on); (b) bf16
              detections of the four images against the f32 ones, with
              block 1 unfused (cuDNN) and through K-B; (c) bf16, batch 32,
              fused block 1, through K-A and K-B (launch counts read around
              this run: K-C, K-D and K-E stay at 0);
  5. api      the kernels API on the main path's own data (counts read
              around it): K-C on the bf16 run's NMS candidates, K-D on
              relu(conv1_1) of its batch with conv1_2's weights, K-E on the
              VGG block-2 and block-3 tails; each output against its plain
              version, and K-D against K-B on the same batch;
  6. grad     K-B's gradients (kernel forward, recompute backward) against
              autograd through the unfused composition, bf16, batch 32; the
              same at VGG block 2's widths on phase 3's pool1, batch 14;
  7. realtime f32  the realtime head (`RealtimeDetector`, whole-image NMS
              through K-C) on phase 4a's f32 forward of the four images, each
              with its own min size: the published config (top_k 2048, then
              the shipped 400: the same sets) and the dense "exercised" one
              against the fixture's realtime reference detections; launch
              counts read around it (K-C launched, K-A not); both modes
              (whole-image and class-wise) against the same head with K-C's
              plain version on the same CUDA tensors, bit for bit;
  8. realtime bf16 the realtime head on the bf16 model with K-B, batch 1
              and batch 32 (counts: K-B and K-C launched, K-A not);
  9. eval     `StreamingEvaluator` (the Detector, K-A and K-B, then the
              matcher on the card) over batch-32 batches with gts from the
              fixture's realtime references, its TP/FP against the matcher
              run on the CPU over the same detections; `RealtimeEvaluator`
              on the four images at their original sizes, scored by
              `PascalVocEvaluator` against those references written as VOC
              XML: AP 1.0 for every class that has a gt;
 10. train    RON-320 training with the trained weights, on host batches
              of the four images at the 512x512 working canvas (uint8) with
              gts from their realtime references: (a) one f32 step at batch
              2 on the card under torch's default flags (cuDNN TF32 on)
              against the same step on the CPU (same weights, batch,
              augmentation and loss draws): loss and parts within 1e-4
              relative, updated parameters and BN statistics within 1e-4;
              its gradients against the step in float64 on the CPU (median
              error within 1e-3, each within 5e-2), and the same step with
              the f32 pin taken out (TF32) must fail that median;
              (b) `Trainer.train` bf16 with K-B, batch 14: 20 steps from a
              step-0 checkpoint of the trained weights, K-B launched once a
              step and no other kernel, every loss finite, a checkpoint at
              step 20 that a second Trainer resumes to step 24, and the
              train-mode loss of one fixed batch (fixed draws) lower after
              than before (its eval-step loss recorded); (c) K-B inside a
              bf16 step: its conv1_* gradients against autograd through the
              unfused composition on the same block-1 input and output
              gradient, within phase 6's tolerance, and against the whole
              fuse_block1=False step (recorded);
 11. ssd f32  SSD-300 and SSD-512 with weights drawn from a numpy seed (He
              scaled, each multibox head scaled to a logit std of 2.5 on the
              four images; the class probabilities' spread printed and
              gated), in f32 at batch 2 on the card against the CPU's forward
              of the same weights and the four demo images (TF1-resized to
              300 and 512): logits, locations and probabilities within 1e-4
              of each one's largest magnitude; the Detector with the SSD eval
              preset (K-A) and the realtime head in class-wise mode (K-C) on
              the card's outputs against the CPU's on the same outputs: equal
              keep counts, scores and boxes within 1e-5; launches read around
              the phase (K-A and K-C);
 12. ssd bf16 SSD-300 at batch 32 and SSD-512 at batch 8, bf16, fused block 1,
              through the Detector (K-B and K-A once each); K-B's output on
              the batch against its plain version (at 300 its tiles are
              ragged); the bf16 detections against the f32 ones (recorded);
 13. ssd train (a) one f32 SSD-300 step at batch 2, dropout 0, card vs CPU
              (the SSD augmentation with the same draws): losses within 1e-4
              relative, updated parameters within 1e-4; (b) `Trainer.train`
              with ssd_300_vgg, bf16, K-B, the ssd_300 preset's matching and
              the repo's from-scratch SSD optimizer recipe, batch 32: 10
              steps, K-B once a step and no other kernel, every loss finite,
              the train-mode loss of a fixed batch lower after than before;
 14. stem     the JAX package's other training forms of VGG block 1:
              (a) f32 on the card, RON-320 (trained weights, the four demo
              images) and SSD-300 (phase "ssd f32"'s weights, two images)
              with s2d_stem against plain: outputs within 1e-4 of each
              one's largest magnitude; one f32 RON-320 train step at batch
              2 with s2d_stem and one with remat_blocks12 against the plain
              step: loss within 1e-5 relative, each gradient within 1e-4 of
              its tensor's largest magnitude (a pre-BN conv bias: of its
              kernel's); (b) in a child process (`--stem-timing`, so that
              its profiler windows leave this process's host timings
              alone), bf16 Trainer steps with TrainConfig.s2d_stem on, the
              model switched through K-B, plain, s2d_stem and
              remat_blocks12, RON-320 at batch 14 and 32 (K-B counted in
              its steps, no kernel in the others), SSD-300 at 32 plain and
              s2d_stem: ms (CUDA events, two runs), peak memory, device
              busy share; (c) the f32 RON-320 Detector at batch 32 with
              nms_method='loop': K-C launched once and no other kernel, its
              keep mask on the Detector's rows bit-equal to the plain
              version, the detections against 'pallas' (K-A; recorded);
 15. heavy    ron_320_vgg_heavy (fc6 7x7 with 4096 channels, fc7 1x1 with
              4096) from seeded weights: f32 batch 2, card vs CPU within
              1e-4; bf16 batch 32 through the Detector with K-B and K-A;
 16. eval losses  `StreamingEvaluator(loss_config=...)` on SSD-300 (bf16,
              `SsdLossConfig`) and on the trained RON-320 (bf16,
              `RonLossConfig`, fixed draws): each batch's loss/* metrics
              against the CPU loss on the same outputs within 1e-5 relative;
 17. timing   the bf16 batch-32 Detector's images/s and stage split; the
              realtime head's batch-1 latency (p50, p90, pipelined) and
              device-idle share, its batch-32 images/s and stage split; the
              streaming evaluator's images/s and the matcher's time; each
              kernel's time beside its plain version's, its bound and a
              library yardstick (K-E also tail by tail; the NMS kernels by
              their device time in a torch.profiler trace, with the
              wrapper's per-call time beside it; K-C on the realtime head's
              own rows); then torch.profiler passes (top device kernels,
              device events, device busy share) over a Detector batch, the
              realtime head's batch-1 call and batch-32 candidates, and
              the streaming evaluator; the bf16 train step (K-B) at batch 14
              and 32: ms, images/s, its stage split (augment, encode,
              forward, backward, optimizer) by CUDA events, peak memory, a
              profiler pass over three steps, and K-B's training cost
              (kernel forward + recompute backward against autograd through
              the unfused cuDNN composition); the SSD-300 (batch 32), SSD-512
              (batch 8 and 32) and heavy RON-320 (batch 32) Detectors' images/s
              and stage splits, the SSD-300 bf16 train step at batch 32 (ms,
              images/s, stage split, peak memory); K-B at [32, 300, 300, 3],
              [8, 512, 512, 3] and [32, 512, 512, 3] beside its bound, plain
              version and cuDNN; K-B at VGG block 2 ([32, 160, 160, 64] ->
              128) beside its bound, plain version and cuDNN, and its
              batch-14 forward + recompute backward; K-A on the SSD
              Detectors' rows and K-C on SSD-300's class-wise realtime rows.
 18. reference import  the reference's RON-320: the 184 slim tensors named in
              tests/fixtures/reference_forward.npz, regenerated by name as
              tools/reference_forward.py does (`weight_for`, a copy), mapped
              by the port's `slim_ron_to_flat` and loaded with
              `from_jax_params`; on the card in float64 against the TF1
              reference graph's outputs and in f32 (TF32 off, torch's own
              convolutions) against that float64 forward, each within
              tests/test_model_parity.py's bounds (raw outputs 2e-3 x
              max(1, |ref|max), probabilities 5e-4); the f32 forward against
              the graph and through cuDNN recorded; the bf16 Detector with
              K-B at batch 32 on the same weights (K-B and K-A once each),
              its detections against the f32 Detector's recorded;
 19. warm start  a seeded ssd.pytorch VGG-16 `.pth` (`vgg.N`, fc6/fc7 at
              31/33) saved with torch.save; a bf16 RON-320 Trainer with K-B,
              checkpoint_format "torch", BGR -> RGB, TensorBoard on: the 30
              backbone tensors equal the source exactly (conv1_1's input
              channels reversed), every other parameter and every buffer the
              seeded init of a Trainer without checkpoint_path; 10 steps at
              batch 14 (K-B 10 times, no other kernel, finite losses); a
              second Trainer on the model dir resumes at step 10 and does not
              warm-start again; the step's ms at batch 14 (CUDA events); then
              SSD-300 from a Caffe model of the same VGG (encoded with the
              port's protobuf primitives, conv4_3's norm scale included):
              its 26 conv tensors restored exactly, the rest at the seeded
              init, 3 steps at batch 32 with K-B;
 20. import cli  `import-ckpt --format torch` of the same `.pth` into a fresh
              model dir, `inspect-ckpt` listing every parameter, and a bf16
              Trainer resuming there at step 0 with the warm start's
              backbone;
 21. tensorboard  phase 19's event file read back with every record's CRCs
              verified: each scalar of metrics.jsonl at each log step, as
              float32.
 22. jpeg     the port's JPEG decoder (its only one), built from
              data/_native/jpeg_decode.c: where the card host has cv2 or
              PIL, bit-equal to them on the fixture JPEGs, and its resize to
              512x512 within 1 level of cv2's; the eight images of
              tests/fixtures/voc_mini (320x320, 500x375, 375x500; gray,
              4:4:4, restart markers, 4:2:0) decode, and make 320x320 eval
              canvases, equal to Pillow's and JAX's by digest
              (tests/fixtures/voc_mini_ref.npz, tools/make_voc_mini.py); the
              resize within 1 level of the fixture's cv2 resizes; decode ms
              per image on one thread and on the pipeline's thread pool;
 23. records  `cli convert-data` of the eight images under 264 ids in two
              shards; every record parses back to its XML and JPEG;
              `Trainer.make_batches`' first batch (seed 0, batch 4) against
              JAX's: gts exact, pixels within 1 level;
 24. cli train  `cli train` from those records: RON-320, bf16, K-B, batch 14,
              5 steps from a step-0 checkpoint of the trained weights (K-B 5
              times, no other kernel; finite losses; a checkpoint at step 5);
              its step ms beside a Trainer's on in-memory batches (warm runs
              of 12 steps in turns: records, memory, memory, records);
 25. cli eval  `cli eval`, RON-320 bf16 with the trained weights, batch 32,
              over the 264 records, the last batch padded (K-A and K-B
              launched): mAP, APs and TP/FP equal to `StreamingEvaluator.run`
              on the same batches decoded beforehand; img/s of both (warm
              runs in turns: CLI, direct, direct, CLI);
 26. cli realtime-eval  `cli realtime-eval`, f32, over tests/fixtures/voc_mini
              (K-C launched, K-A and K-B not): the detections it writes
              against JAX's rows: equal counts, classes and images, scores and
              boxes within 2e-3.
 27. dist     distribution on the one card, ranks in processes of their
              own (`parallel.testing.run_ranks`, the kernels built by the
              parent beforehand), gloo between them (NCCL takes one rank per
              device): (a) one f32 RON-320 step on mesh (2, 1), global batch
              14, against the one-process step on the same batch and draws
              (losses and parts within 1e-4 relative, counts equal, updated
              parameters and BN statistics within 1e-4, ranks bit-identical);
              5 bf16 Trainer steps with K-B on (2, 1), K-B once a step in
              each rank, losses finite, rank 0's checkpoint restored in one
              process; (b) one f32 step on mesh (1, 2) at batch 2, the same
              gates, grad_norm too; (c) `cli eval` on mesh [2, 1] as under
              `python -m torch.distributed.run` (env://), 32 rows a rank:
              mAP, APs and TP/FP equal to phase 25's, K-A and K-B in each
              rank; (d) env:// at
              world size 1 with NCCL: an all-reduce and one Trainer step on
              mesh (1, 1). The 2-rank step's ms beside the one-process step
              and the gradient all-reduce's ms are recorded.
 28. zoo      the classification networks at their published depth, with
              seeded weights (He-scaled kernels, BN means N(0, 0.5),
              variances U(0.5, 1.5)) on seeded images in [-1, 1]:
              Inception-V3 (1001 classes, its weights read through
              `inception_v3_from_torch` from a torchvision-layout state_dict
              made in the script), Xception (8 middle blocks, 1000),
              Inception-ResNet-V2 (10/20/9, 1001) at 299x299 and
              VGG16Classifier (reduced, 1000) at 224x224: (a) f32 at batch 2
              (full f32 convolutions) against the CPU's forward, logits and
              every endpoint within 1e-4 of each one's largest magnitude;
              (c) bf16 at batch 32, its logits against f32's (top-1
              agreement and the largest gap, recorded), ms and images/s by
              CUDA events and the device's busy share (torch.profiler);
              (d) one train-mode forward at batch 8, f32: the updated BN
              running statistics within 1e-4 of the CPU's; (e) launch
              counts read around the phase: no port kernel; (f)
              `profile_trace` around two bf16 Inception-V3 forwards writes
              a trace that holds CUDA kernel events;
 29. cli infer  `cli infer` on the eight JPEGs of tests/fixtures/voc_mini,
              f32 RON-320 with the trained weights at batch 1: K-C launched
              once an image, K-A and K-B not; eight pictures and the JAX
              CLI's lines; the detections bit-equal to `RealtimeDetector`
              called directly on the same decoded, resized and whitened
              images, and within phase 26's 2e-3 of the same CLI on the
              CPU; ms an image (the CLI's run, then two warm runs).
 30. learn    the learning checks, the supervisor and `--debug-nans`:
              (a) `tools/overfit_check.py`, RON-tiny overfit on its 8
              images on the card (400 f32 steps, then the Detector through
              K-A): mAP over the classes with gts >= 0.8, K-A launched and
              no other kernel; (b) `tools/synthetic_e2e.py` at full width
              with the verify recipe (RON-320, canvas 400, bf16, batch 32,
              fuse_block1) cut from its 2500 steps to 1000: 800
              training and 96 held-out
              synthetic images written by the port's JPEG encoder; K-B once
              a training step and no other kernel; the bf16 evaluator over
              the held-out split (K-A and K-B, once a batch); held-out mAP07
              over classes 1-6 >= 0.6; (c) `tools/train_supervised.py`
              over `cli train --preset ron_320` on (b)'s records (Grain
              input, bf16, K-B) with max_host_rss_gb=1e-6 and max_steps=3:
              exactly four launches (exit 75 three times, then 0), the
              supervisor's exit 0, checkpoints at steps 1, 2 and 3, each
              step's record keys equal to those of one uninterrupted 3-step
              CLI run and its loss within LEARN_LOSS_RTOL; (d) `cli
              --debug-nans train` from a step-0 checkpoint with one NaN
              weight raises FloatingPointError naming the weight's module;
              the same command without the flag stops at the trainer's own
              finite check. Each part prints its mAP or result, seconds and
              launch counts.
 31. bench    (a) `cli bench` in this process at the JAX `bench.py`'s
              constants (RON-320: the Detector at batch 32 with K-B and
              K-A, twice, and with shared_top_k=1000 + approx_top_k,
              which selects exactly; bf16 train steps at batch 14 and
              twice at 32; the realtime head's
              batch-1 latency, K-C), its output captured: one JSON line
              whose keys are the JAX record's (read from bench.py's
              source), no null, every number finite and > 0, two inference
              and two batch-32 train runs; K-A, K-B and K-C launched, no
              other kernel (counted around the call); the line printed
              beside the nvidia-smi line; (b) the f32 trained RON-320
              through a Detector with shared_top_k=1000, the card (K-A)
              against the CPU (plain version) on the four images: keep
              counts equal, scores and boxes within 2e-3.
 32. images   in a child process in which `import PIL` and `import cv2`
              fail: (a) the PNGs and progressive JPEGs of
              tests/fixtures/image_formats decode, route by route ("cv2" for
              the pipeline and the realtime evaluator, "pil" for `infer`),
              to the stored digests of cv2's and PIL's decodes; (b) `cli
              infer`, f32 RON-320 with the trained weights, on two fixture
              PNGs and two progressive JPEGs: K-C once an image and no
              other kernel, four pictures read back, the detections
              bit-equal to RealtimeDetector called directly; (c) the f32
              RON-320 Detector at batch 2 with top_k 21250 (every anchor):
              K-A once on [40, 21250] rows, its mask bit-equal to the plain
              version run a row at a time and the detections equal, the
              postprocess's peak memory far below one [R, K, K] tensor, the
              launch's device ms beside its bound; the realtime head with
              top_k 21250 the same with K-C on [2, 21250]; (d) two Trainer steps with dump_debug_images_every=1
              and TensorBoard: two debug JPEGs and two TensorBoard PNGs that
              the port's decoders read.
 33. rehearsal `tools/dress_rehearsal.py`'s `main` at full width on the
              crowded generator, cut to REHEARSAL_ENV (RON-320, 200 training
              and 64 test images, 200 recipe steps at batch 14 in bf16 from
              the seeded torch VGG-16), then `tools/ab_detection_config.py`
              on its work dir (AB_MAX_BOXES=56): the test records and the
              VOCdevkit tree agree image by image (JPEG bytes, size, labels,
              difficult flags; boxes within 0.051 px); K-A and K-C launched
              in the rehearsal and no other kernel, K-A in the streaming
              eval and K-C in the realtime eval; each A/B variant launches
              its kernel only (K-C for 'loop' and 'fixpoint', K-A for
              'pallas' and 'auto'); 'approx_top_k only' and 'fixpoint' give
              the exact run's detections and 'presel + pallas' the
              preselection's, bit for bit (a digest of every Detector
              output); every mAP finite; result.json with the JAX tool's
              keys and its exit code matching its `ok`. Whatever the mAP
              (200 steps do not reach the tool's 0.5), the mAPs and the
              K-A/K-C keep-set parting count are printed.
 34. probes   the ported repo-root tools (`ron_tensorflow_tpu_torch/tools/`):
              `list_caffemodel` on a seeded VGG-16 caffemodel (every layer
              listed); `perf_breakdown` (bf16 RON-320 Detector, K-B and
              K-A, batches 1 and 32), `perf_post` (its stages at b32, K-C's
              scan NMS and K-A's full postprocess), `perf_topk` (the
              selections bit-equal to a stable sort, then five Detector
              configs), `perf_block_times`, `perf_remat12_bandwidth`,
              `perf_train_breakdown`, `perf_step_probe` and
              `perf_train_experiments` (seven step variants, K-B in
              `block1*`) at RON-320's width and the JAX tools' batches
              with one warm-up and two timed calls; `leak_probe` (8 MB, 100
              iterations): every returned number finite and > 0 (deltas
              and RSS growth finite), each tool's kernels launched, K-A,
              K-B and K-C over the phase and no other kernel.
Then one JSON line with the kernels' numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed phase raises: exit code != 0 and
no result line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import io
import itertools
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

if __name__ == "__main__" and sys.argv[1:] == ["--images"]:
    # phase "images" runs in a process where PIL and cv2 cannot be imported, whatever the host has
    sys.modules["PIL"] = sys.modules["cv2"] = None

import numpy as np
import torch
import torch.nn.functional as F

from ron_tensorflow_tpu_torch import bench as bench_mod
from ron_tensorflow_tpu_torch import full_f32_convs, kernels
from ron_tensorflow_tpu_torch.cli import infer_images as cli_infer_images
from ron_tensorflow_tpu_torch.cli import main as cli_main
from ron_tensorflow_tpu_torch.cli import restore_for_eval
from ron_tensorflow_tpu_torch.config import MatchConfig, TrainConfig
from ron_tensorflow_tpu_torch.data import decode, jpeg
from ron_tensorflow_tpu_torch.data.example import _len_delimited, _varint
from ron_tensorflow_tpu_torch.data.pipeline import PipelineConfig, batch_iterator, parse_voc_example, to_device
from ron_tensorflow_tpu_torch.data.preprocess import PreprocessConfig, apply_augment, draw_augment, eval_preprocess, whiten
from ron_tensorflow_tpu_torch.data.resize import tf1_bilinear_resize
from ron_tensorflow_tpu_torch.data.tfrecord import list_shards, read_records
from ron_tensorflow_tpu_torch.data.voc import VOC_CLASSES, parse_annotation
from ron_tensorflow_tpu_torch.eval import PascalVocEvaluator, RealtimeEvaluator, StreamingEvaluator
from ron_tensorflow_tpu_torch.inference.detector import (
    DetectionConfig,
    Detector,
    RealtimeConfig,
    RealtimeDetector,
)
from ron_tensorflow_tpu_torch.kernels import _build
from ron_tensorflow_tpu_torch.kernels import nms as kernels_nms
from ron_tensorflow_tpu_torch.kernels.fused_conv_pool import block1_reference
from ron_tensorflow_tpu_torch.kernels.nms import (
    MAX_K,
    compact_keep,
    fixpoint_keep,
    nms_sorted_kernel,
    suppression_matrix,
)
from ron_tensorflow_tpu_torch.losses.ssd import SsdLossConfig
from ron_tensorflow_tpu_torch.models import (
    InceptionResnetV2,
    InceptionV3,
    VGG16Classifier,
    Xception,
    get_network,
    shard_model,
)
from ron_tensorflow_tpu_torch.models.layers import BatchNorm, max_pool_2x2
from ron_tensorflow_tpu_torch.models.zoo_import import inception_v3_from_torch
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC, SSD_300_SPEC
from ron_tensorflow_tpu_torch.models.vgg import check_block1_forms
from ron_tensorflow_tpu_torch.models.testing import (
    scale_ssd_heads,
    seeded_flax_params,
    torchvision_inception_v3_state_dict,
)
from ron_tensorflow_tpu_torch.ops import nms as ops_nms
from ron_tensorflow_tpu_torch.ops.ap import StreamingTpFp
from ron_tensorflow_tpu_torch.ops.matching import match_all_classes
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from ron_tensorflow_tpu_torch.ops.math import exact_top_k_chunked
from ron_tensorflow_tpu_torch.tools.time_nms import device_ms
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager, flatten_params
from ron_tensorflow_tpu_torch.train.optimizer import global_norm, make_optimizer
from ron_tensorflow_tpu_torch.parallel import (
    GlobalBatch,
    host_local_to_global,
    initialize_distributed,
    local_device,
    make_mesh,
    sharded_names,
    take_rows,
)
from ron_tensorflow_tpu_torch.parallel.testing import run_ranks
from ron_tensorflow_tpu_torch.train.state import (
    all_reduce_flat,
    create_train_state,
    detection_loss_fn,
    gathered_state_dict,
    make_train_step,
    train_forward,
)
from ron_tensorflow_tpu_torch.train.tf_checkpoint import slim_ron_to_flat
from ron_tensorflow_tpu_torch.train.trainer import Trainer
from ron_tensorflow_tpu_torch.tools import ab_detection_config, dress_rehearsal, overfit_check, synthetic_e2e
from ron_tensorflow_tpu_torch.tools import (
    leak_probe,
    list_caffemodel,
    perf_block_times,
    perf_breakdown,
    perf_post,
    perf_remat12_bandwidth,
    perf_step_probe,
    perf_topk,
    perf_train_breakdown,
    perf_train_experiments,
)
from ron_tensorflow_tpu_torch.tools.synthetic_data import make_dataset
from ron_tensorflow_tpu_torch.utils.profiling import profile_trace
from ron_tensorflow_tpu_torch.utils.tensorboard import read_events
from ron_tensorflow_tpu_torch.weights import from_jax_params, jax_names, load_trained_fixture

REPO = Path(__file__).resolve().parent
TRAINED_FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"
IMAGES = ("1", "2", "3", "4")
BATCH = 32
# the streaming-eval defaults (thr 0.4, 'min', top_k 200), with K-A named: 'auto' runs K-A on the card and
# K-C's plain version on the CPU, and the CPU references here are K-A's plain version
NMS_CFG = DetectionConfig(nms_method="pallas")
# The realtime head: the published flags (select 0.6, objectness 0.95, union
# NMS 0.4, keep 20) with the shipped top_k 400, and with
# tests/test_e2e_parity.py's top_k 2048; its class-wise mode with the
# streaming eval's thresholds, as RealtimeConfig.for_spec sets them, rows
# [B*20, 400], 'min' NMS, 100 kept a class.
RT_SHIPPED = RealtimeConfig()
RT_PUBLISHED = RealtimeConfig(top_k=2048)
RT_CLASS_WISE = RealtimeConfig(class_wise=True, select_threshold=0.01, objectness_threshold=0.03, nms_mode="min",
                               keep_per_class=100, keep_top_k=200)
LAT_ITERS = 50  # batch-1 latency samples, as the JAX bench.py takes them
EVAL_BATCHES = 4  # batch-32 batches of the streaming evaluator
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# Kernel against plain version, bf16 output: both round conv1_1 and the
# output to bf16 but sum in another order, so an output may land one bf16
# ulp apart (at most 2^-7 of its value: rtol), and a conv1_1 value that
# rounds the other way shifts the outputs it feeds by |w2| times its ulp
# (atol, for outputs near 0). A dropped tap or input channel moves outputs
# by ~1-2%, well past rtol.
BLOCK1_RTOL, BLOCK1_ATOL = 8e-3, 0.1
PARITY_ATOL = 2e-3  # tests/test_e2e_parity.py's tolerance on scores and boxes
# K-D/K-E against their plain versions: the f32 sums differ in order, within
# CONV_F32_TOL * (1 + |plain|); a bf16-rounded output may land one bf16 ulp
# further apart (see conv_err).
CONV_F32_TOL = 1e-4
# K-B's gradients against autograd through the unfused composition, as a
# share of each gradient's largest magnitude: the backward IS that
# composition's VJP, but cuDNN's bf16 weight gradients may sum with atomics
# in another order on each run, a few bf16 ulps (2^-8 each).
GRAD_REL_TOL = 2e-2
SCAN_KEEP_TOP_K = [16, 100, 200]  # K-C's cap in the edge-shape checks
NMS_SOURCE = "ron_tensorflow_tpu_torch/csrc/nms_greedy.cu"  # K-A and K-C: one greedy sweep
# The kernels that run on the tensor cores: wrapper name -> {instantiation:
# a part of its mangled name}. K-D and K-E launch one kernel templated on the
# store type (uint16_t, "t", holds bf16; "f" f32) and on whether its weights
# stream (Lb1: Ci or Co above 64) or stay resident (Lb0).
CONV_MMA = "conv3x3_relu_pool2_mma_kernel"
CONV_MMA_INSTANTIATIONS = {"bf16 out, resident weights": CONV_MMA + "ItLb0E",
                           "bf16 out, streamed weights": CONV_MMA + "ItLb1E",
                           "f32 out, resident weights": CONV_MMA + "IfLb0E",
                           "f32 out, streamed weights": CONV_MMA + "IfLb1E"}
KB_FOREIGN_KERNELS = ("cudnn", "cublas", "gemm", "xmma", "cutlass", "implicit")  # library kernel names
# K-B's block-2 kernel is templated on conv B's N (ILi<N>EE in its mangled name): 128 at C = 128, 64 at
# every other C.
KB2_KERNEL = "fused_vgg_block2_kernel"
TENSOR_CORE_KERNELS = {
    "fused_vgg_block1": {"block 1 (Ci 3, C 64)": "fused_vgg_block1_kernel",
                         "C = 128 (block 2: 64 -> 128)": KB2_KERNEL + "ILi128EE",
                         "every other width": KB2_KERNEL + "ILi64EE"},
    "fused_stem_conv_relu_pool2": {k: v for k, v in CONV_MMA_INSTANTIATIONS.items() if k.startswith("bf16")},
    "fused_conv3x3_relu_pool2": CONV_MMA_INSTANTIATIONS,
}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def smi_sample():
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


@contextlib.contextmanager
def torch_default_flags():
    """torch's default precision flags inside the block: cuDNN f32
    convolutions in TF32, f32 matmuls in full f32."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def tensor_core_report():
    """For each instantiation of each tensor-core kernel: ptxas's registers
    and spills, its dynamic shared memory and the HGMMA instructions in its
    SASS (`cuobjdump -sass` on the built library, where the toolkit has it).
    Fails if an instantiation was built without HGMMA."""
    ptxas = _build.ptxas_report()
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    hgmma = None
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hgmma, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                hgmma[fn] = 0
            elif fn is not None and "HGMMA" in line:
                hgmma[fn] += 1
    lib = _build.library()
    report = {}
    print(f"  {KB2_KERNEL}: {lib.fused_vgg_block2_smem_bytes()} bytes dynamic shared memory, a weight ring of "
          f"{lib.fused_vgg_block2_stages()} stages of 8 KB, cluster size 1; at C = 128 conv A N = 64, conv B N = "
          f"{lib.fused_vgg_block2_conv_b_n(128)}")
    for name, instantiations in TENSOR_CORE_KERNELS.items():
        report[name] = {"tensor_cores": {}}
        for label, kernel in instantiations.items():
            # the launcher of the kernel: K-B's block-2 one, else the wrapper's own
            smem = getattr(lib, "fused_vgg_block2_smem_bytes" if "block2" in kernel else f"{name}_smem_bytes")()
            (mangled,) = [n for n in ptxas if kernel in n]
            info = {**ptxas[mangled], "smem_bytes": smem, "hgmma": None if hgmma is None else hgmma[mangled]}
            print(f"  {name} {label} ({mangled}): {info['registers']} registers, {info['spill_stores']} bytes "
                  f"spill stores, {info['spill_loads']} bytes spill loads, {smem} bytes dynamic shared memory, "
                  f"HGMMA in SASS: {info['hgmma'] if hgmma is not None else 'not measured (no cuobjdump)'}")
            if info["hgmma"] == 0:
                raise AssertionError(f"{mangled} holds no HGMMA instruction")
            report[name]["tensor_cores"][label] = info
    return report


def bound(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sorted_rows(seed, r, k, grid=None):
    """Score-sorted NMS rows on the card; grid=g snaps boxes to multiples of
    1/g, so overlaps land exactly on thresholds such as 0.5."""
    g = torch.Generator().manual_seed(seed)
    cy, cx = torch.rand(2, r, k, generator=g) * 0.6 + 0.2
    h, w = torch.rand(2, r, k, generator=g) * 0.35 + 0.05
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = torch.round(boxes * grid) / grid
    scores = torch.where(torch.rand(r, k, generator=g) < 0.2, 0.0, torch.rand(r, k, generator=g))
    scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return scores.cuda().contiguous(), boxes.cuda().contiguous()


def edge_rows(edge, r, k):
    """NMS rows at the sweep's edges: 'nan first' (random rows whose first
    score is NaN, as a descending sort puts it: the valid candidates are no
    prefix), 'disjoint' (boxes in disjoint grid cells: all K kept, the
    longest chain of steps), 'identical' (one box K times: one kept) and
    'borderline' (box 0 against boxes shifted by float32 ulps so that their
    overlap with it lies within a few ulps of 0.4, the threshold these rows
    are run at, in 'min' mode for the even ones and in 'union' mode for the
    odd ones: the pairs that K-C's kernel decides by dividing)."""
    scores = torch.linspace(1.0, 0.01, k).repeat(r, 1).cuda()
    if edge == "nan first":
        scores, boxes = sorted_rows(k + 7, r, k)
        scores[:, 0] = float("nan")
    elif edge == "disjoint":
        side = int(k ** 0.5 + 0.999999)
        cell = torch.arange(k)
        y0, x0 = (cell // side) / side, (cell % side) / side
        boxes = torch.stack([y0, x0, y0 + 0.5 / side, x0 + 0.5 / side], -1).repeat(r, 1, 1)
    elif edge == "borderline":
        j = torch.arange(k)
        x = torch.where(j % 2 == 0, 0.6, 3 / 7) + (j // 2 - k // 4) * 2.0 ** -24
        x[0] = 0.0
        boxes = torch.stack([torch.full((k,), 0.2), x, torch.full((k,), 0.7), x + 1], -1).repeat(r, 1, 1)
    else:
        boxes = torch.tensor([0.2, 0.3, 0.6, 0.5]).repeat(r, k, 1)
    return scores.contiguous(), boxes.cuda().contiguous()


def check_nms(label, scores, boxes, thr, mode, caps, errs):
    """Both NMS kernels against their plain versions on one row set: K-A,
    and K-C at each cap. Returns K-A's mask."""
    got = kernels.nms_fixpoint_keep_mask(scores, boxes, thr, mode)
    ref = kernels.nms_fixpoint_keep_mask_plain(scores, boxes, thr, mode)
    torch.cuda.synchronize()
    err, n_diff = mask_err(got, ref)
    errs["nms_fixpoint_keep_mask"] = max(errs["nms_fixpoint_keep_mask"], err)
    r, k = scores.shape
    print(f"  nms_fixpoint_keep_mask {label} [{r},{k}] {mode}: {n_diff} mask differences, "
          f"{int(ref.sum())} kept")
    if n_diff:
        raise AssertionError(f"NMS keep masks differ ({label}, {mode})")
    kept = []
    for cap in caps:
        got_c = kernels.nms_scan_keep_mask(scores, boxes, thr, cap, mode)
        ref_c = kernels.nms_scan_keep_mask_plain(scores, boxes, thr, cap, mode)
        torch.cuda.synchronize()
        err, n_diff = mask_err(got_c, ref_c)
        errs["nms_scan_keep_mask"] = max(errs["nms_scan_keep_mask"], err)
        if n_diff:
            raise AssertionError(f"scan NMS keep masks differ ({label}, {mode}, keep_top_k {cap}): {n_diff}")
        kept.append(int(ref_c.sum()))
    print(f"  nms_scan_keep_mask {label} [{r},{k}] {mode}, keep_top_k {list(caps)}: "
          f"0 mask differences, {kept} kept")
    return ref


def mask_err(got, ref):
    """Largest |kernel - plain| over a keep mask (0 or 1), and the number
    of entries that differ."""
    diff = (got.int() - ref.int()).abs()
    return float(diff.max()), int(diff.sum())


def block1_err(label, got, ref):
    """Check the block-1 kernel's output against its plain version; return
    max |kernel - plain|."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    used = float((diff / (BLOCK1_ATOL + BLOCK1_RTOL * ref.abs())).max())
    print(f"  fused_vgg_block1 {label}: max |kernel - plain| = {float(diff.max()):.6g} "
          f"(max |plain| = {float(ref.abs().max()):.6g}), {int((diff > 0).sum())} of {diff.numel()} differ, "
          f"{used:.3f} of the tolerance used")
    torch.testing.assert_close(got, ref, rtol=BLOCK1_RTOL, atol=BLOCK1_ATOL)
    return float(diff.max())


def bf16_ulp(ref):
    """One bf16 ulp of each bf16-valued entry, 2^(floor(log2 |ref|) - 7); 0 at
    0. The exponent comes from frexp, exact: log2 on the card is not exact at
    powers of two."""
    _, e = torch.frexp(ref)
    return torch.where(ref != 0, torch.ldexp(torch.ones_like(ref), e - 8), 0.0)


def conv_err(label, got, ref, rounded, f32_tol=CONV_F32_TOL):
    """Check a K-D/K-E output against its reference: |diff| within
    f32_tol * (1 + |ref|), plus one bf16 ulp of ref where the output is
    rounded to bf16. Returns max |diff|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    g, r = got.double(), ref.double()
    diff = (g - r).abs()
    tol = f32_tol * (1 + r.abs()) + (bf16_ulp(r) if rounded else 0.0)
    used = float(torch.where(diff > 0, diff / tol, 0.0).max())  # inf where tol is 0 and diff is not
    print(f"  {label}: max |kernel - ref| = {float(diff.max()):.6g} (max |ref| = {float(r.abs().max()):.6g}), "
          f"{int((diff > 0).sum())} of {diff.numel()} differ, {used:.3f} of the tolerance used")
    if used > 1.0:
        raise AssertionError(f"{label}: {int((diff > tol).sum())} outputs out of tolerance")
    return float(diff.max())


def conv_case(seed, shape, cin, cout, dtype):
    """Random NHWC activations (post-ReLU scale) and He-scaled OIHW weights."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(*shape, cin, generator=g) * 3).to(dtype).cuda()
    w = (torch.randn(cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5).cuda()
    b = (torch.randn(cout, generator=g) * 0.1).cuda()
    return x, w, b


CONV_KERNELS = {
    "fused_stem_conv_relu_pool2": (kernels.fused_stem_conv_relu_pool2, kernels.fused_stem_conv_relu_pool2_plain),
    "fused_conv3x3_relu_pool2": (kernels.fused_conv3x3_relu_pool2, kernels.fused_conv3x3_relu_pool2_plain),
}


def check_kernels(block1_weights):
    """Phase 3: every kernel against its plain version on the card."""
    errs = {"nms_fixpoint_keep_mask": 0.0, "nms_scan_keep_mask": 0.0}
    for label, (r, k, grid, thr) in {
        "main-path shape": (BATCH * 20, NMS_CFG.top_k, None, NMS_CFG.nms_threshold),
        "exact-threshold grid": (64, NMS_CFG.top_k, 8, 0.5),
        "K=1024": (8, 1024, 4, 0.25),
        "K=2048": (16, 2048, 4, 0.25),
        f"K={MAX_K}": (8, MAX_K, 4, 0.25),
    }.items():
        for mode in ("min", "union"):
            check_nms(label, *sorted_rows(r + k, r, k, grid), thr, mode, SCAN_KEEP_TOP_K, errs)
    for edge, want in (("nan first", None), ("disjoint", "all"), ("identical", 1), ("borderline", None)):
        for k in (NMS_CFG.top_k, MAX_K):
            for mode in ("min", "union"):
                scores, boxes = edge_rows(edge, 4, k)
                keep = check_nms(edge, scores, boxes, NMS_CFG.nms_threshold, mode, (0, 100, k), errs)
                kept = keep.sum(-1)
                if want is not None and not bool((kept == (k if want == "all" else want)).all()):
                    raise AssertionError(f"{edge} rows at K={k}: kept {kept.tolist()}, expected {want} a row")
                if edge == "nan first" and bool(keep[:, 0].any()):
                    raise AssertionError("a NaN score was kept")

    for name, shape, cin, cout in (
        ("fused_stem_conv_relu_pool2", (2, 36, 52), 64, 64),  # ragged tiles
        ("fused_conv3x3_relu_pool2", (3, 36, 52), 128, 256),  # ragged, Ci != Co
        ("fused_conv3x3_relu_pool2", (2, 20, 26), 512, 512),  # 8 64-channel chunks of K and of N
        ("fused_conv3x3_relu_pool2", (3, 36, 52), 64, 12),  # Co no multiple of 8: padded, cut back
        ("fused_stem_conv_relu_pool2", (2, 36, 52), 12, 12),  # C no multiple of 8
    ):
        kernel, plain = CONV_KERNELS[name]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = conv_case(sum(shape) + cin, shape, cin, cout, dtype)
            rounded = dtype == torch.bfloat16 or kernel is kernels.fused_stem_conv_relu_pool2
            err = conv_err(f"{name} {list(shape) + [cin]} -> {cout} {dtype}", kernel(x, w, b), plain(x, w, b), rounded)
            errs[name] = max(errs.get(name, 0.0), err)

    w1, b1, w2, b2 = block1_weights
    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for shape in ((BATCH, 320, 320), (3, 36, 52)):
        # whitened-pixel scale: VGG-mean-subtracted values in about +-150
        x = (torch.rand(*shape, 3, generator=g) * 255 - 120).to(torch.bfloat16).cuda()
        got = kernels.fused_vgg_block1(x, w1, b1, w2, b2)
        ref = kernels.fused_vgg_block1_plain(x, w1, b1, w2, b2)
        worst = max(worst, block1_err(str(list(shape) + [3]), got, ref))
    errs["fused_vgg_block1"] = worst
    return errs


def check_block2(state, images, max_err):
    """Phase 3, K-B beyond block 1's widths (the kernels API: no model path
    fuses block 2, as none in the JAX package does): the bf16 RON-320's own
    pool1 of the batch (its `_block1`, K-B) through K-B with the model's
    conv2_1/conv2_2, bf16 and f32 x, at full size and cropped to ragged
    tiles at 64 -> 128 and 8 -> 8 (the first 8 channels and weights), each
    held by `block1_err` to the plain version; then block 1 chained into
    block 2 (two K-B launches, counted): its first stage equal to the
    model's pool1, its output against the model's pool2 (cuDNN's bf16 convs
    on that pool1) within `chain_err`'s gate. Returns pool1 (NHWC), the
    block-2 weights and the chain's launches, for phases "grad" and
    "timing"."""
    model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=True)
    model.load_state_dict(state, strict=True)
    bb = model.to("cuda").eval().backbone
    block1 = [t.detach() for c in (bb.conv1_1, bb.conv1_2) for t in (c.conv.weight, c.conv.bias)]
    block2 = [t.detach() for c in (bb.conv2_1, bb.conv2_2) for t in (c.conv.weight, c.conv.bias)]
    x = images.repeat(BATCH // len(IMAGES), 1, 1, 1).to(torch.bfloat16).contiguous()
    worst = 0.0
    with torch.inference_mode():
        pool1 = nhwc(bb._block1(x.permute(0, 3, 1, 2)))
        for dtype in (torch.bfloat16, torch.float32):
            crop = pool1[:3, :36, :52].to(dtype).contiguous()
            for label, xin, w in (("block 2", pool1.to(dtype), block2), ("block 2 ragged", crop, block2),
                                  ("8 -> 8 ragged", crop[..., :8].contiguous(),
                                   [block2[0][:8, :8], block2[1][:8], block2[2][:8, :8], block2[3][:8]])):
                kernels.reset_launch_counts()
                got = kernels.fused_vgg_block1(xin, *w)
                torch.cuda.synchronize()
                if kernels.fused_vgg_block1.launches != 1:
                    raise AssertionError(f"K-B {label}: {kernels.fused_vgg_block1.launches} launches, expected 1")
                name = f"{label} {list(xin.shape)} -> {w[0].shape[0]} {dtype}"
                if got.shape != (*xin.shape[:1], xin.shape[1] // 2, xin.shape[2] // 2, w[0].shape[0]) or got.dtype != dtype:
                    raise AssertionError(f"K-B {name}: output {tuple(got.shape)} {got.dtype}")
                worst = max(worst, block1_err(name, got, kernels.fused_vgg_block1_plain(xin, *w)))

        y1 = bb.conv2_1(pool1.permute(0, 3, 1, 2))
        ref_pool2 = nhwc(max_pool_2x2(bb.conv2_2(y1)))
        kernels.reset_launch_counts()
        stage1 = kernels.fused_vgg_block1(x, *block1)
        pool2 = kernels.fused_vgg_block1(stage1, *block2)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        if launches["fused_vgg_block1"] != 2 or sum(launches.values()) != 2:
            raise AssertionError(f"block 1 -> block 2 chain: launches {launches}, expected K-B twice")
        if not torch.equal(stage1, pool1):
            raise AssertionError("the chain's block 1 differs from the model's pool1")
        chain_err(f"block 1 -> block 2 chained {list(x.shape)} -> {list(pool2.shape)}", pool2,
                  kernels.fused_vgg_block1_plain(pool1, *block2), ref_pool2, y1, block2[2])
        del y1, ref_pool2, stage1, pool2
    max_err["fused_vgg_block1"] = max(max_err["fused_vgg_block1"], worst)
    del model, bb
    return {"pool1": pool1, "weights": block2, "launches": launches["fused_vgg_block1"], "max_abs_err": worst,
            **block2_one_launch(pool1, block2)}


def block2_one_launch(x, w):
    """One K-B call at block 2: a torch.profiler pass over it (on fresh
    copies of the weights, so the wrapper's layout of them runs too) must
    show the port's kernel and no library one (early in the run: on the
    H100 a window at the end of phase "timing" has come back without any
    device event, though the same call in a fresh process never did), and its
    peak memory above what was allocated before it must stay below one
    [B, H, W, C] bf16 intermediate."""
    c = w[0].shape[0]
    # each profiled call on fresh copies of the weights, as a first call on new weights: the wrapper lays
    # them out (`_cached_weight_image`) before the launch. A window holding the one cached launch alone came
    # back without any device event on the H100, as a one-call window of phase "timing" once did.
    prof = profile_call(f"K-B block 2 {list(x.shape)} -> {c}",
                        lambda: kernels.fused_vgg_block1(x, *[t.clone() for t in w]))
    names = [t["name"] for t in prof["top"]]
    foreign = [n for n in names if any(k in n.lower() for k in KB_FOREIGN_KERNELS)]
    if not any(KB2_KERNEL in n for n in names) or foreign:
        raise AssertionError(f"K-B block 2's profile: kernels {names}; library kernels {foreign}")
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = kernels.fused_vgg_block1(x, *w)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
    bsz, h, wd, _ = x.shape
    intermediate = bsz * h * wd * c * 2
    print(f"  fused_vgg_block1 block 2: a call's peak memory {peak} bytes above its inputs, one [B, H, W, C] "
          f"intermediate {intermediate}")
    if peak >= intermediate:
        raise AssertionError(f"K-B block 2 allocated {peak} bytes, an [B, H, W, C] intermediate is {intermediate}")
    del out
    return {"profile": prof, "peak_bytes_above_inputs": peak, "intermediate_bytes": intermediate}


def chain_err(label, got, plain, model_ref, y1, w2):
    """Check K-B's block-1 -> block-2 chain against the model's pool2. The
    model's bf16 convs (cuDNN) sum in another order than the kernel and its
    plain version, so conv2_1 values round the other way now and then (one
    bf16 ulp of values up to a few hundred, 2 at 256-512), and each such
    value moves the pool2 outputs it feeds by |w2| times that ulp: more
    than `block1_err`'s atol, which the plain version itself misses there
    (8 of 26 214 400 outputs at 1.022 of it, measured on the H100 for the
    kernel and the plain version alike). The gate: BLOCK1_RTOL, and an atol
    of one such value, max |w2| times the ulp of max |conv2_1|, from this
    run's tensors. `block1_err`'s usage is printed for both."""
    flip = float(w2.float().abs().max()) * float(bf16_ulp(y1.float().abs().max()))
    ref = model_ref.float()
    for who, t in (("kernel", got), ("plain version", plain)):
        diff = (t.float() - ref).abs()
        same_gate = diff / (BLOCK1_ATOL + BLOCK1_RTOL * ref.abs())
        print(f"  fused_vgg_block1 {label}, the {who} vs the model's pool2: max diff {float(diff.max()):.6g} (max "
              f"|ref| {float(ref.abs().max()):.6g}), {int((diff > 0).sum())} of {diff.numel()} differ; "
              f"block1_err's gate: {float(same_gate.max()):.4f} used, {int((same_gate > 1).sum())} outside; "
              f"this gate (atol {flip:.4g}): {float((diff / (flip + BLOCK1_RTOL * ref.abs())).max()):.4f} used")
    torch.testing.assert_close(got.float(), ref, rtol=BLOCK1_RTOL, atol=flip)


# SSD-300's, RON-320's and SSD-512's anchors (a top_k at every anchor gives such rows), each with the
# mode K-C runs there: SSD's class-wise 'min' rows, the realtime head's whole-image 'union' rows. K-A
# runs both.
WIDE_K = {8732: "min", 21250: "union", 24564: "min"}
WIDE_CAPS = (20, 200)  # K-C's caps on them: the realtime head's keep_top_k and the class-wise keep_top_k
WIDE_REPS = 5  # profiled launches of each wide-row call


def timed_once(fn):
    """(fn's result, its milliseconds on the card by CUDA events, one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def wide_nms_call(scores, boxes, thr, mode, cap, steps=None):
    """K-A (cap None) or K-C on the rows."""
    if cap is None:
        return kernels.nms_fixpoint_keep_mask(scores, boxes, thr, mode, steps=steps)
    return kernels.nms_scan_keep_mask(scores, boxes, thr, cap, mode, steps=steps)


def wide_nms_timing(scores, boxes, thr, mode, cap, keep):
    """A wide-row launch's device time beside its bound, the sweep's steps a
    row and the cluster's size."""
    r, k = scores.shape
    steps = torch.zeros(r, dtype=torch.int32, device=scores.device)
    wide_nms_call(scores, boxes, thr, mode, cap, steps)
    ms, seen = device_ms(lambda: wide_nms_call(scores, boxes, thr, mode, cap), reps=WIDE_REPS)
    pairs = sweep_pairs(scores, boxes, thr, mode, keep, dividing=cap is not None)
    bound_ms, bound_by = bound(r * k * (4 + 16 + 1), 12 * pairs, PEAK_F32_FLOPS)
    ctas, tile = kernels_nms.cluster_layout(r, k)
    held = [len(torch.unique(row.nonzero().squeeze(1) // tile)) for row in keep]
    return {"rows": [r, k], "mode": mode, "keep_top_k": cap, "ms": ms, "launches_profiled": seen, "pairs": pairs,
            "bound_ms": bound_ms, "bound_by": bound_by, "steps": steps.tolist(), "tiles_holding_kept": held,
            "cluster_ctas": ctas, **kept_stats(keep)}


def wide_nms_part(name, scores, boxes, thr, mode, cap, ref, plain_ms):
    """One wide-row call of K-A (cap None) or K-C against its plain
    version's mask `ref`: 0 mask differences, then the launch's device time
    beside its bound, its kept count, steps and cluster size."""
    keep = wide_nms_call(scores, boxes, thr, mode, cap)
    err, n_diff = mask_err(keep, ref)
    r, k = scores.shape
    if n_diff:
        raise AssertionError(f"{name} on wide rows [{r},{k}] {mode} (keep_top_k {cap}): {n_diff} mask differences")
    part = {**wide_nms_timing(scores, boxes, thr, mode, cap, keep), "plain_ms": plain_ms, "max_abs_err": err}
    print(f"  {name} wide rows [{r},{k}] {mode}{'' if cap is None else f', keep_top_k {cap}'}: 0 mask differences, "
          f"{part['ms']:.4f} ms device a launch, bound {part['bound_ms']:.4g} ms by {part['bound_by']} "
          f"({part['pairs']} overlaps needed), plain {plain_ms:.1f} ms; kept per row "
          f"{keep.sum(-1).tolist()}, steps {part['steps']} (tiles holding a kept box {part['tiles_holding_kept']}), "
          f"cluster of {part['cluster_ctas']} CTAs", flush=True)
    return part


def check_wide_rows():
    """Phase 3, rows of more than MAX_K candidates (the kernel's wide-row
    cluster path): seeded [2, 8732], [2, 21250] and [2, 24564] rows, K-A in
    'min' and 'union' mode (against its plain version a row at a time) and
    K-C capped at 20 and 200 in WIDE_K's mode (its plain version takes K
    steps of ~0.5 ms: run once at the larger cap, whose first 20 kept are
    the mask at cap 20, since a taken candidate's kills do not depend on
    the cap), each mask bit-equal; each launch's device time beside its
    bound, with its kept count, steps and cluster size."""
    out = {"nms_fixpoint_keep_mask": [], "nms_scan_keep_mask": []}
    thr = NMS_CFG.nms_threshold
    for k, scan_mode in WIDE_K.items():
        scores, boxes = sorted_rows(k + 11, 2, k)
        for mode in ("min", "union"):
            ref, plain_ms = timed_once(lambda: kernels.nms_fixpoint_keep_mask_plain(scores, boxes, thr, mode))
            out["nms_fixpoint_keep_mask"].append(
                wide_nms_part("nms_fixpoint_keep_mask", scores, boxes, thr, mode, None, ref, plain_ms))
            if mode == scan_mode:
                top = max(WIDE_CAPS)
                ref, plain_ms = timed_once(lambda: kernels.nms_scan_keep_mask_plain(scores, boxes, thr, top, mode))
                for cap in WIDE_CAPS:
                    out["nms_scan_keep_mask"].append(wide_nms_part(
                        "nms_scan_keep_mask", scores, boxes, thr, mode, cap, ref & (torch.cumsum(ref, -1) <= cap),
                        plain_ms))
            del ref
        del scores, boxes
        torch.cuda.empty_cache()
    return out


def f32_parity(state, images, flags):
    """Phase 4a: float32 against the reference detections: the Detector as
    it runs (fixpoint NMS), then its candidates through the scan NMS.
    Returns the Detector's detections, the f32 model and its forward
    outputs of the images."""
    model = RON(RON_320_SPEC, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    det = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")
    dets = det(images)
    check_detections(f"{flags}, fixpoint NMS (the Detector's)", *dets)
    with torch.inference_mode():
        out = det.model(images)
        flat_s, flat_b = det.candidates(out)
        scan_s, scan_b = nms_sorted_kernel(flat_s, flat_b, NMS_CFG.nms_threshold, NMS_CFG.keep_top_k,
                                           NMS_CFG.nms_mode, method="scan")
    c = RON_320_SPEC.num_classes - 1
    check_detections(f"{flags}, scan NMS", scan_s.reshape(len(images), c, -1),
                     scan_b.reshape(len(images), c, -1, 4))
    return dets, model, out


def bf16_drift(state, images, f32_dets):
    """Phase 4b: how far the bf16 detections of the four images lie from the
    f32 ones (`detection_drift`), with block 1 unfused (cuDNN) and through
    K-B."""
    drift = {}
    for fuse in (False, True):
        model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=fuse)
        model.load_state_dict(state, strict=True)
        kernels.reset_launch_counts()
        dets = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")(images)
        torch.cuda.synchronize()
        if kernels.fused_vgg_block1.launches != int(fuse):
            raise AssertionError("the bf16 drift run did not take the intended block 1")
        label = "K-B" if fuse else "unfused (cuDNN)"
        d = drift[label] = detection_drift(f32_dets, dets)
        print(f"  bf16 vs f32 detections, block 1 {label}: keep counts equal in {d['pairs_equal_counts']} of "
              f"{d['pairs']} (image, class) pairs; {d['detections_bf16']} detections vs {d['detections_f32']}; "
              f"over the equal pairs max |score diff| {d['max_abs_score_diff']:.6g}, max |box diff| "
              f"{d['max_abs_box_diff']:.6g}")
    return drift


def check_detections(label, scores, boxes):
    """Detections [B, C-1, keep_top_k(, 4)] of the demo images against the
    fixture's reference: equal keep counts and labels, scores and boxes
    within PARITY_ATOL."""
    scores, boxes = scores.cpu().numpy(), boxes.cpu().numpy()
    fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
    worst, n_kept = 0.0, 0
    for i, img in enumerate(IMAGES):
        for cls in range(1, RON_320_SPEC.num_classes):
            ref_s = fx[f"img_{img}_stream_c{cls}_scores"][0]
            ref_b = fx[f"img_{img}_stream_c{cls}_boxes"][0]
            ref_n = int((ref_s > 0).sum())
            got_n = int((scores[i, cls - 1] > 0).sum())
            if got_n != ref_n:
                raise AssertionError(f"image {img} class {cls}: kept {got_n} vs reference {ref_n}")
            np.testing.assert_allclose(scores[i, cls - 1, :ref_n], ref_s[:ref_n], atol=PARITY_ATOL, rtol=0)
            np.testing.assert_allclose(boxes[i, cls - 1, :ref_n], ref_b[:ref_n], atol=PARITY_ATOL, rtol=0)
            if ref_n:
                worst = max(worst, float(np.abs(scores[i, cls - 1, :ref_n] - ref_s[:ref_n]).max()),
                            float(np.abs(boxes[i, cls - 1, :ref_n] - ref_b[:ref_n]).max()))
            n_kept += ref_n
    print(f"  f32 ({label}): {n_kept} detections over {len(IMAGES)} images x 20 classes equal the reference "
          f"(keep counts, labels); max |diff| of scores and boxes {worst:.3g} <= {PARITY_ATOL}")


MAIN_PATH = ("nms_fixpoint_keep_mask", "fused_vgg_block1")  # the Detector, and the streaming evaluator
REALTIME_PATH = ("nms_scan_keep_mask", "fused_vgg_block1")  # the realtime head on the bf16 model
API_PATH = ("nms_scan_keep_mask", "fused_stem_conv_relu_pool2", "fused_conv3x3_relu_pool2")


def frame_shapes(fx):
    """(H0, W0) of the four images' original frames."""
    return [fx[f"img_{i}_pixels"].shape[:2] for i in IMAGES]


def frame_min_sizes(cfg, shapes):
    """The realtime head's min size for each original frame, float32
    (ref: ron_eval.py:369-375; `RealtimeEvaluator.min_size`)."""
    net = RON_320_SPEC.img_shape[0] * RON_320_SPEC.img_shape[1]
    sizes = [cfg.min_size * float(np.sqrt(h * w / net)) for h, w in shapes]
    return torch.tensor(sizes, dtype=torch.float32, device="cuda")


def rt_exercised(fx):
    """tests/test_e2e_parity.py's dense 'exercised' realtime config."""
    return RealtimeConfig(select_threshold=float(fx["rt_exercised_select"]),
                          objectness_threshold=float(fx["rt_exercised_objectness"]),
                          nms_threshold=0.3, keep_top_k=40, top_k=2048)


def sorted_dets(scores, labels, boxes):
    order = np.lexsort((boxes[:, 0], boxes[:, 1], labels, -scores))
    return scores[order], labels[order], boxes[order]


def check_realtime(label, dets, fx, ref_name):
    """Realtime detections of the four images [4, keep_top_k(, 4)] against
    the fixture's realtime reference: equal counts and labels, scores and
    boxes within PARITY_ATOL (tests/test_e2e_parity.py:195-201)."""
    scores, labels, boxes, valid = (t.cpu().numpy() for t in dets)
    worst, n_kept = 0.0, []
    for i, img in enumerate(IMAGES):
        v = valid[i]
        got_s, got_l, got_b = sorted_dets(scores[i][v], labels[i][v], boxes[i][v])
        tag = f"img_{img}_rt_{ref_name}"
        ref_s, ref_l, ref_b = sorted_dets(fx[f"{tag}_scores"], fx[f"{tag}_labels"], fx[f"{tag}_boxes"])
        if len(got_l) != len(ref_l):
            raise AssertionError(f"{label}, image {img}: kept {len(got_l)} vs reference {len(ref_l)}")
        np.testing.assert_array_equal(got_l, ref_l.astype(got_l.dtype))
        np.testing.assert_allclose(got_s, ref_s, atol=PARITY_ATOL, rtol=0)
        np.testing.assert_allclose(got_b, ref_b, atol=PARITY_ATOL, rtol=0)
        if len(ref_l):
            worst = max(worst, float(np.abs(got_s - ref_s).max()), float(np.abs(got_b - ref_b).max()))
        n_kept.append(len(ref_l))
    print(f"  {label}: detections per image {n_kept} equal the reference's (counts, labels); max |diff| of "
          f"scores and boxes {worst:.3g} <= {PARITY_ATOL}")
    return worst


@contextlib.contextmanager
def plain_scan_nms():
    """Inside the block the realtime head runs K-C's plain version where it
    would launch the kernel, on the same CUDA tensors."""
    plain = kernels_nms.nms_scan_keep_mask_plain
    with mock.patch.object(kernels_nms, "nms_scan_keep_mask", plain), \
            mock.patch.object(ops_nms, "nms_scan_keep_mask", plain):
        yield


def realtime_f32(model, out, fx):
    """Phase 7: the realtime head on the f32 forward of the four images.
    Returns the launch counts of the fixture-gated run and the largest
    score or box difference from the reference."""
    ms = frame_min_sizes(RT_SHIPPED, frame_shapes(fx))
    cfgs = {"published": RT_PUBLISHED, "published, top_k 400": RT_SHIPPED, "exercised": rt_exercised(fx)}
    kernels.reset_launch_counts()
    with torch.inference_mode():
        dets = {name: RealtimeDetector(model, RON_320_SPEC, cfg, device="cuda").postprocess(out, ms)
                for name, cfg in cfgs.items()}
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts("realtime head's NMS (f32, the four images, three configs)", launches, ("nms_scan_keep_mask",))
    worst = max(check_realtime(f"f32 realtime, {name}", d, fx, name.split(",")[0]) for name, d in dets.items())
    if not all(torch.equal(a, b) for a, b in zip(dets["published"], dets["published, top_k 400"])):
        raise AssertionError("the published config gives other detections at top_k 400 than at 2048")
    print("  published config: top_k 400 and 2048 give the same detections, bit for bit")
    for name, cfg in (("whole-image", RT_SHIPPED), ("class-wise", RT_CLASS_WISE)):
        det = RealtimeDetector(model, RON_320_SPEC, cfg, device="cuda")
        with torch.inference_mode():
            got = det.postprocess(out, ms)
            kernels.reset_launch_counts()
            with plain_scan_nms():
                ref = det.postprocess(out, ms)
            torch.cuda.synchronize()
        if kernels.nms_scan_keep_mask.launches:
            raise AssertionError("the plain run launched K-C")
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"realtime head, {name}: K-C's detections differ from its plain version's")
        print(f"  realtime head, {name} mode, through K-C: {int(got[3].sum())} detections, bit-equal to the same "
              f"head through K-C's plain version on the same CUDA tensors")
    return launches, worst


def realtime_bf16(model, images, batch, fx):
    """Phase 8: the realtime head on the bf16 model with K-B, batch 1 and
    batch 32. Returns the batch-32 run's launch counts."""
    det = RealtimeDetector(model, RON_320_SPEC, RT_SHIPPED, device="cuda")
    ms = frame_min_sizes(RT_SHIPPED, frame_shapes(fx))
    for x, m in ((images[:1], ms[:1]), (batch, ms.repeat(BATCH // len(IMAGES)))):
        b = x.shape[0]
        kernels.reset_launch_counts()
        scores, labels, boxes, valid = det(x, m)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_counts(f"realtime head (bf16, batch {b})", launches, REALTIME_PATH)
        k = RT_SHIPPED.keep_top_k
        if scores.shape != (b, k) or labels.shape != (b, k) or boxes.shape != (b, k, 4) or valid.shape != (b, k):
            raise AssertionError(f"bad realtime output shapes at batch {b}")
        if labels.dtype != torch.int32 or not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
            raise AssertionError("realtime detections: labels not int32, or values not finite")
        kept = valid.sum(-1)
        print(f"  realtime bf16 batch {b}: detections per image {kept[:len(IMAGES)].tolist()} (first images)")
        if int(kept.min()) < 1:
            raise AssertionError("an image kept no realtime detection")
    return launches


class Recording:
    """A detector (or model) that keeps what it returned, call by call."""

    def __init__(self, det):
        self.det, self.outputs = det, []

    def __call__(self, images):
        out = self.det(images)
        self.outputs.append(out)
        return out


def reference_gts(fx):
    """The fixture's published realtime references as padded gts of the four
    images: labels [4, G] int32, boxes [4, G, 4], difficult [4, G]."""
    refs = [(fx[f"img_{i}_rt_published_labels"], fx[f"img_{i}_rt_published_boxes"]) for i in IMAGES]
    g = max(len(lab) for lab, _ in refs)
    labels = np.zeros((len(IMAGES), g), np.int32)
    boxes = np.zeros((len(IMAGES), g, 4), np.float32)
    for i, (lab, bx) in enumerate(refs):
        labels[i, :len(lab)], boxes[i, :len(lab)] = lab, bx
    return labels, boxes, np.zeros_like(labels)


def eval_batches(batch, fx):
    reps = BATCH // len(IMAGES)
    gl, gb, gd = (np.tile(a, (reps,) + (1,) * (a.ndim - 1)) for a in reference_gts(fx))
    return [{"image": batch, "gt_labels": gl, "gt_boxes": gb, "gt_difficult": gd} for _ in range(EVAL_BATCHES)]


def streaming_eval(model, batch, fx):
    """Phase 9a: the streaming evaluator on the card; its TP/FP against the
    matcher run on the CPU over the detections it saw."""
    ev = StreamingEvaluator(model, RON_320_SPEC, NMS_CFG, device="cuda")
    ev.detector = Recording(ev.detector)
    batches = eval_batches(batch, fx)
    kernels.reset_launch_counts()
    map07, map12, _, stats = ev.run(iter(batches), log_every=0)
    torch.cuda.synchronize()
    check_counts("streaming evaluator", kernels.launch_counts(), MAIN_PATH)
    c = RON_320_SPEC.num_classes
    cpu = StreamingTpFp(c)
    for (scores, boxes), b in zip(ev.detector.outputs, batches):
        scores = scores.cpu()
        res = match_all_classes(c, scores, boxes.cpu(), *(torch.as_tensor(b[k]) for k in
                                                          ("gt_labels", "gt_boxes", "gt_difficult")))
        for img in range(scores.shape[0]):
            for cls in range(1, c):
                cpu.add(cls, res.n_gt[img, cls - 1].numpy(), scores[img, cls - 1].numpy(),
                        res.tp[img, cls - 1].numpy(), res.fp[img, cls - 1].numpy())
    n_tp = n_fp = 0
    for cls in range(1, c):
        got, ref = ev.accumulator.class_arrays(cls), cpu.class_arrays(cls)
        if ev.accumulator.n_gt[cls] != cpu.n_gt[cls] or not all(np.array_equal(a, r) for a, r in zip(got, ref)):
            raise AssertionError(f"class {cls}: the evaluator's TP/FP differ from the CPU matcher's")
        n_tp, n_fp = n_tp + int(got[1].sum()), n_fp + int(got[2].sum())
    if stats["images"] != EVAL_BATCHES * BATCH or n_tp == 0:
        raise AssertionError(f"streaming evaluator: {stats['images']} images, {n_tp} TP")
    print(f"  streaming evaluator, {stats['images']} images: TP/FP of every class equal the CPU matcher's "
          f"({n_tp} TP, {n_fp} FP, {int(cpu.n_gt.sum())} gts); mAP07 {map07:.4f}, mAP12 {map12:.4f}")
    return ev, batches, {"map07": map07, "map12": map12, "tp": n_tp, "fp": n_fp}


def write_voc_xml(path, shape, objects):
    """A VOC annotation: objects [(class name, (x1, y1, x2, y2) 1-based pixels)]."""
    h, w = shape
    parts = [f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"]
    for name, (x1, y1, x2, y2) in objects:
        parts.append(f"<object><name>{name}</name><difficult>0</difficult><truncated>0</truncated><bndbox>"
                     f"<xmin>{x1!r}</xmin><ymin>{y1!r}</ymin><xmax>{x2!r}</xmax><ymax>{y2!r}</ymax></bndbox></object>")
    parts.append("</annotation>")
    Path(path).write_text("".join(parts))


def realtime_eval(model, fx):
    """Phase 9b: RealtimeEvaluator.detect_batch on the four images (f32)
    at their original sizes, scored by PascalVocEvaluator against their
    realtime references written as VOC XML: AP 1.0 on every class with a gt."""
    rev = RealtimeEvaluator(model, RON_320_SPEC, RT_SHIPPED, device="cuda")
    nh, nw = RON_320_SPEC.img_shape
    shapes = frame_shapes(fx)
    images01 = np.stack([tf1_bilinear_resize(fx[f"img_{i}_pixels"], (nh, nw)) / 255.0 for i in IMAGES])
    kernels.reset_launch_counts()
    per_image = rev.detect_batch(images01.astype(np.float32), shapes)
    torch.cuda.synchronize()
    check_counts("realtime evaluator (f32)", kernels.launch_counts(), ("nms_scan_keep_mask",))
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in IMAGES] for _ in range(RON_320_SPEC.num_classes)]
    with tempfile.TemporaryDirectory() as root:
        year = Path(root) / "VOC2007"
        (year / "Annotations").mkdir(parents=True)
        (year / "ImageSets" / "Main").mkdir(parents=True)
        (year / "ImageSets" / "Main" / "test.txt").write_text("".join(f"{i}\n" for i in IMAGES))
        with_gt = set()
        for ii, (img, (h0, w0)) in enumerate(zip(IMAGES, shapes)):
            objects = []
            for lab, (y1, x1, y2, x2) in zip(fx[f"img_{img}_rt_published_labels"], fx[f"img_{img}_rt_published_boxes"]):
                objects.append((VOC_CLASSES[int(lab) - 1],
                                (float(x1) * w0 + 1, float(y1) * h0 + 1, float(x2) * w0 + 1, float(y2) * h0 + 1)))
                with_gt.add(VOC_CLASSES[int(lab) - 1])
            write_voc_xml(year / "Annotations" / f"{img}.xml", (h0, w0), objects)
            for cls, rows in per_image[ii].items():
                rows = rows.copy()  # net pixels -> the original frame's (`evaluate_voc`)
                rows[:, [0, 2]] *= w0 / nw
                rows[:, [1, 3]] *= h0 / nh
                all_boxes[cls][ii] = rows
        voc_map, aps = PascalVocEvaluator(root, "test").evaluate(all_boxes, use_07_metric=True)
    short = {cls: aps[cls] for cls in sorted(with_gt) if abs(aps[cls] - 1.0) > 1e-9}
    if short:
        raise AssertionError(f"realtime evaluator: classes with a gt below AP 1.0: {short}")
    n_det = sum(len(r) for d in per_image for r in d.values())
    print(f"  realtime evaluator: {n_det} detections of the four images; VOC07 AP 1.0 on all {len(with_gt)} "
          f"classes that have a gt; mAP07 {voc_map:.4f}")
    return {"voc07_map": voc_map, "classes_with_gt": len(with_gt), "detections": n_det}


def check_counts(label, launches, on_path):
    """Every kernel of the path launched, and no other."""
    print(f"  launches on the {label}: {launches}")
    missing = [n for n in on_path if launches[n] < 1]
    stray = [n for n in launches if n not in on_path and launches[n]]
    if missing or stray:
        raise AssertionError(f"{label}: never launched {missing}; launched off the path {stray}")


def nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def api_path(model, det, batch, block1, max_err):
    """Phase 5: the kernels API on the main path's own data. Its inputs are
    made first (the backbone runs K-B); the counts are reset just before
    the four calls and read just after. Returns the inputs, for timing."""
    thr, mode, cap = NMS_CFG.nms_threshold, NMS_CFG.nms_mode, NMS_CFG.keep_top_k
    w1, b1, w2, b2 = block1
    bb = model.backbone
    with torch.inference_mode():
        flat_s, flat_b = (t.contiguous() for t in det.candidates(det.model(batch)))
        x = batch.to(torch.bfloat16)
        # relu(conv1_1) rounded to bf16, as K-B's plain version computes it
        y1 = nhwc(F.relu(F.conv2d(x.float().permute(0, 3, 1, 2), w1.to(torch.bfloat16).float(), b1.float(),
                                  padding=1)).to(torch.bfloat16))
        a21 = bb.conv2_1(bb._block1(x.permute(0, 3, 1, 2)))  # VGG block-2 tail's input
        a32 = bb.conv3_2(bb.conv3_1(max_pool_2x2(bb.conv2_2(a21))))  # block-3 tail's input
        tails = {"block2": (nhwc(a21), bb.conv2_2.conv), "block3": (nhwc(a32), bb.conv3_3.conv)}
        block1_out = kernels.fused_vgg_block1(x.contiguous(), w1, b1, w2, b2)
        torch.cuda.synchronize()

        kernels.reset_launch_counts()
        scan_s, scan_b = nms_sorted_kernel(flat_s, flat_b, thr, cap, mode, method="scan")
        stem_out = kernels.fused_stem_conv_relu_pool2(y1, w2, b2)
        tail_out = {k: kernels.fused_conv3x3_relu_pool2(a, c.weight, c.bias) for k, (a, c) in tails.items()}
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    check_counts("kernels API path", launches, API_PATH)

    with torch.inference_mode():
        keep = kernels.nms_scan_keep_mask(flat_s, flat_b, thr, cap, mode)
        keep_plain = kernels.nms_scan_keep_mask_plain(flat_s, flat_b, thr, cap, mode)
        err, n_diff = mask_err(keep, keep_plain)
        ref_s, ref_b = compact_keep(keep_plain, flat_s, flat_b, cap)
        if n_diff or not (torch.equal(scan_s, ref_s) and torch.equal(scan_b, ref_b)):
            raise AssertionError(f"scan NMS on the main path's candidates: {n_diff} mask differences")
        max_err["nms_scan_keep_mask"] = max(max_err["nms_scan_keep_mask"], err)
        print(f"  nms_scan_keep_mask on the main path's candidates {list(flat_s.shape)}, keep_top_k {cap}: "
              f"0 mask differences, {int(keep_plain.sum())} kept; detections equal the plain mask's")
        name = "fused_stem_conv_relu_pool2"
        max_err[name] = max(max_err[name], conv_err(
            f"{name} relu(conv1_1) {list(y1.shape)} -> 64 vs plain", stem_out,
            kernels.fused_stem_conv_relu_pool2_plain(y1, w2, b2), rounded=True))
        # K-B rounds conv1_1 to bf16 as y1 is: the same function, one bf16 ulp apart at most
        conv_err(f"{name} vs fused_vgg_block1 on the batch", stem_out, block1_out, rounded=True, f32_tol=0.0)
        name = "fused_conv3x3_relu_pool2"
        for k, (a, c) in tails.items():
            max_err[name] = max(max_err[name], conv_err(
                f"{name} {k} tail {list(a.shape)} -> {c.out_channels} vs plain", tail_out[k],
                kernels.fused_conv3x3_relu_pool2_plain(a, c.weight, c.bias), rounded=True))
    return launches, (flat_s, flat_b, keep_plain), y1, tails


def block1_grads(x, block1):
    """Phase 6: K-B's gradients (kernel forward, recompute backward) against
    autograd through `block1_reference`, for one random output gradient;
    block1 = (w1, b1, w2, b2) of any width."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, w, _ = x.shape
    go = torch.randn(b, h // 2, w // 2, block1[0].shape[0], generator=g, device="cuda").to(x.dtype)
    grads = {}
    for fn in (kernels.fused_vgg_block1, block1_reference):
        leaves = [t.detach().clone().requires_grad_() for t in (x, *block1)]
        kernels.reset_launch_counts()
        fn(*leaves).backward(go)
        torch.cuda.synchronize()
        if kernels.fused_vgg_block1.launches != (fn is kernels.fused_vgg_block1):
            raise AssertionError("the gradient run did not go through the block-1 kernel")
        grads[fn.__name__] = [t.grad for t in leaves]
    for name, got, ref in zip(("x", "w1", "b1", "w2", "b2"), *grads.values()):
        if got is None or not torch.isfinite(got).all():
            raise AssertionError(f"d{name}: no finite gradient through the kernel path")
        scale = float(ref.float().abs().max())
        err = float((got.float() - ref.float()).abs().max())
        print(f"  d{name} {list(got.shape)} {got.dtype}: max |kernel path - composition| = {err:.6g}, "
              f"{err / scale:.3g} of max |grad| {scale:.6g} (tolerance {GRAD_REL_TOL})")
        if err > GRAD_REL_TOL * scale:
            raise AssertionError(f"d{name} differs from the composition's")


def conv_row(name, calls, max_err, launches, replaces):
    """One kernels-line row for K-D or K-E: times summed over the calls
    {label: (x, weight, bias)} of its path, and each call's own under
    "parts"."""
    kernel, plain = CONV_KERNELS[name]
    parts = {}
    for label, (x, w, b) in calls.items():
        bsz, h, wd, cin = x.shape
        cout = w.shape[0]
        flops = 2 * bsz * h * wd * cin * cout * 9
        nbytes = x.numel() * 2 + bsz * (h // 2) * (wd // 2) * cout * 2 + w.numel() * 2 + cout * 4
        xn, wl, bl = x.permute(0, 3, 1, 2), w.to(torch.bfloat16), b.to(torch.bfloat16)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        parts[label] = with_rates({
            "ms": cuda_ms(lambda: kernel(x, w, b), reps=20),
            "plain_ms": cuda_ms(lambda: plain(x, w, b), reps=2),
            "library_ms": cuda_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xn, wl, bl, padding=1)), 2, 2), reps=20),
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        }, flops)
    total = {k: sum(p[k] for p in parts.values()) for k in ("ms", "plain_ms", "library_ms", "flops", "bytes")}
    bound_ms, bound_by = bound(total["bytes"], total["flops"], PEAK_BF16_FLOPS)
    row = with_rates({
        "name": name, "route": "cuda", "source": "ron_tensorflow_tpu_torch/csrc/conv3x3_relu_pool2.cu",
        "replaces": replaces, "path": "kernels API", "launches": launches[name], "max_abs_err": max_err[name],
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": total["library_ms"],
    }, total["flops"])
    if len(parts) > 1:
        row["parts"] = parts
    return row


def with_rates(row, flops):
    """A conv kernel's row with its achieved TFLOP/s, its share of the bound
    (bound_ms / ms) and its time over the library call's."""
    row["tflops"] = flops / row["ms"] * 1e-9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["library_ratio"] = row["ms"] / row["library_ms"]
    return row


def profile_call(label, fn, grad=False):
    """One torch.profiler pass over fn() (after one warm-up call): the top
    device kernels by time, the device's events in the trace (launches and
    copies) and the share of the call's wall time in which a kernel ran.
    Under inference_mode unless `grad` (a train step)."""
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if grad else torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # the device's own events (kernels, copies), not the host ops that launched them
    kernels_run = (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    events = sorted((e for e in kernels_run if device_us(e) > 0), key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in events)
    if not events:
        print(f"  profiled {label}: the trace holds no device time")
        return {"device_us": 0.0, "wall_us": wall_us, "device_events": 0, "top": []}
    n_events = sum(e.count for e in events)
    top = [{"name": e.key[:120], "device_us": device_us(e), "count": e.count} for e in events[:12]]
    print(f"  profiled {label}: {busy_us / 1e3:.3f} ms of kernels ({n_events} device events) in "
          f"{wall_us / 1e3:.3f} ms wall (device busy {busy_us / wall_us:.3f}, host clock, profiler on); top kernels:")
    for t in top:
        print(f"    {t['device_us'] / 1e3:8.3f} ms  x{t['count']:<4} {t['name']}")
    return {"device_us": busy_us, "wall_us": wall_us, "device_events": n_events, "top": top}


# --------------------------------------------------------------------------- #
# Training (phase "train" and its timing)

TRAIN_CFG = TrainConfig(fuse_block1=True, log_every_steps=1, save_every_steps=10 ** 9, max_to_keep=2)
TRAIN_BATCH = TRAIN_CFG.data.batch_size  # 14, ref: ron_net.py:152-153
TRAIN_STEPS, RESUME_STEPS = 20, 4
F32_STEP_BATCH = 2
# (a) the f32 step on the card (torch's default flags) against the CPU's: the
# loss and its parts within 1e-4 relative, the updated parameters and
# BatchNorm statistics within 1e-4 of each tensor's largest magnitude. The
# gradients, against the same step in float64 on the CPU: the median over
# the tensors of max |card - float64| / max |float64| within 1e-3, each
# tensor within 5e-2. A step is not continuous at its ReLUs, and a
# train-mode BatchNorm amplifies a flip there: the CPU's own float32 step
# lies 3.2% (of the largest magnitude) from float64 in
# block5_reverse.conv_left's kernel, the card 1.8% in block4's deconv, while
# the medians are 2.8e-6 and 6.9e-5. TF32 in the convolutions shifts every
# gradient: the same step with the pin taken out is run and must fail the
# median gate. The conv biases right before a train-mode BatchNorm (the
# class heads' inception convs) have the exact gradient 0, the batch mean
# taking them out: theirs is roundoff, held to 1e-3 of their conv kernel's
# largest gradient.
TRAIN_LOSS_RTOL, TRAIN_STATE_RTOL = 1e-4, 1e-4
GRAD_MEDIAN_TOL, GRAD_MAX_TOL, ROUNDOFF_TOL = 1e-3, 5e-2, 1e-3
PRE_BN_BIAS = re.compile(r"_cls\.inception\d_(3x3|1x1)\.conv\.bias$")
TRAIN_STAGES = ("augment", "encode", "forward", "backward", "optimizer")


def train_host_batch(fx, batch):
    """The fixture's four images resized to the working canvas as uint8 and
    their realtime references as gts, tiled to `batch`: a host batch as the
    trainer takes it."""
    canvas = TRAIN_CFG.data.working_shape
    images = np.stack([np.clip(np.round(tf1_bilinear_resize(fx[f"img_{i}_pixels"], canvas)), 0, 255).astype(np.uint8)
                       for i in IMAGES])
    labels, boxes, _ = reference_gts(fx)
    reps = -(-batch // len(IMAGES))
    tile = lambda a: np.concatenate([a] * reps)[:batch]  # noqa: E731
    return {"image01": tile(images), "gt_boxes": tile(boxes), "gt_labels": tile(labels), "gt_valid": tile(labels > 0)}


def train_inputs(host, batch, seed):
    """A host batch cut to `batch`, one augmentation's draws and the loss's
    draws, on the CPU: the same step's inputs for any device."""
    g = torch.Generator().manual_seed(seed)
    pcfg = PreprocessConfig(out_shape=RON_320_SPEC.img_shape)
    n = RON_320_SPEC.anchor_layout().num_anchors
    host = {k: torch.as_tensor(v[:batch]) for k, v in host.items()}
    return host, draw_augment(g, batch, pcfg), torch.rand(2, batch, n, generator=g), pcfg


def augmented(host, aug_draws, pcfg, device):
    b = {k: v.to(device) for k, v in host.items()}
    image, boxes, labels, valid = apply_augment(aug_draws, b["image01"].float() / 255.0, b["gt_boxes"],
                                                b["gt_labels"], b["gt_valid"], pcfg)
    return {"image": image, "gt_boxes": boxes, "gt_labels": labels, "gt_valid": valid}


def train_model(state, device, dtype=torch.float32, **flags):
    """RON-320 with the trained weights (and the block-1 form of `flags`:
    fuse_block1, s2d_stem or remat_blocks12), its encoder, optimizer (the
    TrainConfig defaults), train state and train step, on `device`."""
    model = RON(RON_320_SPEC, dtype=dtype, **flags)
    model.load_state_dict(state, strict=True)
    model.to(device)
    enc = TargetEncoder(RON_320_SPEC.anchor_layout(), RON_320_SPEC.img_shape, TRAIN_CFG.match.positive_threshold,
                        TRAIN_CFG.match.ignore_threshold, RON_320_SPEC.prior_scaling)
    tx = make_optimizer(TRAIN_CFG.optimizer, model)
    return model, enc, tx, create_train_state(model, tx), make_train_step(model, enc, tx, TRAIN_CFG.loss)


def record_into(store, key, transform=lambda g: g.detach()):
    """A tensor hook that keeps the first gradient it sees under `key`
    (returning None, so the gradient itself is left alone)."""
    def hook(grad):
        store.setdefault(key, transform(grad))
    return hook


def grad_recorder(model, names=None):
    """{parameter name: its gradient in the next backward}, through hooks."""
    grads = {}
    for name, p in model.named_parameters():
        if names is None or name in names:
            p.register_hook(record_into(grads, name, lambda g: g.detach().float().cpu()))
    return grads


@contextlib.contextmanager
def tf32_unpinned():
    """Inside the block the f32 model's forward and the train step run
    their convolutions under the caller's cuDNN TF32 flag: the pin taken
    out, to show what the gates of phases "train" (a) and "ssd train" (a)
    would see."""
    with mock.patch("ron_tensorflow_tpu_torch.models.ron.full_f32_convs", contextlib.nullcontext), \
            mock.patch("ron_tensorflow_tpu_torch.models.ssd.full_f32_convs", contextlib.nullcontext), \
            mock.patch("ron_tensorflow_tpu_torch.train.state.full_f32_convs", contextlib.nullcontext):
        yield


def grad_errors(grads, ref):
    """{name: max |g - ref| / max |ref|} over the tensors with a nonzero
    float64 gradient that is not roundoff."""
    return {n: float((grads[n] - r).abs().max()) / float(r.abs().max()) for n, r in ref.items()
            if float(r.abs().max()) > 0 and not PRE_BN_BIAS.search(n)}


def f32_train_parity(state, host):
    """Phase "train" (a): one f32 step of RON-320 at batch 2 on the card,
    under torch's default flags (cuDNN TF32 on), against the same step on
    the CPU, in float32 and in float64: the same weights, batch,
    augmentation draws and loss draws. Then the card's step once more with
    the f32 pin taken out, which the gradient gate must catch."""
    host2, aug_draws, loss_draws, pcfg = train_inputs(host, F32_STEP_BATCH, seed=0)
    runs = {}
    for device, dtype, pinned in (("cuda", torch.float32, True), ("cpu", torch.float32, True),
                                  ("cpu", torch.float64, True), ("cuda", torch.float32, False)):
        model, _, _, st, step = train_model(state, device, dtype)
        grads = grad_recorder(model)
        batch = augmented(host2, aug_draws, pcfg, device)
        with torch_default_flags() if device == "cuda" else contextlib.nullcontext(), \
                contextlib.nullcontext() if pinned else tf32_unpinned():
            _, metrics = step(st, batch, draws=loss_draws.to(device))
            if device == "cuda" and not torch.backends.cudnn.allow_tf32:
                raise AssertionError("the f32 step did not restore the caller's TF32 flag")
        after = {n: t.detach().cpu() for n, t in itertools.chain(model.named_parameters(), model.named_buffers())}
        runs[device, dtype, pinned] = ({k: float(v) for k, v in metrics.items()}, grads, after)
    n_params = len(list(model.parameters()))
    (m_gpu, g_gpu, s_gpu) = runs["cuda", torch.float32, True]
    (m_cpu, g_cpu, s_cpu) = runs["cpu", torch.float32, True]
    g_64, g_tf32 = runs["cpu", torch.float64, True][1], runs["cuda", torch.float32, False][1]
    worst = {}
    for k in ("loss/total", "loss/objectness", "loss/classification", "loss/localization"):
        worst[k] = abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
        if worst[k] > TRAIN_LOSS_RTOL:
            raise AssertionError(f"f32 step, {k}: card {m_gpu[k]!r} vs CPU {m_cpu[k]!r}")
    for k in ("counts/positives", "counts/cls_positives"):
        if m_gpu[k] != m_cpu[k]:
            raise AssertionError(f"f32 step, {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}")
    if not g_gpu.keys() == g_cpu.keys() == g_64.keys() or len(g_cpu) != n_params:
        raise AssertionError("f32 step: not every parameter got a gradient on every device")
    zero_heads = [n for n, r in g_64.items() if float(r.abs().max()) == 0]
    for n in zero_heads:  # no positive reaches these heads: exactly 0 everywhere
        if float(g_gpu[n].abs().max()) != 0 or float(g_cpu[n].abs().max()) != 0:
            raise AssertionError(f"f32 step, d{n}: 0 in float64, not on the card or the CPU")
    roundoff = max(max(float(g_gpu[n].abs().max()), float(g_cpu[n].abs().max()))
                   / float(g_64[n[:-len("bias")] + "weight"].abs().max()) for n in g_64 if PRE_BN_BIAS.search(n))
    errs = {label: grad_errors(g, g_64) for label, g in (("card", g_gpu), ("CPU f32", g_cpu), ("card, TF32", g_tf32))}
    medians = {label: float(np.median(list(e.values()))) for label, e in errs.items()}
    maxima = {label: max(e.items(), key=lambda kv: kv[1]) for label, e in errs.items()}
    state_used = max(float((s_gpu[n] - ref).abs().max()) / (TRAIN_STATE_RTOL * max(float(ref.abs().max()), 1e-30))
                     for n, ref in s_cpu.items())
    tf32_loss = runs["cuda", torch.float32, False][0]["loss/total"]
    print(f"  f32 step, batch {F32_STEP_BATCH}, card (cuDNN TF32 flag on) vs CPU: loss {m_cpu['loss/total']:.6f}, parts "
          + ", ".join(f"{k.split('/')[1]} {v:.2e}" for k, v in worst.items()) + f" relative (tolerance {TRAIN_LOSS_RTOL}); "
          f"positives {m_cpu['counts/positives']:.0f} equal; parameters and BN statistics after the update within "
          f"{state_used:.3f} of {TRAIN_STATE_RTOL} relative")
    print(f"  gradients against the float64 step ({len(errs['card'])} tensors): median / largest max|diff|/max|grad| "
          + "; ".join(f"{label} {medians[label]:.2e} / {maxima[label][1]:.2e} ({maxima[label][0]})" for label in errs)
          + f" (tolerances {GRAD_MEDIAN_TOL} / {GRAD_MAX_TOL}); loss with the pin out {tf32_loss:.6f} "
          f"({abs(tf32_loss - m_cpu['loss/total']) / m_cpu['loss/total']:.2e} from the CPU's); {len(zero_heads)} "
          f"exactly 0 on all (heads no positive reaches: {sorted({n.split('.')[0] for n in zero_heads})}); pre-BN "
          f"conv biases' gradients (exactly 0) at {roundoff:.2e} of their kernel's (tolerance {ROUNDOFF_TOL})")
    for ok, what in ((medians["card"] <= GRAD_MEDIAN_TOL, f"median gradient error {medians['card']:.3g}"),
                     (maxima["card"][1] <= GRAD_MAX_TOL, f"gradient d{maxima['card'][0]} {maxima['card'][1]:.3g}"),
                     (medians["card, TF32"] > GRAD_MEDIAN_TOL,
                      f"the median gate would not catch TF32 ({medians['card, TF32']:.3g})"),
                     (roundoff <= ROUNDOFF_TOL, f"roundoff gradients {roundoff:.3g}"),
                     (state_used <= 1.0, f"updated parameters or BN statistics at {state_used:.3f} of the tolerance")):
        if not ok:
            raise AssertionError(f"f32 step: {what}")
    return {"loss_rel_diff": worst, "grad_median_err": medians, "grad_max_err": maxima,
            "roundoff_grad": roundoff, "state_tolerance_used": state_used, "tf32_unpinned_loss": tf32_loss,
            "loss": m_cpu["loss/total"], "grad_norm": m_cpu["grad_norm"]}


def quietly(fn):
    """fn()'s result and the lines it printed, which are not shown."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def seeded_model_dir(model_dir, state, cfg=TRAIN_CFG):
    """A checkpoint at step 0 holding `state` (the trained weights, or
    seeded ones), from which a Trainer of `cfg.model` in `model_dir`
    resumes (warm start is not ported)."""
    model, _ = get_network(cfg.model)
    model.load_state_dict(state, strict=True)
    tx = make_optimizer(cfg.optimizer, model)
    CheckpointManager(model_dir, cfg.max_to_keep).save(0, create_train_state(model, tx))


def bf16_trainer_run(state, host, fx):
    """Phase "train" (b): Trainer.train on the card, bf16 with K-B, from the
    trained weights: 20 steps (K-B once a step, no other kernel), the loss
    finite every step, a checkpoint at step 20 that a second Trainer resumes
    to step 24, and the loss of one fixed batch (one augmentation of the
    host batch, fixed draws) lower after the 20 steps than before, with
    BatchNorm on the batch's statistics as in the step the trainer
    optimizes. The eval step's loss of that batch (inference BatchNorm, the
    running statistics) is recorded: 20 steps on the four images move the
    weights towards their batch statistics, and on the CPU (f32, batch 4,
    10 steps) it rose 0.768 -> 0.863 while the train-mode loss fell
    0.802 -> 0.600, with the running statistics put back as they were or
    not alike (0.8645 / 0.8631)."""
    with tempfile.TemporaryDirectory() as model_dir:
        cfg = dataclasses.replace(TRAIN_CFG, model_dir=model_dir)
        seeded_model_dir(model_dir, state)
        trainer = Trainer(cfg, device="cuda")
        if not trainer.model.backbone.fuse_block1:
            raise AssertionError("the bf16 trainer on the card did not take K-B")
        host_t, aug_draws, loss_draws, pcfg = train_inputs(host, TRAIN_BATCH, seed=1)
        fixed = augmented(host_t, aug_draws, pcfg, "cuda")

        loss_fn = detection_loss_fn(cfg.loss)

        def fixed_losses():
            """(train-mode loss, eval-step loss) of the fixed batch; the
            running statistics are left as they were."""
            _, metrics = trainer.eval_step(trainer.state, fixed, draws=loss_draws.cuda())
            saved = {k: v.clone() for k, v in trainer.model.named_buffers()}
            with torch.no_grad():
                out = trainer.model(fixed["image"], train=True)
                targets = trainer.encoder.batched(fixed["gt_labels"], fixed["gt_boxes"], fixed["gt_valid"])
                total, _ = loss_fn(out, targets, draws=loss_draws.cuda())
                for k, v in trainer.model.named_buffers():
                    v.copy_(saved[k])
            return float(total), float(metrics["loss/total"])

        trainer.init_state()
        before, eval_before = fixed_losses()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, printed = quietly(lambda: trainer.train(max_steps=TRAIN_STEPS, batches=itertools.repeat(host)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        after, eval_after = fixed_losses()
        check_counts(f"trainer ({TRAIN_STEPS} bf16 steps, batch {TRAIN_BATCH})", launches, ("fused_vgg_block1",))
        if st.step != TRAIN_STEPS or launches["fused_vgg_block1"] != TRAIN_STEPS:
            raise AssertionError(f"trainer: step {st.step}, K-B launched {launches['fused_vgg_block1']} times")
        rows = [json.loads(line) for line in open(Path(model_dir) / "metrics.jsonl")]
        losses = [r["loss/total"] for r in rows]
        if [r["step"] for r in rows] != list(range(1, TRAIN_STEPS + 1)) or not np.isfinite(losses).all():
            raise AssertionError(f"trainer: logged steps {[r['step'] for r in rows]}, losses {losses}")
        if trainer._ckpt.latest_step() != TRAIN_STEPS:
            raise AssertionError(f"no checkpoint at step {TRAIN_STEPS}: {trainer._ckpt.all_steps()}")
        if not after < before:
            raise AssertionError(f"the fixed batch's train-mode loss did not fall: {before} -> {after}")
        resumed = Trainer(cfg, device="cuda")
        st2, printed2 = quietly(lambda: resumed.train(max_steps=TRAIN_STEPS + RESUME_STEPS,
                                                      batches=itertools.repeat(host)))
        rows2 = [json.loads(line) for line in open(Path(model_dir) / "metrics.jsonl")][len(rows):]
        if st2.step != TRAIN_STEPS + RESUME_STEPS or [r["step"] for r in rows2] != list(range(21, 25)):
            raise AssertionError(f"resume: step {st2.step}, logged {[r['step'] for r in rows2]}")
    print(f"  trainer's own lines: {[x for x in printed if x.startswith('[trainer] step')][-1]!r}; "
          f"{[x for x in printed2 if 'resumed' in x]!r}")
    print(f"  trainer bf16 + K-B, batch {TRAIN_BATCH}: {TRAIN_STEPS} steps in {seconds:.2f} s (host clock, first steps "
          f"and a checkpoint included), losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite; K-B launched "
          f"{launches['fused_vgg_block1']} times, no other kernel; resumed at step {TRAIN_STEPS} and ran to "
          f"{st2.step}; the fixed batch's loss {before:.4f} -> {after:.4f} (train mode), eval step (inference "
          f"BatchNorm) {eval_before:.4f} -> {eval_after:.4f}")
    return {"steps": TRAIN_STEPS, "seconds": seconds, "losses": losses, "fixed_loss_before": before,
            "fixed_loss_after": after, "eval_step_loss_before": eval_before, "eval_step_loss_after": eval_after,
            "launches": launches, "resumed_to": st2.step}


def kb_train_grads(state, host):
    """Phase "train" (c): K-B inside a bf16 train step (batch 14). The fused
    step's conv1_* gradients against autograd through the unfused
    composition (cuDNN) of the step's own block-1 input and of the gradient
    that reaches block 1's output, within phase 6's tolerance (gated); and
    against the whole step with fuse_block1=False (recorded)."""
    host_t, aug_draws, loss_draws, pcfg = train_inputs(host, TRAIN_BATCH, seed=2)
    names = ("backbone.conv1_1.conv.weight", "backbone.conv1_1.conv.bias", "backbone.conv1_2.conv.weight",
             "backbone.conv1_2.conv.bias")
    steps = {}
    for fuse in (True, False):
        model, _, _, st, step = train_model(state, "cuda", torch.bfloat16, fuse_block1=fuse)
        grads = grad_recorder(model, names)
        seen, inner = {}, model.backbone._block1

        def block1(x, inner=inner, seen=seen):
            seen["x"] = x.detach()
            out = inner(x)
            out.register_hook(record_into(seen, "g_out"))
            return out

        model.backbone._block1 = block1
        kernels.reset_launch_counts()
        _, metrics = step(st, augmented(host_t, aug_draws, pcfg, "cuda"), draws=loss_draws.cuda())
        torch.cuda.synchronize()
        if kernels.fused_vgg_block1.launches != int(fuse):
            raise AssertionError("the (c) step did not take the intended block 1")
        steps[fuse] = (grads, seen, float(metrics["loss/total"]))
    (g_fused, seen, loss_fused), (g_unfused, _, loss_unfused) = steps[True], steps[False]
    model = RON(RON_320_SPEC, dtype=torch.bfloat16)
    model.load_state_dict(state, strict=True)
    model.cuda()
    bb = model.backbone
    weights = [dict(model.named_parameters())[n] for n in names]
    ref = torch.autograd.grad(max_pool_2x2(bb.conv1_2(bb.conv1_1(seen["x"]))), weights, seen["g_out"])
    res = {"same_output_gradient": {}, "whole_step": {}, "loss_fused": loss_fused, "loss_unfused": loss_unfused}
    for name, r in zip(names, ref):
        r = r.float().cpu()
        scale = float(r.abs().max())
        res["same_output_gradient"][name] = float((g_fused[name] - r).abs().max()) / scale
        whole = g_unfused[name]
        res["whole_step"][name] = float((g_fused[name] - whole).abs().max()) / float(whole.abs().max())
        print(f"  d{name.split('.')[1]}.{name.split('.')[-1]}: K-B step vs the unfused composition on the same "
              f"output gradient {res['same_output_gradient'][name]:.3g} of max |grad| {scale:.4g} (tolerance "
              f"{GRAD_REL_TOL}); vs the whole fuse_block1=False step {res['whole_step'][name]:.3g} (recorded)")
        if res["same_output_gradient"][name] > GRAD_REL_TOL:
            raise AssertionError(f"K-B's gradient inside the train step: d{name}")
    print(f"  bf16 step loss with K-B {loss_fused:.6f}, unfused {loss_unfused:.6f}")
    return res


def staged_step_ms(trainer, state, batch, reps):
    """The train step cut at its stages by CUDA events (it does what
    `train.state.make_train_step` does, in its order): augmentation,
    encoding, forward + loss, backward, optimizer + EMA. Mean ms each."""
    model, loss = trainer.model, detection_loss_fn(trainer.loss_config)
    params = list(state.params.values())
    sums = dict.fromkeys(TRAIN_STAGES, 0.0)
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(TRAIN_STAGES) + 1)]
        gen = trainer.generator(state.step)
        ev[0].record()
        aug = trainer.augment(batch, gen)
        ev[1].record()
        targets = trainer.encoder.batched(aug["gt_labels"], aug["gt_boxes"], aug["gt_valid"])
        ev[2].record()
        for p in params:
            p.grad = None
        out = train_forward(model, aug["image"], gen)
        total, _ = loss(out, targets, gen)
        ev[3].record()
        total.backward()
        ev[4].record()
        grads = [p.grad for p in params]
        global_norm(grads)
        trainer.tx.step(params, grads, state.opt_state)
        ev[5].record()
        state.step += 1
        torch.cuda.synchronize()
        if r:
            for i, k in enumerate(TRAIN_STAGES):
                sums[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    return sums


def kb_training_ms(x, w):
    """K-B's training cost on x with w = (w1, b1, w2, b2), CUDA events: the
    kernel forward alone, the kernel forward + recompute backward, and
    autograd through the unfused composition (`block1_reference`), for one
    seeded output gradient."""
    b, h, wd, _ = x.shape
    go = torch.randn(b, h // 2, wd // 2, w[0].shape[0], device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    go = go.to(torch.bfloat16)

    def fwd_bwd(fn):
        leaves = [x] + [t.detach().requires_grad_() for t in w]
        return lambda: torch.autograd.grad(fn(*leaves), leaves[1:], go)

    return {"kernel_fwd_recompute_bwd_ms": cuda_ms(fwd_bwd(kernels.fused_vgg_block1), reps=10, warmup=2),
            "unfused_autograd_ms": cuda_ms(fwd_bwd(block1_reference), reps=10, warmup=2),
            "kernel_fwd_ms": cuda_ms(lambda: kernels.fused_vgg_block1(x, *w), reps=10)}


def train_timing(state, fx):
    """Phase "timing", training: the bf16 step with K-B (the Trainer's step:
    augmentation through the update) at batch 14 and 32, ms and images/s by
    CUDA events, its stage split, peak memory; a torch.profiler pass over
    three steps at batch 14 (device busy share, top kernels); K-B's training
    cost, the kernel forward plus the recompute backward, against autograd
    through the unfused cuDNN composition."""
    res = {}
    for b in (TRAIN_BATCH, BATCH):
        with tempfile.TemporaryDirectory() as model_dir:
            cfg = dataclasses.replace(TRAIN_CFG, model_dir=model_dir, data=dataclasses.replace(TRAIN_CFG.data, batch_size=b))
            trainer = Trainer(cfg, device="cuda")
            st = trainer.init_state()
            trainer.model.load_state_dict(state, strict=True)
            batch = to_device(train_host_batch(fx, b), "cuda")
            ms = cuda_ms(lambda: trainer.step(st, batch), reps=10, warmup=3)
            stages = staged_step_ms(trainer, st, batch, reps=5)
            torch.cuda.reset_peak_memory_stats()
            trainer.step(st, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            res[f"b{b}"] = {"ms": ms, "img_per_s": b * 1e3 / ms, "stage_ms": stages, "peak_bytes": peak}
            print(f"  train step bf16 + K-B, batch {b}: {ms:.3f} ms, {b * 1e3 / ms:.1f} img/s; stages (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                  + f" (sum {sum(stages.values()):.3f}); peak memory {peak / 2 ** 30:.2f} GiB")
            if b == TRAIN_BATCH:
                res["profile_b14"] = profile_call(f"3 train steps, batch {b}", lambda: [trainer.step(st, batch)
                                                                                        for _ in range(3)], grad=True)
                image = trainer.augment(batch, trainer.generator(0))["image"].to(torch.bfloat16).contiguous()
    bb = RON(RON_320_SPEC, dtype=torch.bfloat16)
    bb.load_state_dict(state, strict=True)
    w = [t.cuda() for t in (bb.backbone.conv1_1.conv.weight, bb.backbone.conv1_1.conv.bias,
                            bb.backbone.conv1_2.conv.weight, bb.backbone.conv1_2.conv.bias)]
    kb = kb_training_ms(image, w)
    res["kb_train"] = kb
    print(f"  K-B in training, batch {TRAIN_BATCH} at 320x320: kernel forward + recompute backward "
          f"{kb['kernel_fwd_recompute_bwd_ms']:.3f} ms (the forward alone {kb['kernel_fwd_ms']:.3f}), autograd "
          f"through the unfused cuDNN composition {kb['unfused_autograd_ms']:.3f} ms")
    return res


# --------------------------------------------------------------------------- #
# SSD-300/512 and the heavy VGG variant (phases "ssd f32", "ssd bf16",
# "ssd train", "heavy", "eval losses" and their timings)

SSD_NAMES = ("ssd_300_vgg", "ssd_512_vgg")
# the SSD eval preset's detection values (ron_tensorflow_tpu/presets.py:18-41)
SSD_DET = DetectionConfig(select_threshold=0.01, objectness_threshold=0.0, top_k=400, keep_top_k=200,
                          nms_threshold=0.45, nms_method="pallas")
SSD_BATCH = {"ssd_300_vgg": BATCH, "ssd_512_vgg": 8}
SSD_SEED = {"ssd_300_vgg": 300, "ssd_512_vgg": 512, "ron_320_vgg_heavy": 4096}
SSD_F32_BATCH = 2
# Seeded SSD weights: He-scaled draws (gain sqrt 2) keep each ReLU layer's
# output at its input's scale through the ~20 layers without BatchNorm;
# plain fan-in scaling shrinks it by sqrt 2 a layer and flattens every
# softmax towards 1/21, where top-k order is a coin toss between devices.
# Each multibox head is then scaled so that its logits and locations have
# these standard deviations on the four images.
SSD_GAIN, SSD_LOGIT_STD, SSD_LOC_STD = 2.0 ** 0.5, 2.5, 0.5  # scale_ssd_heads' defaults
SPREAD_MIN = 3.0 / 21  # the mean largest class probability must be 3x the flat softmax's
FORWARD_TOL = 1e-4  # card vs CPU f32 forward, of each output's largest magnitude
DET_TOL = 1e-5  # card vs CPU postprocess of the same outputs: scores and boxes
EVAL_LOSS_RTOL = 1e-5
# The ssd_300 train preset's matching (presets.py:57-60) at batch 32, with the
# repo's recipe for SSD from scratch (plain VGG, no BatchNorm): lr 0.003,
# warmup 1000 steps, gradients clipped at global norm 50 (tools/synthetic_e2e.py:
# 88-104, run with SYNTH_WARMUP=1000 SYNTH_CLIP=50). With the preset's lr 1e-3
# and neither, seeded SSD-300 went to NaN at step 3 (on the CPU, f32, batch 4).
SSD_TRAIN_CFG = dataclasses.replace(
    TRAIN_CFG, model="ssd_300_vgg", match=MatchConfig(positive_threshold=0.5, ignore_threshold=0.5),
    data=dataclasses.replace(TRAIN_CFG.data, batch_size=BATCH),
    optimizer=dataclasses.replace(TRAIN_CFG.optimizer, learning_rate=0.003, warmup_steps=1000, clip_global_norm=50.0))
# (a) The f32 step against the CPU's runs the TrainConfig optimizer (lr 1e-3,
# momentum, weight decay, no warmup, no clipping), so that one step moves the
# weights: with SSD_TRAIN_CFG's warmup the first step's lr is 3e-6 and the
# update, at most 3e-6 x 50, lies below any 1e-4 gate. The loss and its parts
# within 1e-4 relative of the CPU float32 step's; grad_norm within 1e-4 of
# the float64 step's. Each gradient and each update (new - old parameters)
# against the float64 step's as in phase "train" (a): the median over the
# tensors of max |card - float64| / max |float64| within 1e-3, each within
# 5e-2 (a ReLU flip: on the CPU, the float32 step lies 2.6e-3 from float64
# in conv5_3's kernel gradient, the median 1.8e-6; TF32 emulated in the
# convolutions there gives a median of 2.1e-2). The updated parameters
# against the CPU float32 step's: the median over the tensors within 1e-4 of
# each tensor's largest magnitude (the step moves the median tensor by 2.4%
# of it; one flip moves a tensor's by more: 8.7e-4 at conv5_3, CPU float32
# against float64). The step must move the median tensor by at least 1e-3.
SSD_PARITY_OPT = TRAIN_CFG.optimizer
SSD_VISIBLE_MIN = 1e-3
SSD_TRAIN_STEPS = 10
EVAL_LOSS_BATCHES = 2


def demo_images(fx, spec):
    """The four demo images resized (TF1 bilinear) to the spec's input and
    whitened, on the CPU."""
    return torch.stack([eval_preprocess(torch.as_tensor(fx[f"img_{i}_pixels"]).float() / 255.0, spec.img_shape)[0]
                        for i in IMAGES])


def class_spread(predictions):
    """How far the class probabilities [B, N, C] are from the flat softmax:
    the largest probability of an anchor (mean, median), the share of
    anchors whose argmax is the background, the mean entropy in nats (a flat
    softmax over 21 classes has 3.04)."""
    top = predictions.max(-1)
    p = predictions.clamp_min(1e-30)
    return {"mean_max_prob": float(top.values.mean()), "median_max_prob": float(top.values.median()),
            "background_argmax_share": float((top.indices == 0).float().mean()),
            "mean_entropy_nats": float(-(p * p.log()).sum(-1).mean())}


def seeded_state(name, gain):
    """`name`'s weights drawn from a numpy seed (`models.testing`), as a
    state dict, and its spec."""
    model, spec = get_network(name)
    params, stats = seeded_flax_params(model, SSD_SEED[name], gain)
    return from_jax_params(params, stats), spec


def ssd_state(name, fx):
    """Seeded SSD weights (He-scaled draws) with each head scaled to
    SSD_LOGIT_STD and SSD_LOC_STD on the four images, on the card
    (`models.testing.scale_ssd_heads`). Prints the class probabilities'
    spread and fails if they are near the flat softmax."""
    state, spec = seeded_state(name, SSD_GAIN)
    model, _ = get_network(name)
    model.load_state_dict(state, strict=True)
    model.cuda()
    images = demo_images(fx, spec).cuda()
    scale_ssd_heads(model, images, SSD_LOGIT_STD, SSD_LOC_STD)
    with torch.inference_mode():
        spread = class_spread(model(images).predictions)
    print(f"  {name} seeded weights (seed {SSD_SEED[name]}, gain {SSD_GAIN:.4f}, heads scaled to logit std "
          f"{SSD_LOGIT_STD}, location std {SSD_LOC_STD}): class probabilities on the four images " +
          ", ".join(f"{k} {v:.4f}" for k, v in spread.items()))
    if not spread["mean_max_prob"] > SPREAD_MIN:
        raise AssertionError(f"{name}: the class probabilities are near the flat softmax ({spread})")
    return {k: v.cpu() for k, v in model.state_dict().items()}, spec, spread


def host(out):
    return type(out)(*(t.cpu() for t in out))


def forward_errors(label, got, ref, fields=("logits", "locations", "predictions")):
    """max |card - CPU| / max |CPU| of each output, gated at FORWARD_TOL."""
    errs = {}
    for f in fields:
        g, r = getattr(got, f).cpu(), getattr(ref, f)
        errs[f] = float((g - r).abs().max()) / float(r.abs().max())
    print(f"  {label}, card vs CPU f32 forward: max |diff| / max |CPU| " +
          ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tolerance {FORWARD_TOL})")
    if max(errs.values()) > FORWARD_TOL:
        raise AssertionError(f"{label}: the card's f32 forward is off the CPU's: {errs}")
    return errs


def compare_dets(label, got, ref, valid=None, tol=DET_TOL):
    """Card detections against the CPU's (on the same outputs, at the
    default `tol`): equal keep counts per (image, class) (or valid flags and
    labels, realtime), scores and boxes within `tol`. Returns (detections,
    max |diff|)."""
    got = [t.cpu() for t in got]
    if valid is None:  # Detector: (scores [B, C-1, K], boxes)
        counts = (got[0] > 0).sum(-1), (ref[0] > 0).sum(-1)
        if not torch.equal(*counts):
            raise AssertionError(f"{label}: keep counts differ in {int((counts[0] != counts[1]).sum())} pairs")
        pairs = ((got[0], ref[0]), (got[1], ref[1]))
        n = int(counts[1].sum())
    else:  # realtime: (scores, labels, boxes, valid)
        if not (torch.equal(got[3], ref[3]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{label}: realtime valid flags or labels differ")
        pairs = ((got[0], ref[0]), (got[2], ref[2]))
        n = int(ref[3].sum())
    worst = max(float((a - b).abs().max()) for a, b in pairs)
    print(f"  {label}: {n} detections, keep counts equal; max |score or box diff| {worst:.3g} (tolerance {tol})")
    if worst > tol or n == 0:
        raise AssertionError(f"{label}: {n} detections, max diff {worst}")
    return n, worst


def ssd_f32(name, state, spec, fx):
    """Phase "ssd f32": SSD in f32 (the f32 pin) at batch 2 on the card
    against the CPU's forward of the same weights and images; the card's
    Detector (SSD eval preset, K-A) and realtime head (class-wise mode, as
    `RealtimeConfig.for_spec` picks it for SSD; K-C) on the card's outputs
    against the CPU's on the same outputs. Returns the numbers and the f32
    detections of the two images."""
    cpu, _ = get_network(name)
    cpu.load_state_dict(state, strict=True)
    card, _ = get_network(name)
    card.load_state_dict(state, strict=True)
    card.cuda()
    images = demo_images(fx, spec)[:SSD_F32_BATCH]
    with torch.inference_mode():
        out = card(images.cuda())
        ref_out = cpu(images)
        res = {"forward_rel_err": forward_errors(f"{name} batch {SSD_F32_BATCH}", out, ref_out)}
        dets = Detector(card, spec, SSD_DET, device="cuda").postprocess(out)
        ref = Detector(cpu, spec, SSD_DET, device="cpu").postprocess(host(out))
        res["detector"] = compare_dets(f"{name} Detector (SSD eval preset, K-A) vs the CPU's (plain NMS)", dets, ref)
        rt_cfg = RealtimeConfig.for_spec(spec)
        if not rt_cfg.class_wise:
            raise AssertionError("RealtimeConfig.for_spec did not pick class-wise mode for SSD")
        rt = RealtimeDetector(card, spec, rt_cfg, device="cuda").postprocess(out)
        rt_ref = RealtimeDetector(cpu, spec, rt_cfg, device="cpu").postprocess(host(out))
        res["realtime_class_wise"] = compare_dets(f"{name} realtime head, class-wise (K-C) vs the CPU's", rt, rt_ref,
                                                  valid=True)
    return res, dets


def detection_drift(ref, got):
    """Detections [B, C-1, K(, 4)] against reference ones: the (image, class)
    pairs whose keep counts agree, the detections on each side, and over the
    pairs that agree the largest score and box difference."""
    ref_s, ref_b = (t.float() for t in ref)
    got_s, got_b = (t.float() for t in got)
    n_ref, n_got = (ref_s > 0).sum(-1), (got_s > 0).sum(-1)
    same = n_ref == n_got
    rank = torch.arange(ref_s.shape[-1], device=ref_s.device)
    live = same[..., None] & (rank < n_ref[..., None])
    return {"pairs_equal_counts": int(same.sum()), "pairs": same.numel(), "detections_bf16": int(n_got.sum()),
            "detections_f32": int(n_ref.sum()), "sum_abs_count_diff": int((n_got - n_ref).abs().sum()),
            "max_abs_score_diff": float(torch.where(live, (got_s - ref_s).abs(), 0.0).max()),
            "max_abs_box_diff": float(torch.where(live[..., None], (got_b - ref_b).abs(), 0.0).max())}


def block1_of(model):
    """An SSD's block-1 parameters (w1, b1, w2, b2) on its device."""
    return tuple(getattr(getattr(model, f"conv1_{j}").conv, p) for j in (1, 2) for p in ("weight", "bias"))


def bf16_detector_run(label, model, spec, batch):
    """A bf16 Detector batch with K-B: launch counts read around it (K-B
    once, K-A once), output shapes, finite values, a detection in every
    image. Returns (detector, detections, launches)."""
    det = Detector(model, spec, SSD_DET if spec.name.startswith("ssd") else NMS_CFG, device="cuda")
    kernels.reset_launch_counts()
    scores, boxes = det(batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts(label, launches, MAIN_PATH)
    if launches["fused_vgg_block1"] != 1 or launches["nms_fixpoint_keep_mask"] != 1:
        raise AssertionError(f"{label}: K-B and K-A must launch once each: {launches}")
    b, k = batch.shape[0], det.config.keep_top_k
    if scores.shape != (b, spec.num_classes - 1, k) or boxes.shape != (b, spec.num_classes - 1, k, 4):
        raise AssertionError(f"{label}: output shapes {tuple(scores.shape)}, {tuple(boxes.shape)}")
    kept = (scores > 0).sum(dim=(1, 2))
    if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()) or int(kept.min()) < 1:
        raise AssertionError(f"{label}: non-finite detections, or an image kept none")
    print(f"  {label}: detections per image {kept[:len(IMAGES)].tolist()} (first images)")
    return det, (scores, boxes), launches


def ssd_bf16(name, state, spec, fx, f32_dets, max_err):
    """Phase "ssd bf16": SSD in bf16 with K-B through the Detector at its
    batch (SSD-300: 32, SSD-512: 8); K-B's output on that batch against its
    plain version (at 300: ragged tiles); the bf16 detections of the first
    two images against the f32 ones (recorded)."""
    model, _ = get_network(name, dtype=torch.bfloat16, fuse_block1=True)
    model.load_state_dict(state, strict=True)
    b = SSD_BATCH[name]
    batch = demo_images(fx, spec).cuda().repeat(b // len(IMAGES), 1, 1, 1).contiguous()
    det, dets, launches = bf16_detector_run(f"{name} bf16 Detector with K-B, batch {b}", model, spec, batch)
    x = batch.to(torch.bfloat16).contiguous()
    with torch.inference_mode():
        err = block1_err(f"{name} batch {list(x.shape)}", kernels.fused_vgg_block1(x, *block1_of(model)),
                         kernels.fused_vgg_block1_plain(x, *block1_of(model)))
    max_err["fused_vgg_block1"] = max(max_err["fused_vgg_block1"], err)
    drift = detection_drift(f32_dets, tuple(t[:SSD_F32_BATCH] for t in dets))
    print(f"  {name} bf16 vs f32 detections of {SSD_F32_BATCH} images: keep counts equal in "
          f"{drift['pairs_equal_counts']} of {drift['pairs']} pairs; {drift['detections_bf16']} vs "
          f"{drift['detections_f32']}; max |score diff| {drift['max_abs_score_diff']:.4g}, max |box diff| "
          f"{drift['max_abs_box_diff']:.4g} over the equal pairs (recorded)")
    return {"model": model, "det": det, "batch": batch, "launches": launches, "kb_err": err, "drift": drift}


def ssd_train_inputs(host_batch, batch, seed, pcfg):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.as_tensor(v[:batch]) for k, v in host_batch.items()}, draw_augment(g, batch, pcfg)


def ssd_f32_train_parity(state, host_batch):
    """Phase "ssd train" (a): one f32 SSD-300 step at batch 2, dropout rate
    0, on the card (torch's default flags) against the same step on the CPU
    in float32 and in float64: the same weights, batch (the SSD augmentation
    with the same draws), matching (the ssd_300 train preset's) and
    `SsdLossConfig`, the optimizer SSD_PARITY_OPT. Gates: see
    SSD_PARITY_OPT. Then the card's step once more with the f32 pin taken
    out, which the gradient gate must catch."""
    cfg = SSD_TRAIN_CFG
    spec = SSD_300_SPEC
    pcfg = PreprocessConfig(out_shape=spec.img_shape, variant="ssd")
    host_b, draws = ssd_train_inputs(host_batch, F32_STEP_BATCH, 3, pcfg)
    loss_cfg = SsdLossConfig(num_classes=spec.num_classes, match_threshold=cfg.match.positive_threshold)
    before = {n: t.float() for n, t in state.items()}
    runs = {}
    for device, dtype, pinned in (("cuda", torch.float32, True), ("cpu", torch.float32, True),
                                  ("cpu", torch.float64, True), ("cuda", torch.float32, False)):
        model, _ = get_network(cfg.model, dtype=dtype, dropout_rate=0.0)
        model.load_state_dict(state, strict=True)
        model.to(device)
        grads = grad_recorder(model)
        enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, cfg.match.positive_threshold,
                            cfg.match.ignore_threshold, spec.prior_scaling)
        tx = make_optimizer(SSD_PARITY_OPT, model)
        st = create_train_state(model, tx)
        batch = augmented(host_b, draws, pcfg, device)
        with torch_default_flags() if device == "cuda" else contextlib.nullcontext(), \
                contextlib.nullcontext() if pinned else tf32_unpinned():
            _, metrics = make_train_step(model, enc, tx, loss_cfg)(st, batch)
        updates = {n: t.detach().cpu() - before[n] for n, t in model.named_parameters()}
        runs[device, dtype, pinned] = ({k: float(v) for k, v in metrics.items()}, grads, updates)
    (m_gpu, g_gpu, u_gpu), (m_cpu, g_cpu, u_cpu) = runs["cuda", torch.float32, True], runs["cpu", torch.float32, True]
    (m_64, g_64, u_64), g_tf32 = runs["cpu", torch.float64, True], runs["cuda", torch.float32, False][1]
    if not g_gpu.keys() == g_cpu.keys() == g_64.keys() == u_64.keys():
        raise AssertionError("SSD-300 f32 step: not every parameter got a gradient on every device")
    worst = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu if k.startswith("loss/")}
    grad_norm_err = abs(m_gpu["grad_norm"] - m_64["grad_norm"]) / m_64["grad_norm"]
    zero = sorted(n for n, r in g_64.items() if float(r.abs().max()) == 0)
    for n in zero:  # no positive reaches these heads: exactly 0 everywhere
        if float(g_gpu[n].abs().max()) != 0:
            raise AssertionError(f"SSD-300 f32 step, d{n}: 0 in float64, not on the card")
    errs = {label: grad_errors(g, g_64) for label, g in (("card", g_gpu), ("CPU f32", g_cpu), ("card, TF32", g_tf32))}
    errs["card update"] = grad_errors(u_gpu, u_64)
    medians = {label: float(np.median(list(e.values()))) for label, e in errs.items()}
    maxima = {label: max(e.items(), key=lambda kv: kv[1]) for label, e in errs.items()}
    visible = float(np.median([float(u.abs().max()) / float(before[n].abs().max()) for n, u in u_64.items()
                               if float(before[n].abs().max()) > 0]))
    params = {n: float((u_gpu[n] - u_cpu[n]).abs().max()) / (TRAIN_STATE_RTOL * float((before[n] + u_cpu[n]).abs().max()))
              for n in u_cpu}
    params_median, params_max = float(np.median(list(params.values()))), max(params.items(), key=lambda kv: kv[1])
    tf32_loss = runs["cuda", torch.float32, False][0]["loss/total"]
    print(f"  SSD-300 f32 step, batch {F32_STEP_BATCH}, card (cuDNN TF32 flag on) vs CPU: loss {m_cpu['loss/total']:.6f}, "
          + ", ".join(f"{k.split('/')[-1]} {v:.2e}" for k, v in worst.items())
          + f" relative (tolerance {TRAIN_LOSS_RTOL}); positives {m_cpu['counts/positives']:.0f} / "
          f"{m_gpu['counts/positives']:.0f}; grad_norm {m_gpu['grad_norm']:.6g}, {grad_norm_err:.2e} from float64's "
          f"(tolerance {TRAIN_LOSS_RTOL}); the step moves the median tensor by {visible:.3g} of its largest magnitude")
    print(f"  gradients and updates against the float64 step ({len(errs['card'])} tensors): median / largest "
          "max|diff|/max|float64| " + "; ".join(f"{label} {medians[label]:.2e} / {maxima[label][1]:.2e} "
                                               f"({maxima[label][0]})" for label in errs)
          + f" (tolerances {GRAD_MEDIAN_TOL} / {GRAD_MAX_TOL}); loss with the pin out {tf32_loss:.6f}; {len(zero)} "
          f"exactly 0 on all ({zero}); updated parameters vs the CPU f32 step: median {params_median:.3f}, largest "
          f"{params_max[1]:.3f} ({params_max[0]}) of {TRAIN_STATE_RTOL} of each tensor's largest magnitude")
    for ok, what in ((m_gpu["counts/positives"] == m_cpu["counts/positives"], "positives differ"),
                     (max(worst.values()) <= TRAIN_LOSS_RTOL, f"losses {worst}"),
                     (grad_norm_err <= TRAIN_LOSS_RTOL, f"grad_norm {grad_norm_err:.3g} from float64's"),
                     (visible >= SSD_VISIBLE_MIN, f"the step moves the median tensor by only {visible:.3g}"),
                     (medians["card"] <= GRAD_MEDIAN_TOL, f"median gradient error {medians['card']:.3g}"),
                     (maxima["card"][1] <= GRAD_MAX_TOL, f"gradient d{maxima['card'][0]} {maxima['card'][1]:.3g}"),
                     (medians["card update"] <= GRAD_MEDIAN_TOL, f"median update error {medians['card update']:.3g}"),
                     (maxima["card update"][1] <= GRAD_MAX_TOL,
                      f"update of {maxima['card update'][0]} {maxima['card update'][1]:.3g}"),
                     (params_median <= 1.0, f"updated parameters at {params_median:.3f} of the tolerance (median)"),
                     (medians["card, TF32"] > GRAD_MEDIAN_TOL,
                      f"the median gate would not catch TF32 ({medians['card, TF32']:.3g})")):
        if not ok:
            raise AssertionError(f"SSD-300 f32 step: {what}")
    return {"loss_rel_diff": worst, "grad_norm_rel_diff_f64": grad_norm_err, "grad_median_err": medians,
            "grad_max_err": maxima, "median_update_share": visible, "param_tolerance_used_median": params_median,
            "param_tolerance_used_max": params_max, "tf32_unpinned_loss": tf32_loss, "exact_zero": zero,
            "loss": m_cpu["loss/total"], "grad_norm": m_cpu["grad_norm"], "positives": m_cpu["counts/positives"]}


def ssd_trainer_run(state, host_batch):
    """Phase "ssd train" (b): Trainer.train with model ssd_300_vgg, bf16, K-B,
    the ssd_300 train preset's matching, batch 32, from a step-0 checkpoint
    of the seeded weights: 10 steps, K-B launched once a step and no other
    kernel, every loss finite; the train-mode loss (dropout on, masks from a
    fixed generator) of one fixed batch (one SSD augmentation with fixed
    draws) lower after the steps than before; its eval-step loss recorded."""
    with tempfile.TemporaryDirectory() as model_dir:
        cfg = dataclasses.replace(SSD_TRAIN_CFG, model_dir=model_dir)
        seeded_model_dir(model_dir, state, cfg)
        trainer = Trainer(cfg, device="cuda")
        if not (trainer.model.fuse_block1 and trainer.preprocess_config.variant == "ssd"
                and isinstance(trainer.loss_config, SsdLossConfig)):
            raise AssertionError("the SSD trainer did not take K-B, the ssd augmentation or the SSD loss")
        host_b, draws = ssd_train_inputs(host_batch, BATCH, 4, trainer.preprocess_config)
        fixed = augmented(host_b, draws, trainer.preprocess_config, "cuda")
        loss_fn = detection_loss_fn(trainer.loss_config)

        def fixed_losses():
            _, metrics = trainer.eval_step(trainer.state, fixed)
            with torch.no_grad():
                out = trainer.model(fixed["image"], train=True, generator=torch.Generator("cuda").manual_seed(7))
                targets = trainer.encoder.batched(fixed["gt_labels"], fixed["gt_boxes"], fixed["gt_valid"])
                total, _ = loss_fn(out, targets)
            return float(total), float(metrics["loss/total"])

        trainer.init_state()
        before, eval_before = fixed_losses()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, _ = quietly(lambda: trainer.train(max_steps=SSD_TRAIN_STEPS, batches=itertools.repeat(host_batch)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        after, eval_after = fixed_losses()
        check_counts(f"SSD-300 trainer ({SSD_TRAIN_STEPS} bf16 steps, batch {BATCH})", launches, ("fused_vgg_block1",))
        rows = [json.loads(line) for line in open(Path(model_dir) / "metrics.jsonl")]
        losses = [r["loss/total"] for r in rows]
        if st.step != SSD_TRAIN_STEPS or launches["fused_vgg_block1"] != SSD_TRAIN_STEPS:
            raise AssertionError(f"SSD trainer: step {st.step}, K-B launched {launches['fused_vgg_block1']} times")
        if [r["step"] for r in rows] != list(range(1, SSD_TRAIN_STEPS + 1)) or not np.isfinite(losses).all():
            raise AssertionError(f"SSD trainer: logged steps {[r['step'] for r in rows]}, losses {losses}")
        if not after < before:
            raise AssertionError(f"the fixed batch's SSD train-mode loss did not fall: {before} -> {after}")
    print(f"  SSD-300 trainer bf16 + K-B, batch {BATCH}: {SSD_TRAIN_STEPS} steps in {seconds:.2f} s (host clock, "
          f"first steps included), losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite; K-B launched "
          f"{launches['fused_vgg_block1']} times, no other kernel; the fixed batch's loss {before:.4f} -> {after:.4f} "
          f"(train mode, fixed dropout masks), eval step {eval_before:.4f} -> {eval_after:.4f}")
    return {"steps": SSD_TRAIN_STEPS, "seconds": seconds, "losses": losses, "fixed_loss_before": before,
            "fixed_loss_after": after, "eval_step_loss_before": eval_before, "eval_step_loss_after": eval_after,
            "launches": launches}


# --------------------------------------------------------------------------- #
# Phase "stem": the JAX package's other training forms of VGG block 1
# (`s2d_stem`, the phase-output conv; `remat_blocks12`, blocks 1-2
# recomputed in the backward) against the plain form and K-B, and the
# Detector with nms_method="loop" (K-C on the Detector's own rows)

STEM_FORWARD_TOL = 1e-4  # s2d vs plain f32 forward, of each output's largest magnitude
STEM_LOSS_RTOL = 1e-5  # a form's f32 step loss against the plain step's
STEM_GRAD_TOL = 1e-4  # each gradient against the plain step's, of the tensor's largest magnitude
STEM_FORMS = ("K-B", "plain", "s2d_stem", "remat_blocks12")
STEM_SSD_FORMS = ("plain", "s2d_stem")
STEM_STEPS = 4  # CUDA-event steps a run, two runs a form and batch, after one warm-up step
STEM_TIMEOUT = 300  # seconds for the timing process


def block1_flags(form):
    """The model keywords of a block-1 form."""
    return {"fuse_block1": form == "K-B", "s2d_stem": form == "s2d_stem", "remat_blocks12": form == "remat_blocks12"}


def stem_forwards(state, images, ssd_300_state, fx):
    """Phase "stem" (a), forwards: f32 RON-320 (trained weights, the four
    demo images) and SSD-300 (phase "ssd f32"'s weights, two images) with
    s2d_stem against the same model without it, on the card."""
    res = {}
    for name, st, x in (("ron_320_vgg", state, images),
                        ("ssd_300_vgg", ssd_300_state, demo_images(fx, SSD_300_SPEC)[:SSD_F32_BATCH].cuda())):
        outs = []
        for s2d in (False, True):
            model, _ = get_network(name, s2d_stem=s2d)
            model.load_state_dict(st, strict=True)
            with torch.inference_mode():
                outs.append(model.cuda()(x))
        ref, got = outs
        errs = {f: float((getattr(got, f) - getattr(ref, f)).abs().max()) / float(getattr(ref, f).abs().max())
                for f in ("logits", "locations", "predictions")}
        print(f"  {name} f32 batch {len(x)}, s2d_stem vs plain: max |diff| / max |plain| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tolerance {STEM_FORWARD_TOL})")
        if max(errs.values()) > STEM_FORWARD_TOL:
            raise AssertionError(f"{name}: the s2d_stem forward is off the plain one: {errs}")
        res[name] = errs
    return res


def stem_f32_steps(state, host):
    """Phase "stem" (a), steps: one f32 RON-320 train step at batch 2 with
    s2d_stem and one with remat_blocks12 against the plain step, on the
    card, the same weights, batch and draws: the loss within STEM_LOSS_RTOL,
    each gradient within STEM_GRAD_TOL of the plain one's largest magnitude
    (a conv bias right before a train-mode BatchNorm, whose gradient is
    exactly 0 up to roundoff: of its kernel's)."""
    host2, aug_draws, loss_draws, pcfg = train_inputs(host, F32_STEP_BATCH, seed=0)
    runs = {}
    for form in ("plain", "s2d_stem", "remat_blocks12"):
        model, _, _, st, step = train_model(state, "cuda", torch.float32, **block1_flags(form))
        grads = grad_recorder(model)
        _, metrics = step(st, augmented(host2, aug_draws, pcfg, "cuda"), draws=loss_draws.cuda())
        runs[form] = (float(metrics["loss/total"]), grads)
        del model, st, step
    loss, ref = runs["plain"]
    res = {}
    for form in ("s2d_stem", "remat_blocks12"):
        f_loss, grads = runs[form]
        if grads.keys() != ref.keys():
            raise AssertionError(f"f32 step with {form}: not every parameter got a gradient")
        errs = {}
        for n, r in ref.items():
            scale = float(ref[n[:-len("bias")] + "weight"].abs().max() if PRE_BN_BIAS.search(n) else r.abs().max())
            diff = float((grads[n] - r).abs().max())
            errs[n] = diff / scale if scale else diff
        worst = max(errs.items(), key=lambda kv: kv[1])
        loss_err = abs(f_loss - loss) / abs(loss)
        print(f"  f32 step, batch {F32_STEP_BATCH}, {form} vs plain: loss {f_loss:.7f} vs {loss:.7f} "
              f"({loss_err:.2e} relative, tolerance {STEM_LOSS_RTOL}); gradients ({len(errs)} tensors): largest "
              f"max|diff|/max|plain| {worst[1]:.2e} ({worst[0]}), median {float(np.median(list(errs.values()))):.2e} "
              f"(tolerance {STEM_GRAD_TOL})")
        if loss_err > STEM_LOSS_RTOL or worst[1] > STEM_GRAD_TOL:
            raise AssertionError(f"f32 step with {form}: loss {loss_err:.3g}, gradient {worst}")
        res[form] = {"loss": f_loss, "plain_loss": loss, "loss_rel_diff": loss_err, "grad_max_err": worst,
                     "grad_median_err": float(np.median(list(errs.values())))}
    return res


def set_block1_form(model, form):
    """Switch a RON's backbone (or an SSD) to a block-1 form: the forward
    reads the flags at each call, so one model (and one train step) serves
    every form, as the JAX package's tools/perf_train_experiments.py clones
    one model with remat_blocks12."""
    target = getattr(model, "backbone", model)
    flags = block1_flags(form)
    check_block1_forms(**flags)
    for k, v in flags.items():
        if v or hasattr(target, k):
            setattr(target, k, v)


def stem_form_timing(trainer, st, fx, form, batches):
    """One block-1 form's bf16 Trainer step at each batch: ms (CUDA events,
    two runs of STEM_STEPS after a warm-up step), peak memory (reset before
    the batch's first step) and the device's busy share of a step
    (torch.profiler), with the launches of the port's kernels."""
    set_block1_form(trainer.model, form)
    res = {}
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    for b in batches:
        batch = to_device(train_host_batch(fx, b), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [cuda_ms(lambda: trainer.step(st, batch), reps=STEM_STEPS, warmup=1 if i == 0 else 0)
                for i in range(2)]
        peak = torch.cuda.max_memory_allocated()
        busy = device_busy_ms(lambda: trainer.step(st, batch))
        res[f"b{b}"] = {"ms_runs": runs, "img_per_s": b * 1e3 / min(runs), "peak_bytes": peak,
                        "busy_share": busy / min(runs), "device_busy_ms": busy}
    torch.cuda.synchronize()
    res["launches"] = kernels.launch_counts()
    res["steps"] = (1 + 2 * STEM_STEPS + 2) * len(batches)
    res["seconds"] = time.perf_counter() - t0
    return res


def stem_timing_main() -> int:
    """Phase "stem" (b) in a process of its own (`chip_smoke.py
    --stem-timing`), so that its torch.profiler windows do not slow the
    host side of the parent's later phases: bf16 Trainer steps of RON-320
    (trained weights; TrainConfig.s2d_stem on, the model then switched
    through the four block-1 forms: K-B, plain, s2d_stem, remat_blocks12)
    at batch 14 and 32, and of SSD-300 (seeded init, phase "ssd train"'s
    recipe, s2d_stem on) at batch 32, plain and s2d_stem. Prints one JSON
    line last."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE)))
    fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
    out = {}
    for name, base, forms, batches in (("ron_320_vgg", TRAIN_CFG, STEM_FORMS, (TRAIN_BATCH, BATCH)),
                                       ("ssd_300_vgg", SSD_TRAIN_CFG, STEM_SSD_FORMS, (BATCH,))):
        with tempfile.TemporaryDirectory() as model_dir:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(base, model_dir=model_dir, s2d_stem=True)
            trainer, _ = quietly(lambda: Trainer(cfg, device="cuda"))
            if not getattr(trainer.model, "backbone", trainer.model).s2d_stem:
                raise AssertionError(f"{name}: TrainConfig(s2d_stem=True) gave no s2d_stem model")
            st, _ = quietly(trainer.init_state)
            if name.startswith("ron"):
                trainer.model.load_state_dict(state, strict=True)
            print(f"  {name} Trainer(s2d_stem=True) and its state: {time.perf_counter() - t0:.2f} s", flush=True)
            for form in forms:
                res = stem_form_timing(trainer, st, fx, form, batches)
                check_counts(f"{name} {form} train steps", res["launches"],
                             ("fused_vgg_block1",) if form == "K-B" else ())
                out[f"{name} {form}"] = res
                print(f"  {name} bf16 train step, {form}: " + "; ".join(
                    f"batch {k[1:]} {'/'.join(f'{m:.3f}' for m in v['ms_runs'])} ms ({v['img_per_s']:.1f} img/s), "
                    f"peak {v['peak_bytes'] / 2 ** 30:.3f} GiB, device busy {v['busy_share']:.3f}"
                    for k, v in res.items() if k.startswith("b")) + f" ({res['seconds']:.2f} s)", flush=True)
            del trainer, st
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def stem_timing(smi):
    """Phase "stem" (b): `stem_timing_main` in a child process; its lines
    shown, its JSON line returned."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--stem-timing"], capture_output=True,
                          text=True, timeout=STEM_TIMEOUT, cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    print(f"  the timing process took {time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        raise AssertionError(f"the stem timing process exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    res = json.loads(lines[-1])
    kb = res["ron_320_vgg K-B"]
    print(f"  ({smi}) K-B launched {kb['launches']['fused_vgg_block1']} times in {kb['steps']} K-B steps; the "
          f"other forms launched no port kernel")
    return res


def stem_detector_loop(state, images):
    """Phase "stem" (c): the f32 trained RON-320 at batch 32 through a
    Detector with nms_method="loop" (K-C, launches read around the call),
    K-C's keep mask on the same rows bit-equal to its plain version, and
    the detections against nms_method="pallas" (K-A; recorded)."""
    model = RON(RON_320_SPEC)
    model.load_state_dict(state, strict=True)
    batch = images.repeat(BATCH // len(IMAGES), 1, 1, 1).contiguous()
    cfg = DetectionConfig(nms_method="loop")
    det = Detector(model, RON_320_SPEC, cfg, device="cuda")
    kernels.reset_launch_counts()
    loop_dets = det(batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts("f32 Detector, nms_method='loop'", launches, ("nms_scan_keep_mask",))
    with torch.inference_mode():
        flat_s, flat_b = (t.contiguous() for t in det.candidates(det.model(batch)))
        keep = kernels.nms_scan_keep_mask(flat_s, flat_b, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode).cpu()
    plain = kernels.nms_scan_keep_mask_plain(flat_s.cpu(), flat_b.cpu(), cfg.nms_threshold, cfg.keep_top_k,
                                             cfg.nms_mode)
    if not torch.equal(keep, plain):
        raise AssertionError(f"K-C on the Detector's rows differs from its plain version in "
                             f"{int((keep != plain).sum())} slots")
    pallas = [t.cpu() for t in Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")(batch)]
    loop = [t.cpu() for t in loop_dets]
    counts = (loop[0] > 0).sum(-1), (pallas[0] > 0).sum(-1)
    same = counts[0] == counts[1]
    worst = max(float((a - b).abs()[same].max()) for a, b in zip(loop, pallas))
    res = {"launches": launches, "rows": list(flat_s.shape), "kept": int(keep.sum()),
           "keep_count_pairs_differing": int((~same).sum()), "detections": int(counts[0].sum()),
           "max_abs_diff_vs_pallas": worst}
    print(f"  f32 Detector batch {BATCH}, nms_method='loop': K-C launched {launches['nms_scan_keep_mask']} time(s), "
          f"no other kernel; its keep mask on the {list(flat_s.shape)} rows bit-equal to the plain version "
          f"({res['kept']} kept); against 'pallas' (K-A): {res['detections']} detections, keep counts differ in "
          f"{res['keep_count_pairs_differing']} (image, class) pairs, max |score or box diff| {worst:.3g} (recorded)")
    return res


def heavy_phase(fx):
    """Phase "heavy": ron_320_vgg_heavy from seeded weights (fan-in scaled,
    gain 1), f32 at batch 2 on the card against the CPU's forward of the
    same weights and images; then bf16 with K-B at batch 32 through the
    Detector (K-B and K-A once each)."""
    state, spec = seeded_state("ron_320_vgg_heavy", 1.0)
    images = demo_images(fx, spec)
    cpu, _ = get_network("ron_320_vgg_heavy")
    cpu.load_state_dict(state, strict=True)
    card, _ = get_network("ron_320_vgg_heavy")
    card.load_state_dict(state, strict=True)
    card.cuda()
    with torch.inference_mode():
        out = card(images[:SSD_F32_BATCH].cuda())
        errs = forward_errors(f"ron_320_vgg_heavy batch {SSD_F32_BATCH}", out, cpu(images[:SSD_F32_BATCH]),
                              fields=("logits", "locations", "objness_logits", "predictions"))
        spread = class_spread(out.predictions)
    del cpu, card
    model, _ = get_network("ron_320_vgg_heavy", dtype=torch.bfloat16, fuse_block1=True)
    model.load_state_dict(state, strict=True)
    batch = images.cuda().repeat(BATCH // len(IMAGES), 1, 1, 1).contiguous()
    det, _, launches = bf16_detector_run(f"ron_320_vgg_heavy bf16 Detector with K-B, batch {BATCH}", model, spec,
                                         batch)
    print(f"  heavy fc6 {tuple(model.backbone.fc6.conv.weight.shape)}, fc7 {tuple(model.backbone.fc7.conv.weight.shape)}; "
          f"class probabilities " + ", ".join(f"{k} {v:.4f}" for k, v in spread.items()))
    return {"forward_rel_err": errs, "spread": spread, "launches": launches}, det, batch


def eval_losses(label, model, spec, loss_cfg, image_batch, fx, draws=None):
    """Phase "eval losses": StreamingEvaluator(loss_config=...) on the card
    (K-B and K-A) over EVAL_LOSS_BATCHES batches with gts from the fixture's
    realtime references; each batch's loss/* metrics against the port's CPU
    loss on the same outputs (copied to the host) and targets, with the same
    draws for RON, within EVAL_LOSS_RTOL relative."""
    det_cfg = SSD_DET if spec.name.startswith("ssd") else NMS_CFG
    ev = StreamingEvaluator(model, spec, det_cfg, device="cuda", loss_config=loss_cfg)
    ev.detector.model = Recording(ev.detector.model)
    reps = image_batch.shape[0] // len(IMAGES)
    gl, gb, gd = (np.tile(a, (reps,) + (1,) * (a.ndim - 1)) for a in reference_gts(fx))
    batches = [{"image": image_batch, "gt_labels": gl, "gt_boxes": gb, "gt_difficult": gd}
               for _ in range(EVAL_LOSS_BATCHES)]
    kernels.reset_launch_counts()
    _, _, _, stats = ev.run(iter(batches), log_every=0, loss_draws=draws)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts(f"streaming evaluator with losses, {label}", launches, MAIN_PATH)
    enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, 0.5, 0.3, spec.prior_scaling)
    loss_fn = detection_loss_fn(loss_cfg)
    worst = 0.0
    for bi, (out, got) in enumerate(zip(ev.detector.model.outputs, ev.batch_losses)):
        targets = enc.batched(torch.as_tensor(gl), torch.as_tensor(gb), torch.as_tensor(gl) > 0)
        with torch.no_grad():
            _, ref = loss_fn(host(out), targets, draws=None if draws is None else draws[bi].cpu())
        for k, v in ref.items():
            if k.startswith("loss/"):
                worst = max(worst, abs(got[k] - float(v)) / abs(float(v)))
    print(f"  {label}: loss/* of {len(ev.batch_losses)} batches of {image_batch.shape[0]} against the CPU loss on the "
          f"same outputs: max relative diff {worst:.3g} (tolerance {EVAL_LOSS_RTOL}); means "
          + ", ".join(f"{k} {v:.4f}" for k, v in stats.items() if k.startswith("loss/")))
    if worst > EVAL_LOSS_RTOL or len(ev.batch_losses) != EVAL_LOSS_BATCHES:
        raise AssertionError(f"{label}: the evaluator's losses are off the CPU's ({worst})")
    return {"max_rel_diff": worst, "means": {k: v for k, v in stats.items() if k.startswith("loss/")},
            "launches": launches}


def detector_stage_ms(det, batch):
    """A Detector batch's ms (CUDA events) and its stage split: forward,
    candidates (decode, gate, top-k), NMS (K-A + compact)."""
    with torch.inference_mode():
        ms = cuda_ms(lambda: det(batch), reps=5, warmup=2)
        out = det.model(batch)
        flat = det.candidates(out)
        cfg = det.config
        stages = {"forward": cuda_ms(lambda: det.model(batch), reps=5),
                  "candidates": cuda_ms(lambda: det.candidates(out), reps=5),
                  "nms": cuda_ms(lambda: nms_sorted_kernel(*flat, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode),
                                 reps=20)}
    return {"ms": ms, "img_per_s": batch.shape[0] * 1e3 / ms, "stage_ms": stages}, flat


def ssd_timing(ssd, ssd_300_state, heavy_det, heavy_batch, host_batch):
    """Phase "timing", SSD and heavy: the bf16 Detectors' ms, images/s and
    stage split (SSD-300 batch 32, SSD-512 batch 8 and 32, heavy RON-320
    batch 32); the SSD-300 bf16 train step at batch 32, and a profiler pass
    over its augmentation (the step's second-largest stage). Returns the numbers
    and the NMS rows of the SSD Detectors and of SSD-300's class-wise
    realtime head, for the kernels' rows."""
    res, rows = {}, {}
    runs = [("ssd_300_vgg", ssd["ssd_300_vgg"]["det"], ssd["ssd_300_vgg"]["batch"]),
            ("ssd_512_vgg", ssd["ssd_512_vgg"]["det"], ssd["ssd_512_vgg"]["batch"]),
            ("ssd_512_vgg", ssd["ssd_512_vgg"]["det"],
             ssd["ssd_512_vgg"]["batch"].repeat(BATCH // SSD_BATCH["ssd_512_vgg"], 1, 1, 1)),
            ("ron_320_vgg_heavy", heavy_det, heavy_batch)]
    for name, det, batch in runs:
        key = f"{name} b{batch.shape[0]}"
        res[key], flat = detector_stage_ms(det, batch)
        rows[key] = flat
        r = res[key]
        print(f"  Detector {key} bf16 + K-B: {r['ms']:.3f} ms/batch, {r['img_per_s']:.1f} img/s; stages (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["stage_ms"].items()))
    s300 = ssd["ssd_300_vgg"]
    with torch.inference_mode():
        cw = RealtimeDetector(s300["model"], SSD_300_SPEC, RealtimeConfig.for_spec(SSD_300_SPEC), device="cuda")
        rt_rows = cw.candidates(cw.model(s300["batch"]))
    with tempfile.TemporaryDirectory() as model_dir:
        trainer = Trainer(dataclasses.replace(SSD_TRAIN_CFG, model_dir=model_dir), device="cuda")
        st = trainer.init_state()
        trainer.model.load_state_dict(ssd_300_state, strict=True)
        batch = to_device(host_batch, "cuda")
        ms = cuda_ms(lambda: trainer.step(st, batch), reps=10, warmup=3)
        stages = staged_step_ms(trainer, st, batch, reps=5)
        augment_profile = profile_call(f"SSD-300 augmentation, batch {BATCH}",
                                       lambda: trainer.augment(batch, trainer.generator(0)))
        torch.cuda.reset_peak_memory_stats()
        trainer.step(st, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    res["ssd_300_train_b32"] = {"ms": ms, "img_per_s": BATCH * 1e3 / ms, "stage_ms": stages, "peak_bytes": peak,
                                "augment_profile": augment_profile}
    print(f"  SSD-300 train step bf16 + K-B, batch {BATCH}: {ms:.3f} ms, {BATCH * 1e3 / ms:.1f} img/s; stages (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f" (sum {sum(stages.values()):.3f}); peak memory {peak / 2 ** 30:.2f} GiB")
    return res, rows, rt_rows


def nms_part(label, scores, boxes, thr, mode, cap=None):
    """One row set of an NMS kernel (K-A, or K-C with a cap) on a path's own
    rows: 0 mask differences against its plain version, then its device
    time, the wrapper's per-call time, the plain version's time, the
    overlaps the keep set needs and the bound they give."""
    scores, boxes = scores.contiguous(), boxes.contiguous()
    if cap is None:
        fn = lambda: kernels.nms_fixpoint_keep_mask(scores, boxes, thr, mode)  # noqa: E731
        plain = lambda: kernels.nms_fixpoint_keep_mask_plain(scores, boxes, thr, mode)  # noqa: E731
    else:
        fn = lambda: kernels.nms_scan_keep_mask(scores, boxes, thr, cap, mode)  # noqa: E731
        plain = lambda: kernels.nms_scan_keep_mask_plain(scores, boxes, thr, cap, mode)  # noqa: E731
    keep, keep_plain = fn(), plain()
    err, n_diff = mask_err(keep, keep_plain)
    if n_diff:
        raise AssertionError(f"NMS on {label}: {n_diff} mask differences")
    r, k = scores.shape
    pairs = sweep_pairs(scores, boxes, thr, mode, keep, dividing=cap is not None)
    bound_ms, bound_by = bound(r * k * (4 + 16 + 1), 12 * pairs, PEAK_F32_FLOPS)
    part = {"rows": [r, k], "mode": mode, "keep_top_k": cap, **nms_times(fn), "plain_ms": cuda_ms(plain, reps=2),
            "pairs": pairs, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, **kept_stats(keep)}
    print(f"  {'nms_fixpoint_keep_mask' if cap is None else 'nms_scan_keep_mask'} {label} {mode}: {part['ms']:.4f} ms "
          f"device, {part['call_ms']:.4f} ms a wrapper call, plain {part['plain_ms']:.4f}; {pairs} overlaps needed, "
          f"bound {bound_ms:.5f} by {bound_by}; kept per row mean {part['kept_mean']:.2f}, max {part['kept_max']}; "
          "0 mask differences")
    return part


def block_cost(x, w):
    """K-B's operations and bytes on x [B, H, W, Ci] with w = (w1, b1, w2,
    b2): both convs' multiply-adds; x read and the bf16 output written
    once, the bf16 weights and f32 biases read once."""
    bsz, h, wd, cin = x.shape
    c = w[0].shape[0]
    flops = 2 * bsz * h * wd * c * 9 * (cin + c)
    return flops, x.numel() * 2 + bsz * (h // 2) * (wd // 2) * c * 2 + (w[0].numel() + w[2].numel()) * 2 + 2 * c * 4


def cudnn_block(x, w):
    """K-B's function as one PyTorch call per op (`F.conv2d` x2 + ReLU +
    `F.max_pool2d`, bf16, on the channels_last view of x: cuDNN), the
    library yardstick of its time."""
    x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
    lw = [t.to(torch.bfloat16) for t in w]

    def library():
        y = F.relu(F.conv2d(x_nchw, lw[0], lw[1], padding=1))
        return F.max_pool2d(F.relu(F.conv2d(y, lw[2], lw[3], padding=1)), 2, 2)

    return library


def kb_shape_rows(ssd):
    """K-B at the SSD shapes ([32, 300, 300, 3] with ragged tiles, [8, 512,
    512, 3], [32, 512, 512, 3]): its launches in one Detector batch of that
    shape, ms, plain ms, bound, and cuDNN's time for the same block
    (`F.conv2d` x2 + `F.max_pool2d`, bf16)."""
    rows = {}
    for name, b in (("ssd_300_vgg", BATCH), ("ssd_512_vgg", 8), ("ssd_512_vgg", BATCH)):
        s = ssd[name]
        batch = s["batch"].repeat(b // s["batch"].shape[0], 1, 1, 1).contiguous()
        kernels.reset_launch_counts()
        with torch.inference_mode():
            s["det"](batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["fused_vgg_block1"]
        x = batch.to(torch.bfloat16).contiguous()
        w = block1_of(s["model"])
        flops, nbytes = block_cost(x, w)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        library = cudnn_block(x, w)
        with torch.inference_mode():
            row = with_rates({
                "path": f"{name} Detector, bf16, batch {b}", "launches": launches,
                "ms": cuda_ms(lambda: kernels.fused_vgg_block1(x, *w), reps=20),
                "plain_ms": cuda_ms(lambda: kernels.fused_vgg_block1_plain(x, *w), reps=2),
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(library, reps=10),
            }, flops)
        rows[str(list(x.shape))] = row
        print(f"  fused_vgg_block1 {list(x.shape)}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
              f"{bound_ms:.4f} by {bound_by}, cuDNN {row['library_ms']:.4f}), {row['tflops']:.1f} TFLOP/s, "
              f"{row['bound_share']:.3f} of bound, {row['library_ratio']:.3f}x cuDNN; launched {launches} in the "
              f"{name} Detector's batch")
    return rows


def kb_block2_row(block2):
    """K-B at VGG block 2 ([32, 160, 160, 64] -> 128, phase 3's pool1 and
    the model's conv2_1/conv2_2), the kernels API: ms, plain ms, bound and
    cuDNN's time for the same block (`F.conv2d` x2 + ReLU + `F.max_pool2d`,
    bf16); the batch-14 forward and forward + recompute backward (against
    autograd through `block1_reference`); phase 3's profile and peak
    memory of a call."""
    x, w = block2["pool1"], block2["weights"]
    c = w[0].shape[0]
    flops, nbytes = block_cost(x, w)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    with torch.inference_mode():
        row = with_rates({
            "name": "fused_vgg_block1", "route": "cuda", "source": "ron_tensorflow_tpu_torch/csrc/fused_vgg_block1.cu",
            "replaces": "ron_tensorflow_tpu/kernels/fused_conv_pool.py:388", "kernel": KB2_KERNEL,
            "path": "kernels API (phase 3's block 1 -> block 2 chain; 0 on every model path)",
            "launches": block2["launches"], "max_abs_err": block2["max_abs_err"],
            "shape": [list(x.shape), c],
            "ms": cuda_ms(lambda: kernels.fused_vgg_block1(x, *w), reps=20),
            "plain_ms": cuda_ms(lambda: kernels.fused_vgg_block1_plain(x, *w), reps=2),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(cudnn_block(x, w), reps=20),
        }, flops)
    row["b14"] = kb_training_ms(x[:TRAIN_BATCH].clone(), w)
    row.update({k: block2[k] for k in ("profile", "peak_bytes_above_inputs", "intermediate_bytes")})
    lib = _build.library()
    row.update(smem_bytes=lib.fused_vgg_block2_smem_bytes(), ring_units_of_8kb=lib.fused_vgg_block2_stages(),
               cluster_size=1, conv_b_n=lib.fused_vgg_block2_conv_b_n(c))
    print(f"  fused_vgg_block1 block 2 {list(x.shape)} -> {c}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
          f"bound {bound_ms:.4f} by {bound_by}, cuDNN {row['library_ms']:.4f}), {row['tflops']:.1f} TFLOP/s, "
          f"{row['bound_share']:.3f} of bound, {row['library_ratio']:.3f}x cuDNN; batch {TRAIN_BATCH}: forward "
          f"{row['b14']['kernel_fwd_ms']:.4f} ms, + recompute backward {row['b14']['kernel_fwd_recompute_bwd_ms']:.4f}, "
          f"unfused autograd {row['b14']['unfused_autograd_ms']:.4f}; launched {block2['launches']} in phase 3's chain")
    return row


# --------------------------------------------------------------------------- #
# Checkpoint import (phases "reference import", "warm start", "import cli",
# "tensorboard")

REF_FIXTURE = REPO / "tests" / "fixtures" / "reference_forward.npz"
# tests/test_model_parity.py's bounds: raw head outputs within 2e-3 x max(1,
# |ref|max), probabilities within 5e-4 absolute. The import is held to the
# TF1 reference graph's outputs by the port's float64 forward, and the port's
# f32 forward to its float64 one, both at these bounds: the graph's outputs
# are f32 themselves (2.45e-4 from float64 in the probabilities), and an f32
# forward summing in another order than TF's adds as much again.
REF_SCALED_FIELDS, REF_SCALED_TOL = ("logits", "objness_logits", "locations"), 2e-3
REF_PROB_FIELDS, REF_PROB_ATOL = ("predictions", "objness_pred"), 5e-4


def weight_for(name: str, shape) -> np.ndarray:
    """tools/reference_forward.py's name-keyed pseudo-weights (a copy: the
    tool imports TensorFlow's graph code): fan-in-scaled conv kernels,
    non-trivial BatchNorm statistics."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shape = tuple(int(s) for s in shape)
    leaf = name.rsplit("/", 1)[-1]
    if leaf in ("moving_variance", "gamma"):
        return rng.uniform(0.8, 1.2, shape).astype(np.float32)
    if leaf in ("moving_mean", "beta", "biases"):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)
    assert leaf == "weights", name
    # conv HWIO fan-in = kh*kw*cin; TF deconv layout is [kh, kw, OUT, IN].
    cin = shape[3] if "deconv" in name else shape[2]
    std = np.sqrt(2.0 / (shape[0] * shape[1] * cin))
    return (rng.standard_normal(shape) * std).astype(np.float32)


def reference_errors(out, ref) -> dict:
    """max |out - ref| of each output (`ref`: the fixture, or another
    forward's outputs), each raw output's scale max(1, |ref|max), and
    whether all are within the bounds ("within")."""
    errs = {}
    for field in REF_SCALED_FIELDS + REF_PROB_FIELDS:
        r = np.asarray(ref[field] if not hasattr(ref, "_fields") else getattr(ref, field).cpu(), np.float64)
        errs[field] = float(np.abs(getattr(out, field).detach().double().cpu().numpy() - r).max())
        if field in REF_SCALED_FIELDS:
            errs[f"{field}_scale"] = max(1.0, float(np.abs(r).max()))
    errs["within"] = (all(errs[f] <= REF_SCALED_TOL * errs[f"{f}_scale"] for f in REF_SCALED_FIELDS)
                      and all(errs[f] <= REF_PROB_ATOL for f in REF_PROB_FIELDS))
    return errs


def format_errors(errs) -> str:
    return ", ".join([f"{f} {errs[f]:.4g} (bound {REF_SCALED_TOL * errs[f + '_scale']:.4g})" for f in REF_SCALED_FIELDS]
                     + [f"{f} {errs[f]:.4g} (bound {REF_PROB_ATOL})" for f in REF_PROB_FIELDS])


# ssd.pytorch's VGG-16 with the reduced fc6/fc7 (`vgg16_reducedfc.pth`, RON-320's
# and SSD's shapes): (torch index, Caffe layer and flax name, in, out, kernel).
VGG16_REDUCED = tuple((i, n, ci, co, 3) for i, n, ci, co in (
    (0, "conv1_1", 3, 64), (2, "conv1_2", 64, 64), (5, "conv2_1", 64, 128), (7, "conv2_2", 128, 128),
    (10, "conv3_1", 128, 256), (12, "conv3_2", 256, 256), (14, "conv3_3", 256, 256), (17, "conv4_1", 256, 512),
    (19, "conv4_2", 512, 512), (21, "conv4_3", 512, 512), (24, "conv5_1", 512, 512), (26, "conv5_2", 512, 512),
    (28, "conv5_3", 512, 512), (31, "fc6", 512, 1024))) + ((33, "fc7", 1024, 1024, 1),)
VGG_SEED = 16
# The warm-started RON-320 run: phase "train"'s bf16 Trainer with K-B, batch 14,
# from an ssd.pytorch VGG-16 trained on BGR input; TensorBoard on.
WARM_CFG = dataclasses.replace(TRAIN_CFG, checkpoint_format="torch", checkpoint_bgr_to_rgb=True, tensorboard=True)
WARM_STEPS = 10
# SSD-300 from a Caffe VGG-16 (BGR): phase "ssd train"'s recipe, batch 32.
SSD_CAFFE_CFG = dataclasses.replace(SSD_TRAIN_CFG, checkpoint_format="caffe", checkpoint_bgr_to_rgb=True)
SSD_WARM_STEPS = 3


def seeded_vgg16(seed):
    """An ssd.pytorch-layout VGG-16 state dict ('vgg.N', OIHW) drawn from a
    numpy seed: He-scaled kernels, biases N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, _, cin, cout, k in VGG16_REDUCED:
        std = np.sqrt(2.0 / (cin * k * k))
        sd[f"vgg.{idx}.weight"] = torch.from_numpy((rng.standard_normal((cout, cin, k, k)) * std).astype(np.float32))
        sd[f"vgg.{idx}.bias"] = torch.from_numpy((rng.standard_normal(cout) * 0.05).astype(np.float32))
    return sd


def write_caffemodel(path, sd, gamma):
    """`sd`'s VGG-16 as a Caffe NetParameter (layers by Caffe's names, blobs
    with a packed BlobShape and packed float data) plus conv4_3's
    L2-normalization scale, encoded with the port's protobuf primitives."""
    def blob(a):
        shape = _len_delimited(1, b"".join(_varint(d) for d in a.shape))
        return _len_delimited(7, shape) + _len_delimited(5, a.astype("<f4").tobytes())

    def layer(name, ltype, blobs):
        body = _len_delimited(1, name.encode()) + _len_delimited(2, ltype.encode())
        return _len_delimited(100, body + b"".join(_len_delimited(7, blob(b)) for b in blobs))

    net = b"".join(layer(name, "Convolution", [sd[f"vgg.{idx}.weight"].numpy(), sd[f"vgg.{idx}.bias"].numpy()])
                   for idx, name, *_ in VGG16_REDUCED)
    Path(path).write_bytes(net + layer("conv4_3_norm", "Normalize", [gamma]))


def reference_import():
    """Phase "reference import": the reference's RON-320 (the 184 slim
    tensors of tests/fixtures/reference_forward.npz, regenerated by name)
    through the port's `slim_ron_to_flat` and `from_jax_params`, on the card:
    (a) in float64 against the TF1 reference graph's outputs, (b) in f32
    (TF32 off) with torch's own convolutions against (a), both within
    tests/test_model_parity.py's bounds; f32 through cuDNN, and (b) against
    the graph, recorded; then the bf16 Detector with K-B at batch 32 on the
    same weights (K-B and K-A once each), its detections against the f32
    Detector's (recorded)."""
    fx = np.load(REF_FIXTURE, allow_pickle=False)
    names, shapes = [str(n) for n in fx["var_names"]], json.loads(str(fx["var_shapes"]))
    params, stats = slim_ron_to_flat({n: weight_for(n, s) for n, s in zip(names, shapes)})
    if len(params) + len(stats) != len(names):
        raise AssertionError(f"slim_ron_to_flat mapped {len(params) + len(stats)} of {len(names)} tensors")
    state = from_jax_params(params, stats)
    x = torch.from_numpy(fx["input"]).cuda()
    convs = {"torch's own convolutions": lambda: torch.backends.cudnn.flags(enabled=False, allow_tf32=False),
             "cuDNN": contextlib.nullcontext}
    out, model = {}, None
    for dtype, conv in ((torch.float64, "cuDNN"), (torch.float32, "torch's own convolutions"), (torch.float32, "cuDNN")):
        model = RON(RON_320_SPEC, dtype=dtype)
        model.load_state_dict(state, strict=True)
        with torch.inference_mode(), full_f32_convs(), convs[conv]():
            out[dtype, conv] = model.to("cuda", dtype)(x.to(dtype))
    f64 = out[torch.float64, "cuDNN"]
    errs = {"float64 vs graph": reference_errors(f64, fx),
            "f32 (torch's convs) vs float64": reference_errors(out[torch.float32, "torch's own convolutions"], f64),
            "f32 (torch's convs) vs graph": reference_errors(out[torch.float32, "torch's own convolutions"], fx),
            "f32 (cuDNN) vs float64": reference_errors(out[torch.float32, "cuDNN"], f64),
            "f32 (cuDNN) vs graph": reference_errors(out[torch.float32, "cuDNN"], fx)}
    print(f"  {len(names)} slim tensors -> {len(params)} params + {len(stats)} BN statistics; RON-320 on the card:")
    for label, e in errs.items():
        gated = label in ("float64 vs graph", "f32 (torch's convs) vs float64")
        print(f"    {label}{'' if gated else ' (recorded)'}: {format_errors(e)}")
        if gated and not e["within"]:
            raise AssertionError(f"reference import, {label}: outside the bounds: {e}")
    f32_dets = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")(x.repeat(2, 1, 1, 1))
    bf16 = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=True)
    bf16.load_state_dict(state, strict=True)
    _, dets, launches = bf16_detector_run(f"reference weights, bf16 Detector with K-B, batch {BATCH}", bf16,
                                          RON_320_SPEC, x.repeat(BATCH, 1, 1, 1).contiguous())
    drift = detection_drift(f32_dets, tuple(t[:2] for t in dets))
    print(f"  bf16 vs f32 detections (recorded): keep counts equal in {drift['pairs_equal_counts']} of "
          f"{drift['pairs']} pairs; {drift['detections_bf16']} vs {drift['detections_f32']}; max |score diff| "
          f"{drift['max_abs_score_diff']:.4g}, max |box diff| {drift['max_abs_box_diff']:.4g}")
    return {"errors": errs, "launches": launches, "bf16_vs_f32": drift}


def init_tensors(cfg):
    """A Trainer's seeded init of `cfg` without a checkpoint_path: its
    parameters and buffers, on the card."""
    trainer = Trainer(dataclasses.replace(cfg, checkpoint_path=None, model_dir=cfg.model_dir + "_init"), device="cuda")
    state = trainer.init_state()
    return ({k: v.detach().clone() for k, v in state.params.items()},
            {k: v.detach().clone() for k, v in state.batch_stats.items()})


def check_warm_start(label, trainer, state, expected, printed, init, init_bufs):
    """Exactly `expected` ({torch name: source tensor in the port's layout})
    restored, cast to each parameter's dtype; every other parameter and
    every buffer equal to the seeded init."""
    changed = sorted(n for n, p in state.params.items() if not torch.equal(p, init[n]))
    if changed != sorted(expected):
        raise AssertionError(f"{label}: restored {changed}, expected {sorted(expected)}")
    wrong = [n for n, w in expected.items() if not torch.equal(state.params[n], w.to(state.params[n]))]
    kept = [n for n in state.batch_stats if not torch.equal(state.batch_stats[n], init_bufs[n])]
    if wrong or kept:
        raise AssertionError(f"{label}: restored tensors unlike the source {wrong}; buffers moved {kept}")
    names = jax_names(trainer.model)
    n_reverse = sum("reverse" in names[n] for n in state.params)
    print(f"  {label}: {[x for x in printed if x.startswith('[warm-start]')]}; {len(expected)} tensors equal the "
          f"source exactly (float32); the other {len(state.params) - len(expected)} parameters ({n_reverse} under "
          f"'reverse') and {len(state.batch_stats)} buffers equal the seeded init")
    return n_reverse


def trained_rows(label, trainer, steps, launches, t0):
    """Gates of a Trainer.train run: K-B once a step and no other kernel,
    one metrics.jsonl row a step, every loss finite."""
    check_counts(label, launches, ("fused_vgg_block1",))
    rows = [json.loads(line) for line in open(Path(trainer.config.model_dir) / "metrics.jsonl")]
    losses = [r["loss/total"] for r in rows]
    if launches["fused_vgg_block1"] != steps or [r["step"] for r in rows] != list(range(1, steps + 1)):
        raise AssertionError(f"{label}: K-B launched {launches['fused_vgg_block1']} times, logged "
                             f"{[r['step'] for r in rows]}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    print(f"  {label}: {steps} steps in {time.perf_counter() - t0:.2f} s (host clock, first steps and a checkpoint "
          f"included), losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite; K-B launched "
          f"{launches['fused_vgg_block1']} times, no other kernel")
    return rows, losses


def warm_start(host, host32, tmp):
    """Phase "warm start": (a) a bf16 RON-320 Trainer with K-B warm-started
    from an ssd.pytorch VGG-16 `.pth` (BGR-flipped conv1_1): the 30 backbone
    tensors equal the source, everything else the seeded init; 10 steps at
    batch 14 (K-B 10 times, finite losses, TensorBoard on); a second Trainer
    on the model dir resumes at step 10 instead of warm-starting again; the
    step's ms at batch 14. (b) SSD-300 from a Caffe model of the same VGG:
    its 26 conv tensors restored (Caffe's fc6/fc7 and conv4_3_norm do not
    name SSD's conv6/conv7 and block4_box/l2_norm, so those keep the init,
    as in the JAX trainer); 3 steps at batch 32 with K-B."""
    sd = seeded_vgg16(VGG_SEED)
    pth = tmp / "vgg16_reducedfc.pth"
    torch.save(sd, pth)
    cfg = dataclasses.replace(WARM_CFG, model_dir=str(tmp / "ron_warm"), checkpoint_path=str(pth))
    init, init_bufs = init_tensors(cfg)
    trainer = Trainer(cfg, device="cuda")
    if not trainer.model.backbone.fuse_block1 or trainer.model.dtype != torch.bfloat16:
        raise AssertionError("the warm-started trainer is not the bf16 model with K-B")
    state, printed = quietly(trainer.init_state)
    expected = {}
    for idx, name, *_ in VGG16_REDUCED:
        w = sd[f"vgg.{idx}.weight"]
        expected[f"backbone.{name}.conv.weight"] = w.flip(1) if name == "conv1_1" else w  # BGR -> RGB input
        expected[f"backbone.{name}.conv.bias"] = sd[f"vgg.{idx}.bias"]
    n_reverse = check_warm_start("RON-320 from the .pth", trainer, state, expected, printed, init, init_bufs)
    backbone = {n: state.params[n].detach().cpu().clone() for n in expected}
    del init, init_bufs

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, _ = quietly(lambda: trainer.train(max_steps=WARM_STEPS, batches=itertools.repeat(host)))
    torch.cuda.synchronize()
    rows, losses = trained_rows(f"warm-started RON-320 trainer (bf16, batch {TRAIN_BATCH})", trainer, WARM_STEPS,
                                kernels.launch_counts(), t0)
    launches = kernels.launch_counts()
    trained = {k: v.detach().clone() for k, v in state.params.items()}
    resumed = Trainer(cfg, device="cuda")
    st2, printed2 = quietly(resumed.init_state)
    if (st2.step != WARM_STEPS or not any(f"resumed from step {WARM_STEPS}" in x for x in printed2)
            or any(x.startswith("[warm-start]") for x in printed2)
            or not all(torch.equal(st2.params[k], v) for k, v in trained.items())):
        raise AssertionError(f"resume: step {st2.step}, printed {printed2}")
    print(f"  a second Trainer on the model dir (checkpoint_path still set): {printed2[-1]!r}, no warm start, "
          f"parameters equal the step-{WARM_STEPS} ones")
    del resumed, st2, trained
    batch = to_device(host, "cuda")
    step_ms = cuda_ms(lambda: trainer.step(state, batch), reps=5)
    print(f"  warm-started bf16 train step with K-B, batch {TRAIN_BATCH}: {step_ms:.3f} ms, "
          f"{TRAIN_BATCH * 1e3 / step_ms:.1f} img/s (CUDA events, 5 steps)")
    del trainer, state, batch

    caffe = tmp / "VGG_ILSVRC_16_layers_fc_reduced.caffemodel"
    write_caffemodel(caffe, sd, np.full((512,), 20.0, np.float32))
    scfg = dataclasses.replace(SSD_CAFFE_CFG, model_dir=str(tmp / "ssd_warm"), checkpoint_path=str(caffe))
    sinit, sinit_bufs = init_tensors(scfg)
    strainer = Trainer(scfg, device="cuda")
    if not strainer.model.fuse_block1:
        raise AssertionError("the SSD trainer did not take K-B")
    sstate, sprinted = quietly(strainer.init_state)
    sexpected = {}
    for idx, name, *_ in VGG16_REDUCED[:13]:
        w = sd[f"vgg.{idx}.weight"]
        sexpected[f"{name}.conv.weight"] = w.flip(1) if name == "conv1_1" else w
        sexpected[f"{name}.conv.bias"] = sd[f"vgg.{idx}.bias"]
    check_warm_start("SSD-300 from the Caffe model", strainer, sstate, sexpected, sprinted, sinit, sinit_bufs)
    del sinit, sinit_bufs
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    quietly(lambda: strainer.train(max_steps=SSD_WARM_STEPS, batches=itertools.repeat(host32)))
    torch.cuda.synchronize()
    ssd_launches = kernels.launch_counts()
    _, ssd_losses = trained_rows(f"SSD-300 trainer from Caffe (bf16, batch {BATCH})", strainer, SSD_WARM_STEPS,
                                 ssd_launches, t0)
    del strainer, sstate
    return {"ron": {"restored": len(expected), "reverse_at_init": n_reverse, "steps": WARM_STEPS, "losses": losses,
                    "launches": launches, "resumed_to": WARM_STEPS, "step_ms_b14": step_ms},
            "ssd_300_caffe": {"restored": len(sexpected), "steps": SSD_WARM_STEPS, "losses": ssd_losses,
                              "launches": ssd_launches},
            "pth": pth, "backbone": backbone, "model_dir": cfg.model_dir, "rows": rows}


def import_cli(pth, backbone, tmp):
    """Phase "import cli": `import-ckpt --format torch` of the warm start's
    .pth into a fresh model dir, `inspect-ckpt` listing every parameter by
    flax name, and a bf16 Trainer resuming there at step 0 with the warm
    start's backbone."""
    model_dir = str(tmp / "imported")
    _, out = quietly(lambda: cli_main(["import-ckpt", "--format", "torch", "--source", str(pth), "--model-dir",
                                       model_dir, "--bgr-to-rgb"]))
    _, lines = quietly(lambda: cli_main(["inspect-ckpt", "--model-dir", model_dir]))
    model, _ = get_network("ron_320_vgg")
    names = jax_names(model)
    want = sorted(names[n] for n, _ in model.named_parameters())
    listed = sorted(x.split()[0] for x in lines[1:])
    if lines[0] != "step: 0" or listed != want:
        raise AssertionError(f"inspect-ckpt: {lines[0]!r}, {len(listed)} tensors listed of {len(want)}")
    trainer = Trainer(dataclasses.replace(TRAIN_CFG, model_dir=model_dir), device="cuda")
    state, printed = quietly(trainer.init_state)
    same = all(torch.equal(state.params[n].cpu(), v) for n, v in backbone.items())
    if state.step != 0 or not any("resumed from step 0" in x for x in printed) or not same:
        raise AssertionError(f"the imported model dir: step {state.step}, printed {printed}, backbone equal: {same}")
    print(f"  {out[-1]!r}; inspect-ckpt listed all {len(listed)} parameters (e.g. {lines[1].split()[:3]}); a bf16 "
          f"Trainer resumed at step 0 with the warm start's {len(backbone)} backbone tensors")
    return {"listed": len(listed), "resumed_step": state.step}


def tensorboard_check(model_dir, rows):
    """Phase "tensorboard": the warm-started run's event file, read back with
    every record's CRCs verified (`read_records(verify_crc=True)`): each
    scalar of metrics.jsonl at each log step, as float32, and no other."""
    files = sorted(Path(model_dir).glob("events.out.tfevents.*"))
    if len(files) != 1:
        raise AssertionError(f"event files in {model_dir}: {files}")
    events = read_events(str(files[0]))
    got = {e["step"]: e["scalars"] for e in events if e["scalars"]}
    want = {r["step"]: {k: float(np.float32(v)) for k, v in r.items() if k not in ("step", "time")} for r in rows}
    if events[0]["file_version"] != "brain.Event:2" or got != want:
        raise AssertionError(f"TensorBoard scalars differ from metrics.jsonl: {sorted(got)} vs {sorted(want)}")
    n = sum(len(v) for v in want.values())
    print(f"  {files[0].name}: {len(events)} events, {n} scalars at steps {min(got)}-{max(got)} equal to "
          f"metrics.jsonl (float32); images: {sum(len(e['images']) for e in events)} (none asked for)")
    return {"events": len(events), "scalars": n}


# --------------------------------------------------------------------------- #
# The records-to-mAP entry points (phases "jpeg", "records", "cli train",
# "cli eval", "cli realtime-eval"), over the VOCdevkit fixture
# tests/fixtures/voc_mini and the JAX references in voc_mini_ref.npz
# (tools/make_voc_mini.py)

VOC_MINI = REPO / "tests" / "fixtures" / "voc_mini"
VOC_MINI_REF = REPO / "tests" / "fixtures" / "voc_mini_ref.npz"
RECORD_PATTERN = "voc_20??_train_*.tfrecord"
# the records: the eight fixture images under RECORD_COUNT ids in RECORD_PARTS
# year dirs, one shard each; not a multiple of CLI_EVAL_BATCH, so that eval's
# last batch is padded and masked by `sample_valid` on the card
RECORD_COUNT, RECORD_PARTS = 264, 2
BATCH_SEED, BATCH_SIZE = 0, 4  # make_batches' first batch, held to JAX's (voc_mini_ref.npz)
RESIZE_TOL = 1  # the native resize against cv2's, in levels
CLI_TRAIN_STEPS = 5
TIMED_TRAIN_STEPS = 12  # steps of each timed train run; the mean of steps 3..12
CLI_EVAL_BATCH = 32
DECODE_REPS = 16  # passes over the eight fixture JPEGs when timing the decoder
CARD = "cuda"  # the device of the CLI phases


def repeated_vocdevkit(src_year: Path, dst: Path, count: int = RECORD_COUNT, parts: int = RECORD_PARTS):
    """The eight images of `src_year` under ids 000001..count, id k being
    image (k - 1) % 8, split in order into `parts` year directories under
    `dst`. Returns [(year dir, output name)] for `convert-data`.
    (tools/make_voc_mini.py makes JAX's reference batch over the same tree.)"""
    if count % parts:
        raise ValueError(f"{count} ids do not split into {parts} equal parts")
    src_ids = sorted(p.stem for p in (Path(src_year) / "Annotations").glob("*.xml"))
    per_part = count // parts
    out = []
    for p in range(parts):
        year = Path(dst) / f"part{p}" / "VOC2007"
        for sub in ("Annotations", "JPEGImages"):
            (year / sub).mkdir(parents=True, exist_ok=True)
        for k in range(p * per_part, (p + 1) * per_part):
            src = src_ids[k % len(src_ids)]
            shutil.copyfile(Path(src_year) / "Annotations" / f"{src}.xml", year / "Annotations" / f"{k + 1:06d}.xml")
            shutil.copyfile(Path(src_year) / "JPEGImages" / f"{src}.jpg", year / "JPEGImages" / f"{k + 1:06d}.jpg")
        out.append((year, f"voc_2007_train_{p}"))
    return out


def digest(a):
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(), digest_size=16).hexdigest()


def host_jpeg_decoders():
    """{name: (version, decode)} of the JPEG libraries this host has (cv2,
    PIL), each decode JPEG bytes -> RGB: the port needs neither, phase
    "jpeg" holds its decoder to them."""
    found = {}
    try:
        import cv2
        found["cv2"] = (cv2.__version__, lambda b: cv2.cvtColor(cv2.imdecode(np.frombuffer(b, np.uint8),
                                                                             cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    except ImportError:
        pass
    try:
        import PIL
        from PIL import Image
        found["PIL"] = (PIL.__version__, lambda b: np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))
    except ImportError:
        pass
    return found


def jpeg_phase(ref, smi):
    """Phase "jpeg": the port's JPEG decoder (data/jpeg.py, the only one it
    has), built from data/_native/jpeg_decode.c. Where the card host has cv2
    or PIL, every fixture JPEG's decode bit-equal to theirs, and the train
    canvas (the resize to 512x512) within 1 level of cv2.resize's. On every
    host: every fixture JPEG's decode and its 320x320 eval canvas
    (WARP_RESIZE) equal to Pillow's and JAX's by digest (voc_mini_ref.npz);
    the resize within 1 level of the fixture's cv2 resizes. Decode ms per
    image on one thread and with the pipeline's thread pool."""
    t0 = time.perf_counter()
    jpeg.library()
    build_s = time.perf_counter() - t0
    year = VOC_MINI / "VOC2007"
    ids = [str(i) for i in ref["ids"]]
    data = {i: (year / "JPEGImages" / f"{i}.jpg").read_bytes() for i in ids}
    raw = {i: decode.decode_jpeg_raw(data[i]) for i in ids}
    canvas = TRAIN_CFG.data.working_shape
    against_host = {}
    for name, (version, host_decode) in host_jpeg_decoders().items():
        bad = [i for i in ids if not np.array_equal(raw[i], host_decode(data[i]))]
        if bad:
            raise AssertionError(f"the port's decodes differ from the host's {name} {version}: {bad}")
        against_host[name] = {"version": version, "decodes_equal": len(ids)}
        if name == "cv2":
            import cv2

            diffs = [np.abs(jpeg.resize_bilinear(raw[i], canvas).astype(np.int16)
                            - cv2.resize(raw[i], canvas[::-1], interpolation=cv2.INTER_LINEAR)) for i in ids]
            worst = max(int(d.max()) for d in diffs)
            if worst > RESIZE_TOL:
                raise AssertionError(f"train canvases {worst} levels from the host's cv2")
            against_host[name].update(train_canvas_max_levels=worst,
                                      train_canvas_unequal_share=float(np.mean([(d > 0).mean() for d in diffs])))
    bad = [i for k, i in enumerate(ids) if digest(raw[i]) != ref["raw_digest"][k]
           or digest(decode.decode_jpeg_eval(data[i], RON_320_SPEC.img_shape, "WARP_RESIZE")) != ref["eval_digest"][k]]
    if bad:
        raise AssertionError(f"decodes or eval canvases differ from Pillow's / JAX's: {bad}")
    resize = {}
    for k, i in enumerate(str(x) for x in ref["cv2_resize_ids"]):
        diff = np.abs(jpeg.resize_bilinear(raw[i], ref["cv2_resize"].shape[1:3]).astype(np.int16)
                      - ref["cv2_resize"][k])
        resize[i] = {"max": int(diff.max()), "unequal_share": float((diff > 0).mean())}
        if diff.max() > RESIZE_TOL:
            raise AssertionError(f"resize of {i}: {int(diff.max())} levels from cv2's")
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))  # batch_iterator's decode_workers=-1
    blobs = [data[i] for i in ids] * DECODE_REPS

    def per_image_ms(fn, n_threads):
        fn(blobs[0])
        t0 = time.perf_counter()
        if n_threads == 1:
            for b in blobs:
                fn(b)
        else:
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                list(pool.map(fn, blobs))
        return (time.perf_counter() - t0) * 1e3 / len(blobs)

    ms = {f"{name}_{n}_threads": per_image_ms(fn, n) for name, fn in
          (("raw", decode.decode_jpeg_raw), ("train_512", lambda b: decode.decode_jpeg(b, canvas)),
           ("eval_320", lambda b: decode.decode_jpeg_eval(b, RON_320_SPEC.img_shape, "WARP_RESIZE")))
          for n in (1, workers)}
    print(f"  decoder: the port's own (data/jpeg.py, built in {build_s:.2f} s); against this host's libraries: "
          f"{against_host or 'none installed'}")
    print(f"  {len(ids)} JPEGs (320x320, 500x375, 375x500; gray, 4:4:4, restart markers, 4:2:0): decodes and eval "
          f"canvases equal Pillow's and JAX's digests; resize to {canvas}: "
          + ", ".join(f"{i} max {r['max']} level(s), unequal share {r['unequal_share']:.6f}"
                      for i, r in resize.items()))
    print(f"  decode ms per image ({smi}, host CPU, {os.cpu_count()} cores): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return {"decoder": "native", "against_host": against_host, "build_s": build_s, "images": len(ids),
            "resize": resize, "ms_per_image": ms, "decode_workers": workers}


def records_phase(ref, tmp, smi):
    """Phase "records": `convert-data` of the eight fixture images under 264
    ids in two VOC year dirs (one shard each); every record parses back to
    its XML and JPEG; `Trainer.make_batches`' first batch (seed 0, batch 4,
    the trainer's uint8 512x512 pipeline) against JAX's: the same samples
    in the same order, gts exact, pixels within 1 level."""
    records = tmp / "records"
    t0 = time.perf_counter()
    parts = repeated_vocdevkit(VOC_MINI / "VOC2007", tmp / "voc")
    for year, name in parts:
        quietly(lambda: cli_main(["convert-data", "--voc-root", str(year), "--output-dir", str(records),
                                  "--output-name", name]))
    convert_s = time.perf_counter() - t0
    files = list_shards(str(records), RECORD_PATTERN)
    if [os.path.basename(f) for f in files] != [str(x) for x in ref["batch/shards"]]:
        raise AssertionError(f"shards {files}")
    n = 0
    for year, name in parts:
        ids = sorted(p.stem for p in (year / "Annotations").glob("*.xml"))
        for rec, image_id in zip(read_records(str(records / f"{name}_000.tfrecord"), verify_crc=True), ids):
            sample = parse_voc_example(rec)
            ann = parse_annotation(str(year / "Annotations" / f"{image_id}.xml"))
            want = np.asarray([o.bbox for o in ann.objects], np.float32).reshape(-1, 4)
            if (sample["jpeg"] != (year / "JPEGImages" / f"{image_id}.jpg").read_bytes()
                    or not np.array_equal(sample["boxes"], want)
                    or sample["labels"].tolist() != [o.label for o in ann.objects]
                    or sample["difficult"].tolist() != [o.difficult for o in ann.objects]
                    or sample["shape"] != ann.shape):
                raise AssertionError(f"the record of {image_id} does not parse back to its XML and JPEG")
            n += 1
    if n != RECORD_COUNT:
        raise AssertionError(f"{n} records")
    cfg = dataclasses.replace(TRAIN_CFG, model_dir=str(tmp / "unused"), seed=BATCH_SEED,
                              data=dataclasses.replace(TRAIN_CFG.data, dataset_dir=str(records),
                                                       batch_size=BATCH_SIZE))
    trainer = Trainer(cfg, device=CARD)
    t0 = time.perf_counter()
    first = next(iter(trainer.make_batches()))
    first_s = time.perf_counter() - t0
    del trainer
    for k in ("gt_labels", "gt_boxes", "gt_valid", "gt_difficult", "sample_valid"):
        if not np.array_equal(first[k], ref[f"batch/{k}"]):
            raise AssertionError(f"make_batches' first batch: {k} differs from JAX's")
    diff = np.abs(first["image01"].astype(np.int16) - ref["batch/image01"])
    if first["image01"].dtype != np.uint8 or diff.max() > RESIZE_TOL:
        raise AssertionError(f"make_batches' first batch: pixels {int(diff.max())} levels from JAX's")
    print(f"  convert-data: {n} records in {len(files)} shards in {convert_s:.2f} s (host), each parsed back to its "
          f"XML and JPEG; make_batches' first batch (seed {BATCH_SEED}, batch {BATCH_SIZE}, "
          f"{first['image01'].shape[1:3]} uint8) equals JAX's: gts exact, pixels max {int(diff.max())} level(s), "
          f"unequal share {float((diff > 0).mean()):.6f}; first batch in {first_s:.3f} s ({smi})")
    return {"records": n, "shards": len(files), "convert_s": convert_s, "batch_pixel_max": int(diff.max()),
            "batch_pixel_unequal": float((diff > 0).mean()), "path": str(records)}


def step_ms(model_dir):
    """Mean ms of the steps after the second, from metrics.jsonl's host
    times (every step logs, which waits for its loss)."""
    rows = [json.loads(line) for line in open(Path(model_dir) / "metrics.jsonl")]
    times = [r["time"] for r in rows]
    return (times[-1] - times[1]) * 1e3 / (len(times) - 2), rows


def cli_train(state, records, model_dir, steps, batch):
    """`train` through the CLI from a step-0 checkpoint of `state`, every
    step logged; returns the printed lines."""
    seeded_model_dir(str(model_dir), state)
    argv = ["--device", CARD, "train", "--model-dir", str(model_dir), "--dataset-dir", str(records),
            "fuse_block1=true", f"data.batch_size={batch}", f"max_steps={steps}", "log_every_steps=1",
            f"save_every_steps={steps}", "max_to_keep=2", "tensorboard=false"]
    return quietly(lambda: cli_main(argv))[1]


def cli_train_phase(state, records, fx, tmp, smi, steps=CLI_TRAIN_STEPS, batch=TRAIN_BATCH):
    """Phase "cli train": `train` through the CLI on the card from the
    records, RON-320 at full width, bf16, K-B, batch 14, from a step-0
    checkpoint of the trained weights: K-B once a step and no other kernel,
    every loss finite, a checkpoint at the last step. Then the step's ms
    from the records beside a Trainer of the same config on in-memory
    batches: four warm runs of TIMED_TRAIN_STEPS steps in the order
    records, memory, memory, records, each the mean of its steps 3..N."""
    model_dir = tmp / "cli_train"
    kernels.reset_launch_counts()
    printed = cli_train(state, records, model_dir, steps, batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts(f"CLI train ({steps} bf16 steps at batch {batch} from records)", launches, ("fused_vgg_block1",))
    _, rows = step_ms(model_dir)
    losses = [r["loss/total"] for r in rows]
    if (launches["fused_vgg_block1"] != steps or CheckpointManager(str(model_dir)).latest_step() != steps
            or [r["step"] for r in rows] != list(range(1, steps + 1)) or not np.isfinite(losses).all()):
        raise AssertionError(f"CLI train: K-B {launches['fused_vgg_block1']}, checkpoints "
                             f"{CheckpointManager(str(model_dir)).all_steps()}, losses {losses}")
    shutil.rmtree(model_dir)
    host = train_host_batch(fx, batch)

    def timed(source):
        run_dir = tmp / f"timed_{source}"
        if source == "records":
            cli_train(state, records, run_dir, TIMED_TRAIN_STEPS, batch)
        else:
            seeded_model_dir(str(run_dir), state)
            cfg = dataclasses.replace(TRAIN_CFG, model_dir=str(run_dir), max_steps=TIMED_TRAIN_STEPS,
                                      tensorboard=False, data=dataclasses.replace(TRAIN_CFG.data, batch_size=batch))
            quietly(lambda: Trainer(cfg, device=CARD).train(batches=itertools.repeat(host)))
        ms, _ = step_ms(run_dir)
        shutil.rmtree(run_dir)
        return ms

    runs = [(source, timed(source)) for source in ("records", "memory", "memory", "records")]
    records_ms = float(np.mean([ms for s, ms in runs if s == "records"]))
    memory_ms = float(np.mean([ms for s, ms in runs if s == "memory"]))
    print(f"  CLI train: {[x for x in printed if x.startswith('[trainer] step')][-1]!r}; {steps} steps, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; K-B {launches['fused_vgg_block1']} launches; checkpoint "
          f"at step {steps}")
    print(f"  step ms (host clock, each step waits for its loss; runs of {TIMED_TRAIN_STEPS} steps, mean of steps "
          f"3-{TIMED_TRAIN_STEPS}, in turns): " + ", ".join(f"{s} {ms:.3f}" for s, ms in runs)
          + f"; from records {records_ms:.3f}, from in-memory batches {memory_ms:.3f} ({smi})")
    return {"steps": steps, "losses": losses, "launches": launches, "step_ms_records": records_ms,
            "step_ms_in_memory": memory_ms, "timed_runs": runs}


def cli_eval_phase(state, records, tmp, smi):
    """Phase "cli eval": `eval` through the CLI on the card, RON-320 bf16 (K-B)
    with the trained weights, batch 32, over the 264 records (decode
    included; the last batch holds 8 images and 24 padded rows): K-A and K-B
    launched; its mAP07, mAP12, APs and every class's TP/FP equal to
    `StreamingEvaluator.run` of the same evaluator on the same batches
    decoded beforehand and fed directly. img/s of both, from four warm runs
    in the order CLI, direct, direct, CLI."""
    model_dir = tmp / "cli_eval"
    seeded_model_dir(str(model_dir), state)
    runs = []
    real_run = StreamingEvaluator.run

    def recorded(self, *a, **kw):
        out = real_run(self, *a, **kw)
        runs.append((self, out, self.accumulator))
        return out

    argv = ["--device", CARD, "eval", "--model-dir", str(model_dir), "--dataset-dir", str(records),
            f"data.file_pattern={RECORD_PATTERN}", f"data.batch_size={CLI_EVAL_BATCH}"]
    kernels.reset_launch_counts()
    with mock.patch.object(StreamingEvaluator, "run", recorded):
        _, printed = quietly(lambda: cli_main(argv))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts(f"CLI eval (bf16, batch {CLI_EVAL_BATCH}, from records)", launches, MAIN_PATH)
    ev, (map07, map12, aps, stats), acc = runs[0]
    if not ev.detector.model.backbone.fuse_block1:
        raise AssertionError("the CLI's bf16 eval on the card did not take K-B")
    pcfg = PipelineConfig(batch_size=CLI_EVAL_BATCH, working_shape=RON_320_SPEC.img_shape, shuffle=False,
                          keep_difficult=True, eval_resize="WARP_RESIZE", output_dtype="uint8")
    batches = [{"image": b["image01"], "gt_labels": b["gt_labels"], "gt_boxes": b["gt_boxes"],
                "gt_difficult": b["gt_difficult"], "sample_valid": b["sample_valid"]}
               for b in batch_iterator(list_shards(str(records), RECORD_PATTERN), pcfg, epochs=1,
                                       drop_remainder=False)]
    padded = int((~batches[-1]["sample_valid"]).sum())
    dmap07, dmap12, daps, dstats = ev.run(iter(batches), log_every=0)
    n_tp = n_fp = 0
    for c in range(1, RON_320_SPEC.num_classes):
        got, want = acc.class_arrays(c), ev.accumulator.class_arrays(c)
        if acc.n_gt[c] != ev.accumulator.n_gt[c] or not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"CLI eval: class {c}'s TP/FP differ from the direct run's")
        n_tp, n_fp = n_tp + int(got[1].sum()), n_fp + int(got[2].sum())
    if ((map07, map12, aps) != (dmap07, dmap12, daps) or stats["images"] != RECORD_COUNT
            or dstats["images"] != RECORD_COUNT or n_tp == 0 or padded == 0):
        raise AssertionError(f"CLI eval: mAP {map07}/{map12} against {dmap07}/{dmap12}, {stats['images']} images, "
                             f"{padded} padded rows")

    def timed(source):
        if source == "direct":
            return 1.0 / ev.run(iter(batches), log_every=0)[3]["sec_per_image"]
        with mock.patch.object(StreamingEvaluator, "run", recorded):
            quietly(lambda: cli_main(argv))
        return 1.0 / runs[-1][1][3]["sec_per_image"]

    timed_runs = [(source, timed(source)) for source in ("cli", "direct", "direct", "cli")]
    cli_ips = float(np.mean([x for s, x in timed_runs if s == "cli"]))
    mem_ips = float(np.mean([x for s, x in timed_runs if s == "direct"]))
    print(f"  CLI eval: {[x for x in printed if x.startswith('mAP (VOC07')][0]!r}, "
          f"{[x for x in printed if x.startswith('mAP (VOC12')][0]!r}; {stats['images']} images in "
          f"{len(batches)} batches, the last with {padded} padded rows; mAP, APs and TP/FP ({n_tp} TP, {n_fp} FP) "
          f"equal to the direct run's; K-A {launches['nms_fixpoint_keep_mask']}, K-B "
          f"{launches['fused_vgg_block1']} launches")
    print(f"  img/s (warm runs over the {stats['images']} images, in turns; CLI = end to end from the records, "
          f"decode included; direct = batches decoded beforehand): "
          + ", ".join(f"{s} {x:.1f}" for s, x in timed_runs)
          + f"; end to end {cli_ips:.1f}, fed in memory {mem_ips:.1f} ({smi})")
    return {"map07": map07, "map12": map12, "images": stats["images"], "padded_rows": padded, "tp": n_tp,
            "fp": n_fp, "launches": launches, "img_per_s_end_to_end": cli_ips, "img_per_s_in_memory": mem_ips,
            "timed_runs": timed_runs, "losses": {k: v for k, v in stats.items() if k.startswith("loss/")},
            "model_dir": str(model_dir), "aps": aps, "accumulator": acc}


def cli_realtime_phase(model_dir, ref, tmp, smi):
    """Phase "cli realtime-eval": `realtime-eval` through the CLI on the card,
    f32 RON-320 with the trained weights, over the fixture VOCdevkit (its
    JPEGs through the native decoder): K-C launched, K-A and K-B not; the
    detections it writes, per class and image, against JAX's rows: equal
    counts, classes and images, scores and boxes within 2e-3."""
    out_dir = tmp / "rt_out"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, printed = quietly(lambda: cli_main(["--device", CARD, "realtime-eval", "--model-dir", model_dir,
                                           "--voc-root", str(VOC_MINI), "--output-dir", str(out_dir)]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_counts("CLI realtime-eval (f32)", launches, ("nms_scan_keep_mask",))
    with open(out_dir / "detections.pkl", "rb") as f:
        all_boxes = pickle.load(f)
    rows = [(c, ii, row) for c, per_image in enumerate(all_boxes) for ii, r in enumerate(per_image)
            for row in np.asarray(r).reshape(-1, 5)]
    if (len(rows) != len(ref["rt/rows"]) or [c for c, _, _ in rows] != ref["rt/cls"].tolist()
            or [i for _, i, _ in rows] != ref["rt/image"].tolist()):
        raise AssertionError(f"CLI realtime-eval: {len(rows)} detections against JAX's {len(ref['rt/rows'])}, "
                             "or other classes or images")
    err = float(np.abs(np.stack([r for _, _, r in rows]) - ref["rt/rows"]).max())
    if err > PARITY_ATOL:
        raise AssertionError(f"CLI realtime-eval: detections {err} from JAX's")
    mean_ap = [x for x in printed if x.startswith("Mean AP")][0]
    print(f"  CLI realtime-eval: {len(rows)} detections of {len(ref['ids'])} images, classes and counts equal "
          f"JAX's, scores and boxes within {err:.3g} (gate {PARITY_ATOL}); {mean_ap!r} (JAX's "
          f"{float(ref['rt/map']):.4f}); K-C {launches['nms_scan_keep_mask']} launches; {seconds:.2f} s with the "
          f"restore ({smi})")
    return {"detections": len(rows), "max_abs_err": err, "launches": launches, "seconds": seconds,
            "mean_ap": mean_ap}


# --------------------------------------------------------------------------- #
# Distribution (phase "dist"): ranks on the one card

DIST_RUN_TIMEOUT = 600  # s for one multi-process run, start-up included: run_ranks kills its ranks after it
DIST_TIMEOUT = datetime.timedelta(seconds=300)  # every process group's init and collectives
DIST_BATCH, DIST_TP_BATCH, DIST_STEPS = TRAIN_BATCH, 2, 5
# (c)'s global eval batch: 32 rows a rank, so that each rank's forward is
# phase "cli eval"'s forward of the same 32 rows. The card's bf16
# convolutions pick their algorithm by batch size: a 16-row forward differs
# in the last bits from the 32-row one, and the mAP moved (0.2061 on 2 ranks
# of 16 rows against 0.2051; PERF.md, Findings).
DIST_EVAL_BATCH = 2 * CLI_EVAL_BATCH
DIST_DEVICE = "cuda:0"  # every rank on the one card


def dist_start(rank, world, port, mesh_shape, backend="gloo"):
    """This rank's process group (gloo: NCCL takes one rank per device) and
    its mesh."""
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend, device=DIST_DEVICE, timeout=DIST_TIMEOUT)
    return make_mesh(tuple(mesh_shape))


def tensor_digest(tensors) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dist_f32_run(state, host, batch, mesh):
    """One f32 step of RON-320 (the TrainConfig optimizer) on the global
    batch `batch` of `host`, with one augmentation's and the loss's draws of
    the global batch: on `mesh` (this rank's rows) or in one process.
    Returns (metrics, whole parameters and BN statistics on the CPU, step ms,
    the step's gradient all-reduce alone ms or None)."""
    model = RON(RON_320_SPEC)
    model.load_state_dict(state, strict=True)
    enc = TargetEncoder(RON_320_SPEC.anchor_layout(), RON_320_SPEC.img_shape, TRAIN_CFG.match.positive_threshold,
                        TRAIN_CFG.match.ignore_threshold, RON_320_SPEC.prior_scaling)
    tx = make_optimizer(TRAIN_CFG.optimizer, model)
    if mesh is not None:
        shard_model(model, mesh)
    model.to(DIST_DEVICE)
    st = create_train_state(model, tx)
    step = make_train_step(model, enc, tx, TRAIN_CFG.loss, mesh=mesh)
    host_t, aug_draws, loss_draws, pcfg = train_inputs(host, batch, seed=0)
    if mesh is not None:
        b = batch // mesh.data_size
        off = mesh.data_index * b
        local = {k: v[off:off + b] for k, v in host_t.items()}
        inputs = GlobalBatch(augmented(local, take_rows(aug_draws, off, b), pcfg, DIST_DEVICE), off, batch)
    else:
        inputs = augmented(host_t, aug_draws, pcfg, DIST_DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = step(st, inputs, draws=loss_draws.to(DIST_DEVICE))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    sharded = sharded_names(model, mesh) if mesh is not None else {}
    whole = gathered_state_dict(st, mesh, sharded) if mesh is not None else st.state_dict()
    reduce_ms = None
    if mesh is not None and mesh.data_group is not None:
        grads = [torch.zeros_like(p) for p in st.params.values()]
        reduce_ms = cuda_ms(lambda: all_reduce_flat(grads, mesh.data_group), reps=3, warmup=1)
    return ({k: float(v) for k, v in metrics.items()}, {**whole["params"], **whole["batch_stats"]}, ms, reduce_ms)


def dist_f32_worker(rank, world, port, mesh_shape, batch):
    """Phase "dist" (a) and (b), one rank: the f32 step on the mesh; rank 0
    then runs the one-process step on the same global batch and draws and
    holds the mesh's to it."""
    mesh = dist_start(rank, world, port, mesh_shape)
    state = from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE)))
    host = train_host_batch(np.load(TRAINED_FIXTURE, allow_pickle=False), batch)
    metrics, whole, ms, reduce_ms = dist_f32_run(state, host, batch, mesh)
    out = {"metrics": metrics, "digest": tensor_digest(whole), "ms": ms, "allreduce_ms": reduce_ms}
    if rank == 0:
        ref_metrics, ref, ref_ms, _ = dist_f32_run(state, host, batch, None)
        out.update(ref_metrics=ref_metrics, ref_ms=ref_ms,
                   state_err=max((float((whole[k] - r).abs().max()) / max(float(r.abs().max()), 1e-30), k)
                                 for k, r in ref.items()))
    return out


def dist_trainer_worker(rank, world, port, model_dir, steps):
    """Phase "dist" (a), one rank of the bf16 Trainer with K-B on a (2, 1)
    mesh: its rows of the global batch of 14, `steps` steps from the
    trained weights' step-0 checkpoint, then three more steps timed and the
    gradient all-reduce alone timed. Counts K-B's launches in this rank."""
    dist_start(rank, world, port, (world, 1))
    local_b = DIST_BATCH // world
    cfg = dataclasses.replace(TRAIN_CFG, model_dir=model_dir, mesh_shape=(world, 1), tensorboard=False,
                              data=dataclasses.replace(TRAIN_CFG.data, batch_size=local_b))
    trainer = Trainer(cfg, device=DIST_DEVICE)
    if not trainer.model.backbone.fuse_block1:
        raise AssertionError(f"rank {rank}: the bf16 trainer on the card did not take K-B")
    host = train_host_batch(np.load(TRAINED_FIXTURE, allow_pickle=False), DIST_BATCH)
    local = {k: v[rank * local_b:(rank + 1) * local_b] for k, v in host.items()}
    kernels.reset_launch_counts()
    st, _ = quietly(lambda: trainer.train(max_steps=steps, batches=itertools.repeat(local)))
    torch.cuda.synchronize()
    launches, trained_to = kernels.launch_counts(), st.step
    placed = host_local_to_global(local, trainer.mesh, DIST_DEVICE)
    step_ms = cuda_ms(lambda: trainer.step(st, placed), reps=3, warmup=1)
    grads = [torch.zeros_like(p) for p in st.params.values()]
    reduce_ms = cuda_ms(lambda: all_reduce_flat(grads, trainer.mesh.data_group), reps=3, warmup=1)
    losses = None
    if rank == 0:
        losses = [json.loads(line)["loss/total"] for line in open(Path(model_dir) / "metrics.jsonl")]
    return {"launches": launches, "step": trained_to, "losses": losses, "step_ms": step_ms, "allreduce_ms": reduce_ms,
            "saved_digest": tensor_digest(trainer._ckpt.restore_eval(steps)[0]["params"]) if rank == 0 else None}


def dist_eval_worker(rank, world, port, argv):
    """Phase "dist" (c), one rank: the CLI's `eval` as it runs under
    `python -m torch.distributed.run` (env:// variables), K-A and K-B
    counted in this rank; rank 0's mAP, APs and per-class TP/FP."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    runs = []
    real_run = StreamingEvaluator.run

    def recorded(self, *a, **kw):
        out = real_run(self, *a, **kw)
        runs.append((self, out))
        return out

    kernels.reset_launch_counts()
    with mock.patch.object(StreamingEvaluator, "run", recorded):
        _, printed = quietly(lambda: cli_main(argv))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    ev, (map07, map12, aps, stats) = runs[0]
    out = {"launches": launches, "fused": ev.detector.model.backbone.fuse_block1, "mesh": ev.mesh.shape}
    if rank == 0:
        acc = ev.accumulator
        out.update(map07=map07, map12=map12, aps=aps, images=stats["images"], printed=printed,
                   classes={c: (acc.n_gt[c], *acc.class_arrays(c)) for c in range(1, RON_320_SPEC.num_classes)},
                   img_per_s=1.0 / stats["sec_per_image"])
    return out


def dist_nccl_worker(rank, world, port, model_dir):
    """Phase "dist" (d): torch.distributed from env:// at world size 1 with
    the backend a card gets by default (NCCL), one all-reduce, and one bf16
    Trainer step through the mesh code path (mesh (1, 1))."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    device = local_device("cuda")
    if not initialize_distributed(device=device, timeout=DIST_TIMEOUT):
        raise AssertionError("initialize_distributed did not initialize from env://")
    t = torch.full((4,), 3.0, device=device)
    torch.distributed.all_reduce(t)
    cfg = dataclasses.replace(TRAIN_CFG, model_dir=model_dir, mesh_shape=(1, 1), tensorboard=False,
                              data=dataclasses.replace(TRAIN_CFG.data, batch_size=F32_STEP_BATCH))
    host = train_host_batch(np.load(TRAINED_FIXTURE, allow_pickle=False), F32_STEP_BATCH)
    trainer = Trainer(cfg, device=device)
    kernels.reset_launch_counts()
    st, _ = quietly(lambda: trainer.train(max_steps=1, batches=itertools.repeat(host)))
    torch.cuda.synchronize()
    loss = [json.loads(line)["loss/total"] for line in open(Path(model_dir) / "metrics.jsonl")]
    return {"backend": torch.distributed.get_backend(), "device": str(device), "allreduce": t.tolist(),
            "mesh": trainer.mesh.shape, "step": st.step, "loss": loss, "launches": kernels.launch_counts()}


def run_dist(target, world, **kwargs):
    return run_ranks(f"chip_smoke:{target}", world, kwargs, timeout=DIST_RUN_TIMEOUT)


def dist_phase(state, records, cli_eval, eval_dir, tmp, train_times, smi):
    """Phase "dist": distribution on the one card (gloo between ranks, all
    on cuda:0). (a) DP: one f32 RON-320 step on mesh (2, 1) at global batch
    14 (7 a rank) against the one-process f32 step on the same batch and
    draws: losses and parts within 1e-4 relative, counts equal, updated
    parameters and BN statistics within 1e-4 of each tensor's largest
    magnitude, ranks bit-identical; then 5 bf16 Trainer steps with K-B on
    (2, 1): K-B once a step in each rank, every loss finite, rank 0's
    checkpoint restored by a one-process Trainer equal to it. (b) TP: one
    f32 step on mesh (1, 2) at batch 2 against the one-process step, the same
    tolerances, grad_norm within them too. (c) the CLI's eval over the
    records on mesh [2, 1] at a global batch of 64 (phase "cli eval"'s 32
    rows a rank; the last batch 8 images and 56 padded rows): mAP, APs and
    every class's TP/FP equal to phase "cli eval"'s one-process run; K-A
    and K-B launched in each rank. (d)
    env:// at world size 1 with NCCL: an all-reduce and one Trainer step on
    mesh (1, 1). Recorded: the 2-rank step's ms beside the one-process step
    at batch 14, and the gradient all-reduce's."""
    res = {}

    def hold(label, r, world):
        r0 = r[0]
        if len({x["digest"] for x in r}) != 1 or any(x["metrics"] != r0["metrics"] for x in r):
            raise AssertionError(f"{label}: the ranks' states or metrics differ")
        m, ref = r0["metrics"], r0["ref_metrics"]
        worst = {k: abs(m[k] - ref[k]) / abs(ref[k]) for k in ref if k.startswith("loss/") or k == "grad_norm"}
        bad = [k for k, v in worst.items() if v > TRAIN_LOSS_RTOL]
        bad += [k for k in ref if k.startswith("counts/") and m[k] != ref[k]]
        if bad or r0["state_err"][0] > TRAIN_STATE_RTOL:
            raise AssertionError(f"{label}: {bad} off, or the state {r0['state_err']} (tolerance {TRAIN_STATE_RTOL})")
        print(f"  {label}: loss {ref['loss/total']:.6f}, worst part {max(worst.values()):.2e} relative (grad_norm "
              f"{worst['grad_norm']:.2e}), counts equal, updated parameters and BN statistics within "
              f"{r0['state_err'][0]:.2e} ({r0['state_err'][1]}), {world} ranks bit-identical; step "
              f"{r0['ms']:.1f} ms on the mesh, {r0['ref_ms']:.1f} ms in one process (host clock, first step; {smi})")
        return {"loss_rel_diff": worst, "state_err": r0["state_err"], "ms": r0["ms"], "ref_ms": r0["ref_ms"],
                "allreduce_ms": r0["allreduce_ms"]}

    res["dp_f32"] = hold(f"(a) f32 step on mesh (2, 1), global batch {DIST_BATCH}",
                         run_dist("dist_f32_worker", 2, mesh_shape=[2, 1], batch=DIST_BATCH), 2)
    model_dir = tmp / "dist_train"
    seeded_model_dir(str(model_dir), state)
    r = run_dist("dist_trainer_worker", 2, model_dir=str(model_dir), steps=DIST_STEPS)
    for rank, x in enumerate(r):
        check_counts(f"rank {rank}'s {DIST_STEPS} bf16 Trainer steps on mesh (2, 1)", x["launches"],
                     ("fused_vgg_block1",))
        if x["launches"]["fused_vgg_block1"] != DIST_STEPS or x["step"] != DIST_STEPS:
            raise AssertionError(f"rank {rank}: step {x['step']}, K-B launched {x['launches']}")
    losses = r[0]["losses"]
    if len(losses) != DIST_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"dist trainer losses {losses}")
    restored = Trainer(dataclasses.replace(TRAIN_CFG, model_dir=str(model_dir), tensorboard=False), device="cuda")
    st, _ = quietly(restored.init_state)
    if st.step != DIST_STEPS or tensor_digest({k: v for k, v in st.params.items()}) != r[0]["saved_digest"]:
        raise AssertionError(f"the one-process restore of rank 0's checkpoint: step {st.step}, or other parameters")
    one = train_times[f"b{TRAIN_BATCH}"]["ms"]
    res["dp_trainer"] = {"launches_per_rank": [x["launches"]["fused_vgg_block1"] for x in r], "losses": losses,
                         "step_ms": r[0]["step_ms"], "one_process_step_ms": one,
                         "allreduce_ms": r[0]["allreduce_ms"]}
    print(f"  (a) bf16 Trainer + K-B on mesh (2, 1), 7 rows a rank: {DIST_STEPS} steps, K-B launched "
          f"{res['dp_trainer']['launches_per_rank']} times (each rank), losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"all finite; rank 0's checkpoint restored in one process at step {st.step}, parameters equal; step "
          f"{r[0]['step_ms']:.1f} ms on 2 ranks of one card (gloo) against {one:.1f} ms in one process at batch "
          f"{TRAIN_BATCH}; the gradient all-reduce alone {r[0]['allreduce_ms']:.1f} ms ({smi})")
    del restored, st
    res["tp_f32"] = hold(f"(b) f32 step on mesh (1, 2), batch {DIST_TP_BATCH}",
                         run_dist("dist_f32_worker", 2, mesh_shape=[1, 2], batch=DIST_TP_BATCH), 2)

    argv = ["--device", DIST_DEVICE, "--dist-backend", "gloo", "eval", "--model-dir", eval_dir, "--dataset-dir",
            str(records), f"data.file_pattern={RECORD_PATTERN}", f"data.batch_size={DIST_EVAL_BATCH}",
            "mesh_shape=[2, 1]"]
    r = run_dist("dist_eval_worker", 2, argv=argv)
    for rank, x in enumerate(r):
        check_counts(f"rank {rank}'s CLI eval on mesh [2, 1]", x["launches"], MAIN_PATH)
        if not x["fused"] or x["mesh"] != (2, 1):
            raise AssertionError(f"rank {rank}: eval without K-B or on mesh {x['mesh']}")
    r0, acc = r[0], cli_eval["accumulator"]
    same = all(r0["classes"][c][0] == acc.n_gt[c] and all(np.array_equal(a, b) for a, b in
                                                         zip(r0["classes"][c][1:], acc.class_arrays(c)))
               for c in r0["classes"])
    if (r0["map07"], r0["map12"]) != (cli_eval["map07"], cli_eval["map12"]) or r0["aps"] != cli_eval["aps"] \
            or not same or r0["images"] != RECORD_COUNT:
        raise AssertionError(f"(c) mesh eval: mAP {r0['map07']}/{r0['map12']} against one process's "
                             f"{cli_eval['map07']}/{cli_eval['map12']}, TP/FP equal: {same}")
    res["eval"] = {"map07": r0["map07"], "map12": r0["map12"], "img_per_s": r0["img_per_s"],
                   "launches": [x["launches"] for x in r]}
    print(f"  (c) CLI eval on mesh [2, 1], global batch {DIST_EVAL_BATCH}, over the {r0['images']} records: mAP07 "
          f"{r0['map07']:.4f}, mAP12 "
          f"{r0['map12']:.4f}, APs and every class's TP/FP equal to the one-process CLI run's; launches "
          + "; ".join(f"rank {i}: K-A {x['launches']['nms_fixpoint_keep_mask']}, K-B "
                      f"{x['launches']['fused_vgg_block1']}" for i, x in enumerate(r))
          + f"; {r0['img_per_s']:.1f} img/s end to end ({smi})")

    r = run_dist("dist_nccl_worker", 1, model_dir=str(tmp / "dist_nccl"))[0]
    if (r["backend"] != "nccl" or r["allreduce"] != [3.0] * 4 or r["step"] != 1 or r["mesh"] != (1, 1)
            or not np.isfinite(r["loss"]).all() or r["launches"]["fused_vgg_block1"] != 1):
        raise AssertionError(f"(d) NCCL at world size 1: {r}")
    res["nccl_world_1"] = r
    print(f"  (d) env:// at world size 1 on {r['device']}: backend {r['backend']}, all-reduce {r['allreduce']}, one "
          f"Trainer step on mesh {r['mesh']} (loss {r['loss'][0]:.4f}, K-B {r['launches']['fused_vgg_block1']})")
    return res


# Phase "zoo": the classification networks at their published depth and widths
ZOO_SEED = 27
ZOO_F32_BATCH, ZOO_BF16_BATCH, ZOO_TRAIN_BATCH = 2, 32, 8
# (a) and (d): the card's f32 (full f32 convolutions, TF32 off) against the
# CPU's forward of the same weights and images, summation order only, as
# phase "ssd f32": each output within 1e-4 of its largest magnitude; the
# running statistics a train-mode forward updates within 1e-4 of each
# statistic's largest magnitude.
ZOO_TOL = 1e-4


def zoo_networks():
    """name -> (constructor of the network in a dtype, input side): the JAX
    package's published depths and class counts."""
    return {
        "inception_v3": (lambda d: InceptionV3(num_classes=1001, dtype=d), 299),
        "xception": (lambda d: Xception(num_classes=1000, middle_blocks=8, dtype=d), 299),
        "inception_resnet_v2": (lambda d: InceptionResnetV2(num_classes=1001, blocks35=10, blocks17=20, blocks8=9,
                                                            dtype=d), 299),
        "vgg16_classifier": (lambda d: VGG16Classifier(num_classes=1000, variant="reduced", dtype=d), 224),
    }


def zoo_state(name, model):
    """The network's weights as a float32 state_dict: Inception-V3 through the
    torchvision importer from a torchvision-layout state_dict (so the
    importer's names are read on the card host), the others drawn under
    their flax names (He-scaled kernels, BN means N(0, 0.5), variances
    U(0.5, 1.5): a mean/variance swap shows)."""
    if name == "inception_v3":
        sd = torchvision_inception_v3_state_dict(ZOO_SEED, num_classes=1001)
        variables = inception_v3_from_torch(sd)
        state = from_jax_params(flatten_params(variables["params"]), flatten_params(variables["batch_stats"]))
        for ours, theirs in (("mixed_5b.b0_1x1.conv.conv.weight", "Mixed_5b.branch1x1.conv.weight"),
                             ("mixed_7c.b2_3x1.conv.bn.running_var", "Mixed_7c.branch3x3dbl_3b.bn.running_var"),
                             ("logits.weight", "fc.weight")):
            if not torch.equal(state[ours], sd[theirs]):
                raise AssertionError(f"inception_v3_from_torch: {ours} is not torchvision's {theirs}")
        return state
    params, stats = seeded_flax_params(model, ZOO_SEED, gain=float(np.sqrt(2.0)), bn_mean_std=0.5)
    return from_jax_params(params, stats)


def rel_err(got, ref):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def zoo_net(name, make, side, images, smi):
    """One network through (a)-(d) of phase "zoo"."""
    res = {"side": side}
    cpu = make(torch.float32)
    cpu.load_state_dict(zoo_state(name, cpu), strict=True)
    state = cpu.state_dict()
    card = make(torch.float32).cuda().eval()
    card.load_state_dict(state, strict=True)
    x = images[name]
    # (a) f32 at batch 2: logits and every endpoint against the CPU's
    with torch.no_grad():
        want, want_eps = cpu(x[:ZOO_F32_BATCH])
        got, got_eps = card(x[:ZOO_F32_BATCH].cuda())
    errs = {"logits": rel_err(got, want), **{k: rel_err(got_eps[k], v) for k, v in want_eps.items()}}
    res["f32_card_vs_cpu"] = errs
    worst_out = max(errs, key=errs.get)
    if errs[worst_out] > ZOO_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"{name} f32 card vs CPU: {worst_out} {errs[worst_out]:.3g} > {ZOO_TOL}")
    # (c) bf16 at batch 32 against the f32 forward of the same images, then its rate
    bf16 = make(torch.bfloat16).cuda().eval()
    bf16.load_state_dict(state, strict=True)
    xb = x[:ZOO_BF16_BATCH].cuda()
    with torch.inference_mode():
        f32_logits, _ = card(xb)
        b_logits, _ = bf16(xb)
        ms = cuda_ms(lambda: bf16(xb), reps=5, warmup=2)
        f32_ms = cuda_ms(lambda: card(xb), reps=2, warmup=1)
        busy = device_busy_ms(lambda: bf16(xb))
    top1 = float((b_logits.argmax(-1) == f32_logits.argmax(-1)).float().mean())
    res["bf16"] = {"batch": ZOO_BF16_BATCH, "top1_agreement_with_f32": top1,
                   "max_logit_gap_rel": rel_err(b_logits, f32_logits), "ms": ms,
                   "img_per_s": ZOO_BF16_BATCH * 1e3 / ms, "device_ms": busy, "device_busy_share": busy / ms,
                   "f32_ms": f32_ms, "f32_img_per_s": ZOO_BF16_BATCH * 1e3 / f32_ms}
    # (d) one train-mode forward at batch 8: the updated running statistics
    if any(isinstance(m, BatchNorm) for m in cpu.modules()):
        before = {k: v.clone() for k, v in cpu.named_buffers()}
        with torch.no_grad():
            cpu(x[:ZOO_TRAIN_BATCH], train=True)
            card(x[:ZOO_TRAIN_BATCH].cuda(), train=True)
        card_bufs = dict(card.named_buffers())
        stat_err = {k: rel_err(card_bufs[k], v) for k, v in cpu.named_buffers()}
        update_err = {k: rel_err(card_bufs[k] - before[k].cuda(), v - before[k]) for k, v in cpu.named_buffers()}
        worst = max(stat_err, key=stat_err.get)
        res["train_stats"] = {"count": len(stat_err), "worst": worst, "worst_rel": stat_err[worst],
                              "worst_update_rel": max(update_err.values())}
        if stat_err[worst] > ZOO_TOL:
            raise AssertionError(f"{name} train-mode statistics card vs CPU: {worst} {stat_err[worst]:.3g}")
        train_msg = (f"(d) train-mode forward b{ZOO_TRAIN_BATCH}: {len(stat_err)} running statistics within "
                     f"{stat_err[worst]:.3g} of the CPU's (worst {worst}; their updates within "
                     f"{res['train_stats']['worst_update_rel']:.3g})")
    else:
        train_msg = "(d) no BatchNorm: train mode is eval mode"
    b = res["bf16"]
    print(f"  {name} at {side}x{side}: (a) f32 b{ZOO_F32_BATCH} card vs CPU, worst {worst_out} "
          f"{errs[worst_out]:.3g} (logits {errs['logits']:.3g}); (c) bf16 b{ZOO_BF16_BATCH} {ms:.3f} ms, "
          f"{b['img_per_s']:.1f} img/s, device busy {b['device_busy_share']:.3f} ({busy:.3f} ms of kernels); f32 "
          f"{f32_ms:.3f} ms; bf16 top-1 agrees with f32 on {top1:.3f}, largest logit gap {b['max_logit_gap_rel']:.3g} "
          f"of the largest f32 logit; {train_msg} ({smi})")
    del cpu, card
    return res, bf16


def zoo_phase(tmp, smi):
    """Phase "zoo": Inception-V3, Xception, Inception-ResNet-V2 at 299x299 and
    VGG16Classifier at 224x224 on seeded images in [-1, 1]: (a) f32 card vs
    CPU, (b) Inception-V3 through its torchvision importer, (c) bf16 rate,
    (d) train-mode statistics, (e) no port kernel launched, (f) a
    profile_trace of two bf16 Inception-V3 forwards holds CUDA kernels."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(ZOO_SEED)
    res, iv3 = {}, None
    nets = zoo_networks()
    images = {name: torch.from_numpy(rng.uniform(-1.0, 1.0, (ZOO_BF16_BATCH, side, side, 3)).astype(np.float32))
              for name, (_, side) in nets.items()}
    for name, (make, side) in nets.items():
        res[name], bf16 = zoo_net(name, make, side, images, smi)
        if name == "inception_v3":
            iv3 = bf16
        else:
            del bf16
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts("zoo phase (no port kernel)", launches, ())
    res["launches"] = launches
    logdir = tmp / "zoo_trace"
    xb = images["inception_v3"].cuda()
    with torch.inference_mode(), profile_trace(str(logdir), device="cuda"):
        iv3(xb)
        iv3(xb)
        torch.cuda.synchronize()
    traces = list(logdir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile_trace wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    n_kernel = sum(e.get("cat") == "kernel" for e in events)
    if n_kernel == 0:
        raise AssertionError("profile_trace's trace holds no CUDA kernel event")
    res["profile_trace"] = {"events": len(events), "kernel_events": n_kernel, "bytes": traces[0].stat().st_size}
    print(f"  (e) launches of the port's kernels over the phase: {launches}; (f) profile_trace of two bf16 "
          f"Inception-V3 forwards at batch {ZOO_BF16_BATCH}: {n_kernel} CUDA kernel events of {len(events)} in "
          f"{traces[0].name}")
    return res


def cli_infer_phase(model_dir, tmp, smi):
    """Phase "cli infer": `cli infer` on the eight JPEGs of voc_mini, f32
    RON-320 with the trained weights at batch 1: K-C launched once an image
    (K-A and K-B not), eight pictures written, the detections bit-equal to
    `RealtimeDetector` called directly on the same decoded, resized and
    whitened images, and within phase 25's 2e-3 of the same CLI on the CPU."""
    paths = sorted(str(p) for p in (VOC_MINI / "VOC2007" / "JPEGImages").glob("*.jpg"))
    runs = {}

    def run(device, out_dir):
        results, seconds = [], []
        real = cli_infer_images

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(real(*a, **k))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return results[-1]

        t0 = time.perf_counter()
        with mock.patch("ron_tensorflow_tpu_torch.cli.infer_images", timed):
            _, printed = quietly(lambda: cli_main(["--device", device, "infer", "--model-dir", model_dir,
                                                   "--output-dir", str(out_dir), *paths]))
        return results[0], printed, time.perf_counter() - t0, seconds[0]

    kernels.reset_launch_counts()
    got, printed, cmd_s, infer_s = run(CARD, tmp / "infer_out")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts("CLI infer (f32, batch 1)", launches, ("nms_scan_keep_mask",))
    if launches["nms_scan_keep_mask"] != len(paths):
        raise AssertionError(f"K-C launched {launches['nms_scan_keep_mask']} times for {len(paths)} images")
    pictures = sorted((tmp / "infer_out").glob("*.jpg"))
    if len(got) != len(paths) or len(pictures) != len(paths) or len(printed) != len(paths):
        raise AssertionError(f"infer: {len(got)} results, {len(pictures)} pictures, {len(printed)} lines")
    for line, (path, scores, _, _, out) in zip(printed, got):
        if line != f"{path}: {len(scores)} detections -> {out}":
            raise AssertionError(f"infer printed {line!r}")
    # the same images through RealtimeDetector directly, in this process
    model, spec = get_network("ron_320_vgg")
    restore_for_eval(model, model_dir)
    det = RealtimeDetector(model, spec, RealtimeConfig.for_spec(spec, objectness_threshold=0.95), device=CARD)
    for path, scores, labels, boxes, _ in got:
        raw = decode.decode_jpeg_raw(Path(path).read_bytes())
        img = whiten(torch.from_numpy(tf1_bilinear_resize(raw, spec.img_shape) / 255.0).cuda())[None]
        s, lab, b, v = (t[0].cpu().numpy() for t in det(img))
        if not (np.array_equal(s[v], scores) and np.array_equal(lab[v], labels) and np.array_equal(b[v], boxes)):
            raise AssertionError(f"infer's detections on {path} differ from RealtimeDetector's")
    warm_s = []
    for _ in range(2):  # warm runs of the same function the CLI calls, with the direct detector
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_infer_images(det, paths, str(tmp / "infer_warm"))
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    del model, det
    cpu, _, _, _ = run("cpu", tmp / "infer_cpu")
    worst = 0.0
    for (path, s, lab, b, _), (_, cs, clab, cb, _) in zip(got, cpu):
        if len(s) != len(cs) or not np.array_equal(lab, clab):
            raise AssertionError(f"infer on {path}: card {len(s)} detections {lab}, CPU {len(cs)} {clab}")
        if len(s):
            worst = max(worst, float(np.abs(s - cs).max()), float(np.abs(b - cb).max()))
    if worst > PARITY_ATOL:
        raise AssertionError(f"infer card vs CPU: {worst:.3g} > {PARITY_ATOL}")
    n = len(paths)
    res = {"images": n, "detections": [len(r[1]) for r in got], "launches": launches,
           "card_vs_cpu_max_abs": worst, "command_s": cmd_s, "ms_per_image_cold": infer_s * 1e3 / n,
           "ms_per_image_warm": [x * 1e3 / n for x in warm_s]}
    print(f"  cli infer over {n} JPEGs (f32 RON-320, trained weights): detections {res['detections']}, K-C "
          f"{launches['nms_scan_keep_mask']} launches, K-A and K-B none; {n} pictures; equal bit for bit to "
          f"RealtimeDetector called directly; within {worst:.3g} of the CLI on the CPU; command {cmd_s:.2f} s, "
          f"{res['ms_per_image_cold']:.2f} ms an image in the CLI (first run), warm "
          + ", ".join(f"{x:.2f}" for x in res["ms_per_image_warm"]) + f" ms an image ({smi})")
    return res


# the verify recipe at full width and the default batch of 32, cut from its 2500 steps to 1000 (the schedule's
# boundaries scale with the steps; held-out mAP07 0.95 at 2500 and at 1500): its host-bound steps took 90-188 ms
# on the card's host from one run to the next, which put the whole script at 985-1150 s of its 1200
LEARN_RECIPE = {"SYNTH_MODEL": "ron_320_vgg", "SYNTH_CANVAS": "400", "SYNTH_BF16": "true", "SYNTH_STEPS": "1000",
                "SYNTH_FUSE_BLOCK1": "true"}
SUPERVISED_STEPS = 3
SUPERVISOR = REPO / "ron_tensorflow_tpu_torch" / "tools" / "train_supervised.py"
SUPERVISED_TIMEOUT = 900  # s for the supervised run, its four launches and probes included
# each step's loss, supervised against one uninterrupted run: two processes whose cuDNN backward
# need not agree in the last bits, which bf16 steps carry into the next loss (three processes gave
# equal losses bit for bit on the H100); the record keys are held exactly
LEARN_LOSS_RTOL = 1e-4
NAN_WEIGHT = "backbone.conv4_1.conv.weight"  # the weight that --debug-nans' run sets to NaN


def learn_overfit(smi):
    """Phase "learn" (a): the overfit check on the card."""
    kernels.reset_launch_counts()
    res, printed = quietly(lambda: overfit_check.run(CARD))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts("overfit check (RON-tiny f32 training, then the Detector)", launches, ("nms_fixpoint_keep_mask",))
    if not res["passed"] or res["map"] < overfit_check.PASS_MAP:
        raise AssertionError(f"overfit check: mAP {res['map']:.4f} < {overfit_check.PASS_MAP}\n" + "\n".join(printed))
    print(f"  (a) overfit check, RON-tiny f32, {res['steps']} steps: mAP07 over the classes with gts "
          f"{res['map']:.4f} (APs {({c: round(v, 4) for c, v in res['aps'].items()})}; all 20 classes "
          f"{res['map_all_classes']:.4f}); loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}; training "
          f"{res['train_s']:.2f} s, {res['seconds']:.2f} s in all; K-A {launches['nms_fixpoint_keep_mask']} "
          f"launch(es) ({smi})")
    return {**{k: v for k, v in res.items() if k != "losses"}, "loss_first": res["losses"][0],
            "loss_last": res["losses"][-1], "launches": launches}


def learn_synthetic(tmp, smi):
    """Phase "learn" (b): the synthetic check at full width. Returns its
    numbers and the records' directory."""
    s = synthetic_e2e.settings(LEARN_RECIPE)
    steps, work = int(s["STEPS"]), tmp / "synthetic"
    t0 = time.perf_counter()
    data_dir = make_dataset(str(work / "records"), canvas=int(s["CANVAS"]))
    data_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, printed = quietly(lambda: synthetic_e2e.train(s, data_dir, str(work), CARD))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = kernels.launch_counts()
    check_counts(f"synthetic training (RON-320 bf16, fuse_block1, batch {s['BATCH']})", train_launches,
                 ("fused_vgg_block1",))
    rows = [json.loads(line) for line in open(work / "model" / "metrics.jsonl")]
    losses = [r["loss/total"] for r in rows]
    if (train_launches["fused_vgg_block1"] != steps or not rows or rows[-1]["step"] != steps
            or not np.isfinite(losses).all()):
        raise AssertionError(f"synthetic training: K-B {train_launches['fused_vgg_block1']} for {steps} steps, "
                             f"logged steps {[r['step'] for r in rows]}, losses {losses}")
    weights = trainer.model.state_dict()
    del trainer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = synthetic_e2e.evaluate(s, weights, data_dir, CARD)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = kernels.launch_counts()
    check_counts("held-out evaluation (bf16, fused block 1)", eval_launches, MAIN_PATH)
    n_batches = -(-96 // 8)  # the held-out split's 96 images, 8 a batch
    if eval_launches["fused_vgg_block1"] != n_batches or eval_launches["nms_fixpoint_keep_mask"] != n_batches:
        raise AssertionError(f"held-out evaluation: {eval_launches} for {n_batches} batches")
    if res["map"] < synthetic_e2e.PASS_MAP:
        raise AssertionError(f"synthetic check: held-out mAP07 over classes 1-6 {res['map']:.4f} < "
                             f"{synthetic_e2e.PASS_MAP}; APs {res['aps']}; losses every 100 steps {losses}")
    print(f"  (b) synthetic check, {s['MODEL']} canvas {s['CANVAS']} bf16 fuse_block1, {steps} steps at batch "
          f"{s['BATCH']}: held-out mAP07 over classes 1-6 {res['map']:.4f} (APs "
          f"{({c: round(v, 4) for c, v in res['aps'].items()})}; all 21 classes {res['map07_all_classes']:.4f}, "
          f"mAP12 {res['map12_all_classes']:.4f}); loss {losses[0]:.4f} (step {rows[0]['step']}) -> "
          f"{losses[-1]:.4f}; data {data_s:.2f} s, training {train_s:.2f} s ({train_s * 1e3 / steps:.2f} ms a "
          f"step), evaluation {eval_s:.2f} s; K-B {train_launches['fused_vgg_block1']} launches in training, "
          f"{eval_launches['fused_vgg_block1']} in eval; K-A {eval_launches['nms_fixpoint_keep_mask']} in eval "
          f"({smi})")
    res = {**res, "steps": steps, "batch": int(s["BATCH"]), "losses_logged": losses, "data_s": data_s,
           "train_s": train_s, "eval_s": eval_s, "train_launches": train_launches, "eval_launches": eval_launches}
    return res, Path(data_dir)


def cli_train_argv(model_dir, records, *extra):
    return ["--device", CARD, "train", "--preset", "ron_320", "--model-dir", str(model_dir), "--dataset-dir",
            str(records), "data.file_pattern=synth_train_*.tfrecord", "data.use_grain=true", "fuse_block1=true",
            f"max_steps={SUPERVISED_STEPS}", "log_every_steps=1", "tensorboard=false", *extra]


def run_logged(cmd, timeout):
    """A subprocess from the repo's root with the package importable ->
    (exit code, its output)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def step_log(model_dir):
    """{step: (loss, record keys)} of a CLI run's model dir."""
    losses = {r["step"]: r["loss/total"] for r in map(json.loads, open(model_dir / "metrics.jsonl"))}
    keys = {r["step"]: r["record_keys"] for r in map(json.loads, open(model_dir / "input_keys.jsonl"))}
    return {k: (losses[k], keys[k]) for k in sorted(keys)}


def learn_supervised(records, tmp, smi):
    """Phase "learn" (c): the supervisor over the CLI's train with the
    host-RSS guard at 1e-6 GB, against one uninterrupted run."""
    sup_dir, ref_dir = tmp / "supervised", tmp / "uninterrupted"
    cli = [sys.executable, "-m", "ron_tensorflow_tpu_torch.cli"]
    t0 = time.perf_counter()
    rc, out = run_logged([sys.executable, str(SUPERVISOR), "--probe-interval", "1", "--",
                          *cli, *cli_train_argv(sup_dir, records, "max_host_rss_gb=1e-6")], SUPERVISED_TIMEOUT)
    sup_s = time.perf_counter() - t0
    launches = out.count("[supervisor] launch #")
    tempfails = out.count("EX_TEMPFAIL after")
    steps = CheckpointManager(str(sup_dir)).all_steps()
    if rc != 0 or launches != SUPERVISED_STEPS + 1 or tempfails != SUPERVISED_STEPS or "run completed" not in out:
        raise AssertionError(f"supervised CLI train: exit {rc}, {launches} launches, {tempfails} exits 75\n"
                             + out[-6000:])
    if list(steps) != list(range(1, SUPERVISED_STEPS + 1)):
        raise AssertionError(f"supervised CLI train: checkpoints at steps {steps}")
    t0 = time.perf_counter()
    rc, ref_out = run_logged([*cli, *cli_train_argv(ref_dir, records)], SUPERVISED_TIMEOUT)
    ref_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"uninterrupted CLI train: exit {rc}\n" + ref_out[-6000:])
    got, ref = step_log(sup_dir), step_log(ref_dir)
    if list(got) != list(ref) or list(ref) != list(range(1, SUPERVISED_STEPS + 1)):
        raise AssertionError(f"logged steps: supervised {list(got)}, uninterrupted {list(ref)}")
    rel = [abs(got[k][0] - ref[k][0]) / abs(ref[k][0]) for k in ref]
    keys_equal = all(got[k][1] == ref[k][1] for k in ref)
    if not keys_equal or max(rel) > LEARN_LOSS_RTOL or not np.isfinite([g[0] for g in got.values()]).all():
        raise AssertionError(f"supervised against uninterrupted: record keys equal {keys_equal}; losses "
                             f"{[g[0] for g in got.values()]} against {[r[0] for r in ref.values()]} "
                             f"(relative {rel}, tolerance {LEARN_LOSS_RTOL})")
    print(f"  (c) supervisor over `cli train --preset ron_320` (bf16, K-B, Grain input, batch "
          f"{len(ref[1][1])}) with max_host_rss_gb=1e-6: {launches} launches (exit 75 x{tempfails}, then 0), "
          f"exit 0, checkpoints at steps {steps}, in {sup_s:.2f} s; the uninterrupted run in {ref_s:.2f} s; each "
          f"step's record keys equal, losses {[round(g[0], 6) for g in got.values()]} against "
          f"{[round(r[0], 6) for r in ref.values()]} (relative {max(rel):.3g}, tolerance {LEARN_LOSS_RTOL}) ({smi})")
    shutil.rmtree(sup_dir)
    shutil.rmtree(ref_dir)
    return {"launches": launches, "exits_75": tempfails, "checkpoint_steps": list(steps), "supervised_s": sup_s,
            "uninterrupted_s": ref_s, "losses": [g[0] for g in got.values()],
            "uninterrupted_losses": [r[0] for r in ref.values()], "loss_rel_max": max(rel),
            "record_keys": [g[1] for g in got.values()]}


def nan_model_dir(model_dir):
    """A step-0 checkpoint of the ron_320 preset's model, seeded, with
    NAN_WEIGHT set to NaN."""
    cfg = TrainConfig()
    model, _ = get_network(cfg.model)
    with torch.no_grad():
        model.get_parameter(NAN_WEIGHT).fill_(float("nan"))
    CheckpointManager(str(model_dir), cfg.max_to_keep).save(0, create_train_state(model, make_optimizer(
        cfg.optimizer, model)))


def learn_debug_nans(records, tmp, smi):
    """Phase "learn" (d): `--debug-nans` on a NaN weight, and without it."""
    module = NAN_WEIGHT.rsplit(".", 2)[0]  # the Conv that computes with the weight
    caught = {}
    for flag in (True, False):
        model_dir = tmp / f"nan_{flag}"
        nan_model_dir(model_dir)
        argv = (["--debug-nans"] if flag else []) + cli_train_argv(model_dir, records)
        try:
            quietly(lambda: cli_main(argv))
        except FloatingPointError as e:
            caught[flag] = str(e)
        else:
            raise AssertionError(f"cli train {'with' if flag else 'without'} --debug-nans ran through a NaN weight")
        if torch.is_anomaly_enabled():
            raise AssertionError("--debug-nans left anomaly detection on")
        shutil.rmtree(model_dir)
    if f"{module!r}" not in caught[True]:
        raise AssertionError(f"--debug-nans raised {caught[True]!r}, which does not name {module!r}")
    if not caught[False].startswith("non-finite loss at step 1"):
        raise AssertionError(f"without --debug-nans: {caught[False]!r}, not the trainer's finite check")
    print(f"  (d) `cli --debug-nans train` with {NAN_WEIGHT} NaN: FloatingPointError({caught[True]!r}); "
          f"without the flag: FloatingPointError({caught[False]!r}) ({smi})")
    return {"with_flag": caught[True], "without_flag": caught[False]}


def learn_phase(tmp, smi):
    """Phase "learn": (a) to (d) above."""
    res = {"overfit": learn_overfit(smi)}
    res["synthetic"], records = learn_synthetic(tmp, smi)
    res["supervised"] = learn_supervised(records, tmp, smi)
    res["debug_nans"] = learn_debug_nans(records, tmp, smi)
    return res


BENCH_PATH = ("nms_fixpoint_keep_mask", "fused_vgg_block1", "nms_scan_keep_mask")
BENCH_SHARED_TOP_K = 1000  # the JAX bench.py's fast-knobs condition


def bench_cli(smi):
    """Phase "bench" (a): `cli bench` in this process, its standard output
    captured, launch counts read around it."""
    kernels.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_main(["bench"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    lines = out.getvalue().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"cli bench printed {len(lines)} lines, not one: {lines[:3]}")
    print(f"  cli bench in {seconds:.2f} s on {smi}: {lines[0]}")
    record = json.loads(lines[0])
    keys = bench_mod.record_keys()
    if list(record) != keys:
        raise AssertionError(f"bench keys {list(record)} are not the JAX record's but its baseline's {keys}")
    if any(v is None for v in record.values()):
        raise AssertionError(f"null bench values: {[k for k, v in record.items() if v is None]}")
    bad = [x for x in bench_mod.record_numbers(list(record.values())) if not (np.isfinite(x) and x > 0)]
    if bad:
        raise AssertionError(f"bench numbers not finite and > 0: {bad}")
    if len(record["inference_runs_images_per_sec"]) != 2 or len(record["train_bs32_runs"]) != 2:
        raise AssertionError("bench: two inference runs and two batch-32 train runs expected")
    check_counts("bench", launches, BENCH_PATH)
    return {"record": record, "launches": launches, "seconds": seconds}


def bench_shared_top_k(state, images):
    """Phase "bench" (b): the f32 trained RON-320 through a Detector with
    the bench's preselection on the card (K-A) against the same on the CPU
    (K-A's plain version): keep counts equal, scores and boxes within
    PARITY_ATOL."""
    cfg = dataclasses.replace(NMS_CFG, shared_top_k=BENCH_SHARED_TOP_K)
    dets = {}
    for device in ("cuda", "cpu"):
        model = RON(RON_320_SPEC, dtype=torch.float32)
        model.load_state_dict(state, strict=True)
        kernels.reset_launch_counts()
        dets[device] = Detector(model, RON_320_SPEC, cfg, device=device)(images.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            check_counts(f"f32 Detector, shared_top_k={BENCH_SHARED_TOP_K}", kernels.launch_counts(),
                         ("nms_fixpoint_keep_mask",))
    n, worst = compare_dets(f"shared_top_k={BENCH_SHARED_TOP_K}, card (K-A) vs CPU (plain)", dets["cuda"],
                            dets["cpu"], tol=PARITY_ATOL)
    return {"detections": n, "max_abs_diff": worst}


IMAGE_FORMATS = REPO / "tests" / "fixtures" / "image_formats"
IMAGES_TIMEOUT = 300  # seconds for the images process
WIDE_TOP_K = 21250  # RON-320's anchors: the Detector's and the realtime head's rows of every anchor
# the realtime head on those rows with no score or objectness threshold (every anchor whose argmax
# is an object class valid) and up to 200 kept
RT_WIDE = RealtimeConfig(top_k=WIDE_TOP_K, select_threshold=0.0, objectness_threshold=0.0, keep_top_k=200)
IMAGES_TRAIN_STEPS = 2


def images_decode(digests):
    """Phase "images" (a): each fixture PNG and progressive JPEG through the
    port's decoders, route "cv2" (the pipeline's, the realtime evaluator's)
    and route "pil" (`infer`'s), against the stored digests of cv2's and
    PIL's decodes."""
    parted = []
    for name, want_pil, want_cv2 in zip(digests["names"], digests["pil"], digests["cv2"]):
        data = (IMAGE_FORMATS / name).read_bytes()
        got = {route: decode.decode_image(data, route) for route in ("cv2", "pil")}
        if tuple(hashlib.sha256(got[r].tobytes()).hexdigest() for r in ("cv2", "pil")) != (want_cv2, want_pil):
            raise AssertionError(f"{name}: the port's decodes differ from the stored cv2/PIL digests")
        if want_cv2 != want_pil:
            parted.append(str(name))
    print(f"  {len(digests['names'])} fixture images (PNG of every colour type and depth, Adam7, palette + tRNS; "
          f"progressive JPEG 4:2:0, 4:4:4, gray, restart markers, odd size) equal to cv2's and PIL's decodes by "
          f"digest, route by route; the routes part on {parted}", flush=True)
    if parted != ["gray16.png"]:
        raise AssertionError(f"the cv2 and PIL routes part on {parted}, expected the 16-bit gray PNG only")
    return {"files": len(digests["names"]), "routes_part_on": parted}


def images_infer(model_dir, digests, tmp):
    """Phase "images" (b): `cli infer`, f32 RON-320 with the trained weights,
    on two fixture PNGs and two progressive JPEGs: K-C once an image and no
    other kernel, four pictures that the port's decoder reads back, the
    detections bit-equal to RealtimeDetector called directly on the same
    decoded (PIL's route), resized and whitened images."""
    paths = [str(IMAGE_FORMATS / n) for n in list(digests["infer_pngs"]) + list(digests["infer_jpegs"])]
    results, out_dir = [], tmp / "infer_formats"
    real = cli_infer_images
    kernels.reset_launch_counts()
    with mock.patch("ron_tensorflow_tpu_torch.cli.infer_images", lambda *a, **k: results.append(real(*a, **k))
                    or results[-1]):
        _, printed = quietly(lambda: cli_main(["--device", CARD, "infer", "--model-dir", model_dir, "--output-dir",
                                               str(out_dir), *paths]))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_counts("CLI infer on PNG and progressive JPEG", launches, ("nms_scan_keep_mask",))
    if launches["nms_scan_keep_mask"] != len(paths):
        raise AssertionError(f"K-C launched {launches['nms_scan_keep_mask']} times for {len(paths)} images")
    got = results[0]
    pictures = sorted(out_dir.glob("*.jpg"))
    if len(got) != len(paths) or len(pictures) != len(paths) or len(printed) != len(paths):
        raise AssertionError(f"infer: {len(got)} results, {len(pictures)} pictures, {len(printed)} lines")
    for pic in pictures:
        if decode.decode_image(pic.read_bytes()).shape != (*RON_320_SPEC.img_shape, 3):
            raise AssertionError(f"{pic}: not a {RON_320_SPEC.img_shape} picture")
    model, spec = get_network("ron_320_vgg")
    restore_for_eval(model, model_dir)
    det = RealtimeDetector(model, spec, RealtimeConfig.for_spec(spec, objectness_threshold=0.95), device=CARD)
    for path, scores, labels, boxes, _ in got:
        raw = decode.decode_image(Path(path).read_bytes(), "pil")
        img = whiten(torch.from_numpy(tf1_bilinear_resize(raw, spec.img_shape) / 255.0).to(CARD))[None]
        sc, lab, b, v = (t[0].cpu().numpy() for t in det(img))
        if not (np.array_equal(sc[v], scores) and np.array_equal(lab[v], labels) and np.array_equal(b[v], boxes)):
            raise AssertionError(f"infer's detections on {path} differ from RealtimeDetector's")
    counts = [len(r[1]) for r in got]
    print(f"  cli infer on {[Path(p).name for p in paths]}: detections {counts}, K-C {launches['nms_scan_keep_mask']} "
          f"launches and no other kernel, {len(pictures)} pictures read back, equal bit for bit to RealtimeDetector "
          "called directly", flush=True)
    return {"launches": launches, "detections": counts}


def wide_detector_rows(images):
    """Phase "images" (c): the f32 RON-320 Detector (trained weights) at batch
    2 with top_k = 21250, every anchor, and the realtime head with the same
    top_k: K-A launched once on [40, 21250] rows, K-C once on [2, 21250],
    counted around each call, no other kernel; each mask bit-equal to its
    plain version on the same rows (K-A's a row at a time), and the call's
    peak memory far below one [R, K, K] tensor (R K^2 bytes)."""
    model, spec = get_network("ron_320_vgg")
    model.load_state_dict(from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE))), strict=True)
    batch = images[:2].contiguous()
    out = {}
    for name, det, kernel in (
        ("Detector", Detector(model, spec, dataclasses.replace(NMS_CFG, top_k=WIDE_TOP_K), device=CARD),
         "nms_fixpoint_keep_mask"),
        ("realtime head", RealtimeDetector(model, spec, RT_WIDE, device=CARD), "nms_scan_keep_mask"),
    ):
        with torch.inference_mode():
            net_out = det.model(batch)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            dets = det.postprocess(net_out)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
            check_counts(f"{name}, top_k {WIDE_TOP_K}", launches, (kernel,))
            if launches[kernel] != 1:
                raise AssertionError(f"{name}: {kernel} launched {launches[kernel]} times")
            rows = det.candidates(net_out)
            if kernel == "nms_fixpoint_keep_mask":
                scores, boxes = rows[0].contiguous(), rows[1].contiguous()
                cfg = det.config
                keep = kernels.nms_fixpoint_keep_mask(scores, boxes, cfg.nms_threshold, cfg.nms_mode)
                ref = kernels.nms_fixpoint_keep_mask_plain(scores, boxes, cfg.nms_threshold, cfg.nms_mode)
                want = compact_keep(ref, scores, boxes, cfg.keep_top_k)
                got = [t.reshape(-1, cfg.keep_top_k, *t.shape[3:]) for t in dets]
            else:
                scores, boxes = rows[3].to(torch.float32), rows[2].contiguous()
                cfg = det.config
                keep = kernels.nms_scan_keep_mask(scores, boxes, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)
                ref = kernels.nms_scan_keep_mask_plain(scores, boxes, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)
                want = kernels_nms.compact_keep_labelled(ref, rows[0], rows[1], rows[2], cfg.keep_top_k)
                got = dets
        r, k = scores.shape
        _, n_diff = mask_err(keep, ref)
        if (r, k) != ((2 * (spec.num_classes - 1), WIDE_TOP_K) if kernel == "nms_fixpoint_keep_mask" else
                      (2, WIDE_TOP_K)):
            raise AssertionError(f"{name}: NMS rows {(r, k)}")
        if n_diff or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} with top_k {WIDE_TOP_K}: {n_diff} mask differences, or detections that "
                                 "differ from the plain version's")
        if peak >= r * k * k:
            raise AssertionError(f"{name}: {peak} bytes at peak, an [R, K, K] tensor's worth")
        cap = None if kernel == "nms_fixpoint_keep_mask" else cfg.keep_top_k
        timing = wide_nms_timing(scores, boxes, cfg.nms_threshold, cfg.nms_mode, cap, keep)
        out[name] = {"rows": [r, k], "launches": launches, "kept_mean": float(keep.sum(-1).float().mean()),
                     "valid": int((scores > 0).sum()), "peak_bytes": peak, "timing": timing}
        print(f"  {name} f32 batch 2, top_k {WIDE_TOP_K}: {kernel} once on [{r},{k}] rows "
              f"({out[name]['valid']} candidates > 0), mask bit-equal to the plain version, detections equal; "
              f"kept per row {out[name]['kept_mean']:.2f}; postprocess peak {peak / 2 ** 20:.1f} MiB "
              f"(one [R, K, K] bool tensor: {r * k * k / 2 ** 30:.1f} GiB); {timing['ms']:.4f} ms device a launch, "
              f"bound {timing['bound_ms']:.4g} ms by {timing['bound_by']} ({timing['pairs']} overlaps needed), steps "
              f"max {max(timing['steps'])} (tiles holding a kept box: max {max(timing['tiles_holding_kept'])}), "
              f"cluster of {timing['cluster_ctas']} CTAs", flush=True)
        del keep, ref
        torch.cuda.empty_cache()
    return out


def images_trainer(fx, tmp):
    """Phase "images" (d): two Trainer steps with dump_debug_images_every=1
    and TensorBoard on: a debug JPEG each step and a TensorBoard image each
    step, which the port's own readers decode (the JPEG within 8 levels of
    the PNG on average: both are the drawn picture)."""
    cfg = dataclasses.replace(TRAIN_CFG, model_dir=str(tmp / "images_trainer"), max_steps=IMAGES_TRAIN_STEPS,
                              dump_debug_images_every=1, tensorboard=True,
                              data=dataclasses.replace(TRAIN_CFG.data, batch_size=F32_STEP_BATCH))
    trainer, _ = quietly(lambda: Trainer(cfg, device=CARD))
    host = train_host_batch(fx, F32_STEP_BATCH)
    state, _ = quietly(lambda: trainer.train(batches=iter([host] * IMAGES_TRAIN_STEPS)))
    debug = sorted((Path(cfg.model_dir) / "debug").glob("step_*.jpg"))
    (events_file,) = Path(cfg.model_dir).glob("events.out.tfevents.*")
    pngs = [im for e in read_events(str(events_file)) for im in e["images"].values()]
    if state.step != IMAGES_TRAIN_STEPS or len(debug) != IMAGES_TRAIN_STEPS or len(pngs) != IMAGES_TRAIN_STEPS:
        raise AssertionError(f"trainer: step {state.step}, {len(debug)} debug JPEGs, {len(pngs)} TensorBoard images")
    diffs = []
    for jpg, (h, w, png) in zip(debug, pngs):
        a, b = decode.decode_image(jpg.read_bytes()), decode.decode_image(png)
        if a.shape != b.shape or b.shape != (h, w, 3):
            raise AssertionError(f"{jpg.name}: {a.shape} against the TensorBoard image's {b.shape}, ({h}, {w})")
        diffs.append(float(np.abs(a.astype(np.float64) - b).mean()))
    if max(diffs) > 8:
        raise AssertionError(f"debug JPEGs against TensorBoard PNGs: mean |diff| {diffs}")
    print(f"  Trainer, {IMAGES_TRAIN_STEPS} steps with dump_debug_images_every=1: {[p.name for p in debug]} and "
          f"{len(pngs)} TensorBoard images ({pngs[0][0]}x{pngs[0][1]}), decoded by the port; JPEG vs PNG mean "
          f"|diff| {diffs}", flush=True)
    return {"debug_jpegs": len(debug), "tensorboard_images": len(pngs), "jpeg_vs_png_mean_abs": diffs}


def images_main() -> int:
    """Phase "images" in a process of its own (`chip_smoke.py --images`),
    in which `import PIL` and `import cv2` fail: (a) decode, (b) `cli
    infer` on PNG and progressive JPEG, (c) the Detector and the realtime
    head on rows of every anchor, (d) the Trainer's pictures. Prints one
    JSON line last."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("PIL", "cv2"):
        try:
            __import__(name)
        except ImportError:
            continue
        raise AssertionError(f"{name} is importable in the images process")
    digests = np.load(IMAGE_FORMATS / "digests.npz", allow_pickle=False)
    fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        res["decode"] = images_decode(digests)
        model_dir = str(tmp / "model")
        seeded_model_dir(model_dir, from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE))))
        res["infer"] = images_infer(model_dir, digests, tmp)
        pixels = [torch.as_tensor(fx[f"img_{i}_pixels"], device=CARD) for i in IMAGES]
        images = torch.stack([eval_preprocess(p.float() / 255.0, RON_320_SPEC.img_shape)[0] for p in pixels])
        res["wide_rows"] = wide_detector_rows(images)
        res["trainer"] = images_trainer(fx, tmp)
        res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res))
    return 0


def images_phase(smi):
    """Phase "images": `images_main` in a child process; its lines shown,
    its JSON line returned."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--images"], capture_output=True,
                          text=True, timeout=IMAGES_TIMEOUT, cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    if proc.returncode != 0:
        raise AssertionError(f"the images process exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    res = json.loads(lines[-1])
    res["process_s"] = time.perf_counter() - t0
    print(f"  the images process (no PIL, no cv2) took {res['process_s']:.2f} s ({smi})")
    return res


# phase "rehearsal": the dress rehearsal's scale cut to the phase's budget
# (full width, the crowded generator, the recipe's batch 14), then the A/B
REHEARSAL_ENV = {"DR_MODEL": "ron_320_vgg", "DR_CROWDED": "1", "DR_TRAIN": "200", "DR_TEST": "64",
                 "DR_STEPS": "200", "DR_BATCH": "14"}
REHEARSAL_AB_MAX_BOXES = "56"  # the crowded sets' gt pad
REHEARSAL_BOX_TOL = 0.051  # px: the XML rounds to 0.1 px, the records hold float32
# variants that must give the same detections bit for bit: K-C on the same rows, K-A on the same rows
REHEARSAL_SAME = (("exact reference (no knobs)", "approx_top_k only", "fixpoint NMS"),
                  ("presel shared_top_k=1000", "presel + pallas NMS"))


def rehearsal_layouts(work):
    """Phase "rehearsal": the test records against the VOCdevkit tree, image
    by image in test.txt's order: the JPEG bytes, the size, labels and
    difficult flags equal, the boxes within REHEARSAL_BOX_TOL px."""
    voc = work / "VOCdevkit" / "VOC2007"
    ids = (voc / "ImageSets" / "Main" / "test.txt").read_text().split()
    records = [parse_voc_example(r) for f in sorted((work / "records").glob("synth_test_*.tfrecord"))
               for r in read_records(str(f))]
    if len(ids) != len(records) or ids != [f"{i:06d}" for i in range(len(ids))]:
        raise AssertionError(f"test.txt lists {len(ids)} ids, the test records hold {len(records)}")
    worst, n_objects, n_difficult = 0.0, 0, 0
    for image_id, rec in zip(ids, records):
        ann = parse_annotation(str(voc / "Annotations" / f"{image_id}.xml"))
        h, w = ann.shape[:2]
        if (voc / "JPEGImages" / f"{image_id}.jpg").read_bytes() != rec["jpeg"]:
            raise AssertionError(f"{image_id}: the JPEG differs between the records and the VOCdevkit tree")
        labels = [o.label for o in ann.objects]
        difficult = [o.difficult for o in ann.objects]
        if tuple(rec["shape"][:2]) != (h, w) or list(rec["labels"]) != labels or list(rec["difficult"]) != difficult:
            raise AssertionError(f"{image_id}: size, labels or difficult flags differ: records "
                                 f"{rec['shape']} {list(rec['labels'])} {list(rec['difficult'])}, XML "
                                 f"{(h, w)} {labels} {difficult}")
        scale = np.asarray([h, w, h, w], np.float64)
        xml_px = np.asarray([o.bbox for o in ann.objects], np.float64).reshape(-1, 4) * scale
        err = float(np.abs(xml_px - np.asarray(rec["boxes"], np.float64).reshape(-1, 4) * scale).max(initial=0.0))
        if err > REHEARSAL_BOX_TOL:
            raise AssertionError(f"{image_id}: boxes differ by {err:.4f} px between the records and the XML")
        worst, n_objects, n_difficult = max(worst, err), n_objects + len(labels), n_difficult + sum(difficult)
    return {"images": len(ids), "objects": n_objects, "difficult": n_difficult, "box_max_px": worst}


@contextlib.contextmanager
def rehearsal_probes(counts, digests):
    """Around every `Trainer.train`, `StreamingEvaluator.run` and
    `evaluate_voc` call: its launches and seconds (appended to
    counts[label]); and a digest of every `Detector.postprocess` output
    (scores and boxes, bit for bit) that a `StreamingEvaluator.run` makes,
    one digest a run."""
    runs = {"train": (Trainer, "train"), "streaming": (StreamingEvaluator, "run"),
            "realtime": (RealtimeEvaluator, "evaluate_voc")}
    originals = {label: getattr(cls, name) for label, (cls, name) in runs.items()}
    postprocess = Detector.postprocess

    def probe(label):
        def wrapper(*args, **kwargs):
            before, t0 = kernels.launch_counts(), time.perf_counter()
            if label == "streaming":
                digests.append(hashlib.sha256())
            out = originals[label](*args, **kwargs)
            torch.cuda.synchronize()
            counts[label].append({"launches": {k: n - before[k] for k, n in kernels.launch_counts().items()},
                                  "s": time.perf_counter() - t0})
            return out
        return wrapper

    def hashed(self, out):
        scores, boxes = postprocess(self, out)
        for t in (scores, boxes):
            digests[-1].update(t.float().cpu().numpy().tobytes())
        return scores, boxes

    with contextlib.ExitStack() as stack:
        for label, (cls, name) in runs.items():
            stack.enter_context(mock.patch.object(cls, name, probe(label)))
        stack.enter_context(mock.patch.object(Detector, "postprocess", hashed))
        yield


def rehearsal_phase(smi):
    """Phase "rehearsal": `tools/dress_rehearsal.py` at REHEARSAL_ENV's scale
    through its `main`, then `tools/ab_detection_config.py` on its work dir."""
    counts, digests = {"train": [], "streaming": [], "realtime": []}, []
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(os.environ, REHEARSAL_ENV):
        work = Path(tmp) / "rehearsal"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with rehearsal_probes(counts, digests):
            rc, printed = quietly(lambda: dress_rehearsal.main(["--device", CARD, str(work)]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        check_counts("dress rehearsal (training, streaming eval, realtime eval)", launches,
                     ("nms_fixpoint_keep_mask", "nms_scan_keep_mask"))
        result = json.loads((work / "result.json").read_text())
        if tuple(result) != dress_rehearsal.RESULT_KEYS or rc != (0 if json.loads(
                (work / "rehearsal.json").read_text())[0]["ok"] else 1):
            raise AssertionError(f"result.json keys {list(result)} (JAX's: {dress_rehearsal.RESULT_KEYS}), exit {rc}"
                                 "\n" + "\n".join(printed[-20:]))
        layouts = rehearsal_layouts(work)
        (train,), (stream,), (realtime,) = counts["train"], counts["streaming"], counts["realtime"]
        train_s, stream, realtime = train["s"], stream["launches"], realtime["launches"]
        if (any(train["launches"].values()) or stream["nms_fixpoint_keep_mask"] < 1
                or realtime["nms_scan_keep_mask"] < 1):
            raise AssertionError(f"launches: training {train['launches']} (none expected: K-B stays off), streaming "
                                 f"eval {stream} (K-A), realtime eval {realtime} (K-C)")
        t0 = time.perf_counter()
        with rehearsal_probes(counts, digests), mock.patch.dict(os.environ, {"AB_MAX_BOXES": REHEARSAL_AB_MAX_BOXES}):
            ab_out, ab_printed = quietly(lambda: ab_detection_config.main(["--device", CARD, str(work), "ron_320_vgg"]))
        torch.cuda.synchronize()
        ab_s = time.perf_counter() - t0
    names = list(ab_detection_config.VARIANTS)
    variant_launches = dict(zip(names, (c["launches"] for c in counts["streaming"][1:])))
    variant_digests = dict(zip(names, (d.hexdigest() for d in digests[1:])))
    if len(counts["streaming"]) != 1 + len(names):
        raise AssertionError(f"{len(counts['streaming']) - 1} A/B evaluator runs, {len(names)} variants")
    for name, launched in variant_launches.items():
        kernel = ("nms_scan_keep_mask" if ab_detection_config.VARIANTS[name].nms_method in ("loop", "fixpoint")
                  else "nms_fixpoint_keep_mask")
        if launched[kernel] < 1 or sum(launched.values()) != launched[kernel]:
            raise AssertionError(f"A/B variant {name!r}: launches {launched}, {kernel} only expected")
    for group in REHEARSAL_SAME:
        if len({variant_digests[n] for n in group}) != 1:
            raise AssertionError(f"A/B variants {group} differ: {[variant_digests[n][:12] for n in group]}")
    maps = {"map07_streaming": result["map07_streaming"], "map12_streaming": result["map12_streaming"],
            "map07_realtime": result["map07_realtime"], **ab_out["map07"]}
    if not all(np.isfinite(v) for v in maps.values()):
        raise AssertionError(f"non-finite mAP: {maps}")
    parting = ab_out["keep_set_parting"]
    env = REHEARSAL_ENV
    print(f"  dress rehearsal {env['DR_MODEL']} crowded, {env['DR_TRAIN']} + {env['DR_TEST']} images, "
          f"{result['steps']} steps at batch {env['DR_BATCH']} (bf16, seeded torch VGG warm start): mAP07 streaming "
          f"{result['map07_streaming']} (mAP12 {result['map12_streaming']}), realtime {result['map07_realtime']}, "
          f"delta {result['delta']}; {seconds:.2f} s (training {train_s:.2f} s), exit {rc}; records and VOCdevkit "
          f"agree on {layouts['images']} images, {layouts['objects']} objects ({layouts['difficult']} difficult), "
          f"boxes within {layouts['box_max_px']:.3f} px; K-A {stream['nms_fixpoint_keep_mask']} launches in the "
          f"streaming eval, K-C {realtime['nms_scan_keep_mask']} in the realtime eval ({smi})")
    print(f"  A/B ({ab_s:.2f} s): " + ", ".join(f"{n} {v:.4f}" for n, v in ab_out["map07"].items()))
    print(f"  A/B: {' = '.join(REHEARSAL_SAME[0])} (K-C) and {' = '.join(REHEARSAL_SAME[1])} (K-A) bit for "
          f"bit; K-A vs K-C keep sets part on {parting['rows_parted']} of {parting['rows']} rows, "
          f"{parting['boxes_parted']} boxes; " + ab_printed[-3].strip())
    return {"result": result, "exit": rc, "seconds": seconds, "train_s": train_s, "ab_s": ab_s, "layouts": layouts,
            "launches": launches, "streaming_launches": stream, "realtime_launches": realtime,
            "ab": {"map07": ab_out["map07"], "lossless": ab_out["lossless"], "keep_set_parting": parting,
                   "launches": variant_launches, "digests": variant_digests}}


# phase "probes": the ported repo-root tools at RON-320's full width, their calls cut
PROBE_CALLS = ["--iters", "2", "--warmup", "1"]
PROBE_PATH = ("nms_fixpoint_keep_mask", "fused_vgg_block1", "nms_scan_keep_mask")  # K-A, K-B, K-C
# the numbers that may be 0 or below: a delta between two timed variants, and the leak probe's RSS growth
PROBE_SIGNED = ("delta_ms", "encode", "rss_growth_gb", "mb_per_iter")
PROBE_TOOLS = (  # (name, the tool's main, its arguments, the kernels it must launch)
    ("perf_breakdown", perf_breakdown.main, ["--batches", "1", "32", *PROBE_CALLS],
     ("nms_fixpoint_keep_mask", "fused_vgg_block1")),
    ("perf_post", perf_post.main, PROBE_CALLS, ("nms_fixpoint_keep_mask", "nms_scan_keep_mask")),
    ("perf_topk", perf_topk.main, PROBE_CALLS, ("nms_fixpoint_keep_mask", "fused_vgg_block1")),
    ("perf_block_times", perf_block_times.main, PROBE_CALLS, ()),
    ("perf_remat12_bandwidth", perf_remat12_bandwidth.main, PROBE_CALLS, ()),
    ("perf_train_breakdown", perf_train_breakdown.main, PROBE_CALLS, ()),
    ("perf_step_probe", perf_step_probe.main, PROBE_CALLS, ()),
    ("perf_train_experiments", perf_train_experiments.main, PROBE_CALLS, ("fused_vgg_block1",)),
    ("leak_probe", leak_probe.main, ["8", "100"], ()),  # MB, iterations: the JAX tool's 8 MB, 100 of its 200
)


def probe_numbers(tool, res, key=None):
    """Every number of a probe's result: finite, and > 0 but for PROBE_SIGNED's."""
    if isinstance(res, dict):
        for k, v in res.items():
            probe_numbers(tool, v, k if isinstance(k, str) else key)
    elif isinstance(res, (list, tuple)):
        for v in res:
            probe_numbers(tool, v, key)
    elif isinstance(res, (int, float)) and not isinstance(res, bool):
        if not np.isfinite(res) or (key not in PROBE_SIGNED and res <= 0):
            raise AssertionError(f"{tool}: {key} = {res}")


def probes_phase(smi):
    """Phase "probes": `tools/list_caffemodel.py` on a seeded VGG-16
    caffemodel, then each perf probe at RON-320's full width and the JAX
    tools' batches (perf_breakdown cut to 1 and 32) with PROBE_CALLS, and
    the leak probe: each one's numbers finite and > 0 (PROBE_SIGNED's
    finite), each one's kernels launched (counted around it), K-A, K-B and
    K-C launched over the phase and no other kernel."""
    res, launches, seconds = {}, {}, {}
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        caffe = Path(tmp) / "vgg16.caffemodel"
        write_caffemodel(caffe, seeded_vgg16(VGG_SEED), np.full((512,), 20.0, np.float32))
        t0 = time.perf_counter()
        res["list_caffemodel"] = list_caffemodel.main([str(caffe)])
        seconds["list_caffemodel"] = time.perf_counter() - t0
    if res["list_caffemodel"]["layers"] != len(VGG16_REDUCED) + 1:
        raise AssertionError(f"list_caffemodel: {res['list_caffemodel']['layers']} layers, "
                             f"{len(VGG16_REDUCED) + 1} written")
    for name, tool_main, args, path in PROBE_TOOLS:
        before, t0 = kernels.launch_counts(), time.perf_counter()
        res[name] = tool_main(args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        probe_numbers(name, res[name])
        missing = [k for k in path if launches[name][k] < 1]
        if missing:
            raise AssertionError(f"{name}: never launched {missing} ({launches[name]})")
    total = kernels.launch_counts()
    check_counts("probes", total, PROBE_PATH)
    print("  probe seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f" ({smi})")
    return {"results": res, "launches": launches, "seconds": seconds, "total_launches": total}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
              file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--stem-timing"]:
        return stem_timing_main()
    if sys.argv[1:] == ["--images"]:
        return images_main()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s)")

    with phase("build"):
        seconds = _build.timed_build()
        print(f"  one nvcc call: {_build.library_path().name} in {seconds:.2f} s")
        tc_report = tensor_core_report()
        for name, info in sorted(_build.ptxas_report().items()):
            if "nms_sweep_kernel" in name:
                print(f"  {name}: {info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
                      f"stores, {info.get('spill_loads')} bytes spill loads")

    with phase("weights"):
        state = from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE)))
        fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
        pixels = [torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda") for i in IMAGES]
        images = torch.stack([eval_preprocess(p.float() / 255.0, RON_320_SPEC.img_shape)[0] for p in pixels])
        block1 = tuple(state[f"backbone.conv1_{j}.conv.{p}"].cuda() for j in (1, 2) for p in ("weight", "bias"))

    with phase("kernels"):
        max_err = check_kernels(block1)
        kb_block2 = check_block2(state, images, max_err)
        wide = check_wide_rows()

    with phase("main f32"):
        f32_dets, f32_model, f32_out = f32_parity(state, images, "TF32 off")
        with torch_default_flags():
            f32_parity(state, images, "torch's default flags, cuDNN TF32 on")

    with phase("bf16 drift"):
        drift = bf16_drift(state, images, f32_dets)

    with phase("main bf16"):
        model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=True)
        model.load_state_dict(state, strict=True)
        det = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")
        batch = images.repeat(BATCH // len(IMAGES), 1, 1, 1).contiguous()
        kernels.reset_launch_counts()
        scores, boxes = det(batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_counts("main path", launches, MAIN_PATH)
        c = RON_320_SPEC.num_classes - 1
        if scores.shape != (BATCH, c, NMS_CFG.keep_top_k) or boxes.shape != (BATCH, c, NMS_CFG.keep_top_k, 4):
            raise AssertionError(f"bad output shapes {tuple(scores.shape)}, {tuple(boxes.shape)}")
        if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
            raise AssertionError("non-finite detections")
        kept = (scores > 0).sum(dim=(1, 2))
        print(f"  bf16 batch {BATCH}: detections per image {kept[:len(IMAGES)].tolist()} (first images)")
        if int(kept.min()) < 1:
            raise AssertionError("an image kept no detection")

    with phase("api"):
        api_launches, (flat_s, flat_b, _), y1, tails = api_path(model, det, batch, block1, max_err)

    with phase("grad"):
        block1_grads(batch.to(torch.bfloat16).contiguous(), block1)
        block1_grads(kb_block2["pool1"][:TRAIN_BATCH].contiguous(), kb_block2["weights"])

    with phase("realtime f32"):
        _, rt_f32_worst = realtime_f32(f32_model, f32_out, fx)

    with phase("realtime bf16"):
        rt_launches = realtime_bf16(model, images, batch, fx)

    with phase("eval"):
        stream_ev, stream_batches, stream_eval = streaming_eval(model, batch, fx)
        rt_eval = realtime_eval(f32_model, fx)
        del f32_model, f32_out

    with phase("train"):
        host = train_host_batch(fx, TRAIN_BATCH)
        train_f32 = f32_train_parity(state, host)
        train_run = bf16_trainer_run(state, host, fx)
        train_kb = kb_train_grads(state, host)

    with phase("ssd f32"):
        ssd_states, ssd_res, ssd_f32_dets = {}, {}, {}
        kernels.reset_launch_counts()
        for name in SSD_NAMES:
            ssd_states[name], spec, spread = ssd_state(name, fx)
            ssd_res[name], ssd_f32_dets[name] = ssd_f32(name, ssd_states[name], spec, fx)
            ssd_res[name]["spread"] = spread
        torch.cuda.synchronize()
        check_counts("SSD f32 phase (Detector and class-wise realtime head)", kernels.launch_counts(),
                     ("nms_fixpoint_keep_mask", "nms_scan_keep_mask"))
        ssd_f32_launches = kernels.launch_counts()

    with phase("ssd bf16"):
        ssd = {name: ssd_bf16(name, ssd_states[name], get_network(name)[1], fx, ssd_f32_dets[name], max_err)
               for name in SSD_NAMES}

    with phase("ssd train"):
        host32 = train_host_batch(fx, BATCH)
        ssd_train = {"f32_card_vs_cpu": ssd_f32_train_parity(ssd_states["ssd_300_vgg"], host32),
                     "trainer_bf16": ssd_trainer_run(ssd_states["ssd_300_vgg"], host32)}

    with phase("stem"):
        stem = {"f32_forward": stem_forwards(state, images, ssd_states["ssd_300_vgg"], fx),
                "f32_step": stem_f32_steps(state, host), "bf16_train": stem_timing(smi),
                "detector_loop": stem_detector_loop(state, images)}

    with phase("heavy"):
        heavy, heavy_det, heavy_batch = heavy_phase(fx)

    with phase("eval losses"):
        s300 = ssd["ssd_300_vgg"]
        n_ron = RON_320_SPEC.anchor_layout().num_anchors
        ron_draws = [torch.rand(2, BATCH, n_ron, device="cuda", generator=torch.Generator("cuda").manual_seed(bi))
                     for bi in range(EVAL_LOSS_BATCHES)]
        eval_loss = {"ssd_300_vgg": eval_losses("SSD-300 bf16, SsdLossConfig", s300["model"], SSD_300_SPEC,
                                                SsdLossConfig(), s300["batch"], fx),
                     "ron_320_vgg": eval_losses("RON-320 bf16 (trained), RonLossConfig", model, RON_320_SPEC,
                                                TRAIN_CFG.loss, batch, fx, ron_draws)}

    with phase("timing"):
        print(f"  card before timing: {smi_sample()} (SM clock, power, temperature)")
        with torch.inference_mode():
            ms_det = cuda_ms(lambda: det(batch), reps=5, warmup=2)
            out = det.model(batch)
            nhwc_batch = batch.to(torch.bfloat16).contiguous()
            # where the Detector's time goes, stage by stage (CUDA events)
            breakdown = {
                "forward": cuda_ms(lambda: det.model(batch), reps=5),
                "candidates": cuda_ms(lambda: det.candidates(out), reps=5),
                "nms": cuda_ms(lambda: nms_sorted_kernel(
                    flat_s, flat_b, NMS_CFG.nms_threshold, NMS_CFG.keep_top_k, NMS_CFG.nms_mode), reps=20),
            }
            print(f"  card after the stage split: {smi_sample()}")
            # the per-class top-k as the Detector runs it (chunked) against one
            # stable sort of each whole row, on the main path's scores
            cls_scores, _ = det.class_scores(out)
            k_top = NMS_CFG.top_k
            chunks = NMS_CFG.topk_chunks
            chunked = exact_top_k_chunked(cls_scores, k_top, chunks)
            one_sort = [t[..., :k_top] for t in torch.sort(cls_scores, dim=-1, descending=True, stable=True)]
            if not all(torch.equal(a, b) for a, b in zip(chunked, one_sort)):
                raise AssertionError("chunked top-k differs from one stable sort")
            topk_ms = {
                "chunked": cuda_ms(lambda: exact_top_k_chunked(cls_scores, k_top, chunks), reps=20),
                "one_sort": cuda_ms(lambda: torch.sort(cls_scores, dim=-1, descending=True, stable=True), reps=20),
            }
            print(f"  Detector bf16 batch {BATCH}: {ms_det:.3f} ms/batch, {BATCH * 1e3 / ms_det:.1f} img/s; "
                  f"stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()))
            print(f"  top-k of {list(cls_scores.shape)}, k={k_top}: {chunks} chunks {topk_ms['chunked']:.4f} ms, "
                  f"one stable sort {topk_ms['one_sort']:.4f} ms")
        realtime, rt_rows = realtime_timing(model, batch, fx)
        evaluators = {"streaming": evaluator_timing(stream_ev, stream_batches), **stream_eval,
                      "realtime_voc": rt_eval, "realtime_f32_max_abs_diff": rt_f32_worst}
        with torch.inference_mode():
            results = timing_rows(launches, api_launches, rt_launches, max_err, block1, nhwc_batch,
                                  flat_s, flat_b, rt_rows, y1, tails)
            nms_split = nms_stage_split(breakdown["nms"], results[0]["ms"], flat_s, flat_b)
        for res in results:
            res.update(tc_report.get(res["name"], {}))
            rates = (f", {res['tflops']:.1f} TFLOP/s, {res['bound_share']:.3f} of bound, "
                     f"{res['library_ratio']:.3f}x the library" if "tflops" in res else "")
            nms = (f"; device time, {res['call_ms']:.4f} ms a wrapper call; kept per row mean "
                   f"{res['kept_mean']:.2f}, max {res['kept_max']}" if "call_ms" in res else "")
            print(f"  {res['name']}: {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, bound {res['bound_ms']:.4f} "
                  f"by {res['bound_by']}, library {res['library_ms']}{rates}{nms})")
            for label, p in (res.get("parts", {}) if "tflops" in res else {}).items():
                print(f"    {label} tail: {p['ms']:.4f} ms (plain {p['plain_ms']:.4f}, bound {p['bound_ms']:.4f} "
                      f"by {p['bound_by']}, library {p['library_ms']:.4f}), {p['tflops']:.1f} TFLOP/s, "
                      f"{p['bound_share']:.3f} of bound, {p['library_ratio']:.3f}x the library")
        train_times = train_timing(state, fx)
        ssd_times, ssd_rows, ssd_rt_rows = ssd_timing(ssd, ssd_states["ssd_300_vgg"], heavy_det, heavy_batch, host32)
        del heavy_det, heavy_batch
        with torch.inference_mode():
            results[0]["parts"] = {f"{key} {list(flat[0].shape)}": nms_part(key, *flat, SSD_DET.nms_threshold,
                                                                              SSD_DET.nms_mode)
                                   for key, flat in ssd_rows.items() if key.startswith("ssd")}
            cw = RealtimeConfig.for_spec(SSD_300_SPEC)
            results[2]["parts"][f"ssd_300 class-wise {list(ssd_rt_rows[0].shape)}"] = nms_part(
                "ssd_300 class-wise", *ssd_rt_rows, cw.nms_threshold, cw.nms_mode, cw.keep_per_class)
            results[0]["parts_launches"] = {name: s["launches"]["nms_fixpoint_keep_mask"] for name, s in ssd.items()}
            results[2]["ssd_f32_launches"] = ssd_f32_launches["nms_scan_keep_mask"]
        kb_row = next(r for r in results if r["name"] == "fused_vgg_block1")
        kb_row["shapes"] = kb_shape_rows(ssd)
        kb_row["block2"] = kb_block2_row(kb_block2)
        del kb_block2
        kb_row.update({"train_launches": train_run["launches"]["fused_vgg_block1"], "train_steps": TRAIN_STEPS,
                       "train_path": "Trainer.train, bf16, batch 14: one kernel forward a step, backward by "
                                     "recompute through block1_reference (cuDNN)", **train_times["kb_train"]})
        print(f"  card after timing: {smi_sample()}")

    with phase("profile"):
        profile = profile_call(f"Detector batch {BATCH}", lambda: det(batch))
        rt_det = RealtimeDetector(model, RON_320_SPEC, RT_SHIPPED, device="cuda")
        ms32 = frame_min_sizes(RT_SHIPPED, frame_shapes(fx)).repeat(BATCH // len(IMAGES))
        with torch.inference_mode():
            rt_out = rt_det.model(batch)
        rt_profile = {
            "b1": profile_call("realtime head batch 1", lambda: rt_det(batch[:1], ms32[:1])),
            "b32_candidates": profile_call(f"realtime head's candidates, batch {BATCH}",
                                           lambda: rt_det.candidates(rt_out, ms32)),
            "streaming_evaluator": profile_call(f"streaming evaluator, {EVAL_BATCHES} batches of {BATCH}",
                                                lambda: stream_ev.run(iter(stream_batches), log_every=0)),
        }

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with phase("reference import"):
            ref_import = reference_import()
        with phase("warm start"):
            warm = warm_start(host, host32, tmp)
        with phase("import cli"):
            imported = import_cli(warm.pop("pth"), warm.pop("backbone"), tmp)
        with phase("tensorboard"):
            tb = tensorboard_check(warm.pop("model_dir"), warm.pop("rows"))
    ref = np.load(VOC_MINI_REF, allow_pickle=False)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with phase("jpeg"):
            jpeg_res = jpeg_phase(ref, smi)
        with phase("records"):
            records = records_phase(ref, tmp, smi)
        with phase("cli train"):
            cli_train = cli_train_phase(state, Path(records["path"]), fx, tmp, smi)
        with phase("cli eval"):
            cli_eval = cli_eval_phase(state, Path(records["path"]), tmp, smi)
        eval_dir = cli_eval.pop("model_dir")
        with phase("cli realtime-eval"):
            cli_rt = cli_realtime_phase(eval_dir, ref, tmp, smi)
        with phase("dist"):
            dist = dist_phase(state, Path(records["path"]), cli_eval, eval_dir, tmp, train_times, smi)
        del cli_eval["accumulator"], cli_eval["aps"]
        with phase("zoo"):
            zoo_res = zoo_phase(tmp, smi)
        with phase("cli infer"):
            cli_inf = cli_infer_phase(eval_dir, tmp, smi)
        with phase("learn"):
            learn = learn_phase(tmp, smi)
    with phase("bench"):
        bench = {**bench_cli(smi), "shared_top_k": bench_shared_top_k(state, images)}
    with phase("images"):
        images_res = images_phase(smi)
    with phase("rehearsal"):
        rehearsal = rehearsal_phase(smi)
    with phase("probes"):
        probes = probes_phase(smi)
    results[2]["cli_infer_launches"] = cli_inf["launches"]["nms_scan_keep_mask"]
    kb_row["cli_launches"] = {"train": cli_train["launches"]["fused_vgg_block1"],
                              "eval": cli_eval["launches"]["fused_vgg_block1"]}
    results[0]["cli_eval_launches"] = cli_eval["launches"]["nms_fixpoint_keep_mask"]
    results[2]["cli_realtime_eval_launches"] = cli_rt["launches"]["nms_scan_keep_mask"]
    kb_row["warm_start_launches"] = {"ron_320": warm["ron"]["launches"]["fused_vgg_block1"],
                                     "ssd_300_caffe": warm["ssd_300_caffe"]["launches"]["fused_vgg_block1"],
                                     "reference_import_detector": ref_import["launches"]["fused_vgg_block1"]}
    results[0]["reference_import_launches"] = ref_import["launches"]["nms_fixpoint_keep_mask"]
    # the dist path, counted in each rank: K-B in every rank's train step and eval, K-A in every rank's eval
    kb_row["dist_launches"] = {"trainer_per_rank": dist["dp_trainer"]["launches_per_rank"],
                               "eval_per_rank": [x["fused_vgg_block1"] for x in dist["eval"]["launches"]],
                               "nccl_world_1_step": dist["nccl_world_1"]["launches"]["fused_vgg_block1"]}
    results[0]["dist_launches"] = {"eval_per_rank": [x["nms_fixpoint_keep_mask"] for x in dist["eval"]["launches"]]}
    results[0]["learn_launches"] = {"overfit": learn["overfit"]["launches"]["nms_fixpoint_keep_mask"],
                                    "synthetic_eval": learn["synthetic"]["eval_launches"]["nms_fixpoint_keep_mask"]}
    kb_row["learn_launches"] = {"synthetic_train": learn["synthetic"]["train_launches"]["fused_vgg_block1"],
                                "synthetic_eval": learn["synthetic"]["eval_launches"]["fused_vgg_block1"]}
    results[0]["bench_launches"] = bench["launches"]["nms_fixpoint_keep_mask"]
    kb_row["bench_launches"] = bench["launches"]["fused_vgg_block1"]
    results[2]["bench_launches"] = bench["launches"]["nms_scan_keep_mask"]
    results[2]["detector_loop_launches"] = stem["detector_loop"]["launches"]["nms_scan_keep_mask"]
    kb_row["stem_train_launches"] = stem["bf16_train"]["ron_320_vgg K-B"]["launches"]["fused_vgg_block1"]
    results[0]["wide_rows"] = wide["nms_fixpoint_keep_mask"]
    results[2]["wide_rows"] = wide["nms_scan_keep_mask"]
    results[0]["images_launches"] = images_res["wide_rows"]["Detector"]["launches"]["nms_fixpoint_keep_mask"]
    results[0]["images_wide_rows"] = images_res["wide_rows"]["Detector"]["timing"]
    results[2]["images_wide_rows"] = images_res["wide_rows"]["realtime head"]["timing"]
    ab_launches = rehearsal["ab"]["launches"]
    results[0]["rehearsal_launches"] = {
        "streaming_eval": rehearsal["streaming_launches"]["nms_fixpoint_keep_mask"],
        "ab_variants": {n: v["nms_fixpoint_keep_mask"] for n, v in ab_launches.items() if v["nms_fixpoint_keep_mask"]}}
    results[2]["rehearsal_launches"] = {
        "realtime_eval": rehearsal["realtime_launches"]["nms_scan_keep_mask"],
        "ab_variants": {n: v["nms_scan_keep_mask"] for n, v in ab_launches.items() if v["nms_scan_keep_mask"]}}
    results[0]["probes_launches"] = probes["total_launches"]["nms_fixpoint_keep_mask"]
    kb_row["probes_launches"] = probes["total_launches"]["fused_vgg_block1"]
    results[2]["probes_launches"] = probes["total_launches"]["nms_scan_keep_mask"]
    results[2]["images_launches"] = {
        "cli_infer": images_res["infer"]["launches"]["nms_scan_keep_mask"],
        "realtime_wide": images_res["wide_rows"]["realtime head"]["launches"]["nms_scan_keep_mask"]}

    print(json.dumps({"kernels": results, "detector_bf16_b32_img_per_s": BATCH * 1e3 / ms_det,
                      "detector_stage_ms": breakdown, "nms_stage_split": nms_split, "topk_ms": topk_ms,
                      "bf16_vs_f32": drift, "profile": profile, "realtime_head_bf16": realtime,
                      "evaluators": evaluators, "profile_realtime": rt_profile,
                      "train": {"f32_card_vs_cpu": train_f32, "trainer_bf16": train_run, "kb_in_step": train_kb,
                                "timing": train_times},
                      "ssd": {name: {**ssd_res[name], "kb_err": ssd[name]["kb_err"], "bf16_vs_f32": ssd[name]["drift"]}
                              for name in SSD_NAMES},
                      "ssd_train": ssd_train, "heavy": heavy, "eval_losses": eval_loss, "ssd_timing": ssd_times,
                      "checkpoint_import": {"reference_import": ref_import, "warm_start": warm, "import_cli": imported,
                                            "tensorboard": tb},
                      "records_to_map": {"jpeg": jpeg_res, "records": records, "cli_train": cli_train,
                                         "cli_eval": cli_eval, "cli_realtime_eval": cli_rt},
                      "dist": dist, "zoo": zoo_res, "cli_infer": cli_inf, "learn": learn, "bench": bench,
                      "stem": stem, "images": images_res, "rehearsal": rehearsal,
                      "probes": {"launches": probes["launches"], "seconds": probes["seconds"]}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def sweep_pairs(scores, boxes, thr, mode, keep, dividing=False):
    """Overlaps the greedy sweep that gives `keep` must evaluate: each kept
    i against every later candidate still alive at i's turn, that is with a
    score > 0 and not suppressed by a kept box before i. A candidate j is
    tested by the kept boxes before it up to and including the first that
    suppresses it. The predicate is K-A's division-free one, or K-C's
    dividing one where `dividing`."""
    total, k = 0, keep.shape[-1]
    arange, chunk = torch.arange(k, device=keep.device), max(1, (1 << 24) // k)  # kept boxes tested at once
    for r in range(keep.shape[0]):
        idx = keep[r].nonzero().squeeze(1)
        n = idx.numel()
        first = torch.full_like(arange, n)  # index in kept order of j's first suppressor, n if none
        y0, x0, y1, x1 = boxes[r].unbind(-1)
        vol = (y1 - y0) * (x1 - x0)
        for c0 in range(0, n, chunk):
            i = idx[c0:c0 + chunk, None]
            ih = torch.clamp(torch.minimum(y1, y1[i]) - torch.maximum(y0, y0[i]), min=0.0)
            iw = torch.clamp(torch.minimum(x1, x1[i]) - torch.maximum(x0, x0[i]), min=0.0)
            inter = ih * iw
            denom = (vol + vol[i]) - inter if mode == "union" else torch.minimum(vol, vol[i])
            if dividing:
                hit = torch.where(denom > 0.0, inter / torch.where(denom > 0.0, denom, 1.0), 0.0) >= thr
            else:
                hit = (inter >= thr * denom) & (denom > 0.0)
            hit &= i < arange
            found = hit.any(0)
            first = torch.where((first == n) & found, hit.to(torch.uint8).argmax(0) + c0, first)
        before = torch.cumsum(keep[r], 0) - keep[r].long()  # kept boxes ahead of j
        total += int((torch.minimum(before, first + 1) * (scores[r] > 0.0)).sum())
    return total


def kept_stats(keep):
    per_row = keep.sum(-1).float()
    return {"kept_mean": float(per_row.mean()), "kept_max": int(per_row.max())}


def nms_times(fn):
    """An NMS kernel's device time (torch.profiler, the kernel's own device
    events, per launch) as "ms", and the wrapper's per-call time (CUDA
    events around back-to-back calls: host cost included) as "call_ms"."""
    ms, seen = device_ms(fn)
    return {"ms": ms, "call_ms": cuda_ms(fn, reps=50), "device_launches_traced": seen}


def device_busy_ms(fn):
    """Device time of one call of fn: the sum of the device's own events in
    a torch.profiler trace of the call (one warm-up call first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
             for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3


def realtime_timing(model, batch, fx):
    """Phase 10, the realtime head on the bf16 model with K-B (trained
    weights): batch-1 latency as the JAX bench.py:266-324 defines it, on
    seeded whitened pixels: p50 and p90 of synchronous calls (host pixels
    in, detections back on the host), and pipelined (LAT_ITERS calls on
    pixels already on the card, back to back, one wait: total / LAT_ITERS);
    the device's share of the pipelined time (profiler device time of one
    call over it); batch-32 ms and its stage split. Returns the numbers and
    the K-C rows of the runs: {label: (scores, boxes, keep_top_k, mode)}."""
    det = RealtimeDetector(model, RON_320_SPEC, RT_SHIPPED, device="cuda")
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, (LAT_ITERS, 1, *RON_320_SPEC.img_shape, 3)).astype(np.float32)
    host = [whiten(torch.from_numpy(p) / 255.0) for p in pixels]
    p50, p90, pipelined = bench_mod.latency_ms(det, host, "cuda")
    x0 = host[0].cuda()
    b1_device = device_busy_ms(lambda: det(x0))
    res = {"b1_p50_ms": p50, "b1_p90_ms": p90,
           "b1_pipelined_ms": pipelined, "b1_device_ms": b1_device, "b1_device_share": b1_device / pipelined}
    ms1 = frame_min_sizes(RT_SHIPPED, frame_shapes(fx))
    ms32 = ms1.repeat(BATCH // len(IMAGES))
    with torch.inference_mode():
        rows1 = det.candidates(det.model(batch[:1]), ms1[:1])
        res["b32_ms"] = cuda_ms(lambda: det(batch, ms32), reps=5, warmup=2)
        out32 = det.model(batch)
        rows32 = det.candidates(out32, ms32)
        res["b32_stage_ms"] = {
            "forward": cuda_ms(lambda: det.model(batch), reps=5),
            "candidates": cuda_ms(lambda: det.candidates(out32, ms32), reps=10),
            "nms": cuda_ms(lambda: det.nms(rows32), reps=20),
        }
        cw = RealtimeDetector(model, RON_320_SPEC, RT_CLASS_WISE, device="cuda")
        cw_rows = cw.candidates(out32, ms32)
    res["b32_img_per_s"] = BATCH * 1e3 / res["b32_ms"]
    print(f"  realtime head bf16 batch 1: p50 {res['b1_p50_ms']:.3f} ms, p90 {res['b1_p90_ms']:.3f} ms "
          f"(synchronous, {LAT_ITERS} images), pipelined {pipelined:.3f} ms; device time of one call "
          f"{b1_device:.3f} ms = {res['b1_device_share']:.3f} of the pipelined time (idle "
          f"{1 - res['b1_device_share']:.3f})")
    print(f"  realtime head bf16 batch {BATCH}: {res['b32_ms']:.3f} ms, {res['b32_img_per_s']:.1f} img/s; stages "
          f"(ms): " + ", ".join(f"{k} {v:.3f}" for k, v in res["b32_stage_ms"].items()))
    rows = {
        "realtime [1, 400]": (rows1[3].to(torch.float32), rows1[2], RT_SHIPPED.keep_top_k, RT_SHIPPED.nms_mode),
        "realtime [32, 400]": (rows32[3].to(torch.float32), rows32[2], RT_SHIPPED.keep_top_k, RT_SHIPPED.nms_mode),
        "class-wise [640, 400]": (*cw_rows, RT_CLASS_WISE.keep_per_class, RT_CLASS_WISE.nms_mode),
    }
    return res, rows


def evaluator_timing(ev, batches):
    """Phase 10: the streaming evaluator's images/s over its batches (host
    clock around `run`, which ends with every result on the host), and the
    matcher's time a batch-32 call (CUDA events)."""
    t0 = time.perf_counter()
    _, _, _, stats = ev.run(iter(batches), log_every=0)
    seconds = time.perf_counter() - t0
    with torch.inference_mode():
        scores, boxes = ev.detector(batches[0]["image"])
        gts = [torch.as_tensor(batches[0][k]).cuda() for k in ("gt_labels", "gt_boxes", "gt_difficult")]
        match_ms = cuda_ms(lambda: match_all_classes(RON_320_SPEC.num_classes, scores, boxes, *gts), reps=20)
    res = {"img_per_s": stats["images"] / seconds, "images": stats["images"], "matcher_ms_per_batch": match_ms}
    print(f"  streaming evaluator: {res['img_per_s']:.1f} img/s over {stats['images']} images "
          f"(batches of {BATCH}); matcher {match_ms:.3f} ms a batch")
    return res


def scan_row(rt_rows, api_rows, api_launches, rt_launches, max_err):
    """The kernels-line row of K-C: the realtime head's rows (the row's own
    numbers: [32, 400] union, cap 20), each row set under "parts", the
    streaming Detector's [640, 200] rows through the kernels API among them.
    Each part: device time, the wrapper's per-call time, the plain version's
    time, the pairs the keep set needs and the bound."""
    parts = {}
    for label, (scores, boxes, cap, mode) in {**rt_rows, **api_rows}.items():
        scores, boxes = scores.contiguous(), boxes.contiguous()
        thr = RT_SHIPPED.nms_threshold if label in rt_rows else NMS_CFG.nms_threshold
        keep = kernels.nms_scan_keep_mask(scores, boxes, thr, cap, mode)
        keep_plain = kernels.nms_scan_keep_mask_plain(scores, boxes, thr, cap, mode)
        err, n_diff = mask_err(keep, keep_plain)
        if n_diff:
            raise AssertionError(f"K-C on {label}: {n_diff} mask differences")
        max_err["nms_scan_keep_mask"] = max(max_err["nms_scan_keep_mask"], err)
        r, k = scores.shape
        pairs = sweep_pairs(scores, boxes, thr, mode, keep, dividing=True)
        bound_ms, bound_by = bound(r * k * (4 + 16 + 1), 12 * pairs, PEAK_F32_FLOPS)
        fn = lambda: kernels.nms_scan_keep_mask(scores, boxes, thr, cap, mode)  # noqa: E731
        parts[label] = {"rows": [r, k], "mode": mode, "keep_top_k": cap, **nms_times(fn),
                        "plain_ms": cuda_ms(lambda: kernels.nms_scan_keep_mask_plain(scores, boxes, thr, cap, mode),
                                            reps=2),
                        "pairs": pairs, "bound_ms": bound_ms, "bound_by": bound_by, **kept_stats(keep)}
        p = parts[label]
        print(f"  nms_scan_keep_mask {label} {mode} cap {cap}: {p['ms']:.4f} ms device, {p['call_ms']:.4f} ms a "
              f"wrapper call, plain {p['plain_ms']:.4f}; {pairs} overlaps needed, bound {bound_ms:.5f} by "
              f"{bound_by}; kept per row mean {p['kept_mean']:.2f}, max {p['kept_max']}; 0 mask differences")
    main = parts["realtime [32, 400]"]
    return {
        "name": "nms_scan_keep_mask", "route": "cuda", "source": NMS_SOURCE,
        "replaces": "ron_tensorflow_tpu/kernels/nms_pallas.py:93", "path": "realtime head",
        "launches": rt_launches["nms_scan_keep_mask"], "max_abs_err": max_err["nms_scan_keep_mask"],
        **{k: main[k] for k in ("ms", "call_ms", "device_launches_traced", "plain_ms", "bound_ms", "bound_by",
                                "kept_mean", "kept_max")},
        "library_ms": None, "kernels_api_launches": api_launches["nms_scan_keep_mask"], "parts": parts,
    }


def nms_stage_split(stage_ms, mask_device_ms, flat_s, flat_b):
    """The Detector's NMS stage (`nms_sorted_kernel`: K-A's mask, then
    `compact_keep`) split into K-A's device time, compact_keep's device
    time and launches, and what is left: host time the device waits for."""
    thr, mode, cap = NMS_CFG.nms_threshold, NMS_CFG.nms_mode, NMS_CFG.keep_top_k
    keep = kernels.nms_fixpoint_keep_mask(flat_s, flat_b, thr, mode)
    compact = lambda: compact_keep(keep, flat_s, flat_b, cap)  # noqa: E731
    reps = 50
    compact_dev, compact_events = device_ms(compact, reps=reps, match="")
    split = {"stage_ms": stage_ms, "keep_mask_device_ms": mask_device_ms,
             "compact_device_ms": compact_dev, "compact_launches": compact_events / reps,
             "compact_call_ms": cuda_ms(compact, reps=reps)}
    split["rest_ms"] = stage_ms - mask_device_ms - compact_dev
    print(f"  NMS stage {stage_ms:.4f} ms = K-A {mask_device_ms:.4f} ms (device) + compact_keep "
          f"{compact_dev:.4f} ms (device, {split['compact_launches']:.0f} launches; "
          f"{split['compact_call_ms']:.4f} ms a call) + {split['rest_ms']:.4f} ms of host time the card waits for")
    return split


def timing_rows(launches, api_launches, rt_launches, max_err, block1, nhwc_batch, flat_s, flat_b, rt_rows, y1, tails):
    """Phase 10: one row per kernel, each timed on its path's own inputs."""
    results = []
    thr, mode, cap = NMS_CFG.nms_threshold, NMS_CFG.nms_mode, NMS_CFG.keep_top_k
    r, k = flat_s.shape
    # the kernels once more against their plain versions, on the main path's own inputs
    keep = kernels.nms_fixpoint_keep_mask(flat_s, flat_b, thr, mode)
    keep_plain = kernels.nms_fixpoint_keep_mask_plain(flat_s, flat_b, thr, mode)
    err, n_diff = mask_err(keep, keep_plain)
    max_err["nms_fixpoint_keep_mask"] = max(max_err["nms_fixpoint_keep_mask"], err)
    if n_diff:
        raise AssertionError(f"NMS keep masks differ on the main path's candidates ({n_diff} entries)")
    w1, b1, w2, b2 = block1
    max_err["fused_vgg_block1"] = max(max_err["fused_vgg_block1"], block1_err(
        "main path's batch", kernels.fused_vgg_block1(nhwc_batch, w1, b1, w2, b2),
        kernels.fused_vgg_block1_plain(nhwc_batch, w1, b1, w2, b2)))
    # K-A's bound counts the work these rows need, as K-C's does: each kept i
    # against every later candidate still alive at its turn. The fixpoint
    # algorithm's all-pairs count is printed beside it, for the record.
    _, steps = fixpoint_keep(flat_s > 0, suppression_matrix(flat_b, thr, mode))
    nms_bytes = r * k * (4 + 16 + 1)
    pairs = sweep_pairs(flat_s, flat_b, thr, mode, keep)
    nms_bound, nms_by = bound(nms_bytes, 12 * pairs, PEAK_F32_FLOPS)
    fixpoint_ops = r * k * (k - 1) / 2 * 11 + steps * r * k * ((k + 31) // 32) * 2
    old_bound, old_by = bound(nms_bytes, fixpoint_ops, PEAK_F32_FLOPS)
    fn = lambda: kernels.nms_fixpoint_keep_mask(flat_s, flat_b, thr, mode)  # noqa: E731
    results.append({
        "name": "nms_fixpoint_keep_mask", "route": "cuda", "source": NMS_SOURCE,
        "replaces": "ron_tensorflow_tpu/kernels/nms_pallas.py:225", "path": "main",
        "launches": launches["nms_fixpoint_keep_mask"],
        "max_abs_err": max_err["nms_fixpoint_keep_mask"],
        **nms_times(fn),
        "plain_ms": cuda_ms(lambda: kernels.nms_fixpoint_keep_mask_plain(flat_s, flat_b, thr, mode), reps=3),
        "bound_ms": nms_bound, "bound_by": nms_by, "library_ms": None, **kept_stats(keep),
    })
    print(f"  nms rows [{r},{k}]: {int(keep.sum())} kept, {pairs} overlaps needed; "
          f"the fixpoint algorithm's count ({steps} steps, all pairs) would make the bound "
          f"{old_bound:.4f} ms by {old_by}; block 1 on the batch: max |kernel - plain| = "
          f"{max_err['fused_vgg_block1']:.6g}")

    blk_flops, blk_bytes = block_cost(nhwc_batch, block1)
    blk_bound, blk_by = bound(blk_bytes, blk_flops, PEAK_BF16_FLOPS)
    results.append(with_rates({
        "name": "fused_vgg_block1", "route": "cuda",
        "source": "ron_tensorflow_tpu_torch/csrc/fused_vgg_block1.cu",
        "replaces": "ron_tensorflow_tpu/kernels/fused_conv_pool.py:388", "path": "main",
        "launches": launches["fused_vgg_block1"],
        "max_abs_err": max_err["fused_vgg_block1"],
        "ms": cuda_ms(lambda: kernels.fused_vgg_block1(nhwc_batch, w1, b1, w2, b2), reps=20),
        "plain_ms": cuda_ms(lambda: kernels.fused_vgg_block1_plain(nhwc_batch, w1, b1, w2, b2), reps=3),
        "bound_ms": blk_bound, "bound_by": blk_by,
        "library_ms": cuda_ms(cudnn_block(nhwc_batch, block1), reps=20),
    }, blk_flops))

    # K-C on the realtime head's rows, and on the Detector's through the
    # kernels API: the pairs each keep set needs (sweep_pairs)
    results.append(scan_row(rt_rows, {"streaming [640, 200] (kernels API)": (flat_s, flat_b, cap, mode)},
                            api_launches, rt_launches, max_err))

    results.append(conv_row("fused_stem_conv_relu_pool2", {"block1": (y1, w2, b2)}, max_err, api_launches,
                            "ron_tensorflow_tpu/kernels/fused_conv_pool.py:116"))
    results.append(conv_row("fused_conv3x3_relu_pool2", {k: (a, c.weight, c.bias) for k, (a, c) in tails.items()},
                            max_err, api_launches, "ron_tensorflow_tpu/kernels/fused_conv_pool.py:470"))
    return results


if __name__ == "__main__":
    sys.exit(main())
