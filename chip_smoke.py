#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out-dir chip_smoke_out]

1. Preflight: fails without a CUDA device; prints the card's name and power
   limit; turns TF32 off for float32 matmuls and convolutions.
2. Builds the CUDA kernels (ops/csrc) from this checkout with nvcc.
3. Kernel phase, at the training path's shapes (N=12, S=256): each kernel
   K1 (warp), K2 (CLAHE LUTs), K3 (CLAHE blend) against its plain PyTorch
   version on the same inputs (coordinates from the port's own augmentation
   draws plus out-of-range, half-integer and exact-.5 ones; CLAHE apply
   flags mixing 0 and 1). K2 runs on a second batch too, `K2_saturated`:
   the same images cut to a disc, as a micro-CT slice is outside its field
   of view, so whole tiles fall in one bin. Fails on any excess over the
   stated tolerance. K1's plain version is also held against
   `F.grid_sample` (reflection padding, align_corners=True: reflect-101)
   on float32 copies of its inputs, images within 1e-3. Then K1-K3 again
   on the top-left crops of the batch at `KERNEL_SIDES` (252, 255 and 23:
   sides the 8x8 CLAHE grid does not divide), at the same tolerances.
   Each kernel and plain version is then timed, at `TIMED_SIDES` (256
   and 252), over runs of >= 64 calls
   (`time_ms`): CUDA events around a run that cycles through k >= 8
   copies of the inputs, k * bytes >= twice the 50 MB L2, so every call
   reads its inputs from HBM as the bound counts them; a GPU spin ahead of
   the run hides the host's dispatch. The time is run time / calls,
   median of 5 runs.
4. Slice phase: `VolSeg2dTrainer` trains U-Net/ResNet-34 (random init) at
   256x256, batch 12, bf16 on a 64x256x256 synthetic vessels volume sliced
   along all three axes: LR finder, frozen epoch, LR finder, unfrozen epoch,
   with launch counters reset just before. Fails unless every loss is
   finite, frozen encoder parameters are unchanged, each kernel launched
   once per train step, and the checkpoint reloads to the same model.
5. Predict phase, from the slice phase's checkpoint, through
   `VolSeg2DPredictionManager(...).predict_volume_to_path(None)` with the
   shipped prediction settings (clip_data on): MEDIUM bf16 on a 256^3
   vessels volume held to MeanIoU >= 0.75 against its truth; MEDIUM equal,
   labels and max-probs, to a numpy merge of the three LOW sweeps, and
   repeatable; on a 24x72x40 crop in float32 (TF32 off), the card at LOW,
   MEDIUM and HIGH against the plain path on the CPU (near-tie rule); bf16
   MEDIUM labels >= 99% equal to float32 on the 256^3 volume; no kernel
   launch. Then times MEDIUM and HIGH on a 512^3 volume (the clipped
   256^3 one tiled 2x2x2), uint8 ndarray in to labels on the host; MEDIUM
   from the raw 512^3 volume with the manager's set-up (checkpoint load,
   clip_to_uint8) timed too; and MEDIUM at the prediction batches
   `PRED_BATCHES` (median of 3 runs each).
6. CLI phase, in process so that the launch counters see it, in
   `<out-dir>/cli`: writes a `CLI_TRAIN_SHAPE` vessels training pair as gzip
   HDF5 (chunks=True) with the port's writer, and the shipped settings
   files (train: one frozen and one unfrozen epoch, seed 0; predict:
   output_probs on). `model-train-2d` (`scripts/train_2d_model.main`) on
   the card, with launch counters reset just before: fails unless the
   dated checkpoint and the CSV exist, every loss is finite, the last
   eval score is >= 0.5 and each kernel launched once per train step.
   `model-predict-2d` on the 256^3 vessels volume (seed 7) from HDF5:
   labels equal to the manager's on the same ndarray at every voxel,
   MeanIoU >= 0.75, a float16 max-prob sidecar of the volume's shape.
   Then `model-predict-2d` end to end on the raw 512^3 volume (the 256^3
   one tiled 2x2x2, gzip HDF5) with the shipped prediction settings as
   written, timed by part: HDF5 read, the manager's clip, checkpoint load,
   sweeps, HDF5 write, and `main`'s wall time.
7. Losses phase, from one seeded U-Net/ResNet-34 at 256x256, batch 12,
   bf16: for each of the five losses of the shipped settings,
   `LOSS_STEPS` train steps through `build_train_step`, each followed by the eval step with
   MeanIoU and with DiceCoefficient; fails unless every loss and score is
   finite and each kernel launched once per step. Then each loss, its
   gradient on the logits and both metrics on the card against the CPU on
   the same (12, 2, 256, 256) float32 logits: |card - CPU| <= 1e-5 times
   the CPU value's largest magnitude.
8. Checkpoint phase: the slice phase's model written as a JAX package
   `VSTPU1` file under a `.pytorch` name (forward map and the port's
   msgpack writer) must rebuild to a state_dict bit-equal to the torch
   file's, and `model-predict-2d` on it must give the torch file's labels
   at every voxel of the 256^3 volume; the torch file must unpickle through
   the reference-path Unpickler and name the reference's module. The same
   weights as bfloat16 tensors, with an extra of a bfloat16 array chunked
   past a 1 MiB `CHUNK_LIMIT`, complex64 and complex128 arrays and a Python
   complex, written as a `VSTPU1` file and read back
   (`bfloat16_checkpoint`): the bytes rewritten from what was read equal
   the bytes written, each bfloat16 and complex leaf keeps its bits, and
   `load_checkpoint` gives the bfloat16 weights widened to float32.
9. Large phase, from the slice phase's checkpoint, in `<out-dir>/large`:
   the 256^3 vessels volume as gzip HDF5 (chunks=True), kept lazy
   (`lazy_ingest_threshold` below it, clip on, bf16): LOW, MEDIUM, HIGH
   and one-hot MEDIUM from the slab-streaming predictor (slab = batch)
   equal, labels and max-probs, to the same source assembled on the card
   and predicted in memory; the manager's streamed MEDIUM equal too; the
   eager ingest of the file agrees on >= 99.5% of labels, its data_mean
   within 1e-9 relative; no read above one slab's largest face. Then
   MEDIUM on the clipped volume tiled to 512^3, in memory and streamed,
   twice each, labels equal. Then `model-predict-2d` with the shipped
   predict settings as written on a (D, 2048, 2048) gzip HDF5 tiling of
   the raw volume, D the smallest multiple of 256 above 1.15 x
   `in_memory_limit_voxels` (1024 on an 80 GB card), written from a tiled
   view that is never materialised: it must stream, write uint8 labels of
   the input's shape and score MeanIoU >= 0.75 against the tiled truth
   (counted slab by slab from partial reads). Prints its times by part
   (lazy mean and sigma, each sweep, each merge, checkpoint load, HDF5
   write, `main`), the batch it settled on, peak device memory, peak host
   RSS, the workdir's peak bytes, free disk before, during and after, and
   the chunks inflated; deletes its files.
10. Pretrained phase (run after the sides phase, beside the parallel and
   spatial phases): the slice model's encoder, its first convolution
   widened to 3 channels (the kernel, then zeros), as
   `$VOLSEG_TPU_WEIGHTS_DIR/resnet34.vstpu`; `model-train-2d` on the CLI
   phase's `ROUND_TRIP_SHAPE` HDF5 pair with the shipped settings plus
   `skip_frozen_without_pretrained`, `autosave` and `profile_dir`: fails
   unless the frozen phase runs, every model the trainer creates starts
   from the slice model's encoder, each kernel launched once per step, the
   autosave is gone at the end and a Chrome trace holds CUDA kernel events.
11. Architectures phase, for each of the seven decoders beside U-Net on
   resnet34 (U-Net++, FPN, DeepLabV3, DeepLabV3+, MA-Net, LinkNet, PAN), in
   `<out-dir>/architectures`: a seeded model on the CPU and the same
   tensors on the card, float32 eval on a 2x1x256x256 batch, within
   `ARCH_CARD_VS_CPU_RTOL` of the logits' scale (and, recorded as its
   control, the same with TF32 on); the parameter count equal to the JAX
   model's (`ARCH_PARAMS`); forward GFLOP a 256^2 sample from the layer
   shapes; `ARCH_STEPS` seeded unfrozen train steps (256, batch 12, bf16,
   DiceLoss): finite losses, each kernel launched once a step, median step
   ms and peak memory; the same steps again from the same weights and seeds,
   with cuDNN's flags as the port leaves them: equal losses; for FPN and
   DeepLabV3 one more run with another dropout seed: other losses; one step at
   `THROUGHPUT_TRAIN_BATCH` (peak memory, or the OOM recorded, not failed);
   the trained weights written by the trainer's checkpoint writer, MEDIUM
   on the 256^3 vessels volume (seconds, peak memory) equal to the merge of
   its LOW sweeps, and the same weights as a JAX `VSTPU1` file through
   `model-predict-2d` giving the same labels. Then `model-train-2d` with the
   shipped settings as written but `type: U_Net_Plus_Plus` (1+1 epochs,
   seed 0) on the CLI phase's `ROUND_TRIP_SHAPE` pair: last eval score >=
   0.5, each kernel launched once a step; `model-predict-2d` on 256^3 equal to the manager's
   labels.
12. Encoders phase, for each of the six encoders beside resnet34
   (ResNet-50, ResNeXt-50 32x4d, EfficientNet-B3/-B4, ResNeSt-50d/-101e)
   under U-Net, in `<out-dir>/encoders`: card against CPU as the
   architectures phase but with every BatchNorm randomised, for U-Net and
   the dilated forms under DeepLabV3+ (output stride 16) and DeepLabV3
   (8), each with its TF32 control and the logits' scale; the
   JAX parameter count (`ENCODER_PARAMS`); forward GFLOP a sample; 5
   seeded frozen train steps as the trainer freezes (256, batch 12, bf16,
   DiceLoss): exactly the parameters the JAX freeze mask leaves trainable
   move (their count is the JAX one: EfficientNet's BatchNorms and
   ResNeSt's split-attention BatchNorms), every other parameter keeps its
   bits, every BatchNorm's running statistics move; then `ENCODER_STEPS`
   unfrozen steps, run twice from the same weights and seeds: finite, equal
   losses, each kernel launched once a step (with the frozen steps); median frozen
   and unfrozen step ms and peak memory; one step at
   `THROUGHPUT_TRAIN_BATCH` (or the OOM, recorded); MEDIUM on 256^3 from the
   trained weights equal to its LOW sweeps' merge and to `model-predict-2d`
   on the same weights as a `VSTPU1` file. Then `model-train-2d` with the
   shipped settings as written but `encoder_name: efficientnet-b3`, from a
   cached encoder (the phase's trained B3 encoder, first convolution
   widened to 3 channels): the frozen phase runs from the cache, last eval
   score >= 0.5, each kernel launched once a step; `model-predict-2d` on
   256^3 equal to the manager's labels.
13. Formats phase, in `<out-dir>/formats`, from the CLI phase's files:
   (a) `model-train-2d` on the CLI phase's pair written as TIFF by
   `write_tiff` (data Deflate with predictor 2, labels an uncompressed
   BigTIFF), the CLI phase's settings: fails unless its epoch losses,
   eval scores and checkpoint tensors equal the HDF5 run's bit for bit,
   the loss plot and montage PNGs exist, each montage prediction panel
   equals the argmax of an eval forward of the trainer's model on the first
   validation batch, which this script computes on the card itself rather
   than through the trainer's `predict_batch` that drew the panel (the
   argmax against JAX is `tests/test_torch_figures.py`'s), and each kernel
   launched once a step;
   (b) `model-predict-2d` on the 256^3 vessels volume as LZW TIFF: labels
   equal to the CLI phase's from HDF5, and that file read back equal, its
   read timed; then the 512^3 volume written and read back as uint8
   uncompressed and Deflate TIFF, uint16 Deflate TIFF and gzip HDF5, equal
   to what was written, each read timed (s and MB/s of the decoded array;
   LZW at 256^3: a 512^3 one took 56 s on a slow host); (c) the library's
   PNG-directory path: the
   slicer writes the pair as PNG slices (timed, and the PNG read of every
   file), (e) rewrites its image PNGs Adam7-interlaced (`png_adam7_bytes`)
   and reads them back equal to the originals (timed), then
   `VolSeg2dTrainer(image_dir, label_dir, ...)` on the interlaced files and
   a trainer on the CLI's in-memory slices take `FORMATS_STEPS` seeded
   steps each: equal arrays and losses bit for bit, each kernel launched
   once a step; `clean_up_slices` leaves no file; (d) the 256^3 vessels
   volume written by `write_tiff` as PackBits uint8, float32 Deflate with
   predictor 3, LZMA uint8, fill order 2 uint8, 1-bit labels
   (`labels > 0`), an ImageJ `frames=256` stack, a shaped file with a
   second 64^3 series and a stack interleaved with 64x64 thumbnails, each
   read back equal to its first series (read s and MB/s), then
   `model-predict-2d` on the predictor-3 float32 file with the shipped
   settings: labels equal to the CLI phase's of the uint8 volume.
13a. Sides phase (run after the virtual phase, beside the parallel and
   spatial phases), in `<out-dir>/sides`: `model-train-2d` with the shipped
   settings but `type: DeepLabV3` (whose x8 head resizes the logits back)
   at `image_size: 100` (a side the CLAHE grid does not divide), 0+1
   epochs, seed 0, on a `SIDES_TRAIN_SHAPE` vessels pair: fails unless it
   trains that model at that side, every loss and eval score is finite and
   each kernel launched once a step.
14. Interchange phase, in `<out-dir>/interchange`, from the HDF5 fixtures
   h5py wrote (`tests/data/torch_hdf5/`, by `tests/torch_hdf5_fixtures.py`):
   every fixture reads equal to its array rebuilt here (`fixture_arrays`);
   seeded resnet34 (torchvision names) and efficientnet-b3 (lukemelas
   names) state_dicts saved as .pth files and converted by
   `scripts/convert_torch_encoder.py` into a weights directory; the B3
   cache loads bit for bit; `model-train-2d` with the shipped settings
   (U-Net/resnet34, 256, 1+1 epochs, `encoder_weights: imagenet` from the
   resnet34 cache) on `vessels.nxs`, whose data is an external link into a
   superblock 3 file (extensible array, shuffle, gzip, Fletcher-32), and the
   fixed-array labels: fails unless the encoder at creation equals the
   cache bit for bit, the frozen parameters keep their bits through the
   frozen epoch and each kernel launched once a step; `model-predict-2d`
   on `vessels.nxs` in memory and slab-streamed from a lazy source, and on
   the default-layout copy `utils/hdf5.write` makes: labels equal at every
   voxel; `spatial_partitions: 2` on one GPU raises the JAX package's
   ValueError.
15. Virtual phase, in `<out-dir>/virtual`, from the fixtures h5py wrote
   for the rest of what it reads (`VIRTUAL_READS`, `FIXTURE_OTHERS`): (a)
   each reads equal to its array rebuilt here (LZF behind shuffle and
   Fletcher-32, integer and float scale-offset, n-bit, external raw data
   found through $HDF5_EXTFILE_PREFIX=${ORIGIN}, a virtual dataset with
   sources in the same file, a sibling file, a missing file and another
   virtual dataset, the LZF tile, the stitched training pair, szip on the
   crop as bytes, as big-endian uint16 and as shuffled float32 and on the
   vessels pair, committed datatypes, 12-bit uint16 unfiltered and under
   n-bit, 11-bit int16 under n-bit, a virtual int8 dataset over uint8),
   the best of three reads timed (s and MB/s); (b) the
   512^3 virtual dataset of 512 mappings over the 64^3 LZF tile read
   whole, timed (s and MB/s), equal to the tile tiled, then read again as
   `LazyHDF5Volume` slabs of
   `VIRTUAL_SLAB` (each slab's s); (c) `model-train-2d` with the shipped
   settings (1+1 epochs, seed 0) on `stitched.nxs`, a NeXus virtual
   dataset stitched from an LZF half and an integer scale-offset half,
   and labels in integer scale-offset: fails unless every loss and eval
   score is finite, the frozen parameters keep their bits through the
   frozen epoch and each kernel launched once a step; (d)
   `model-predict-2d` from that checkpoint on the 256^3 virtual dataset
   over the tile in memory, slab-streamed from a lazy source (both
   thresholds below it) and from a gzip copy of the materialised volume
   written by `utils/hdf5.write`: labels equal at every voxel; then the
   same 256^3 volume as four Z blocks of `BLOCK_DEPTH` slices, each a file
   of the port's writer, under the committed %b virtual dataset
   `BLOCKS_VDS`: read whole equal to it (the best of three, s and MB/s),
   and `model-predict-2d` on it: labels equal to the gzip copy's; the
   committed unlimited virtual dataset `GROWING_VDS` read equal to its
   source, then to the source rewritten larger (its extent follows); (e)
   `model-train-2d` with the shipped settings (0+1 epochs, seed 0) on the
   vessels volume and labels as szip chunks (`vessels_szip.h5`,
   `vessels_labels_szip.h5`): every loss and eval score finite, each
   kernel launched once a step; then `model-predict-2d` from (c)'s
   checkpoint on the szip volume and on its gzip copy
   (`vessels_latest.h5`): labels equal at every voxel. (f) What the
   library writes beyond h5py's defaults (`OPTION_READS`): h5py's bool
   labels, a big-endian int16 enumeration, the crop in files of offsets
   and lengths of (4, 4), (8, 4), (4, 8) and (2, 2) bytes at superblock 0
   and 3, and unfiltered partial edge chunks under a fixed array, an
   extensible array and a version 2 B-tree, each equal to its array (the
   best of three reads, s and MB/s); then `model-train-2d` as (e) on the
   vessels volume in a (4, 4) file with unfiltered partial edge chunks
   (`vessels_sizes_44_edges.h5`) and the bool labels (`labels_bool.h5`):
   fails unless the trainer is handed (e)'s slices bit for bit, the
   checkpoint's label codes are label_val_False and label_val_True, the run
   writes every file (e)'s wrote, every loss and eval score is finite and
   each kernel launched once a step.
16. Train-batch sweep (`THROUGHPUT_TRAIN_BATCH`): `SWEEP_STEPS` timed
   `build_train_step` steps on one seeded batch at batches 12, 32, 64, 128
   and 256 (bf16, unfrozen), samples/s and peak memory; the smallest batch
   within 5% of the best samples/s is printed beside the configured one.
17. Parallel phase (run before the sweep, beside the spatial phase and the
   interchange, virtual and sides phases, from the slice phase's
   checkpoint), every rank a child process (`parallel.mesh.spawn_ranks`),
   so that no process group is left in this one; inputs in
   `<out-dir>/parallel`: (1) one NCCL rank at world size 1:
   `PARALLEL_STEPS_ONE` seeded data-parallel steps (U-Net/ResNet-34, 256,
   batch 12, bf16, augmentation on) give the plain `build_train_step`'s
   losses and final state bit for bit from the same weights and seeds,
   each kernel launched once a step; median step ms of both. (2) Two gloo
   ranks on cuda:0 (NCCL refuses two ranks on one GPU; gloo carries CUDA
   tensors through the host), float32, TF32 off, global batch 12, 6 rows a
   rank, augmentation on, `PARALLEL_STEPS_TWO` steps at
   `PARALLEL_LR_TWO`, every run under deterministic algorithms
   (`deterministic_algorithms`): losses within 1e-5 relative of one process on the
   global batch, the first step's gradients within 30x the one-process
   float32 noise against a float64 step (BatchNorm in float64 too), its
   running statistics within the larger of 1e-4 and 10x that noise, the
   parameters it moved clear of the two runs' difference within 1e-6, both
   ranks' states equal, each kernel launched once a step on each rank's 6
   rows; median step ms. (2b) In the same two ranks, a mesh over rank 0
   alone (`get_mesh(n_devices=1)`): rank 0's `SUBMESH_STEPS` steps on it,
   both runs under deterministic algorithms, equal one process's losses,
   first gradients and state after each step bit for bit, each kernel
   launched once a step, and rank 1's
   step raises ValueError naming that it is not in the mesh; rank 1 then
   waits for rank 0's runs at a barrier. (3) In the same two ranks, multi-host prediction:
   each sweeps half of the 256^3 vessels volume's Z slices from the
   checkpoint into its partial HDF5 file (labels, float16 max-probs,
   `global_start` / `global_slices`), stitched to equal the one-process Z
   sweep under the near-tie rule. (4) Then `model-train-2d` in the group
   on a 48x96x96 gzip HDF5 pair with the shipped settings (1+1 epochs,
   seed 0): one dated checkpoint and one CSV, the ranks' weights equal
   before every load, last eval score >= 0.5, each kernel launched once a
   step on each rank. (5) Where `torch.cuda.device_count() >= 2`, (2)-(4)
   again over NCCL across cuda:0 and cuda:1; otherwise the phase says it
   did not run them. (6) The predictor with `devices=["cuda:0", "cuda:0"]`
   at MEDIUM, float32, on the 256^3 volume against one device under the
   near-tie rule.
18. Spatial phase (run beside the interchange, virtual, sides, pretrained
   and parallel phases, so their times include its load), two gloo ranks
   sharing cuda:0 in child processes on a 1 data x 2 space mesh (image height
   split over the ranks, `parallel/spatial.py`), inputs in
   `<out-dir>/spatial`: (a) U-Net/ResNet-34 at 256x256, a global batch of
   12 Z slices of a vessels volume, augmentation on, float32, TF32 off,
   `SPATIAL_STEPS` steps at `SPATIAL_LR` against one process's plain step
   from the same state: as the parallel phase's (2) (losses within 1e-5
   relative, first-step gradients within 30x the one-process float32 noise
   against a float64 step, running statistics, moved parameters within
   1e-6, here on more than 10% of the elements), both ranks' states equal
   after every step, each kernel launched once a step on each rank; median
   step ms of both. (b) `SPATIAL_MEMORY`: at
   1024x1024, global batch 4, bf16, two steps on the two ranks and then in
   one process (plain step): each rank's `max_memory_allocated`, and the
   larger at most `SPATIAL_MEMORY_RATIO` of the one process's; each kernel
   launched once a step on each rank. (c) `model-train-2d` in the group
   with the shipped settings, `spatial_partitions: 2`, 0+1 epochs, on a
   `SPATIAL_TRAIN_SHAPE` gzip HDF5 pair (49 steps a rank): the ranks'
   weights equal before the load, one dated checkpoint and one CSV, finite
   eval scores, each kernel launched once a step on each rank; then the
   checkpoint through the one-process `model-predict-2d` on the training
   volume: labels of its shape (MeanIoU recorded). (d) `SPATIAL_PAIRS`,
   the other decoders on ResNet-34 and U-Net on the EfficientNet and
   ResNeSt encoders, at full width and 256x256, and DeepLabV3/ResNet-34 at
   252x252 and PAN/ResNet-34 at 254x254 (their heads resize the logits
   back to the input with half-pixel centres, row-sharded; K2 and K3 at
   sides the CLAHE grid does not divide), a global batch of
   `SPATIAL_PAIR_BATCH` Z slices, augmentation on, float32, from one
   seeded state each: `SPATIAL_PAIR_STEPS` train steps
   at `SPATIAL_LR` on the two ranks (dropout from one seeded generator),
   then the eval step
   (DiceLoss, MeanIoU) on the slices, against the one process's plain
   steps and eval step from the same state: the first loss within
   `SPATIAL_PAIR_RTOL` relative, or twice the one process's distance from
   its float64 loss where that is larger, the later ones within
   `SPATIAL_PAIR_LATER_RTOL`, eval loss and score within
   `SPATIAL_PAIR_EVAL_ATOL`, both ranks' states equal after every step,
   each kernel launched once a step on each rank; step ms of
   both and each rank's `max_memory_allocated`.
19. Prints a `{"kernels": [...]}` line (launches of the slice, CLI, losses,
   pretrained, architectures, encoders, formats, sides, interchange,
   virtual, parallel and spatial phases, the last two on every rank; times
   and errors at S=256) and, last, the device line.

Exits non-zero on any failure, without a GPU, and outside a checkout of the
repository (the package is imported from beside this file).
"""

import argparse
import concurrent.futures
import contextlib
import csv
import functools
import hashlib
import json
import logging
import lzma
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N, S = 12, 256  # parity batch and image size of the shipped settings
P = 256  # side of the prediction phase's vessels volume; timed at 2 P
CLI_TRAIN_SHAPE = (80, 288, 320)  # no side is S: every slice is resized
# The pretrained phase's run and the U-Net++ and EfficientNet-B3
# `model-train-2d` round trips, which hold no MeanIoU floor on a
# prediction: half the CLI pair's depth (132 steps a run, not 180). (The
# CLI phase's own run keeps its pair: trained on this one, its prediction
# of the 256^3 volume scored a MeanIoU of 0.489 against its 0.75 floor.)
ROUND_TRIP_SHAPE = (40, 144, 160)
PRED_BATCHES = (32, 128)  # (16, 32, 64, 128) before the spatial phase's (d)
CROP = (24, 72, 40)  # card against plain path: no side a multiple of 32
GPU_BANDWIDTH = (  # bytes/s by card name (NVIDIA data sheets)
    ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
    ("H100", 3.35e12),
)
L2_BYTES = 50e6  # H100 and H200 L2 cache (NVIDIA data sheets)
MIN_SETS, MIN_LAUNCHES = 8, 64  # rotating input sets and calls per timed run
MAX_SPIN_MS = 200.0  # longest GPU spin ahead of a timed run
LIBRARY_NOTES = {
    "K1": ("no single PyTorch call computes the same function: grid_sample "
           "(reflection, align_corners=True) is reflect-101 but takes no "
           "uint8 input and rounds the mask's nearest pick half to even; "
           "grid_sample_pair_ms times its two calls as a yardstick"),
    "K2": "no PyTorch call computes CLAHE",
    "K3": "no PyTorch call computes CLAHE",
}
LIBRARY_NOTES["K2_saturated"] = LIBRARY_NOTES["K2"]
GRID_SAMPLE_RTOL = 1e-3  # image values in [0, 1]; another border rule is off by ~0.1-1
# Sides the kernel phase also holds K1-K3 at (crops of the S batch), which
# the 8x8 CLAHE grid does not divide: S % 8 != 0 with S % 4 == 0 (K3's
# 16-byte path), odd (the scalar paths), and below 64, where a tile row's
# columns past 8 * tw reach past the next row's first tile. The run timer
# times K1-K3 at `TIMED_SIDES`.
KERNEL_SIDES = (252, 255, 23)
TIMED_SIDES = (S, 252)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    return next(bw for key, bw in GPU_BANDWIDTH if key in name)


def rotating_sets(args, bytes_per_call):
    """k copies of a call's tensor arguments, k >= 8 and k * bytes_per_call
    >= twice the L2, so that a run cycling through them finds every call's
    inputs out of L2, as the bound counts them (read once from HBM)."""
    k = max(MIN_SETS, math.ceil(2 * L2_BYTES / bytes_per_call))
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            for _ in range(k)]


@functools.cache
def sleep_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, arg_sets, repeats=5):
    """Device time of one call of `fn`: (median over `repeats` runs of the
    CUDA-event time of a run) / (calls in a run), and whether every run's
    timed interval held device work only.

    A run calls `fn` on each of the k argument sets in turn, r rounds,
    k * r >= MIN_LAUNCHES, keeping the last result of each set alive, so
    outputs rotate through k + 1 buffers as the inputs rotate through k.
    Before the start event a spin keeps the GPU busy for twice the host's
    enqueue time of a run (measured after a warm-up run; at most
    MAX_SPIN_MS), so the launches queue up behind it. If the start event
    has not completed when the host has queued the whole run, the interval
    holds no host dispatch; otherwise (a run of thousands of small launches
    can fill the launch queue and hold the host back) the time includes
    host waits, and the second value is False."""
    k = len(arg_sets)
    rounds = math.ceil(MIN_LAUNCHES / k)
    outs = [None] * k

    def run():
        for _ in range(rounds):
            for i, args in enumerate(arg_sets):
                outs[i] = fn(*args)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int(sleep_cycles_per_ms() * min(2 * host_ms + 1.0, MAX_SPIN_MS))
    times, hidden = [], True
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        run()
        end.record()
        hidden &= not start.query()
        end.synchronize()
        times.append(start.elapsed_time(end) / (k * rounds))
    return statistics.median(times), hidden


def make_vessel_volume(shape, n_vessels=40, seed=0):
    """Synthetic vessels volume: random-walk tubes over a noisy, slowly
    varying background (the generator of tools/make_tutorial_data.py,
    written for a non-cubic shape)."""
    rng = np.random.default_rng(seed)
    shape_a = np.array(shape, float)
    labels = np.zeros(shape, dtype=np.uint8)
    side = max(shape)
    for _ in range(n_vessels):
        pos = rng.uniform(shape_a * 0.1, shape_a * 0.9)
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        radius = rng.uniform(2.0, max(2.0, side / 40))
        for _ in range(int(side * 1.5)):
            direction += rng.normal(scale=0.15, size=3)
            direction /= np.linalg.norm(direction)
            pos = pos + direction * 2.0
            if (pos < radius).any() or (pos > shape_a - radius).any():
                break
            c = pos.astype(int)
            r = int(np.ceil(radius)) + 1
            sl = tuple(slice(max(c[i] - r, 0), min(c[i] + r + 1, shape[i]))
                       for i in range(3))
            zc, yc, xc = (np.arange(s.start, s.stop) for s in sl)
            d2 = ((zc[:, None, None] - pos[0]) ** 2
                  + (yc[None, :, None] - pos[1]) ** 2
                  + (xc[None, None, :] - pos[2]) ** 2)
            labels[sl] |= (d2 <= radius ** 2).astype(np.uint8)
    background = rng.normal(90, 18, shape)
    background += np.cumsum(rng.normal(0, 0.2, shape[0]))[:, None, None]
    background += np.cumsum(rng.normal(0, 0.2, shape[1]))[None, :, None]
    vessels = np.where(labels > 0, rng.normal(170, 12, shape), background)
    return np.clip(vessels, 0, 255).astype(np.uint8), labels


def three_axis_slices(vol):
    return ([s for s in vol] + [vol[:, i] for i in range(vol.shape[1])]
            + [vol[:, :, i] for i in range(vol.shape[2])])


def training_settings() -> SimpleNamespace:
    """volseg-settings/2d_model_train_settings.yaml as a dict (PyYAML is
    not needed), with the run cut to one frozen and one unfrozen epoch."""
    return SimpleNamespace(
        data_im_dirname="data", seg_im_out_dirname="seg",
        model_output_fn="trained_2d_model", clip_data=False,
        st_dev_factor=2.575, data_hdf5_path="/data", seg_hdf5_path="/data",
        training_axes="All", image_size=S, downsample=False,
        training_set_proportion=0.8, cuda_device=0,
        num_cyc_frozen=1, num_cyc_unfrozen=1, patience=3,
        loss_criterion="DiceLoss", alpha=0.75, beta=0.25, eval_metric="MeanIoU",
        pct_lr_inc=0.3, starting_lr=1e-6, end_lr=50, lr_find_epochs=1,
        lr_reduce_factor=500, plot_lr_graph=False,
        model={"type": "U_Net", "encoder_name": "resnet34",
               "encoder_weights": None},
        batch_size=N, compute_dtype="bfloat16", seed=0,
    )


def adversarial_coords(rng, dev, side=S):
    """Out of range by more than one reflect period, half-integer, and
    exact .5 fractions (mask pick is wy > 0.5, not round-half-even)."""
    c = np.empty((N, 2, side, side), np.float32)
    period = 2 * (side - 1)
    c[0:4] = rng.uniform(-2.5 * period, 2.5 * period, (4, 2, side, side))
    c[4:8] = rng.integers(-3 * side, 4 * side, (4, 2, side, side)) + 0.5
    c[8:12, 0] = rng.integers(0, side, (4, side, side)) + 0.5
    c[8:12, 1] = rng.uniform(-5.0, side + 4.0, (4, side, side))
    return torch.from_numpy(c).to(dev)


def field_of_view_cut(imgs):
    """Each sample with every pixel outside a centred disc of radius 0.45 S
    set to 0.0, as a micro-CT slice is outside its reconstruction's field of
    view after the data manager's st-dev clip: 36% of the pixels, and at
    S=256 12 of the 64 CLAHE tiles wholly, fall in bin 0."""
    s = imgs.shape[-1]
    yx = torch.arange(s, dtype=torch.float32, device=imgs.device) - (s - 1) / 2
    return imgs.masked_fill(yx[:, None] ** 2 + yx[None, :] ** 2 > (0.45 * s) ** 2,
                            0.0)


def kernel_inputs(images_u8, masks_u8, dev):
    """The kernels' inputs at the training path's shapes: coordinate fields
    from the port's augmentation draws and adversarial ones; the CLAHE batch
    (the warped images, the draws' clip limits, apply flags mixing 0 and 1)
    and the same batch cut to its field of view."""
    from volume_segmantics_tpu_torch.ops import augment as aug
    from volume_segmantics_tpu_torch.ops import warp as wp

    side = images_u8.shape[-1]
    gen = torch.Generator(dev).manual_seed(1)
    geo = aug.draw_geometric_params(gen, N, side, dev)
    inten = aug.draw_intensity_params(gen, N, dev)
    coord_sets = {
        "augment": aug.geometric_coords(geo, side).contiguous(),
        "adversarial": adversarial_coords(np.random.default_rng(2), dev, side),
    }
    imgs = torch.clamp(
        wp.warp_batch_u8(images_u8, masks_u8, coord_sets["augment"])[0], 0, 1)
    apply = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 0], dtype=torch.int32,
                         device=dev)
    n_on = int(apply.sum())
    return SimpleNamespace(
        coord_sets=coord_sets, imgs=imgs, saturated=field_of_view_cut(imgs),
        clips=inten["clip"].float().contiguous(), apply=apply, n_on=n_on,
        k2_bytes=n_on * side * side * 4 + N * 8 + n_on * 64 * 256,
    )


def copy_same_bytes_ms(nbytes, dev):
    """Yardstick, not a library call for the same function: PyTorch's copy
    of a float32 tensor that moves `nbytes` (read once, written once, rounded
    down to whole 64-byte lines: a copy of a size that is not a multiple of
    16 bytes takes a slower path), timed as the kernels are: what one launch
    of this size costs on this timer."""
    blob = torch.empty(nbytes // 128 * 16, dtype=torch.float32, device=dev)
    return time_ms(torch.clone, rotating_sets((blob,), nbytes))[0]


def kernel_checks(images_u8, masks_u8, dev):
    """Each kernel against its plain version on the `kernel_inputs` of a
    (N, side, side) batch: ({name: result}, {name: (kernel, plain, args,
    C entry)}, the inputs). At side S, K2 also on the batch cut to its
    field of view (`K2_saturated`)."""
    from volume_segmantics_tpu_torch.ops import clahe as cl
    from volume_segmantics_tpu_torch.ops import warp as wp

    side = images_u8.shape[-1]
    inp = kernel_inputs(images_u8, masks_u8, dev)
    entry = {k: e for k, _, e, _, _ in KERNELS}
    results, timed = {}, {}

    img_err, msk_bad = 0.0, 0
    for coords in inp.coord_sets.values():
        got = wp.warp_batch_u8(images_u8, masks_u8, coords)
        ref = wp.warp_pair_u8(images_u8, masks_u8, coords)
        torch.cuda.synchronize()
        img_err = max(img_err, (got[0] - ref[0]).abs().max().item())
        msk_bad += int((got[1] != ref[1]).sum())
    results["K1"] = dict(
        max_abs_err=img_err, mask_mismatches=msk_bad, tolerance=2e-7,
        ok=img_err <= 2e-7 and msk_bad == 0,
        bytes=N * side * side * (1 + 1 + 8 + 4 + 1),
    )
    timed["K1"] = (wp.warp_batch_u8, wp.warp_pair_u8,
                   (images_u8, masks_u8, inp.coord_sets["augment"]), entry["K1"])

    imgs, clips, apply = inp.imgs, inp.clips, inp.apply
    on = apply.bool()
    batches = (("K2", imgs),) + ((("K2_saturated", inp.saturated),)
                                 if side == S else ())
    for name, batch in batches:
        got = cl.clahe_luts(batch, clips, apply)
        ref = cl.clahe_luts_plain(batch, clips)
        torch.cuda.synchronize()
        lut_err = (got[on].int() - ref[on].int()).abs().max().item()
        results[name] = dict(max_abs_err=float(lut_err), tolerance=0.0,
                             ok=lut_err == 0, bytes=inp.k2_bytes)
        timed[name] = (cl.clahe_luts,
                       lambda im, c, _a: cl.clahe_luts_plain(im, c),
                       (batch, clips, apply), entry["K2"])
        if name == "K2":
            luts, ref_luts = got, ref

    out = cl.clahe_blend(imgs, apply, luts)
    ref = cl.clahe_blend_plain(imgs, apply, ref_luts)
    torch.cuda.synchronize()
    blend_err = (out - ref).abs().max().item()
    skipped_equal = bool(torch.equal(out[~on], imgs[~on]))
    results["K3"] = dict(
        max_abs_err=blend_err, skipped_bit_exact=skipped_equal, tolerance=1e-6,
        ok=blend_err <= 1e-6 and skipped_equal,
        bytes=N * side * side * 4 * 2 + N * 4 + inp.n_on * 64 * 256,
    )
    timed["K3"] = (cl.clahe_blend, cl.clahe_blend_plain, (imgs, apply, ref_luts),
                   entry["K3"])
    return results, timed, inp


def kernel_phase(images_u8, masks_u8, bw, dev):
    """Each kernel against its plain version at side S and at
    `KERNEL_SIDES` (the top-left crops of the batch), timed at
    `TIMED_SIDES`; returns per-kernel results, those of another side than
    S under "<name>@<side>"."""
    from volume_segmantics_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    results = {}
    for side in (S,) + KERNEL_SIDES:
        crop = [t[:, :side, :side].contiguous() for t in (images_u8, masks_u8)]
        checked, timed, inp = kernel_checks(*crop, dev)
        for name, r in checked.items():
            r["side"] = side
            if side in TIMED_SIDES:
                kernel_fn, plain_fn, args, kernel_entry = timed[name]
                sets = rotating_sets(args, r["bytes"])
                r["kernel_ms"], r["kernel_device_only"] = time_ms(kernel_fn, sets)
                r["plain_ms"], r["plain_device_only"] = time_ms(plain_fn, sets)
                r["timed_sets"] = len(sets)
                r["timed_calls"] = math.ceil(MIN_LAUNCHES / len(sets)) * len(sets)
                del sets
                r["copy_same_bytes_ms"] = copy_same_bytes_ms(r["bytes"], dev)
            r["bound_ms"] = r["bytes"] / bw * 1e3
            # comparisons and timing only
            r["launches"] = kernels.LAUNCHES[timed[name][3]]
            if name == "K1" and side == S:
                r.update(grid_sample_yardstick(*crop, inp.coord_sets, dev))
                if not r["grid_sample_ok"]:
                    r["ok"] = False
            key = name if side == S else f"{name}@{side}"
            print(json.dumps({"phase": "kernel", "kernel": key, **r,
                              "library_ms": None,
                              "library_note": LIBRARY_NOTES[name]}),
                  flush=True)
            results[key] = r
    return results


def grid_sample_pair(imgs_f, msks_f, grid):
    """`F.grid_sample` bilinear on the images and nearest on the masks,
    both with reflection padding and align_corners=True."""
    gs = torch.nn.functional.grid_sample
    return (gs(imgs_f, grid, "bilinear", "reflection", True),
            gs(msks_f, grid, "nearest", "reflection", True))


def grid_sample_yardstick(images_u8, masks_u8, coord_sets, dev):
    """K1's plain version against `grid_sample_pair` on float32 copies of
    its inputs: images within GRID_SAMPLE_RTOL on the augmentation's
    coordinates (reflect-101 borders), and mask mismatches counted (half
    to even against K1's wy > 0.5 at exact .5 fractions); then the pair
    timed as K1 is, a two-call yardstick that does not compute K1's
    function."""
    from volume_segmantics_tpu_torch.ops import warp as wp

    n, s, _ = images_u8.shape
    imgs_f = (images_u8.float() / 255.0)[:, None].contiguous()
    msks_f = masks_u8.float()[:, None].contiguous()
    r = {}
    for name, coords in coord_sets.items():
        grid = (torch.stack((coords[:, 1], coords[:, 0]), -1) * (2.0 / (s - 1))
                - 1.0).contiguous()
        gs_img, gs_msk = grid_sample_pair(imgs_f, msks_f, grid)
        ref_img, ref_msk = wp.warp_pair_u8(images_u8, masks_u8, coords)
        r[f"grid_sample_image_max_abs_err_{name}"] = (
            gs_img[:, 0] - ref_img).abs().max().item()
        r[f"grid_sample_mask_mismatches_{name}"] = int(
            (gs_msk[:, 0].to(torch.uint8) != ref_msk).sum())
        if name == "augment":
            timed_args = (imgs_f, msks_f, grid)
    r["grid_sample_ok"] = (r["grid_sample_image_max_abs_err_augment"]
                           <= GRID_SAMPLE_RTOL)
    nbytes = n * s * s * (4 + 4 + 8 + 4 + 4)
    sets = rotating_sets(timed_args, nbytes)
    r["grid_sample_pair_ms"], r["grid_sample_pair_device_only"] = time_ms(
        grid_sample_pair, sets)
    r["grid_sample_pair_bytes"] = nbytes
    return r


def slice_phase(dev, model_out: Path):
    """Trains through VolSeg2dTrainer; its checkpoint is written to
    `model_out`."""
    from volume_segmantics_tpu_torch.model import VolSeg2dTrainer
    from volume_segmantics_tpu_torch.model.model_2d import create_model_from_file
    from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
    from volume_segmantics_tpu_torch.ops import kernels

    class CheckedTrainer(VolSeg2dTrainer):
        """Records the encoder parameters of every model it creates."""

        def _create_model_and_optimiser(self, learning_rate, frozen=False):
            super()._create_model_and_optimiser(learning_rate, frozen)
            self.encoder_at_create = {
                n: p.detach().clone() for n, p in self.model.named_parameters()
                if n.startswith("encoder.")
            }

    t0 = time.perf_counter()
    data, labels = make_vessel_volume((64, S, S))
    settings = training_settings()
    trainer = CheckedTrainer(three_axis_slices(data), three_axis_slices(labels),
                             2, settings, device=dev)
    setup_s = time.perf_counter() - t0
    failures = []
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer.train_model(model_out, settings.num_cyc_frozen,
                        settings.patience, create=True, frozen=True)
    changed = [n for n, p in trainer.model.named_parameters()
               if n.startswith("encoder.")
               and not torch.equal(p.detach(), trainer.encoder_at_create[n])]
    if changed:
        failures.append(f"frozen encoder parameters changed: {changed[:3]}")
    trainer.train_model(model_out, settings.num_cyc_unfrozen,
                        settings.patience, create=False, frozen=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    ckpt = load_checkpoint(model_out)
    model, _, _ = create_model_from_file(model_out, device=dev)
    x = torch.randn(2, 1, S, S, generator=torch.Generator().manual_seed(0))
    model.eval()
    trainer.model.eval()
    with torch.no_grad():
        reload_equal = torch.equal(model(x.to(dev)), trainer.model(x.to(dev)))
        # The trained model on the card (float32, TF32 off) against the
        # same weights on the CPU: the port's plain reference path.
        cpu_model = create_model_from_file(model_out, device="cpu")[0].eval()
        small = x[:, :, :64, :64]
        ref = cpu_model(small)
        gpu_err = (model(small.to(dev)).cpu() - ref).abs().max().item()
    if not reload_equal:
        failures.append("checkpoint reload changed the model's forward")
    if set(ckpt) != {"model_state_dict", "model_struc_dict",
                     "optimizer_state_dict", "loss_val", "label_codes"}:
        failures.append(f"checkpoint keys {sorted(ckpt)}")
    ref_scale = max(1.0, ref.abs().max().item())
    if not gpu_err <= 1e-3 * ref_scale:
        failures.append(f"GPU forward differs from CPU by {gpu_err}")

    losses = trainer.avg_train_losses + trainer.avg_valid_losses
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite losses {losses}")
    for name, count in launches.items():
        if count != trainer.train_steps:
            failures.append(f"{name} launched {count} times in "
                            f"{trainer.train_steps} train steps")
    epoch_samples = sum(trainer.epoch_train_steps) * N
    summary = {
        "phase": "slice",
        "slices": len(trainer.training_loader.images),
        "train_batches_per_epoch": len(trainer.training_loader),
        "train_steps": trainer.train_steps,
        "median_step_ms": 1e3 * statistics.median(trainer.lr_find_step_seconds),
        "epoch_samples_per_s": epoch_samples / sum(trainer.epoch_train_seconds),
        "peak_memory_gib": peak / 2**30,
        "avg_train_losses": trainer.avg_train_losses,
        "final_valid_loss": trainer.avg_valid_losses[-1],
        "final_mean_iou": trainer.avg_eval_scores[-1],
        "setup_s": setup_s,
        "train_s": train_s,
        "gpu_vs_cpu_forward_max_abs_err": gpu_err,
        "launches": launches,
        "failures": failures,
    }
    print(json.dumps(summary), flush=True)
    return summary


def prediction_settings(**overrides) -> SimpleNamespace:
    """volseg-settings/2d_model_predict_settings.yaml as a namespace."""
    settings = dict(
        quality="medium", output_probs=False, clip_data=True,
        st_dev_factor=2.575, data_hdf5_path="/data", cuda_device=0,
        downsample=False, one_hot=False, prediction_axis="Z",
        compute_dtype="bfloat16",
    )
    settings.update(overrides)
    return SimpleNamespace(**settings)


def volume_mean_iou(labels, truth, dev) -> float:
    """The port's MeanIoU of a 2-class label volume against its truth."""
    from volume_segmantics_tpu_torch.data.metrics import mean_iou

    def one_hot(vol):
        t = torch.from_numpy(vol).to(dev).long()
        return torch.nn.functional.one_hot(t, 2).permute(3, 0, 1, 2)[None]

    return mean_iou(one_hot(labels).float(), one_hot(truth)).item()


def merge_max_prob(sweeps):
    """numpy merge of (labels, probs) pairs in order: strictly greater wins,
    a tie keeps the earlier sweep."""
    labels, probs = sweeps[0]
    for lab, prob in sweeps[1:]:
        take = prob > probs
        labels, probs = np.where(take, lab, labels), np.where(take, prob, probs)
    return labels, probs


def near_tie_check(name, got, ref):
    """The card's (labels, probs) against the plain path's: LOW labels equal
    wherever the reference's max probability exceeds 0.5 + 1e-4; MEDIUM and
    HIGH labels equal on >= 99.9% of voxels, each other voxel a near-tie;
    float16 max probabilities within 1e-3 everywhere."""
    (lab, prob), (ref_lab, ref_prob) = got, ref
    prob_err = np.abs(prob.astype(np.float32) - ref_prob.astype(np.float32))
    differ = lab != ref_lab
    res = {"label_agreement": float(1.0 - differ.mean()),
           "max_prob_abs_err": float(prob_err.max())}
    if name == "LOW":
        ok = not (differ & (ref_prob.astype(np.float32) > 0.5 + 1e-4)).any()
    else:
        ok = res["label_agreement"] >= 0.999 and (prob_err[differ] <= 1e-3).all()
    res["ok"] = bool(ok and res["max_prob_abs_err"] <= 1e-3
                     and lab.dtype == np.uint8 and prob.dtype == np.float16)
    return res


def timed_predict(manager, quality, dev, batch=None):
    """Seconds from the ndarray handed in to labels on the host, with the
    slices swept, peak device memory and the batch the run ended at."""
    from volume_segmantics_tpu_torch.utils.base_data_utils import Quality

    if batch is not None:
        manager.predictor.batch_size = batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    labels = manager.predict_volume_to_path(None, quality)
    seconds = time.perf_counter() - t0
    sweeps = {Quality.MEDIUM: 3, Quality.HIGH: 8}[quality]
    return labels, {
        "seconds": seconds,
        "voxels_per_s": labels.size / seconds,
        "slices_per_s": sweeps * labels.shape[0] / seconds,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "batch": manager.predictor.batch_size,
    }


def predict_phase(model_file: Path, dev):
    """3-D prediction with the trained checkpoint (see the module doc)."""
    from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
        VolSeg2dPredictor,
    )
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.utils.base_data_utils import Axis, Quality

    launches_before = dict(kernels.LAUNCHES)
    failures, res = [], {"phase": "predict"}
    data, truth = make_vessel_volume((P, P, P), seed=7)

    # 1. Correctness: the shipped settings (MEDIUM, bf16, clip_data on).
    t0 = time.perf_counter()
    manager = VolSeg2DPredictionManager(model_file, data, prediction_settings(),
                                        device=dev)
    res["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = manager.predict_volume_to_path(None)
    res["medium_256_first_call_s"] = time.perf_counter() - t0
    res["mean_iou"] = volume_mean_iou(labels, truth, dev)
    res["mean_iou_all_background"] = volume_mean_iou(np.zeros_like(truth),
                                                     truth, dev)
    if not (labels.shape == data.shape and labels.dtype == np.uint8):
        failures.append(f"MEDIUM labels {labels.shape} {labels.dtype}")
    if not res["mean_iou"] >= 0.75:
        failures.append(f"MEDIUM MeanIoU {res['mean_iou']} < 0.75")
    vol = manager.data_vol  # clipped to uint8

    # 2. Internal consistency: MEDIUM is the merge of the three LOW sweeps.
    predictor = manager.predictor
    lows = [predictor._predict_single_axis(vol, True, axis)
            for axis in (Axis.Z, Axis.Y, Axis.X)]
    med_labels, med_probs = predictor._predict_3_ways_max_probs(vol, True)
    ref_labels, ref_probs = merge_max_prob(lows)
    res["medium_equals_low_merge"] = bool(
        np.array_equal(med_labels, ref_labels)
        and np.array_equal(med_probs, ref_probs))
    res["medium_repeatable"] = bool(np.array_equal(med_labels, labels))
    if not res["medium_equals_low_merge"]:
        failures.append("MEDIUM differs from the merge of the LOW sweeps")
    if not res["medium_repeatable"]:
        failures.append("two MEDIUM runs gave different labels")

    # 3. Card against plain path, float32 (TF32 is off), on a crop.
    f32 = prediction_settings(compute_dtype="float32")
    crop = np.ascontiguousarray(vol[:CROP[0], :CROP[1], :CROP[2]])
    on_card = VolSeg2dPredictor(model_file, f32, device=dev)
    on_cpu = VolSeg2dPredictor(model_file, f32, device="cpu")
    for name, method in (("LOW", "_predict_single_axis"),
                         ("MEDIUM", "_predict_3_ways_max_probs"),
                         ("HIGH", "_predict_12_ways_max_probs")):
        r = near_tie_check(name, getattr(on_card, method)(crop),
                           getattr(on_cpu, method)(crop))
        res[f"card_vs_cpu_{name}"] = r
        if not r["ok"]:
            failures.append(f"{name} on the card against the CPU: {r}")
    f32_labels = on_card._predict_3_ways_max_probs(vol, False)[0]
    res["bf16_vs_f32_medium_agreement"] = float((f32_labels == labels).mean())
    if not res["bf16_vs_f32_medium_agreement"] >= 0.99:
        failures.append(f"bf16 MEDIUM agrees with float32 on "
                        f"{res['bf16_vs_f32_medium_agreement']} < 0.99")
    del on_card, on_cpu, f32_labels, lows

    # 5. Times at 512^3 (content does not change the time).
    big = np.tile(vol, (2, 2, 2))
    timed = VolSeg2DPredictionManager(
        model_file, big, prediction_settings(clip_data=False), device=dev)
    res["default_batch"] = timed.predictor.batch_size
    timed_labels = {}
    for quality in (Quality.MEDIUM, Quality.HIGH):
        timed_predict(timed, quality, dev)  # warm-up: cuDNN plans, allocator
        out, r = timed_predict(timed, quality, dev)
        res[f"{quality.name.lower()}_512"] = r
        timed_labels[quality] = out
        if not (out.shape == big.shape and out.dtype == np.uint8):
            failures.append(f"{quality.name} 512^3 labels {out.shape} {out.dtype}")
    # MEDIUM from the raw 512^3 volume as a user hands it in: the manager's
    # set-up (checkpoint loaded, clip_to_uint8 on the host) and the sweeps.
    raw = np.tile(data, (2, 2, 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from_raw = VolSeg2DPredictionManager(model_file, raw, prediction_settings(),
                                         device=dev)
    setup_s = time.perf_counter() - t0
    out = from_raw.predict_volume_to_path(None)
    seconds = time.perf_counter() - t0
    res["medium_512_from_raw"] = {
        "setup_s": setup_s, "predict_s": seconds - setup_s,
        "seconds": seconds, "voxels_per_s": out.size / seconds,
        "batch": from_raw.predictor.batch_size,
        "label_agreement": float((out == timed_labels[Quality.MEDIUM]).mean()),
    }
    if not res["medium_512_from_raw"]["label_agreement"] >= 0.999:
        failures.append(f"MEDIUM 512^3 from the raw volume: "
                        f"{res['medium_512_from_raw']}")
    del raw, from_raw, out, timed_labels
    sweep = {}
    for batch in PRED_BATCHES:
        timed_predict(timed, Quality.MEDIUM, dev, batch)
        runs = [timed_predict(timed, Quality.MEDIUM, dev, batch)[1]
                for _ in range(3)]
        sweep[batch] = dict(sorted(runs, key=lambda r: r["seconds"])[1],
                            all_seconds=[r["seconds"] for r in runs])
    res["medium_512_batch_sweep"] = sweep
    fits = [b for b, r in sweep.items() if r["batch"] == b]
    res["fastest_batch"] = min(fits, key=lambda b: sweep[b]["seconds"])

    # 4. Prediction launches none of the augmentation kernels.
    res["kernel_launches"] = {k: kernels.LAUNCHES[k] - launches_before[k]
                              for k in kernels.LAUNCHES}
    if any(res["kernel_launches"].values()):
        failures.append(f"prediction launched kernels {res['kernel_launches']}")
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


def settings_text(name, **edits) -> str:
    """A shipped settings file of this checkout as text, with `key: value`
    lines replaced (or appended where the file lacks the key)."""
    text = (REPO / "volseg-settings" / name).read_text()
    for key, value in edits.items():
        line = f"{key}: {value}"
        text, n = re.subn(rf"(?m)^{key}:.*$", line, text)
        if not n:
            text = text.rstrip("\n") + f"\n{line}\n"
    return text


@contextlib.contextmanager
def timed_spans(targets):
    """Wraps each (owner, attribute, span) of `targets` so that its calls
    add their wall seconds to `spans[span]`; yields `spans` and restores
    the attributes on exit."""
    spans, saved = {}, []

    def wrap(fn, span):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[span] = spans.get(span, 0.0) + time.perf_counter() - t0
        return timed

    for owner, attr, span in targets:
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, wrap(getattr(owner, attr), span))
    try:
        yield spans
    finally:
        for owner, attr, original in saved:
            setattr(owner, attr, original)


def cli_phase(dev, out_dir: Path):
    """Both console entry points, in process, from HDF5 files and settings
    files the port writes (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.data import get_settings_data
    from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager
    from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
    from volume_segmantics_tpu_torch.model.operations import vol_seg_2d_predictor
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import predict_2d_model, train_2d_model
    from volume_segmantics_tpu_torch.utils import base_data_utils, hdf5

    failures, res = [], {"phase": "cli"}
    root = out_dir / "cli"
    shutil.rmtree(root, ignore_errors=True)
    settings_dir = root / cfg.SETTINGS_DIR
    settings_dir.mkdir(parents=True)

    # 1. Inputs: a training pair (gzip, chunks=True) and the shipped
    # settings files, cut to one frozen and one unfrozen epoch.
    t0 = time.perf_counter()
    data, labels = make_vessel_volume(CLI_TRAIN_SHAPE, seed=2)
    hdf5.write(root / "train_data.h5", data, chunks=True)
    hdf5.write(root / "train_labels.h5", labels, chunks=True)
    data, labels = make_vessel_volume(ROUND_TRIP_SHAPE, seed=2)
    hdf5.write(root / "round_trip_data.h5", data, chunks=True)
    hdf5.write(root / "round_trip_labels.h5", labels, chunks=True)
    (settings_dir / cfg.TRAIN_SETTINGS_FN).write_text(settings_text(
        cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=1, num_cyc_unfrozen=1, seed=0))
    (settings_dir / cfg.PREDICTION_SETTINGS_FN).write_text(settings_text(
        cfg.PREDICTION_SETTINGS_FN, output_probs=True))
    res["inputs_s"] = time.perf_counter() - t0
    del data, labels

    # 2. model-train-2d on the card.
    trainers = []

    class RecordedTrainer(train_2d_model.VolSeg2dTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    train_2d_model.VolSeg2dTrainer = RecordedTrainer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_2d_model.main(["--data", str(root / "train_data.h5"),
                             "--labels", str(root / "train_labels.h5"),
                             "--data_dir", str(root)])
    finally:
        train_2d_model.VolSeg2dTrainer = RecordedTrainer.__bases__[0]
    torch.cuda.synchronize()
    res["train_main_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    trainer = trainers[0]
    ckpt = train_2d_model._model_output_path(trainer.settings, root)
    stats = root / f"{ckpt.stem}_train_stats.csv"
    for path in (ckpt, stats):
        if not path.exists():
            failures.append(f"model-train-2d wrote no {path.name}")
    with open(stats, newline="") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in ("Train Loss", "Valid Loss")]
    eval_scores = [float(r["Eval Score"]) for r in rows]
    epoch_samples = sum(trainer.epoch_train_steps) * trainer.training_loader.batch_size
    res.update({
        "checkpoint": ckpt.name, "csv_rows": len(rows),
        "slices": len(trainer.training_loader.images),
        "batch_size": trainer.training_loader.batch_size,
        "train_steps": trainer.train_steps,
        "median_lr_find_step_ms": 1e3 * statistics.median(trainer.lr_find_step_seconds),
        "epoch_samples_per_s": epoch_samples / sum(trainer.epoch_train_seconds),
        "losses": losses, "eval_scores": eval_scores, "launches": launches,
    })
    if len(rows) != 2 or not all(np.isfinite(losses)):
        failures.append(f"train-stats CSV: {len(rows)} epochs, losses {losses}")
    if not eval_scores or not eval_scores[-1] >= 0.5:
        failures.append(f"last eval score {eval_scores} < 0.5")
    for name, count in launches.items():
        if count != trainer.train_steps:
            failures.append(f"{name} launched {count} times in the CLI's "
                            f"{trainer.train_steps} train steps")
    del trainers, trainer

    # 3. model-predict-2d with output_probs on the 256^3 vessels volume,
    # against the manager on the same ndarray.
    vol, truth = make_vessel_volume((P, P, P), seed=7)
    hdf5.write(root / "vessels_256.h5", vol, chunks=True)
    t0 = time.perf_counter()
    predict_2d_model.main([str(ckpt), str(root / "vessels_256.h5"),
                           "--data_dir", str(root)])
    res["predict_256_main_s"] = time.perf_counter() - t0
    out = predict_2d_model.create_output_path(root, Path("vessels_256.h5"))
    cli_labels, res["output_chunks"] = hdf5.read(out)
    probs, _ = hdf5.read(out.with_name(f"{out.stem}_probs.h5"))
    settings = get_settings_data(settings_dir / cfg.PREDICTION_SETTINGS_FN,
                                 kind="prediction")
    ref = VolSeg2DPredictionManager(ckpt, vol, settings,
                                    device=dev).predict_volume_to_path(None)
    res["labels_equal_manager"] = bool(np.array_equal(cli_labels, ref))
    res["mean_iou"] = volume_mean_iou(cli_labels, truth, dev)
    res["probs"] = {"dtype": str(probs.dtype), "shape": list(probs.shape),
                    "min": float(probs.min()), "max": float(probs.max())}
    if not res["labels_equal_manager"]:
        failures.append("model-predict-2d labels differ from the manager's")
    if not res["mean_iou"] >= 0.75:
        failures.append(f"model-predict-2d MeanIoU {res['mean_iou']} < 0.75")
    if probs.dtype != np.float16 or probs.shape != vol.shape:
        failures.append(f"max-prob sidecar {probs.dtype} {probs.shape}")
    del cli_labels, probs, ref, truth

    # 4. model-predict-2d end to end on the raw 512^3 volume (gzip, chunks
    # True), with the shipped prediction settings as written.
    shipped = root / "shipped"
    (shipped / cfg.SETTINGS_DIR).mkdir(parents=True)
    (shipped / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN).write_text(
        settings_text(cfg.PREDICTION_SETTINGS_FN))
    raw = np.tile(vol, (2, 2, 2))
    big = shipped / "vessels_512.h5"
    t0 = time.perf_counter()
    hdf5.write(big, raw, chunks=True)
    input_write_s = time.perf_counter() - t0
    raw_mb, big_mb = raw.nbytes / 1e6, big.stat().st_size / 1e6
    del raw, vol
    spans_of = ((base_data_utils, "get_numpy_from_path", "hdf5_read_s"),
                (BaseDataManager, "_preprocess_data", "setup_clip_s"),
                (vol_seg_2d_predictor, "create_model_from_file", "checkpoint_load_s"),
                (vol_seg_2d_predictor.VolSeg2dPredictor,
                 "_predict_3_ways_max_probs", "sweeps_s"),
                (base_data_utils, "save_data_to_hdf5", "hdf5_write_s"))
    with timed_spans(spans_of) as spans:
        t0 = time.perf_counter()
        predict_2d_model.main([str(ckpt), str(big), "--data_dir", str(shipped)])
        spans["main_s"] = time.perf_counter() - t0
    out = predict_2d_model.create_output_path(shipped, big)
    labels_512, _ = hdf5.read(out)
    out_mb = out.stat().st_size / 1e6
    res["predict_512"] = dict(
        spans, other_s=spans["main_s"] - sum(v for k, v in spans.items()
                                             if k != "main_s"),
        input_mb=raw_mb, input_file_mb=big_mb, output_file_mb=out_mb,
        hdf5_read_mb_per_s=raw_mb / spans["hdf5_read_s"],
        hdf5_write_mb_per_s=labels_512.nbytes / 1e6 / spans["hdf5_write_s"],
        input_write_s=input_write_s,
        input_write_mb_per_s=raw_mb / input_write_s,
    )
    if labels_512.shape != (2 * P,) * 3 or labels_512.dtype != np.uint8:
        failures.append(f"512^3 labels {labels_512.shape} {labels_512.dtype}")
    big.unlink()
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# TIFF writer (the formats phase's inputs; the port only reads TIFF)
# ---------------------------------------------------------------------------

LZW_CLEAR, LZW_EOI = 256, 257


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes of 9 to 12 bits,
    widened one code early, a Clear code first and whenever the table
    reaches 4094 entries, an EOI code last."""
    codes, clears = [LZW_CLEAR], [0]
    table, next_code, prefix = {}, 258, -1
    for ch in data:
        if prefix < 0:
            prefix = ch
            continue
        code = table.get((prefix << 8) | ch)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        table[(prefix << 8) | ch] = next_code
        next_code += 1
        prefix = ch
        if next_code == 4094:
            clears.append(len(codes))
            codes.append(LZW_CLEAR)
            table, next_code = {}, 258
    if prefix >= 0:
        codes.append(prefix)
        if next_code + 1 == 4094:
            clears.append(len(codes))
            codes.append(LZW_CLEAR)
    codes.append(LZW_EOI)
    codes = np.asarray(codes, np.int64)
    # A code's width follows its index since the last Clear before it.
    index = np.arange(len(codes))
    after = np.asarray(clears) + 1
    start = np.zeros(len(codes) + 1, np.int64)
    start[after] = after
    j = index - np.maximum.accumulate(start[:-1])
    width = np.select([j <= 253, j <= 765, j <= 1789], [9, 10, 11], 12)
    shifts = np.arange(11, -1, -1)
    bits = (codes[:, None] >> shifts) & 1
    return np.packbits(bits[shifts[None, :] < width[:, None]].astype(np.uint8)).tobytes()


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats (at most 128
    each), the bytes between them as literals (at most 128 each)."""
    a = np.frombuffer(data, np.uint8)
    if not a.size:
        return b""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(a)) + 1])
    lengths = np.diff(np.concatenate([starts, [a.size]]))
    long = lengths >= 3
    out = []

    def literal(lo, hi):
        for at in range(lo, hi, 128):
            n = min(128, hi - at)
            out.append(bytes([n - 1]) + data[at:at + n])

    done = 0
    for start, length in zip(starts[long].tolist(), lengths[long].tolist()):
        literal(done, start)
        for at in range(start, start + length, 128):
            n = min(128, start + length - at)
            if n < 3:  # a tail too short to repeat
                literal(at, at + n)
            else:
                out.append(bytes([257 - n, data[at]]))
        done = start + length
    literal(done, a.size)
    return b"".join(out)


def float_predictor_encode(part: np.ndarray) -> np.ndarray:
    """TIFF predictor 3 on (rows, cols) floating-point samples: each row's
    byte planes, most significant first, each byte differenced from the
    one before it. Returns (rows, cols * itemsize) uint8."""
    rows, cols = part.shape
    size = part.dtype.itemsize
    big = np.ascontiguousarray(part, part.dtype.newbyteorder(">")).view(np.uint8)
    planes = big.reshape(rows, cols, size).transpose(0, 2, 1).reshape(rows, -1)
    return np.diff(planes, axis=1, prepend=np.zeros((rows, 1), np.uint8))


REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
TIFF_COMPRESSIONS = {None: 1, "lzw": 5, "deflate": 8, "packbits": 32773,
                     "lzma": 34925}


def write_tiff(path: Path, vol, compression=None, predictor=1,
               bigtiff=False, byteorder="<", tile=None, rows_per_strip=None,
               imagej=False, extra_tags=None, bits=None, fill_order=1,
               descriptions=None) -> None:
    """Write pages, a (pages, H, W) array or a sequence of 2-D arrays of
    any sizes and one type, as a multipage TIFF, one sample per pixel:
    `compression` None, "deflate" (8), "lzw" (5), "packbits" (32773) or
    "lzma" (34925); `predictor` 2 differences each row, 3 (floating-point
    samples) each row's byte planes; `bits` 1, 2 or 4 packs the samples
    (values below 2**bits; bool for 1), each row padded to a byte;
    `fill_order` 2 reverses the bits of every stored byte; `tile`
    (length, width) stores tiles, else strips of `rows_per_strip` rows
    (default: about 64 KB); `imagej` writes one IFD naming `images=N`
    before N contiguous uncompressed pages, as ImageJ writes stacks above
    4 GB; `descriptions` {page index: bytes} gives pages an
    ImageDescription. `extra_tags` {tag: (field type, values)} adds or
    replaces entries of every page. Identical blocks are compressed once."""
    pages = list(vol)
    dtype = np.dtype(pages[0].dtype).newbyteorder(byteorder)
    if bits is not None:
        dtype = np.dtype(np.uint8)
    off_fmt, off_type, inline = ("Q", 16, 8) if bigtiff else ("I", 4, 4)
    compress = {None: bytes, "deflate": lambda b: zlib.compress(b, 6),
                "lzw": lzw_encode, "packbits": packbits_encode,
                "lzma": lzma.compress}[compression]

    def encode(raw):
        data = compress(raw)
        return data.translate(REVERSED_BITS) if fill_order == 2 else data

    def stored(part):
        """A block's bytes before compression."""
        if bits is not None:
            shifts = np.arange(8 - bits, -1, -bits)
            cols = -(-part.shape[1] * bits // 8) * 8 // bits
            wide = np.zeros((part.shape[0], cols), np.uint8)
            wide[:, :part.shape[1]] = part
            wide = wide.reshape(part.shape[0], -1, 8 // bits) << shifts
            return wide.sum(axis=2, dtype=np.uint8).tobytes()
        if predictor == 2:
            part = np.diff(part, axis=1, prepend=np.zeros((part.shape[0], 1),
                                                          part.dtype))
        if predictor == 3:
            return float_predictor_encode(part).tobytes()
        return np.ascontiguousarray(part, dtype).tobytes()

    out = bytearray(b"II" if byteorder == "<" else b"MM")
    out += struct.pack(byteorder + ("HHHQ" if bigtiff else "HI"),
                       *((43, 8, 0, 0) if bigtiff else (42, 0)))
    next_ptr, cache = len(out) - inline, {}
    for z in range(1 if imagej else len(pages)):
        height, width = pages[z].shape
        row_bytes = -(-width * (bits or 8 * dtype.itemsize) // 8)
        if imagej:
            rows, boxes = height, []
        elif tile is None:
            rows = rows_per_strip or max(1, 65536 // row_bytes)
            boxes = [(r, 0, min(rows, height - r), width)
                     for r in range(0, height, rows)]
        else:
            boxes = [(r, c, *tile) for r in range(0, height, tile[0])
                     for c in range(0, width, tile[1])]
        tags = {256: (4, [width]), 257: (4, [height]),
                258: (3, [bits or 8 * dtype.itemsize]),
                259: (3, [TIFF_COMPRESSIONS[compression]]),
                262: (3, [1]), 277: (3, [1]), 284: (3, [1]),
                339: (3, [{"u": 1, "b": 1, "i": 2, "f": 3}[dtype.kind]])}
        if predictor != 1:
            tags[317] = (3, [predictor])
        if fill_order != 1:
            tags[266] = (3, [fill_order])
        if imagej:
            tags[270] = (2, f"ImageJ=1.54f\nimages={len(pages)}\n"
                            f"slices={len(pages)}\n".encode())
        if descriptions and z in descriptions:
            tags[270] = (2, descriptions[z])
        offsets, counts = [], []
        if imagej:  # every page's bytes, one after another
            offsets.append(len(out))
            out += np.ascontiguousarray(np.stack(pages), dtype).tobytes()
            counts.append(height * width * dtype.itemsize)
        for r, c, nr, nc in boxes:
            part = np.zeros((nr, nc), pages[z].dtype)  # tiles past the edge: zeros
            src = pages[z][r:r + nr, c:c + nc]
            part[:src.shape[0], :src.shape[1]] = src
            raw = stored(part)
            if raw not in cache:
                cache[raw] = encode(raw)
            offsets.append(len(out))
            out += cache[raw]
            counts.append(len(cache[raw]))
        if tile is None:
            tags.update({273: (off_type, offsets), 278: (4, [rows]),
                         279: (off_type, counts)})
        else:
            tags.update({322: (4, [tile[1]]), 323: (4, [tile[0]]),
                         324: (off_type, offsets), 325: (off_type, counts)})
        tags.update(extra_tags or {})
        # Values that do not fit an entry go first (word-aligned), then
        # the IFD, whose offset goes into the previous IFD's link.
        entries = []
        for tag in sorted(tags):
            ftype, values = tags[tag]
            payload = (bytes(values) + b"\0" if ftype == 2 else struct.pack(
                f"{byteorder}{len(values)}{ {1: 'B', 3: 'H', 4: 'I', 16: 'Q'}[ftype]}",
                *values))
            count = len(payload) // {1: 1, 2: 1, 3: 2, 4: 4, 16: 8}[ftype]
            if len(payload) > inline:
                out += b"\0" * (len(out) % 2)
                at = len(out)
                out += payload
                payload = struct.pack(byteorder + off_fmt, at)
            entries.append(struct.pack(byteorder + ("HHQ" if bigtiff else "HHI"),
                                       tag, ftype, count) + payload.ljust(inline, b"\0"))
        out += b"\0" * (len(out) % 2)
        struct.pack_into(byteorder + off_fmt, out, next_ptr, len(out))
        out += struct.pack(byteorder + ("Q" if bigtiff else "H"), len(entries))
        out += b"".join(entries)
        next_ptr = len(out)
        out += struct.pack(byteorder + off_fmt, 0)
    Path(path).write_bytes(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def png_adam7_bytes(image: np.ndarray) -> bytes:
    """An 8-bit grey PNG of a 2-D uint8 array, Adam7-interlaced: each of
    the seven passes' rows filtered with Up on its own."""
    height, width = image.shape
    body = []
    for x0, y0, dx, dy in ADAM7:
        part = image[y0::dy, x0::dx]
        if not part.size:
            continue
        rows = np.empty((part.shape[0], 1 + part.shape[1]), np.uint8)
        rows[:, 0] = 2  # Up
        rows[0, 1:] = part[0]
        np.subtract(part[1:], part[:-1], out=rows[1:, 1:])
        body.append(rows.tobytes())

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return b"".join([b"\x89PNG\r\n\x1a\n",
                     chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 0,
                                                0, 0, 1)),
                     chunk(b"IDAT", zlib.compress(b"".join(body), 1)),
                     chunk(b"IEND", b"")])


FORMATS_STEPS = 10  # 20 before the spatial phase's (d)


def formats_phase(dev, out_dir: Path, cli_res):
    """TIFF volumes through both CLIs, a 512^3 volume's read time by file
    format, and the PNG-directory library path (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.data import TrainingDataSlicer, get_settings_data
    from volume_segmantics_tpu_torch.data.datasets import get_2d_training_dataset
    from volume_segmantics_tpu_torch.data.dataloaders import to_device_batches
    from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel.train import autocast, normalise
    from volume_segmantics_tpu_torch.scripts import predict_2d_model, train_2d_model
    from volume_segmantics_tpu_torch.utils import figures, hdf5, png, tiff

    failures, res = [], {"phase": "formats"}
    root, cli_root = out_dir / "formats", out_dir / "cli"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cli_root / cfg.SETTINGS_DIR, root / cfg.SETTINGS_DIR)
    launches, steps = dict.fromkeys(kernels.LAUNCHES, 0), 0
    t_phase = time.perf_counter()

    # (a) model-train-2d on the CLI phase's pair as TIFF files: Deflate
    # with predictor 2 (data) and uncompressed BigTIFF (labels).
    data, _ = hdf5.read(cli_root / "train_data.h5")
    labels, _ = hdf5.read(cli_root / "train_labels.h5")
    write_tiff(root / "train_data.tif", data, compression="deflate", predictor=2)
    write_tiff(root / "train_labels.tiff", labels, bigtiff=True)
    del data, labels
    trainers = []

    class RecordedTrainer(train_2d_model.VolSeg2dTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    train_2d_model.VolSeg2dTrainer = RecordedTrainer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_2d_model.main(["--data", str(root / "train_data.tif"),
                             "--labels", str(root / "train_labels.tiff"),
                             "--data_dir", str(root)])
    finally:
        train_2d_model.VolSeg2dTrainer = RecordedTrainer.__bases__[0]
    torch.cuda.synchronize()
    res["train_main_s"] = time.perf_counter() - t0
    trainer = trainers[0]
    for name, count in kernels.LAUNCHES.items():
        launches[name] += count
        if count != trainer.train_steps:
            failures.append(f"{name} launched {count} times in the TIFF CLI's "
                            f"{trainer.train_steps} train steps")
    steps += trainer.train_steps
    ckpt = train_2d_model._model_output_path(trainer.settings, root)
    with open(root / f"{ckpt.stem}_train_stats.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in ("Train Loss", "Valid Loss")]
    eval_scores = [float(r["Eval Score"]) for r in rows]
    got = load_checkpoint(ckpt)["model_state_dict"]
    ref = load_checkpoint(cli_root / cli_res["checkpoint"])["model_state_dict"]
    res["tiff_train"] = {
        "losses": losses, "eval_scores": eval_scores,
        "equal_to_hdf5_run": losses == cli_res["losses"]
        and eval_scores == cli_res["eval_scores"],
        "checkpoint_equal": got.keys() == ref.keys()
        and all(torch.equal(got[k], ref[k]) for k in ref),
    }
    if not res["tiff_train"]["equal_to_hdf5_run"]:
        failures.append(f"TIFF run losses {losses} / scores {eval_scores} differ "
                        f"from the HDF5 run's {cli_res['losses']} / "
                        f"{cli_res['eval_scores']}")
    if not res["tiff_train"]["checkpoint_equal"]:
        failures.append("TIFF run checkpoint differs from the HDF5 run's")
    plot = root / f"{ckpt.stem}_loss_plot.png"
    shown = root / f"{ckpt.stem}_prediction_image.png"
    for path in (plot, shown):
        if not path.exists():
            failures.append(f"model-train-2d wrote no {path.name}")
    # The prediction panels against an eval forward of the trainer's model
    # computed here, apart from the trainer's `predict_batch` that drew them.
    images, masks, _ = next(iter(trainer.validation_loader))
    trainer.model.eval()
    with torch.no_grad(), autocast(dev, trainer.compute_dtype):
        logits = trainer.model(normalise(
            torch.from_numpy(images).to(dev).float() / 255.0))
    predicted = logits.float().argmax(dim=1).cpu().numpy()
    grid = png.read_grey(shown)
    panels_equal = []
    for r in range(min(images.shape[0], 4)):
        y, x = figures.panel_origin(r, 2, images.shape[1:])
        panels_equal.append(bool(np.array_equal(
            grid[y:y + images.shape[1], x:x + images.shape[2]],
            figures.to_grey(predicted[r]))))
    res["montage"] = {"shape": list(grid.shape), "prediction_panels_equal": panels_equal,
                      "foreground_share": float(predicted.mean())}
    if not panels_equal or not all(panels_equal):
        failures.append(f"montage prediction panels {panels_equal} differ from "
                        "the card's eval argmax")
    del trainers, trainer, got, ref

    # (b) model-predict-2d on the 256^3 vessels volume as LZW TIFF, against
    # the CLI phase's labels of the same volume from HDF5.
    vol, vessel_labels = make_vessel_volume((P, P, P), seed=7)
    t0 = time.perf_counter()
    write_tiff(root / "vessels_256.tif", vol, compression="lzw")
    res["lzw_256_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    predict_2d_model.main([str(cli_root / cli_res["checkpoint"]),
                           str(root / "vessels_256.tif"), "--data_dir", str(root)])
    res["predict_tiff_main_s"] = time.perf_counter() - t0
    tiff_labels, _ = hdf5.read(predict_2d_model.create_output_path(
        root, Path("vessels_256.tif")))
    hdf5_labels, _ = hdf5.read(predict_2d_model.create_output_path(
        cli_root, Path("vessels_256.h5")))
    res["tiff_labels_equal_hdf5"] = bool(np.array_equal(tiff_labels, hdf5_labels))
    if not res["tiff_labels_equal_hdf5"]:
        failures.append("model-predict-2d labels from TIFF differ from HDF5")
    del tiff_labels, hdf5_labels
    # LZW decodes in numpy at a few MB/s: its read is timed on this 256^3
    # file (a 512^3 one took 56 s to write and read on a slow host).
    t0 = time.perf_counter()
    back = tiff.read(root / "vessels_256.tif")
    read_s = time.perf_counter() - t0
    res["lzw_256_read"] = {"read_s": read_s,
                           "read_mb_per_s": vol.nbytes / 1e6 / read_s,
                           "equal": bool(np.array_equal(back, vol))}
    if not res["lzw_256_read"]["equal"]:
        failures.append("the 256^3 LZW TIFF read back differs")
    del back

    # The 512^3 volume (the 256^3 one tiled 2x2x2) read from each other
    # format.
    raw = np.tile(vol, (2, 2, 2))
    raw16 = raw.astype(np.uint16) * 257
    files = (("tiff_u8_raw", "u8_raw.tif", raw, dict()),
             ("tiff_u8_deflate", "u8_deflate.tif", raw, dict(compression="deflate")),
             ("tiff_u16_deflate", "u16_deflate.tif", raw16, dict(compression="deflate")),
             ("hdf5_u8_gzip", "u8_gzip.h5", raw, None))
    res["reads_512"] = {}
    for name, fn, arr, options in files:
        path = root / fn
        t0 = time.perf_counter()
        if options is None:
            hdf5.write(path, arr, chunks=True)
        else:
            write_tiff(path, arr, **options)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = hdf5.read(path)[0] if options is None else tiff.read(path)
        read_s = time.perf_counter() - t0
        equal = bool(np.array_equal(back, arr))
        res["reads_512"][name] = {
            "read_s": read_s, "read_mb_per_s": arr.nbytes / 1e6 / read_s,
            "array_mb": arr.nbytes / 1e6, "file_mb": path.stat().st_size / 1e6,
            "write_s": write_s, "equal": equal}
        if not equal:
            failures.append(f"{name}: the 512^3 volume read back differs")
        path.unlink()
        del back
    del raw, raw16

    # (c) The library's PNG-directory path: the slicer writes the pair as
    # PNG slices, a trainer is built on the directories and trains
    # FORMATS_STEPS seeded steps, equal to a trainer on the CLI's in-memory
    # slices; clean_up_slices leaves nothing behind.
    settings = get_settings_data(root / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN,
                                 kind="training")
    pair = (cli_root / "train_data.h5", cli_root / "train_labels.h5")
    slicer = TrainingDataSlicer(*pair, settings)
    pngs = root / "png"
    t0 = time.perf_counter()
    slicer.output_data_slices(pngs / "data", "data0")
    slicer.output_label_slices(pngs / "seg", "seg0")
    write_s = time.perf_counter() - t0
    written = sorted((pngs / "data").glob("*.png")) + sorted((pngs / "seg").glob("*.png"))
    t0 = time.perf_counter()
    for path in written:
        png.read_grey(path)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    get_2d_training_dataset(pngs / "data", pngs / "seg", settings).stacked_arrays()
    stacked_s = time.perf_counter() - t0
    res["png"] = {"files": len(written), "bytes": sum(p.stat().st_size for p in written),
                  "write_s": write_s, "write_slices_per_s": len(written) / write_s,
                  "read_s": read_s, "read_slices_per_s": len(written) / read_s,
                  "stacked_arrays_s": stacked_s}
    # (e) The slicer's image PNGs rewritten as Adam7 read back equal to
    # the originals; the trainers below then read the interlaced files.
    images = sorted((pngs / "data").glob("*.png"))
    originals = [png.read_grey(path) for path in images]
    t0 = time.perf_counter()
    for path, image in zip(images, originals):
        path.write_bytes(png_adam7_bytes(image))
    adam7_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = [png.read_grey(path) for path in images]
    adam7_read_s = time.perf_counter() - t0
    res["png_adam7"] = {
        "files": len(images), "bytes": sum(p.stat().st_size for p in images),
        "write_s": adam7_write_s, "read_s": adam7_read_s,
        "read_slices_per_s": len(images) / adam7_read_s,
        "read_mb_per_s": sum(a.nbytes for a in back) / 1e6 / adam7_read_s,
        "equal": len(back) == len(originals) and all(
            np.array_equal(a, b) for a, b in zip(back, originals))}
    if not res["png_adam7"]["equal"]:
        failures.append("the Adam7 rewrites of the slicer's PNGs read back differ")
    del originals, back
    (data, labels), _, codes, _ = train_2d_model._slice_all_volumes(
        [pair[0]], [pair[1]], settings)
    codes = {str(i): code for i, code in enumerate(codes)}
    from_dirs = train_2d_model.VolSeg2dTrainer(pngs / "data", pngs / "seg", codes,
                                               settings, device=dev)
    from_lists = train_2d_model.VolSeg2dTrainer(data, labels, codes, settings,
                                                device=dev)
    same_arrays = all(np.array_equal(getattr(from_dirs.training_loader, a),
                                     getattr(from_lists.training_loader, a))
                      for a in ("images", "masks", "indices"))
    kernels.reset_launch_counts()
    runs = []
    for trainer in (from_dirs, from_lists):
        trainer._create_model_and_optimiser(1e-3, frozen=False)
        step_losses = []
        while len(step_losses) < FORMATS_STEPS:
            for imgs, msks, _ in to_device_batches(trainer.training_loader, dev):
                step_losses.append(trainer._train_one_batch_async(imgs, msks, 1e-3))
                if len(step_losses) == FORMATS_STEPS:
                    break
        runs.append(torch.stack(step_losses).cpu())
    for name, count in kernels.LAUNCHES.items():
        launches[name] += count
        if count != 2 * FORMATS_STEPS:
            failures.append(f"{name} launched {count} times in the PNG "
                            f"trainers' {2 * FORMATS_STEPS} steps")
    steps += 2 * FORMATS_STEPS
    slicer.clean_up_slices()
    left = [str(p) for p in pngs.rglob("*")]
    res["png_trainer"] = {"same_arrays": same_arrays,
                          "losses_equal": bool(torch.equal(*runs)),
                          "losses": runs[0].tolist(), "left_after_clean_up": left}
    if not same_arrays or not res["png_trainer"]["losses_equal"]:
        failures.append("the PNG-directory trainer differs from the in-memory one")
    if left:
        failures.append(f"clean_up_slices left {left}")

    # (d) The 256^3 vessels volume in further TIFF encodings and series
    # layouts, each read back equal to the array written (series 0 only),
    # then model-predict-2d on the predictor-3 float32 file against the
    # CLI phase's labels of the uint8 volume.
    tiff_encodings_step(root, cli_root, cli_res, vol, vessel_labels, res,
                        failures)
    del vol, vessel_labels
    res.update(launches=launches, train_steps=steps,
               seconds=time.perf_counter() - t_phase, failures=failures)
    print(json.dumps(res), flush=True)
    return res


def tiff_encodings_step(root: Path, cli_root: Path, cli_res, vol, labels, res,
                        failures):
    """The formats phase's (d) (see the module doc)."""
    from volume_segmantics_tpu_torch.scripts import predict_2d_model
    from volume_segmantics_tpu_torch.utils import hdf5, tiff

    small = np.ascontiguousarray(vol[:64, :64, :64])
    as_float = vol.astype(np.float32)
    files = {  # name: (array written, the first series' array, options)
        "packbits_u8": (vol, vol, dict(compression="packbits")),
        "predictor3_f32_deflate": (as_float, as_float,
                                   dict(compression="deflate", predictor=3)),
        "lzma_u8": (vol, vol, dict(compression="lzma")),
        "fill_order2_u8": (vol, vol, dict(fill_order=2)),
        "bits1_labels": (labels > 0, labels > 0, dict(bits=1)),
        "imagej_frames_u8": (vol, vol, dict(imagej=True, descriptions={
            0: f"ImageJ=1.54f\nimages={len(vol)}\nframes={len(vol)}\n".encode()})),
        "shaped_second_series_u8": ([*vol, *small], vol, dict(descriptions={
            0: json.dumps({"shape": list(vol.shape)}).encode(),
            len(vol): json.dumps({"shape": list(small.shape)}).encode()})),
        "thumbnails_interleaved_u8": (
            [p for z in range(len(vol)) for p in (vol[z], vol[z, ::4, ::4])],
            vol, dict(compression="deflate")),
    }
    res["reads_256"] = {}
    for name, (pages, first, options) in files.items():
        path = root / f"{name}.tif"
        t0 = time.perf_counter()
        write_tiff(path, pages, **options)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = tiff.read(path)
        read_s = time.perf_counter() - t0
        equal = back.dtype == first.dtype and bool(np.array_equal(back, first))
        res["reads_256"][name] = {
            "read_s": read_s, "read_mb_per_s": first.nbytes / 1e6 / read_s,
            "array_mb": first.nbytes / 1e6, "file_mb": path.stat().st_size / 1e6,
            "write_s": write_s, "equal": equal}
        if not equal:
            failures.append(f"{name}: the 256^3 TIFF read back differs from "
                            "its first series")
        if name != "predictor3_f32_deflate":
            path.unlink()
        del back
    # Both packages turn the float32 copy into the uint8 volume's clipped
    # uint8 (tests/test_torch_tiff_codecs.py), so the labels must agree.
    t0 = time.perf_counter()
    predict_2d_model.main([str(cli_root / cli_res["checkpoint"]),
                           str(root / "predictor3_f32_deflate.tif"),
                           "--data_dir", str(root)])
    res["predict_predictor3_f32_main_s"] = time.perf_counter() - t0
    got, _ = hdf5.read(predict_2d_model.create_output_path(
        root, Path("predictor3_f32_deflate.tif")))
    want, _ = hdf5.read(predict_2d_model.create_output_path(
        cli_root, Path("vessels_256.h5")))
    res["predictor3_f32_labels_equal_cli"] = bool(np.array_equal(got, want))
    if not res["predictor3_f32_labels_equal_cli"]:
        failures.append("model-predict-2d labels from the predictor-3 float32 "
                        "TIFF differ from the CLI phase's")
    (root / "predictor3_f32_deflate.tif").unlink()


SIDES_TYPE = "DeepLabV3"  # its x8 head resizes the logits back at side 100
SIDES_IMAGE_SIZE = 100  # not a multiple of 8: the CLAHE grid leaves 4 over
SIDES_TRAIN_SHAPE = (16, 100, 112)


def sides_phase(dev, out_dir: Path):
    """`model-train-2d` at an image side the CLAHE grid does not divide
    (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import train_2d_model
    from volume_segmantics_tpu_torch.utils import hdf5

    t_phase = time.perf_counter()
    failures, res = [], {"phase": "sides", "type": SIDES_TYPE,
                         "image_size": SIDES_IMAGE_SIZE}
    root = out_dir / "sides"
    shutil.rmtree(root, ignore_errors=True)
    settings_dir = root / cfg.SETTINGS_DIR
    settings_dir.mkdir(parents=True)
    data, labels = make_vessel_volume(SIDES_TRAIN_SHAPE, seed=4)
    hdf5.write(root / "train_data.h5", data, chunks=True)
    hdf5.write(root / "train_labels.h5", labels, chunks=True)
    text = settings_text(cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=0,
                         num_cyc_unfrozen=1, seed=0,
                         image_size=SIDES_IMAGE_SIZE)
    text = text.replace('type: "U_Net"', f'type: "{SIDES_TYPE}"').replace(
        'encoder_weights: "imagenet"', "encoder_weights: null")
    (settings_dir / cfg.TRAIN_SETTINGS_FN).write_text(text)

    trainers = []

    class RecordedTrainer(train_2d_model.VolSeg2dTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    train_2d_model.VolSeg2dTrainer = RecordedTrainer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_2d_model.main(["--data", str(root / "train_data.h5"),
                             "--labels", str(root / "train_labels.h5"),
                             "--data_dir", str(root)])
    finally:
        train_2d_model.VolSeg2dTrainer = RecordedTrainer.__bases__[0]
    torch.cuda.synchronize()
    res["train_main_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    (trainer,) = trainers
    ckpt = train_2d_model._model_output_path(trainer.settings, root)
    with open(root / f"{ckpt.stem}_train_stats.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in ("Train Loss", "Valid Loss")]
    res.update(checkpoint=ckpt.name, model_type=trainer.settings.model["type"],
               trained_side=trainer.settings.image_size,
               slices=len(trainer.training_loader.images),
               train_steps=trainer.train_steps, losses=losses,
               eval_scores=[float(r["Eval Score"]) for r in rows],
               launches=launches)
    if (res["model_type"], res["trained_side"]) != (SIDES_TYPE, SIDES_IMAGE_SIZE):
        failures.append(f"trained {res['model_type']} at {res['trained_side']}")
    if len(rows) != 1 or not all(np.isfinite(losses + res["eval_scores"])):
        failures.append(f"train-stats CSV: {len(rows)} epochs, losses {losses}")
    for name, count in launches.items():
        if count != trainer.train_steps:
            failures.append(f"{name} launched {count} times in "
                            f"{trainer.train_steps} train steps at side "
                            f"{SIDES_IMAGE_SIZE}")
    shutil.rmtree(root, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


SHIPPED_LOSSES = ("DiceLoss", "BCEDiceLoss", "BCELoss", "GeneralizedDiceLoss",
                  "CrossEntropyLoss")  # 2d_model_train_settings.yaml:20
METRICS = ("MeanIoU", "DiceCoefficient")  # :23
LOSS_STEPS = 10  # 20 before the spatial phase's (d)
STRUC = {"type": "U_Net", "encoder_name": "resnet34", "encoder_weights": None,
         "in_channels": 1, "classes": 2}
SWEEP_BATCHES = (12, 32, 64, 128, 256)
SWEEP_STEPS = 6  # 30 in the first card run, then 15, then 10; cut for time


def loss_settings(name, **more) -> SimpleNamespace:
    return SimpleNamespace(loss_criterion=name, alpha=0.75, beta=0.25, **more)


def against_cpu(fn, gpu_args, cpu_args):
    """|fn on the card - fn on the CPU| over the CPU value's largest
    magnitude, for a scalar or tensor result."""
    got, ref = fn(*gpu_args).detach().cpu(), fn(*cpu_args).detach()
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


def losses_phase(images_u8, masks_u8, dev):
    """Each shipped loss through the train step, and every loss and metric
    on the card against the CPU (see the module doc)."""
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.data.metrics import get_eval_metric_fn
    from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel.train import (
        build_eval_step,
        build_train_step,
        make_base_optimizer,
    )

    failures, res = [], {"phase": "losses", "steps_per_loss": LOSS_STEPS}
    model = create_model_on_device(dev, STRUC,
                                   generator=torch.Generator().manual_seed(11))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    metric_fns = {m: get_eval_metric_fn(SimpleNamespace(eval_metric=m))
                  for m in METRICS}
    kernels.reset_launch_counts()
    steps = 0
    for name in SHIPPED_LOSSES:
        loss_fn = get_loss_fn(loss_settings(name))
        model.load_state_dict(initial)
        optimizer = make_base_optimizer(model.parameters())
        step = build_train_step(
            model, loss_fn, optimizer, num_labels=2, image_size=S,
            compute_dtype=torch.bfloat16,
            generator=torch.Generator(dev).manual_seed(12))
        evals = {m: build_eval_step(model, loss_fn, fn, num_labels=2)
                 for m, fn in metric_fns.items()}
        step_ms, losses, scores = [], [], {m: [] for m in METRICS}
        for _ in range(LOSS_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(images_u8, masks_u8, 1e-3)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss.item())
            for m, ev in evals.items():
                scores[m].append(ev(images_u8, masks_u8, N)[1].item())
            steps += 1
        finite = all(np.isfinite(losses + scores["MeanIoU"]
                                 + scores["DiceCoefficient"]))
        res[name] = {"median_step_ms": statistics.median(step_ms),
                     "first_loss": losses[0], "last_loss": losses[-1],
                     **{f"last_{m}": scores[m][-1] for m in METRICS}}
        if not finite:
            failures.append(f"{name}: non-finite losses or scores "
                            f"{losses} {scores}")
        del step, evals, optimizer
    res["launches"] = dict(kernels.LAUNCHES)
    for entry, count in res["launches"].items():
        if count != steps:
            failures.append(f"{entry} launched {count} times in {steps} "
                            "train steps of the losses phase")
    del model, initial

    # Every loss, its logits-gradient and both metrics: card against CPU.
    gen = torch.Generator().manual_seed(13)
    logits = torch.randn(N, 2, S, S, generator=gen)
    target = torch.nn.functional.one_hot(masks_u8.long().cpu(), 2).permute(
        0, 3, 1, 2).float()
    cpu_args, gpu_args = (logits, target), (logits.to(dev), target.to(dev))
    errors = {}
    for name in SHIPPED_LOSSES:
        loss_fn = get_loss_fn(loss_settings(name))

        def grad(x, t, fn=loss_fn):
            x = x.clone().requires_grad_(True)
            fn(x, t).backward()
            return x.grad

        errors[name] = against_cpu(loss_fn, gpu_args, cpu_args)
        errors[f"{name}_grad"] = against_cpu(grad, gpu_args, cpu_args)
    probs = torch.softmax(logits, dim=1)
    for m, fn in metric_fns.items():
        errors[m] = against_cpu(fn, (probs.to(dev), target.to(dev)),
                                (probs, target))
    res["card_vs_cpu_rel_err"] = errors
    res["card_vs_cpu_rtol"] = 1e-5
    bad = {k: v for k, v in errors.items() if not v <= 1e-5}
    if bad:
        failures.append(f"card against CPU beyond rtol 1e-5: {bad}")
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


def write_native_checkpoint(torch_file: Path, path: Path) -> Path:
    """`torch_file` rewritten as a JAX package checkpoint: the magic, then
    the flax msgpack of its five keys with the weights as a flax tree."""
    from volume_segmantics_tpu_torch.models.checkpoint import MAGIC, load_checkpoint
    from volume_segmantics_tpu_torch.models.torch_export import (
        variables_from_smp_state_dict,
    )
    from volume_segmantics_tpu_torch.utils.flax_msgpack import msgpack_serialize

    ckpt = load_checkpoint(torch_file)
    struc = dict(ckpt["model_struc_dict"])
    struc["type"] = struc["type"].name
    blob = {
        "model_state_dict": variables_from_smp_state_dict(
            ckpt["model_state_dict"], struc),
        "model_struc_dict": struc, "optimizer_state_dict": {},
        "loss_val": float(ckpt["loss_val"]), "label_codes": ckpt["label_codes"],
    }
    path.write_bytes(MAGIC + msgpack_serialize(blob))
    return path


def bfloat16_checkpoint(torch_file: Path, path: Path) -> dict:
    """`torch_file` as a JAX package checkpoint of bfloat16 weights with an
    extra of bfloat16 (an array and a scalar), complex and chunked leaves
    (an array past
    `CHUNK_LIMIT`, patched to 1 MiB here), written and read back: the
    bytes rewritten from what was read are the bytes written, every
    bfloat16 and complex leaf keeps its bits, the chunked array comes back
    whole, and `load_checkpoint` maps the weights to the bfloat16 values
    widened to float32."""
    from volume_segmantics_tpu_torch.models.checkpoint import MAGIC, load_checkpoint
    from volume_segmantics_tpu_torch.models.torch_export import (
        variables_from_smp_state_dict,
    )
    from volume_segmantics_tpu_torch.utils import flax_msgpack

    t0 = time.perf_counter()
    ckpt = load_checkpoint(torch_file)
    struc = dict(ckpt["model_struc_dict"], type=ckpt["model_struc_dict"]["type"].name)

    def bf16(tree):
        if isinstance(tree, dict):
            return {k: bf16(v) for k, v in tree.items()}
        return torch.from_numpy(np.ascontiguousarray(tree)).to(torch.bfloat16)

    weights = bf16(variables_from_smp_state_dict(ckpt["model_state_dict"], struc))
    rng = np.random.default_rng(4)
    extra = {"ema": torch.from_numpy(rng.normal(size=(768, 1024)).astype(
                 np.float32)).to(torch.bfloat16),
             "phase": np.exp(1j * rng.normal(size=(64,))).astype(np.complex64),
             "shift": (rng.normal(size=(8,)) + 1j).astype(np.complex128),
             "z": complex(rng.normal(), -rng.normal()),
             "scale": torch.tensor(rng.normal(), dtype=torch.bfloat16).as_subclass(
                 flax_msgpack.BFloat16Scalar)}
    blob = {"model_state_dict": weights, "model_struc_dict": struc,
            "optimizer_state_dict": {}, "loss_val": 0.5,
            "label_codes": ckpt["label_codes"], "extra": extra}
    limit, flax_msgpack.CHUNK_LIMIT = flax_msgpack.CHUNK_LIMIT, 1 << 20
    try:
        data = MAGIC + flax_msgpack.msgpack_serialize(blob)
        path.write_bytes(data)
        raw = flax_msgpack.msgpack_restore(path.read_bytes()[len(MAGIC):])
        rewritten = MAGIC + flax_msgpack.msgpack_serialize(raw)
    finally:
        flax_msgpack.CHUNK_LIMIT = limit
    back = load_checkpoint(path)
    got = back["extra"]
    widened = {k: v.to(torch.bfloat16).float() for k, v in
               ckpt["model_state_dict"].items() if v.is_floating_point()}
    return {
        "mb": len(data) / 1e6, "s": time.perf_counter() - t0,
        "chunked_arrays": data.count(flax_msgpack.CHUNKED.encode()),
        "rewrite_equal": rewritten == data,
        "ema_bits_equal": bool(got["ema"].dtype == torch.bfloat16 and torch.equal(
            got["ema"].view(torch.int16), extra["ema"].view(torch.int16))),
        "scalar_bits_equal": bool(
            type(got["scale"]) is flax_msgpack.BFloat16Scalar and torch.equal(
                got["scale"].view(torch.int16), extra["scale"].view(torch.int16))),
        "complex_bits_equal": all(
            got[k].dtype == extra[k].dtype
            and got[k].tobytes() == extra[k].tobytes() for k in ("phase", "shift"))
        and got["z"] == extra["z"],
        "weights_equal": set(widened) <= set(back["model_state_dict"]) and all(
            torch.equal(back["model_state_dict"][k], v) for k, v in widened.items())}


def checkpoint_phase(model_file: Path, dev, out_dir: Path):
    """The JAX package's checkpoint format and the reference's pickling,
    on the slice phase's model (see the module doc)."""
    import zipfile

    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.model.model_2d import create_model_from_file
    from volume_segmantics_tpu_torch.models import checkpoint
    from volume_segmantics_tpu_torch.scripts import predict_2d_model
    from volume_segmantics_tpu_torch.utils import hdf5
    from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType

    failures, res = [], {"phase": "checkpoint"}
    root = out_dir / "checkpoint"
    shutil.rmtree(root, ignore_errors=True)
    (root / cfg.SETTINGS_DIR).mkdir(parents=True)
    native = write_native_checkpoint(model_file, root / "vessels_native.pytorch")
    res["native_mb"] = native.stat().st_size / 1e6
    with open(native, "rb") as f:
        res["native_magic"] = f.read(8).decode("latin-1")
    torch_model = create_model_from_file(model_file, device=dev)[0]
    native_model = create_model_from_file(native, device=dev)[0]
    ref_sd, sd = torch_model.state_dict(), native_model.state_dict()
    res["state_dict_bit_equal"] = set(sd) == set(ref_sd) and all(
        torch.equal(sd[k], ref_sd[k]) for k in ref_sd)
    if not res["state_dict_bit_equal"]:
        failures.append("the VSTPU1 file rebuilds another state_dict")
    del torch_model, native_model, sd, ref_sd
    res["bfloat16"] = bfloat16_checkpoint(model_file, root / "vessels_bf16.vstpu")
    if not all(v for k, v in res["bfloat16"].items() if k.endswith("equal")):
        failures.append(f"the bfloat16 VSTPU1 file {res['bfloat16']}")

    (root / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN).write_text(
        settings_text(cfg.PREDICTION_SETTINGS_FN))
    vol, _ = make_vessel_volume((P, P, P), seed=7)
    hdf5.write(root / "vessels_256.h5", vol, chunks=True)
    labels = {}
    for name, path in (("torch", model_file), ("native", native)):
        t0 = time.perf_counter()
        predict_2d_model.main([str(path), str(root / "vessels_256.h5"),
                               "--data_dir", str(root)])
        res[f"predict_{name}_main_s"] = time.perf_counter() - t0
        out = predict_2d_model.create_output_path(root, Path("vessels_256.h5"))
        labels[name] = hdf5.read(out)[0]
        out.unlink()
    res["labels_equal"] = bool(np.array_equal(labels["torch"], labels["native"]))
    res["labels_shape"] = list(labels["native"].shape)
    if not res["labels_equal"] or labels["native"].shape != vol.shape:
        failures.append("model-predict-2d on the VSTPU1 file gave other labels")

    blob = torch.load(model_file, map_location="cpu", weights_only=False,
                      pickle_module=checkpoint.REFERENCE_PICKLE)
    with zipfile.ZipFile(model_file) as z:
        pickled = z.read(next(n for n in z.namelist() if n.endswith("data.pkl")))
    res["reference_unpickler_type"] = repr(blob["model_struc_dict"]["type"])
    res["pickles_reference_module"] = checkpoint.REFERENCE_MODULE.encode() in pickled
    if blob["model_struc_dict"]["type"] is not ModelType.U_NET:
        failures.append(f"reference Unpickler gave {res['reference_unpickler_type']}")
    if not res["pickles_reference_module"]:
        failures.append("the torch file does not pickle ModelType under "
                        f"{checkpoint.REFERENCE_MODULE}")
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


LARGE_SIDE = 2048  # slice side of the large phase's volume (full-field micro-CT)
LARGE_STEP = 256  # its depth is a multiple of this, above 1.15 x the limit
LARGE_MARGIN = 1.15


class TiledVolume:
    """`tile` repeated to `shape`, read a block at a time by basic slices
    (the HDF5 writer's reads): never materialised."""

    def __init__(self, tile, shape):
        self.tile, self.shape, self.dtype = tile, tuple(shape), tile.dtype

    def __getitem__(self, sel):
        sel = (sel if isinstance(sel, tuple) else (sel,)) + (slice(None),) * 3
        idx = []
        for s, n, t in zip(sel, self.shape, self.tile.shape):
            start, stop, _ = s.indices(n)
            off = start % t
            idx.append(slice(off, off + stop - start) if off + stop - start <= t
                       else np.arange(start, stop) % t)
        if all(isinstance(i, slice) for i in idx):
            return self.tile[tuple(idx)]
        return self.tile[np.ix_(*(np.arange(i.start, i.stop) if isinstance(i, slice)
                                  else i for i in idx))]


@contextlib.contextmanager
def host_peaks(path: Path, every_s=0.25):
    """Samples this process's resident set (file-backed memmap pages
    included) and the free space of `path`'s file system in a thread;
    yields the running peaks."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")
    peaks = {"rss_bytes": 0, "min_free_bytes": shutil.disk_usage(path).free}
    stop = threading.Event()

    def sample():
        while True:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * page
            peaks["rss_bytes"] = max(peaks["rss_bytes"], rss)
            peaks["min_free_bytes"] = min(peaks["min_free_bytes"],
                                          shutil.disk_usage(path).free)
            if stop.wait(every_s):
                return

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield peaks
    finally:
        stop.set()
        thread.join(timeout=10)


def tiled_mean_iou(path: Path, truth, dev, slab) -> float:
    """The port's MeanIoU (per-class IoU, mean over the 2 classes) of the
    labels in HDF5 file `path` against `truth` tiled to their shape,
    counted slab by slab with partial reads (slabs within one tile)."""
    from volume_segmantics_tpu_torch.utils import hdf5

    t = torch.from_numpy(truth).to(dev)
    inter = torch.zeros(2, dtype=torch.float64, device=dev)
    union = torch.zeros(2, dtype=torch.float64, device=dev)
    with hdf5.File(path) as f:
        ds = f["/data"]
        reps = [n // s for n, s in zip(ds.shape[1:], truth.shape[1:])]
        for z in range(0, ds.shape[0], slab):
            pred = torch.from_numpy(ds[z:z + slab]).to(dev)
            z0 = z % truth.shape[0]
            tru = t[z0:z0 + pred.shape[0]].repeat(1, *reps)
            for c in range(2):
                p, q = pred == c, tru == c
                inter[c] += (p & q).sum()
                union[c] += (p | q).sum()
    return (inter / union.clamp(min=1e-8)).mean().item()


def large_phase(model_file: Path, dev, out_dir: Path):
    """Volumes beyond the in-memory limit (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
    from volume_segmantics_tpu_torch.model.operations import (
        vol_seg_2d_predictor,
        vol_seg_prediction_manager,
    )
    from volume_segmantics_tpu_torch.model.operations.vol_seg_large_predictor import (
        VolSegLargeVolPredictor,
    )
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import predict_2d_model
    from volume_segmantics_tpu_torch.utils import base_data_utils, hdf5
    from volume_segmantics_tpu_torch.utils.base_data_utils import (
        Axis,
        LazyHDF5Volume,
    )

    launches_before = dict(kernels.LAUNCHES)
    failures, res = [], {"phase": "large"}
    root = out_dir / "large"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    vol, truth = make_vessel_volume((P, P, P), seed=7)

    # 1. Equality at P^3: a lazy gzip HDF5 source, streamed and assembled
    # on the device, with the same preprocessing (clip on, bf16).
    src = root / "vessels.h5"
    hdf5.write(src, vol, chunks=True)
    below = P ** 3 - 1
    lazy_mgr = VolSeg2DPredictionManager(
        model_file, src, prediction_settings(lazy_ingest_threshold=below), device=dev)
    if not isinstance(lazy_mgr.data_vol, LazyHDF5Volume):
        failures.append(f"{P}^3 source not lazy: {type(lazy_mgr.data_vol)}")
    predictor, lazy = lazy_mgr.predictor, lazy_mgr.data_vol
    on_device = lazy_mgr._upload_lazy_to_device(lazy)
    large = VolSegLargeVolPredictor(predictor, temp_parent=root)
    res["batch"] = predictor.batch_size
    res["slab"] = large.slab_size
    equal = {}
    for name, streamed_fn, in_memory_fn in (
            ("LOW", lambda v: large.predict_single_axis(v, Axis.Z),
             lambda v: predictor._predict_single_axis(v, True, Axis.Z)),
            ("MEDIUM", large.predict_3_ways,
             lambda v: predictor._predict_3_ways_max_probs(v, True)),
            ("HIGH", large.predict_12_ways,
             lambda v: predictor._predict_12_ways_max_probs(v, True)),
            ("MEDIUM_one_hot", large.predict_3_ways_one_hot,
             predictor._predict_3_ways_one_hot)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = streamed_fn(lazy)
        streamed_s = time.perf_counter() - t0
        ref = in_memory_fn(on_device)
        torch.cuda.synchronize()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        same = all(np.array_equal(np.asarray(a), b) for a, b in zip(got, ref))
        equal[name] = {"equal": same, "streamed_s": streamed_s,
                       "in_memory_s": time.perf_counter() - t0 - streamed_s}
        if not same:
            failures.append(f"{name} streamed differs from in-memory at {P}^3")
        if name == "MEDIUM":
            medium_labels = ref[0]
        del got, ref
    res[f"streamed_vs_in_memory_{P}"] = equal
    del on_device, large
    res["max_read_voxels"] = lazy.max_read_voxels
    largest_face = res["slab"] * P * P
    if not lazy.max_read_voxels <= largest_face:
        failures.append(f"largest read {lazy.max_read_voxels} > {largest_face}")
    # Through the manager's dispatch, and against the eager ingest.
    streamed_mgr = VolSeg2DPredictionManager(
        model_file, src, prediction_settings(lazy_ingest_threshold=below,
                                             streaming_threshold=below), device=dev)
    res["manager_streamed_equal"] = bool(np.array_equal(
        streamed_mgr.predict_volume_to_path(None), medium_labels))
    if not res["manager_streamed_equal"]:
        failures.append("the manager's streamed MEDIUM differs from in-memory")
    eager = VolSeg2DPredictionManager(model_file, src, prediction_settings(),
                                      device=dev)
    res["eager_vs_lazy"] = {
        "label_agreement": float((eager.predict_volume_to_path(None)
                                  == medium_labels).mean()),
        "data_mean_rel_diff": abs(float(lazy_mgr.data_mean) / float(eager.data_mean)
                                  - 1.0),
    }
    if not (res["eager_vs_lazy"]["label_agreement"] >= 0.995
            and res["eager_vs_lazy"]["data_mean_rel_diff"] <= 1e-9):
        failures.append(f"eager against lazy ingest: {res['eager_vs_lazy']}")
    clipped = eager.data_vol
    del lazy_mgr, streamed_mgr, eager, lazy, medium_labels
    src.unlink()
    torch.cuda.empty_cache()

    # 2. Streaming overhead: MEDIUM on one 2P^3 uint8 ndarray, in memory
    # and streamed (streaming_threshold below it).
    big = np.tile(clipped, (2, 2, 2))
    runs = {}
    for name, more in (("in_memory", {}), ("streamed", {"streaming_threshold":
                                                        big.size - 1})):
        mgr = VolSeg2DPredictionManager(
            model_file, big, prediction_settings(clip_data=False, **more),
            device=dev)
        seconds = []
        for _ in range(2):  # the first run warms cuDNN and the pinned cache
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = mgr.predict_volume_to_path(None)
            seconds.append(time.perf_counter() - t0)
        runs[name] = np.array(labels)
        res[f"medium_{2 * P}_{name}_s"] = seconds
        del mgr, labels
    res[f"medium_{2 * P}_streamed_equal"] = bool(
        np.array_equal(runs["streamed"], runs["in_memory"]))
    if not res[f"medium_{2 * P}_streamed_equal"]:
        failures.append(f"{2 * P}^3 MEDIUM streamed differs from in-memory")
    del big, runs, clipped
    torch.cuda.empty_cache()

    # 3. model-predict-2d above the limit: the shipped settings as written
    # on a (D, LARGE_SIDE, LARGE_SIDE) gzip HDF5 tiling of the raw volume.
    shipped = root / "shipped"
    (shipped / cfg.SETTINGS_DIR).mkdir(parents=True)
    (shipped / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN).write_text(
        settings_text(cfg.PREDICTION_SETTINGS_FN))
    limit = VolSeg2DPredictionManager(
        model_file, vol[:4], prediction_settings(), device=dev
    ).in_memory_limit_voxels(False)
    face = LARGE_SIDE * LARGE_SIDE
    depth = (int(LARGE_MARGIN * limit) // face // LARGE_STEP + 1) * LARGE_STEP
    shape = (depth, LARGE_SIDE, LARGE_SIDE)
    res["above_limit"] = r = {"shape": list(shape), "voxels": math.prod(shape),
                              "in_memory_limit_voxels": limit}
    big = shipped / "vessels_large.h5"
    t0 = time.perf_counter()
    hdf5.write(big, TiledVolume(vol, shape), chunks=True)
    r["input_write_s"] = time.perf_counter() - t0
    r["input_file_gb"] = big.stat().st_size / 1e9
    r["free_gb_before"] = shutil.disk_usage(shipped).free / 1e9
    managers, larges = [], []

    class RecordedManager(predict_2d_model.VolSeg2DPredictionManager):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            managers.append(self)

    class RecordedLarge(VolSegLargeVolPredictor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.sweep_s, self.merge_s = [], []
            larges.append(self)

        def _predict_axis_streaming(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return super()._predict_axis_streaming(*args, **kwargs)
            finally:
                self.sweep_s.append(time.perf_counter() - t0)

        def _merge_into(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return super()._merge_into(*args, **kwargs)
            finally:
                self.merge_s.append(time.perf_counter() - t0)

    spans_of = ((base_data_utils, "streaming_nanmean", "lazy_mean_s"),
                (base_data_utils, "streaming_nanstd", "lazy_std_s"),
                (vol_seg_2d_predictor, "create_model_from_file", "checkpoint_load_s"),
                (base_data_utils, "save_data_to_hdf5", "hdf5_write_s"))
    saved = (predict_2d_model.VolSeg2DPredictionManager,
             vol_seg_prediction_manager.VolSegLargeVolPredictor)
    predict_2d_model.VolSeg2DPredictionManager = RecordedManager
    vol_seg_prediction_manager.VolSegLargeVolPredictor = RecordedLarge
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with timed_spans(spans_of) as spans, host_peaks(shipped) as peaks:
            t0 = time.perf_counter()
            predict_2d_model.main([str(model_file), str(big), "--data_dir",
                                   str(shipped)])
            spans["main_s"] = time.perf_counter() - t0
    finally:
        (predict_2d_model.VolSeg2DPredictionManager,
         vol_seg_prediction_manager.VolSegLargeVolPredictor) = saved
    mgr, streamed = managers[0], larges[0]
    r.update(spans)
    r.update({
        "sweeps_s": streamed.sweep_s, "merges_s": streamed.merge_s,
        "other_s": spans["main_s"] - sum(v for k, v in spans.items() if k != "main_s")
        - sum(streamed.sweep_s) - sum(streamed.merge_s),
        "batch": mgr.predictor.batch_size, "slab": streamed.slab_size,
        "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "peak_host_rss_gib": peaks["rss_bytes"] / 2**30,
        "workdir_peak_gb": streamed.peak_workdir_bytes / 1e9,
        "min_free_gb_during": peaks["min_free_bytes"] / 1e9,
        "free_gb_after": shutil.disk_usage(shipped).free / 1e9,
        "inflated_chunks": getattr(mgr.data_vol, "inflated_chunks", None),
        "chunks_in_file": math.prod(-(-n // c) for n, c in
                                    zip(shape, mgr.input_data_chunking)),
        "max_read_voxels": getattr(mgr.data_vol, "max_read_voxels", None),
    })
    lazy_ok = isinstance(mgr.data_vol, LazyHDF5Volume)
    del mgr, streamed, managers, larges
    out = predict_2d_model.create_output_path(shipped, big)
    with hdf5.File(out) as f:
        out_shape, out_dtype = f["/data"].shape, f["/data"].dtype
    r["output_file_gb"] = out.stat().st_size / 1e9
    t0 = time.perf_counter()
    r["mean_iou"] = tiled_mean_iou(out, truth, dev, LARGE_STEP // 2)
    r["mean_iou_s"] = time.perf_counter() - t0
    if not lazy_ok:
        failures.append("the large input was not ingested lazily")
    if tuple(out_shape) != shape or out_dtype != np.uint8:
        failures.append(f"large output {out_shape} {out_dtype}")
    if not r["mean_iou"] >= 0.75:
        failures.append(f"large MeanIoU {r['mean_iou']} < 0.75")
    big.unlink()
    out.unlink()
    r["workdirs_left"] = [p.name for p in shipped.iterdir()
                          if p.name.startswith("volseg_large_")]
    if r["workdirs_left"]:
        failures.append(f"workdirs left: {r['workdirs_left']}")
    res["kernel_launches"] = {k: kernels.LAUNCHES[k] - launches_before[k]
                              for k in kernels.LAUNCHES}
    if any(res["kernel_launches"].values()):
        failures.append(f"the large phase launched kernels {res['kernel_launches']}")
    shutil.rmtree(root, ignore_errors=True)
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


def chrome_trace_kernels(path: Path) -> int:
    """CUDA kernel events in a Chrome trace that torch.profiler exported
    (an epoch's trace is hundreds of MB: counted in the text, not parsed)."""
    data = path.read_bytes()
    if not data.lstrip().startswith(b"{") or b'"traceEvents"' not in data:
        return 0
    return len(re.findall(rb'"cat":\s*"kernel"', data))


def pretrained_phase(model_file: Path, dev, out_dir: Path, cli_res):
    """`model-train-2d` from a pretrained-encoder cache, with autosave and
    profiling (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
    from volume_segmantics_tpu_torch.models.pretrained import WEIGHTS_DIR_ENV
    from volume_segmantics_tpu_torch.models.torch_export import (
        variables_from_smp_state_dict,
    )
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import train_2d_model
    from volume_segmantics_tpu_torch.utils.flax_msgpack import msgpack_serialize

    failures, res = [], {"phase": "pretrained"}
    root = out_dir / "pretrained"
    shutil.rmtree(root, ignore_errors=True)
    (root / cfg.SETTINGS_DIR).mkdir(parents=True)
    (root / "weights").mkdir()

    # The slice model's encoder as a converted 3-channel ImageNet cache: the
    # first kernel in input channel 0 and zeros in 1 and 2, so that the
    # grayscale adaptation (a sum over input channels) gives it back.
    ckpt = load_checkpoint(model_file)
    slice_encoder = {k: v for k, v in ckpt["model_state_dict"].items()
                     if k.startswith("encoder.")}
    tree = variables_from_smp_state_dict(ckpt["model_state_dict"],
                                         ckpt["model_struc_dict"])
    params = tree["params"]["encoder"]
    kernel = params["stem_conv"]["conv"]["kernel"]  # HWIO, I = 1
    params["stem_conv"]["conv"]["kernel"] = np.concatenate(
        [kernel, np.zeros_like(kernel), np.zeros_like(kernel)], axis=2)
    (root / "weights" / "resnet34.vstpu").write_bytes(msgpack_serialize(
        {"params": params, "batch_stats": tree["batch_stats"]["encoder"]}))
    (root / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN).write_text(settings_text(
        cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=1, num_cyc_unfrozen=1, seed=0,
        skip_frozen_without_pretrained=True, autosave=True,
        profile_dir=root / "profile"))

    trainers, phases = [], []

    class RecordedTrainer(train_2d_model.VolSeg2dTrainer):
        """Records the phases it trains and each model's encoder at
        creation."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.encoders_at_create = []
            trainers.append(self)

        def _create_model_and_optimiser(self, learning_rate, frozen=False):
            super()._create_model_and_optimiser(learning_rate, frozen)
            self.encoders_at_create.append(
                (self.model.pretrained_loaded,
                 {n: v.detach().cpu().clone()
                  for n, v in self.model.state_dict().items()
                  if n.startswith("encoder.")}))

        def train_model(self, output_path, num_epochs, patience, create=True,
                        frozen=False):
            phases.append({"epochs": num_epochs, "create": create,
                           "frozen": frozen})
            return super().train_model(output_path, num_epochs, patience,
                                       create, frozen)

    saved_env = os.environ.get(WEIGHTS_DIR_ENV)
    os.environ[WEIGHTS_DIR_ENV] = str(root / "weights")
    train_2d_model.VolSeg2dTrainer = RecordedTrainer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_2d_model.main(["--data",
                             str(out_dir / "cli" / "round_trip_data.h5"),
                             "--labels",
                             str(out_dir / "cli" / "round_trip_labels.h5"),
                             "--data_dir", str(root)])
    finally:
        train_2d_model.VolSeg2dTrainer = RecordedTrainer.__bases__[0]
        if saved_env is None:
            del os.environ[WEIGHTS_DIR_ENV]
        else:
            os.environ[WEIGHTS_DIR_ENV] = saved_env
    torch.cuda.synchronize()
    res["train_main_s"] = time.perf_counter() - t0
    res["launches"] = dict(kernels.LAUNCHES)
    trainer = trainers[0]
    model_out = train_2d_model._model_output_path(trainer.settings, root)
    res["phases"] = phases
    if not phases or not phases[0]["frozen"]:
        failures.append(f"the frozen phase did not run: {phases}")
    res["models_created"] = len(trainer.encoders_at_create)
    mismatched = [i for i, (loaded, enc) in enumerate(trainer.encoders_at_create)
                  if not loaded or set(enc) != set(slice_encoder)
                  or not all(torch.equal(enc[k], slice_encoder[k]) for k in enc)]
    res["encoder_at_create_equal"] = not mismatched
    if mismatched or not trainer.encoders_at_create:
        failures.append(f"created models {mismatched} do not start from the "
                        "cached encoder")
    res["autosave_left"] = Path(f"{model_out}.autosave").exists()
    if res["autosave_left"] or not model_out.exists():
        failures.append(f"autosave left {res['autosave_left']}, checkpoint "
                        f"written {model_out.exists()}")
    traces = sorted((root / "profile").glob("*.json"))
    res["traces"] = {t.name: {"mb": t.stat().st_size / 1e6,
                              "cuda_kernel_events": chrome_trace_kernels(t)}
                     for t in traces}
    if not any(v["cuda_kernel_events"] for v in res["traces"].values()):
        failures.append(f"no Chrome trace with CUDA kernel events: {res['traces']}")
    for entry, count in res["launches"].items():
        if count != trainer.train_steps:
            failures.append(f"{entry} launched {count} times in the pretrained "
                            f"run's {trainer.train_steps} train steps")
    res.update({
        "train_steps": trainer.train_steps,
        "eval_scores": trainer.avg_eval_scores,
        "last_eval_mean_iou": trainer.avg_eval_scores[-1],
        "random_init_cli_last_eval_mean_iou": cli_res["eval_scores"][-1],
        "failures": failures,
    })
    for trace in traces:
        trace.unlink()  # tens of MB each
    print(json.dumps(res), flush=True)
    return res


def train_batch_sweep(images_u8, masks_u8, dev):
    """Train-step throughput by batch for `THROUGHPUT_TRAIN_BATCH` (see the
    module doc); launches here are not counted on the kernels line."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device
    from volume_segmantics_tpu_torch.parallel.train import (
        build_train_step,
        make_base_optimizer,
    )

    res = {"phase": "train_batch_sweep", "steps": SWEEP_STEPS, "batches": {}}
    for batch in SWEEP_BATCHES:
        reps = -(-batch // images_u8.shape[0])
        imgs = images_u8.repeat(reps, 1, 1)[:batch].contiguous()
        msks = masks_u8.repeat(reps, 1, 1)[:batch].contiguous()
        model = create_model_on_device(dev, STRUC,
                                       generator=torch.Generator().manual_seed(14))
        step = build_train_step(
            model, get_loss_fn(loss_settings("DiceLoss")),
            make_base_optimizer(model.parameters()), num_labels=2, image_size=S,
            compute_dtype=torch.bfloat16,
            generator=torch.Generator(dev).manual_seed(15))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(3):  # warm-up: cuDNN plans, allocator
            step(imgs, msks, 1e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SWEEP_STEPS):
            loss = step(imgs, msks, 1e-4)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        res["batches"][batch] = {
            "step_ms": 1e3 * seconds / SWEEP_STEPS,
            "samples_per_s": batch * SWEEP_STEPS / seconds,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "loss_finite": bool(np.isfinite(loss.item())),
        }
        del model, step, imgs, msks, loss
        torch.cuda.empty_cache()
    best = max(r["samples_per_s"] for r in res["batches"].values())
    res["throughput_train_batch"] = min(
        b for b, r in res["batches"].items() if r["samples_per_s"] >= 0.95 * best)
    res["configured_throughput_train_batch"] = cfg.THROUGHPUT_TRAIN_BATCH
    res["failures"] = [f"batch {b}: non-finite loss"
                       for b, r in res["batches"].items() if not r["loss_finite"]]
    print(json.dumps(res), flush=True)
    return res


# The seven decoders beside U-Net, each on resnet34, at 2 classes, with
# their parameter counts from the JAX package (tests/
# test_torch_architectures_pyramid.py holds these constants to it).
ARCH_PARAMS = {
    "U_Net_Plus_Plus": 26072482, "FPN": 23149250, "DeepLabV3": 26001090,
    "DeepLabV3_Plus": 22431442, "MA_Net": 31777506, "Linknet": 21765442,
    "PAN": 21469833,
}
ARCH_STEPS = 4  # 20 before the parallel phase, 10 before spatial, 6 before (d)
DROPOUT_ARCHS = ("FPN", "DeepLabV3")
# Card against CPU, float32 eval, TF32 off, over the logits' largest
# magnitude (at least 1). The CPU tests hold the port to JAX within 3e-5
# (one float32 library against another); cuDNN's float32 algorithms round
# differently again but no coarser: the card read 6.6e-7 to 4.2e-6 here
# (NVIDIA H100 80GB HBM3, 700 W). So the CPU tests' bound, which a TF32 or
# bf16 leak (10 or 8 mantissa bits over 40-90 layers) would exceed: each
# type's TF32-on reading is recorded beside it as the control.
ARCH_CARD_VS_CPU_RTOL = 3e-5


def forward_gflop_per_sample(model, side, dev) -> float:
    """Multiply-adds x 2 of every convolution in one forward pass of one
    side x side sample, from the layer shapes (forward hooks); the few
    matrix products (MA-Net's attention, the align-corners resizes) are
    left out."""
    flops = []

    def conv_hook(m, inputs, out):
        k = m.kernel_size[0] * m.kernel_size[1] // m.groups
        if isinstance(m, torch.nn.ConvTranspose2d):
            flops.append(2 * inputs[0][0].numel() * m.out_channels * k)
        else:
            flops.append(2 * out[0].numel() * m.in_channels * k)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, 1, side, side, device=dev))
    for h in hooks:
        h.remove()
    return sum(flops) / 1e9


def randomize_batchnorms(model, seed):
    """Every BatchNorm's scale, bias and running statistics drawn from a
    seeded generator (scale and variance in [0.5, 1.5), bias N(0, 0.2),
    mean N(0, 0.5)): fresh-init BatchNorm is an identity in eval mode, and
    through EfficientNet's DeepLabV3 it leaves logits of ~3e-7, where any
    two results agree."""
    from volume_segmantics_tpu_torch.models.layers import BnAct

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BnAct):
                n = m.weight.numel()
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.2 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.5 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))


def card_against_cpu(struc, x, dev, seed=31, randomize_bn=False):
    """A seeded model on the CPU (its BatchNorms randomised with
    `randomize_bn`) and the same tensors on the card, float32 eval on `x`:
    returns the card model and the largest |card - CPU| over the logits'
    scale (at least 1), with TF32 off as the script runs and, as the
    control, on, and the scale."""
    from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device

    cpu_model = create_model_on_device(
        "cpu", struc, generator=torch.Generator().manual_seed(seed)).eval()
    if randomize_bn:
        randomize_batchnorms(cpu_model, seed)
    model = model_from_state(struc, cpu_model.state_dict(), dev).eval()
    with torch.no_grad():
        ref = cpu_model(x)
        got = model(x.to(dev)).cpu()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            got_tf32 = model(x.to(dev)).cpu()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    scale = max(1.0, ref.abs().max().item())
    return model, {"rel_err": (got - ref).abs().max().item() / scale,
                   "rel_err_tf32_control": (got_tf32 - ref).abs().max().item()
                   / scale, "logits_scale": ref.abs().max().item()}


def arch_train_run(model, images_u8, masks_u8, dev, dropout_seed, steps,
                   timed=False, params=None):
    """`steps` seeded train steps (DiceLoss, bf16) from `model`'s current
    weights, AdamW over `params` (default all: unfrozen); returns the
    losses and each step's synchronised ms."""
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.parallel.train import (
        build_train_step,
        make_base_optimizer,
    )

    step = build_train_step(
        model, get_loss_fn(loss_settings("DiceLoss")),
        make_base_optimizer(model.parameters() if params is None else params),
        num_labels=2, image_size=images_u8.shape[-1],
        compute_dtype=torch.bfloat16,
        generator=torch.Generator(dev).manual_seed(21),
        dropout_generator=torch.Generator(dev).manual_seed(dropout_seed))
    losses, step_ms = [], []
    for _ in range(steps):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(images_u8, masks_u8, 1e-4)
        if timed:
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
    return losses, step_ms


def architectures_phase(images_u8, masks_u8, dev, out_dir: Path):
    """The seven other decoders through training and prediction (see the
    module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.models.checkpoint import save_checkpoint
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType

    failures, res = [], {"phase": "architectures", "steps": ARCH_STEPS,
                         "card_vs_cpu_rtol": ARCH_CARD_VS_CPU_RTOL,
                         "archs": {}}
    root, predict_settings, vol, truth = prediction_root(out_dir /
                                                         "architectures")
    x_card = torch.randn(1, 1, S, S, generator=torch.Generator().manual_seed(3))
    big = throughput_batch(images_u8, masks_u8)
    launches = dict.fromkeys(kernels.LAUNCHES, 0)

    for arch, jax_params in ARCH_PARAMS.items():
        r, struc = {}, dict(STRUC, type=ModelType[arch.upper()])
        res["archs"][arch] = r
        # 1. The same seeded weights on the CPU and on the card.
        model, c = card_against_cpu(struc, x_card, dev)
        r["card_vs_cpu_rel_err"] = c["rel_err"]
        r["card_vs_cpu_rel_err_tf32_control"] = c["rel_err_tf32_control"]
        if not r["card_vs_cpu_rel_err"] <= ARCH_CARD_VS_CPU_RTOL:
            failures.append(f"{arch}: card against CPU {r['card_vs_cpu_rel_err']}")
        r["params"] = sum(p.numel() for p in model.parameters())
        if r["params"] != jax_params:
            failures.append(f"{arch}: {r['params']} parameters, JAX {jax_params}")
        r["forward_gflop_per_sample"] = forward_gflop_per_sample(model, S, dev)
        initial = {k: v.clone() for k, v in model.state_dict().items()}

        # 2. ARCH_STEPS seeded train steps at the shipped settings; each kernel
        # launched once a step.
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = arch_train_run(model, images_u8, masks_u8, dev, 22,
                                         ARCH_STEPS, timed=True)
        r["launches"] = dict(kernels.LAUNCHES)
        r.update(first_loss=losses[0], last_loss=losses[-1],
                 median_step_ms=statistics.median(step_ms),
                 first_step_ms=step_ms[0],
                 peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        for entry, count in r["launches"].items():
            launches[entry] += count
            if count != ARCH_STEPS:
                failures.append(f"{arch}: {entry} launched {count} times in "
                                f"{ARCH_STEPS} train steps")
        if not all(np.isfinite(losses)):
            failures.append(f"{arch}: non-finite losses {losses}")
        trained = {k: v.clone() for k, v in model.state_dict().items()}

        # 3. The seeded run repeats as the trainer runs it (cuDNN's flags as
        # the port leaves them): the same weights, augmentation and dropout
        # seeds give step 2's losses bit for bit; for FPN and DeepLabV3
        # another dropout seed gives other losses.
        r["cudnn_deterministic"] = torch.backends.cudnn.deterministic
        model.load_state_dict(initial)
        repeat = arch_train_run(model, images_u8, masks_u8, dev, 22,
                                ARCH_STEPS)[0]
        r["repeats"] = repeat == losses
        if not r["repeats"]:
            failures.append(f"{arch}: a seeded run gave {repeat}, then {losses}")
        if arch in DROPOUT_ARCHS:
            model.load_state_dict(initial)
            other = arch_train_run(model, images_u8, masks_u8, dev, 24,
                                   ARCH_STEPS)[0]
            r["dropout_seed_changes_losses"] = other != losses
            r["other_dropout_seed_last_loss"] = other[-1]
            if not r["dropout_seed_changes_losses"]:
                failures.append(f"{arch}: another dropout seed gave the same "
                                "losses")

        # 4. One unfrozen step at the throughput batch: peak memory or OOM.
        model.load_state_dict(initial)
        r["throughput_batch"] = throughput_step(model, *big, dev)

        # 5. MEDIUM on 256^3 from the trained weights, written by the
        # trainer's checkpoint writer; equal to its LOW sweeps' merge; the
        # same weights as a JAX VSTPU1 file through model-predict-2d.
        model.load_state_dict(trained)
        ckpt = root / f"{arch}.pytorch"
        save_checkpoint(ckpt, model, struc)
        del model, initial, trained
        prediction_checks(arch, ckpt, vol, truth, predict_settings, root, dev,
                          r, failures)
        print(json.dumps({"phase": "architectures", "arch": arch, **r}),
              flush=True)

    # 6. model-train-2d then model-predict-2d with the shipped files as
    # written, type U_Net_Plus_Plus, on the CLI phase's round-trip pair.
    text = settings_text(cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=1,
                         num_cyc_unfrozen=1, seed=0)
    rt = cli_round_trip("U-Net++", text.replace('type: "U_Net"',
                                                'type: "U_Net_Plus_Plus"'),
                        root, out_dir, vol, truth, predict_settings, dev,
                        failures)
    for entry, count in rt["launches"].items():
        launches[entry] += count
    res["unetpp_cli"] = rt
    res["launches"] = launches
    res["failures"] = failures
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({k: v for k, v in res.items() if k != "archs"}),
          flush=True)
    return res


def prediction_root(root: Path):
    """`root` made anew with the shipped prediction settings and the 256^3
    vessels volume as `vessels_256.h5`; returns it, the settings, the
    volume and its truth."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.data import get_settings_data
    from volume_segmantics_tpu_torch.utils import hdf5

    shutil.rmtree(root, ignore_errors=True)
    (root / cfg.SETTINGS_DIR).mkdir(parents=True)
    predict_file = root / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN
    predict_file.write_text(settings_text(cfg.PREDICTION_SETTINGS_FN))
    vol, truth = make_vessel_volume((P, P, P), seed=7)
    hdf5.write(root / "vessels_256.h5", vol, chunks=True)
    return (root, get_settings_data(predict_file, kind="prediction"), vol,
            truth)


def throughput_batch(images_u8, masks_u8):
    """The batch tiled to `THROUGHPUT_TRAIN_BATCH`."""
    import volume_segmantics_tpu_torch.utils.config as cfg

    n = cfg.THROUGHPUT_TRAIN_BATCH
    reps = -(-n // images_u8.shape[0])
    return (images_u8.repeat(reps, 1, 1)[:n].contiguous(),
            masks_u8.repeat(reps, 1, 1)[:n].contiguous())


def throughput_step(model, big_imgs, big_msks, dev):
    """Two unfrozen steps at the throughput batch: the second's ms and the
    peak memory, or the OOM (recorded, not failed)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    n = big_imgs.shape[0]
    try:
        big_ms = arch_train_run(model, big_imgs, big_msks, dev, 25, 2,
                                timed=True)[1]
        out = {"batch": n, "oom": False, "second_step_ms": big_ms[1],
               "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    except torch.cuda.OutOfMemoryError as e:
        out = {"batch": n, "oom": True, "error": str(e)[:200]}
    torch.cuda.empty_cache()
    return out


def prediction_checks(name, ckpt, vol, truth, predict_settings, root: Path,
                      dev, r, failures):
    """MEDIUM on `vol` from `ckpt` through the manager (seconds, peak
    memory, MeanIoU against `truth`), equal to the merge of its three LOW
    sweeps, and `model-predict-2d` on the same weights as a JAX `VSTPU1`
    file giving the same labels; `root` holds `vol` as `vessels_256.h5`
    and the prediction settings. Results go into `r`, misses into
    `failures`."""
    from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
    from volume_segmantics_tpu_torch.scripts import predict_2d_model
    from volume_segmantics_tpu_torch.utils import hdf5
    from volume_segmantics_tpu_torch.utils.base_data_utils import Axis

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    manager = VolSeg2DPredictionManager(ckpt, vol, predict_settings,
                                        device=dev)
    labels = manager.predict_volume_to_path(None)
    r["medium_256_s"] = time.perf_counter() - t0
    r["medium_256_peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    r["mean_iou_after_training"] = volume_mean_iou(labels, truth, dev)
    predictor = manager.predictor
    lows = [predictor._predict_single_axis(manager.data_vol, True, axis)
            for axis in (Axis.Z, Axis.Y, Axis.X)]
    med = predictor._predict_3_ways_max_probs(manager.data_vol, True)
    low_merge = merge_max_prob(lows)
    r["medium_equals_low_merge"] = bool(
        np.array_equal(med[0], low_merge[0])
        and np.array_equal(med[1], low_merge[1])
        and np.array_equal(med[0], labels))
    if not r["medium_equals_low_merge"]:
        failures.append(f"{name}: MEDIUM differs from its LOW sweeps' merge")
    del manager, predictor, lows, med, low_merge
    native = write_native_checkpoint(ckpt, root / f"{ckpt.stem}_native.pytorch")
    predict_2d_model.main([str(native), str(root / "vessels_256.h5"),
                           "--data_dir", str(root)])
    out = predict_2d_model.create_output_path(root, Path("vessels_256.h5"))
    r["native_labels_equal"] = bool(np.array_equal(hdf5.read(out)[0], labels))
    out.unlink()
    native.unlink()
    if not r["native_labels_equal"]:
        failures.append(f"{name}: model-predict-2d on the VSTPU1 file gave "
                        "other labels")
    torch.cuda.empty_cache()


def cli_round_trip(name, train_text, root: Path, out_dir: Path, vol, truth,
                   predict_settings, dev, failures, trainer_cls=None):
    """`model-train-2d` with `train_text` as the train settings file on the
    CLI phase's round-trip pair, in `root`/cli: the last eval score >= 0.5
    and each kernel launched once a step; then `model-predict-2d` on `vol` (`root`
    holds it as `vessels_256.h5`, and the prediction settings) equal to the
    manager's labels. `trainer_cls` (default the CLI's) records the run.
    Returns the results; misses go into `failures`."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import predict_2d_model, train_2d_model
    from volume_segmantics_tpu_torch.utils import hdf5

    cli = root / "cli"
    shutil.rmtree(cli, ignore_errors=True)
    (cli / cfg.SETTINGS_DIR).mkdir(parents=True)
    (cli / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN).write_text(train_text)
    shutil.copy(root / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN,
                cli / cfg.SETTINGS_DIR)
    trainers = []
    base = trainer_cls or train_2d_model.VolSeg2dTrainer

    class RecordedTrainer(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    saved = train_2d_model.VolSeg2dTrainer
    train_2d_model.VolSeg2dTrainer = RecordedTrainer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_2d_model.main(["--data",
                             str(out_dir / "cli" / "round_trip_data.h5"),
                             "--labels",
                             str(out_dir / "cli" / "round_trip_labels.h5"),
                             "--data_dir", str(cli)])
    finally:
        train_2d_model.VolSeg2dTrainer = saved
    torch.cuda.synchronize()
    trainer = trainers[0]
    ckpt = train_2d_model._model_output_path(trainer.settings, cli)
    with open(cli / f"{ckpt.stem}_train_stats.csv", newline="") as f:
        scores = [float(row["Eval Score"]) for row in csv.DictReader(f)]
    rt = {"train_main_s": time.perf_counter() - t0, "checkpoint": ckpt.name,
          "train_steps": trainer.train_steps, "eval_scores": scores,
          "launches": dict(kernels.LAUNCHES),
          "median_lr_find_step_ms": 1e3 * statistics.median(
              trainer.lr_find_step_seconds)}
    for entry, count in rt["launches"].items():
        if count != trainer.train_steps:
            failures.append(f"{name} CLI: {entry} launched {count} times in "
                            f"{trainer.train_steps} train steps")
    if not scores or not scores[-1] >= 0.5:
        failures.append(f"{name} CLI: last eval score {scores} < 0.5")
    del trainers, trainer
    t0 = time.perf_counter()
    predict_2d_model.main([str(ckpt), str(root / "vessels_256.h5"),
                           "--data_dir", str(cli)])
    rt["predict_256_main_s"] = time.perf_counter() - t0
    cli_labels = hdf5.read(predict_2d_model.create_output_path(
        cli, Path("vessels_256.h5")))[0]
    ref = VolSeg2DPredictionManager(ckpt, vol, predict_settings,
                                    device=dev).predict_volume_to_path(None)
    rt["labels_equal_manager"] = bool(np.array_equal(cli_labels, ref))
    rt["mean_iou"] = volume_mean_iou(cli_labels, truth, dev)
    if not rt["labels_equal_manager"]:
        failures.append(f"{name} CLI: model-predict-2d labels differ from the "
                        "manager's")
    return rt


# The six encoders beside ResNet-34, each under U-Net at 2 classes: the
# JAX model's parameter count, and the encoder parameters (leaves,
# elements) that the JAX freeze mask leaves trainable (tests/
# torch_encoder_cases.py holds both to the JAX package).
ENCODER_PARAMS = {
    "resnet50": (32514978, 0, 0),
    "resnext50_32x4d": (31986850, 0, 0),
    "efficientnet-b3": (12565562, 154, 84224),
    "efficientnet-b4": (19418570, 190, 121616),
    "timm-resnest50d": (34446882, 64, 18880),
    "timm-resnest101e": (55256514, 132, 40640),
}
ENCODER_FROZEN_STEPS = 3  # 5 before the spatial phase's (d)
ENCODER_STEPS = 4  # 20 before the parallel phase, 10 before spatial, 6 before (d)
# The dilated forms held card against CPU beside U-Net (output stride 16
# and 8).
ENCODER_DILATED = ("DeepLabV3_Plus", "DeepLabV3")
ENCODER_CLI = "efficientnet-b3"


def bn_running_means(model):
    """Each BatchNorm's running mean (a clone), by module name."""
    from volume_segmantics_tpu_torch.models.layers import BnAct

    return {name: m.running_mean.clone() for name, m in model.named_modules()
            if isinstance(m, BnAct)}


def encoders_phase(images_u8, masks_u8, dev, out_dir: Path):
    """The six other encoders through training and prediction (see the
    module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
        frozen_parameter_names,
    )
    from volume_segmantics_tpu_torch.models.checkpoint import save_checkpoint
    from volume_segmantics_tpu_torch.models.pretrained import (
        WEIGHTS_DIR_ENV,
        first_conv_path,
    )
    from volume_segmantics_tpu_torch.models.torch_export import (
        variables_from_smp_state_dict,
    )
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import train_2d_model
    from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType
    from volume_segmantics_tpu_torch.utils.flax_msgpack import msgpack_serialize

    failures, res = [], {"phase": "encoders",
                         "frozen_steps": ENCODER_FROZEN_STEPS,
                         "steps": ENCODER_STEPS,
                         "card_vs_cpu_rtol": ARCH_CARD_VS_CPU_RTOL,
                         "encoders": {}}
    root, predict_settings, vol, truth = prediction_root(out_dir / "encoders")
    x_card = torch.randn(1, 1, S, S, generator=torch.Generator().manual_seed(3))
    big = throughput_batch(images_u8, masks_u8)
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    cache_tree = None

    for name, (jax_params, jax_leaves, jax_elements) in ENCODER_PARAMS.items():
        r = {}
        struc = dict(STRUC, encoder_name=name, type=ModelType.U_NET)
        res["encoders"][name] = r
        # 1. The same seeded weights, BatchNorms randomised, on the CPU and
        # on the card, float32 eval: U-Net, then the dilated forms (output
        # stride 16 and 8).
        for mtype in ENCODER_DILATED:
            m, r[f"{mtype}_card_vs_cpu"] = card_against_cpu(
                dict(struc, type=ModelType[mtype.upper()]), x_card, dev,
                randomize_bn=True)
            del m
        model, r["U_Net_card_vs_cpu"] = card_against_cpu(
            struc, x_card, dev, randomize_bn=True)
        for mtype in ("U_Net",) + ENCODER_DILATED:
            err = r[f"{mtype}_card_vs_cpu"]["rel_err"]
            if not err <= ARCH_CARD_VS_CPU_RTOL:
                failures.append(f"{name} {mtype}: card against CPU {err}")
        r["params"] = sum(p.numel() for p in model.parameters())
        if r["params"] != jax_params:
            failures.append(f"{name}: {r['params']} parameters, JAX {jax_params}")
        r["forward_gflop_per_sample"] = forward_gflop_per_sample(model, S, dev)
        initial = {k: v.clone() for k, v in model.state_dict().items()}

        # 2. Frozen steps as the trainer sets them up: exactly the
        # parameters the JAX mask leaves trainable move; the running
        # statistics of every BatchNorm move.
        frozen = frozen_parameter_names(model, struc)
        trainable = []
        for n, p in model.named_parameters():
            p.requires_grad_(n not in frozen)
            if p.requires_grad:
                trainable.append(p)
        enc = [p for n, p in model.named_parameters()
               if n.startswith("encoder.") and n not in frozen]
        r["trainable_encoder"] = [len(enc), sum(p.numel() for p in enc)]
        if r["trainable_encoder"] != [jax_leaves, jax_elements]:
            failures.append(f"{name}: trainable encoder {r['trainable_encoder']}"
                            f", JAX {[jax_leaves, jax_elements]}")
        stats = bn_running_means(model)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        frozen_losses, frozen_ms = arch_train_run(
            model, images_u8, masks_u8, dev, 22, ENCODER_FROZEN_STEPS,
            timed=True, params=trainable)
        r["frozen_peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        after = model.state_dict()
        changed = {n for n, _ in model.named_parameters()
                   if not torch.equal(after[n], initial[n])}
        r["frozen_changed_exactly_trainable"] = (
            changed == {n for n, _ in model.named_parameters()} - frozen)
        if not r["frozen_changed_exactly_trainable"]:
            failures.append(f"{name}: frozen steps changed "
                            f"{len(changed)} parameters, "
                            f"{len(trainable)} trainable")
        still = [k for k, v in bn_running_means(model).items()
                 if torch.equal(v, stats[k])]
        r["frozen_stats_moved"] = not still
        if still:
            failures.append(f"{name}: frozen steps left running statistics "
                            f"of {still[:3]}")
        if not all(np.isfinite(frozen_losses)):
            failures.append(f"{name}: non-finite frozen losses {frozen_losses}")

        # 3. Unfrozen steps from there, twice from the same weights and
        # seeds, with cuDNN's flags as the trainer leaves them: equal
        # losses; each kernel launched once a step in the first run.
        for p in model.parameters():
            p.requires_grad_(True)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = arch_train_run(model, images_u8, masks_u8, dev, 22,
                                         ENCODER_STEPS, timed=True)
        r["launches"] = dict(kernels.LAUNCHES)
        r.update(frozen_last_loss=frozen_losses[-1],
                 median_frozen_step_ms=statistics.median(frozen_ms),
                 first_loss=losses[0], last_loss=losses[-1],
                 median_step_ms=statistics.median(step_ms),
                 first_step_ms=step_ms[0],
                 peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        steps = ENCODER_FROZEN_STEPS + ENCODER_STEPS
        for entry, count in r["launches"].items():
            launches[entry] += count
            if count != steps:
                failures.append(f"{name}: {entry} launched {count} times in "
                                f"{steps} train steps")
        if not all(np.isfinite(losses)):
            failures.append(f"{name}: non-finite losses {losses}")
        trained = {k: v.clone() for k, v in model.state_dict().items()}
        r["cudnn_deterministic"] = torch.backends.cudnn.deterministic
        model.load_state_dict(start)
        repeat = arch_train_run(model, images_u8, masks_u8, dev, 22,
                                ENCODER_STEPS)[0]
        r["repeats"] = repeat == losses
        if not r["repeats"]:
            failures.append(f"{name}: a seeded run gave {repeat}, then {losses}")

        # 4. One unfrozen step at the throughput batch: peak memory or OOM.
        model.load_state_dict(initial)
        r["throughput_batch"] = throughput_step(model, *big, dev)

        # 5. MEDIUM on 256^3 from the trained weights (the trainer's
        # checkpoint writer), equal to its LOW sweeps' merge; the same
        # weights as a JAX VSTPU1 file through model-predict-2d.
        model.load_state_dict(trained)
        ckpt = root / f"{name}.pytorch"
        save_checkpoint(ckpt, model, struc)
        if name == ENCODER_CLI:
            cache_tree = variables_from_smp_state_dict(trained, struc)
        del model, initial, start, trained, after
        prediction_checks(name, ckpt, vol, truth, predict_settings, root, dev,
                          r, failures)
        ckpt.unlink()
        print(json.dumps({"phase": "encoders", "encoder": name, **r}),
              flush=True)

    # 6. model-train-2d with the shipped files as written but
    # `encoder_name: ENCODER_CLI`, from a cached encoder (the trained one
    # above, its first convolution widened to 3 channels: the kernel, then
    # zeros), so the frozen phase runs; then model-predict-2d.
    params = cache_tree["params"]["encoder"]
    node = params
    path = first_conv_path(params)
    for key in path[:-1]:
        node = node[key]
    kernel = node[path[-1]]  # HWIO, I = 1
    node[path[-1]] = np.concatenate(
        [kernel, np.zeros_like(kernel), np.zeros_like(kernel)], axis=2)
    (root / "weights").mkdir()
    (root / "weights" / f"{ENCODER_CLI}.vstpu").write_bytes(msgpack_serialize(
        {"params": params, "batch_stats": cache_tree["batch_stats"]["encoder"]}))
    phases, loaded = [], []

    class CachedTrainer(train_2d_model.VolSeg2dTrainer):
        """Records the phases it trains and whether each model it creates
        took the cached encoder."""

        def _create_model_and_optimiser(self, learning_rate, frozen=False):
            super()._create_model_and_optimiser(learning_rate, frozen)
            loaded.append(self.model.pretrained_loaded)

        def train_model(self, output_path, num_epochs, patience, create=True,
                        frozen=False):
            phases.append(frozen)
            return super().train_model(output_path, num_epochs, patience,
                                       create, frozen)

    text = settings_text(cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=1,
                         num_cyc_unfrozen=1, seed=0)
    saved_env = os.environ.get(WEIGHTS_DIR_ENV)
    os.environ[WEIGHTS_DIR_ENV] = str(root / "weights")
    try:
        rt = cli_round_trip(
            ENCODER_CLI, text.replace('encoder_name: "resnet34"',
                                      f'encoder_name: "{ENCODER_CLI}"'),
            root, out_dir, vol, truth, predict_settings, dev, failures,
            trainer_cls=CachedTrainer)
    finally:
        if saved_env is None:
            del os.environ[WEIGHTS_DIR_ENV]
        else:
            os.environ[WEIGHTS_DIR_ENV] = saved_env
    rt.update(phases_frozen=phases, models_from_cache=loaded)
    if phases[:1] != [True] or not loaded or not all(loaded):
        failures.append(f"{ENCODER_CLI} CLI: frozen phases {phases}, models "
                        f"from the cache {loaded}")
    for entry, count in rt["launches"].items():
        launches[entry] += count
    res["cli"] = rt
    res["launches"] = launches
    res["failures"] = failures
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({k: v for k, v in res.items() if k != "encoders"}),
          flush=True)
    return res


# HDF5 fixtures written by h5py (tests/torch_hdf5_fixtures.py), read on the
# card by the interchange and virtual phases: file -> (dataset path, the
# array it holds), those of the interchange phase, then those of the
# virtual phase.
FIXTURE_DIR = REPO / "tests" / "data" / "torch_hdf5"
FIXTURE_SHAPE = (48, 96, 96)
NEXUS_DATA = "entry/final_result_tomo/data"
INTERCHANGE_READS = {
    "vessels.nxs": (NEXUS_DATA, "vessels"),
    "vessels_latest.h5": ("data", "vessels"),
    "vessels_labels.h5": ("data", "labels"),
    "single_chunk.h5": ("data", "crop"),
    "implicit.h5": ("data", "crop"),
    "fixed_array_paged.h5": ("data", "crop"),
    "btree2.h5": ("data", "crop"),
    "contiguous_latest.h5": ("data", "crop"),
    "superblock_2.h5": ("data", "crop"),
    "user_block.h5": ("data", "crop"),
    "soft_link.nxs": (NEXUS_DATA, "crop"),
}
VIRTUAL_READS = {
    "crop_lzf.h5": ("data", "crop_u2"),
    "crop_scaleoffset_int.h5": ("data", "crop_u2"),
    "crop_scaleoffset_float.h5": ("data", "crop_quarters"),
    "crop_nbit.h5": ("data", "crop"),
    "crop_external.h5": ("data", "crop"),
    "crop_virtual.h5": ("data", "crop_virtual"),
    "tile_lzf.h5": ("data", "tile"),
    "tile_256.h5": ("data", "tile_256"),
    "stitched_lzf.h5": ("data", "stitched_top"),
    "stitched_scaleoffset.h5": ("data", "stitched_bottom"),
    "stitched.nxs": (NEXUS_DATA, "stitched"),
    "stitched_labels.h5": ("data", "stitched_labels"),
    "crop_szip.h5": ("data", "crop"),
    "crop_szip_u2.h5": ("data", "crop_u2"),
    "crop_szip_float.h5": ("data", "crop_quarters"),
    "vessels_szip.h5": ("data", "vessels"),
    "vessels_labels_szip.h5": ("data", "labels"),
    "crop_committed.h5": ("data", "crop_u2"),
    "crop_committed_latest.h5": ("data", "crop_u2"),
    "crop_reduced.h5": ("data", "crop_u2"),
    "crop_nbit_12.h5": ("data", "crop_u2"),
    "crop_nbit_signed.h5": ("data", "crop_signed"),
    "crop_saturated.h5": ("data", "crop_saturated"),
}
# What the library writes beyond h5py's defaults, read by the virtual
# phase's step 6: h5py's bool and an enumeration, offsets and lengths of
# (offsets, lengths) bytes at superblock 0 and 3, and partial edge chunks
# stored unfiltered.
SIZED_FIXTURES = [(f"crop_sizes_{o}{n}{'_latest' if libver == 'latest' else ''}.h5",
                   (o, n), libver)
                  for o, n in ((4, 4), (8, 4), (4, 8), (2, 2))
                  for libver in ("earliest", "latest")]
OPTION_READS = {
    "labels_bool.h5": ("data", "labels_bool"),
    "crop_enum.h5": ("data", "crop_enum"),
    **{name: ("data", "crop") for name, _, _ in SIZED_FIXTURES},
    "vessels_sizes_44_edges.h5": ("data", "vessels"),
    "crop_edges_fixed.h5": ("data", "crop"),
    "crop_edges_extensible.h5": ("data", "crop"),
    "crop_edges_btree2.h5": ("data", "crop"),
}
FIXTURE_READS = {**INTERCHANGE_READS, **VIRTUAL_READS, **OPTION_READS}
# Virtual datasets committed without their sources, which the virtual
# phase and the tests write beside a copy with the port's writer: a
# printf-style (%b) mapping of Z blocks of BLOCK_DEPTH slices, one file a
# block (`write_block_sources`), and an unlimited mapping whose extent
# follows its one source's.
BLOCKS_VDS, BLOCK_SOURCE, BLOCK_DEPTH = "vessels_blocks.h5", "vessels_block_%b.h5", 64
GROWING_VDS, GROWING_SOURCE = "growing_virtual.h5", "growing_source.h5"
# Committed beside them: the 512^3 virtual dataset over the tile (read by
# the virtual phase's step 2), the external raw data file and the two
# virtual datasets above.
FIXTURE_OTHERS = ("tile_512.h5", "crop_external.raw", BLOCKS_VDS, GROWING_VDS)
TILE_SIDE, TILE_COPIES = 64, (4, 8)  # the tile, its copies a side in the two VDS
VIRTUAL_FILL = 7  # the fill value of crop_virtual.h5
INTERCHANGE_ENCODERS = {"resnet34": "torchvision", "efficientnet-b3": "lukemelas"}
INTERCHANGE_LAZY_VOXELS = 100_000  # below the fixture volume's 442,368


def field_of_view(side: int) -> np.ndarray:
    """The pixels of a side x side slice inside a micro-CT reconstruction's
    field of view: a centred disc of radius 0.45 side (`field_of_view_cut`)."""
    yx = np.arange(side) - (side - 1) / 2
    return yx[:, None] ** 2 + yx[None, :] ** 2 <= (0.45 * side) ** 2


def fixture_arrays() -> dict:
    """The arrays the HDF5 fixtures hold, rebuilt without h5py: the vessels
    volume and its labels, a (12, 24, 24) crop of the volume, the crop as
    uint16 and in float32 quarters (scale-offset with 2 decimal digits
    stores those exactly), the four quadrants of crop_virtual.h5; the
    vessels volume and labels with the slices' corners outside the field of
    view zeroed ("stitched", as uint16, and its halves as stored), and a
    64^3 vessels tile cut so, alone and tiled 4 x 4 x 4; the crop less 128
    as int16 ("crop_signed"), and saturated to int8; the labels as bool,
    and the crop spread to the values of an int16 enumeration with gaps
    between them ("crop_enum": 3 x - 300)."""
    vol, labels = make_vessel_volume(FIXTURE_SHAPE, seed=1)
    crop = np.ascontiguousarray(vol[:12, :24, :24])
    crop_u2 = crop.astype(np.uint16) * 3 + 1000
    quadrants = np.full((12, 48, 48), VIRTUAL_FILL, np.uint16)
    quadrants[:, :24, :24] = crop
    quadrants[:, :24, 24:] = crop_u2
    quadrants[:, 24:, 24:] = crop
    inside = field_of_view(FIXTURE_SHAPE[1])
    stitched = (vol * inside).astype(np.uint16)
    signed = crop.astype(np.int16) - 128
    tile = make_vessel_volume((TILE_SIDE,) * 3, seed=4)[0] * field_of_view(TILE_SIDE)
    half = FIXTURE_SHAPE[0] // 2
    return {"vessels": vol, "labels": labels, "crop": crop, "crop_u2": crop_u2,
            "crop_quarters": (crop.astype(np.float32) - 100) / 4,
            "crop_virtual": quadrants, "stitched": stitched,
            "stitched_top": stitched[:half].astype(np.uint8),
            "stitched_bottom": stitched[half:],
            "stitched_labels": labels * inside.astype(np.uint8),
            "tile": tile, "tile_256": np.tile(tile, (TILE_COPIES[0],) * 3),
            "crop_signed": signed,
            "crop_saturated": np.minimum(crop, 127).astype(np.int8),
            "labels_bool": labels.astype(bool),
            "crop_enum": crop.astype(np.int16) * 3 - 300}


def write_block_sources(folder: Path, vol: np.ndarray) -> None:
    """`vol`'s Z blocks of BLOCK_DEPTH slices as the sources of BLOCKS_VDS
    in `folder`, with the port's writer."""
    from volume_segmantics_tpu_torch.utils import hdf5

    for b in range(len(vol) // BLOCK_DEPTH):
        hdf5.write(folder / BLOCK_SOURCE.replace("%b", str(b)),
                   vol[b * BLOCK_DEPTH:(b + 1) * BLOCK_DEPTH])


def seeded_encoder_file(encoder_name: str, path: Path, seed=5) -> dict:
    """A seeded 3-channel encoder state_dict saved as a .pth in torchvision
    names (ResNet) or lukemelas names (EfficientNet, with its unused
    classification tail), as the port's names are; returns it."""
    from volume_segmantics_tpu_torch.models.registry import create_model

    model = create_model({"type": "U_Net", "encoder_name": encoder_name,
                          "encoder_weights": None, "in_channels": 3,
                          "classes": 2},
                         generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in model.state_dict().items():
        if not key.startswith("encoder."):
            continue
        if key.endswith("running_var"):
            value = torch.from_numpy(rng.uniform(0.5, 1.5, value.shape)
                                     .astype(np.float32))
        elif key.endswith(("running_mean", ".bias")) or (
                value.dtype == torch.float32 and value.ndim == 1):
            value = torch.from_numpy(rng.normal(0, 0.1, value.shape)
                                     .astype(np.float32))
        sd[key[len("encoder."):]] = value.clone()
    torch.save(sd, path)
    return sd


def interchange_phase(dev, out_dir: Path):
    """HDF5 and NeXus files as h5py writes them, the encoder cache written
    without JAX, and `spatial_partitions` (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
        frozen_parameter_names,
    )
    from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device
    from volume_segmantics_tpu_torch.models.pretrained import (
        WEIGHTS_DIR_ENV,
        first_conv_path,
    )
    from volume_segmantics_tpu_torch.models.torch_export import (
        encoder_state_dict_from_variables,
    )
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import (
        convert_torch_encoder,
        predict_2d_model,
        train_2d_model,
    )
    from volume_segmantics_tpu_torch.utils import hdf5
    from volume_segmantics_tpu_torch.utils.flax_msgpack import msgpack_restore

    failures, res = [], {"phase": "interchange"}
    root = out_dir / "interchange"
    shutil.rmtree(root, ignore_errors=True)
    (root / "weights").mkdir(parents=True)
    t_phase = time.perf_counter()

    # 1. Every fixture reads equal to the array rebuilt here.
    arrays = fixture_arrays()
    reads = {}
    for name, (internal, array) in INTERCHANGE_READS.items():
        t0 = time.perf_counter()
        with hdf5.File(FIXTURE_DIR / name) as f:
            ds = f[internal]
            got, chunks = ds[()], ds.chunks
        reads[name] = {"s": time.perf_counter() - t0, "chunks": chunks,
                       "equal": bool(got.dtype == arrays[array].dtype
                                     and np.array_equal(got, arrays[array]))}
        if not reads[name]["equal"]:
            failures.append(f"fixture {name}:{internal} differs from {array}")
    res["reads"] = reads

    # 2. The encoder caches, from seeded .pth files through the command.
    def expected_encoder(cache: Path, encoder_name: str) -> dict:
        """The converter's output as a 1-channel model's `encoder.*`
        entries: the first convolution summed over its 3 inputs."""
        blob = msgpack_restore(cache.read_bytes())
        params = blob["params"]
        node = params
        for key in first_conv_path(params)[:-1]:
            node = node[key]
        leaf = first_conv_path(params)[-1]
        node[leaf] = node[leaf].sum(axis=2, keepdims=True)
        return encoder_state_dict_from_variables(params, blob["batch_stats"],
                                                 encoder_name)

    caches = {}
    for encoder_name, naming in INTERCHANGE_ENCODERS.items():
        pth = root / f"{encoder_name}_{naming}.pth"
        seeded_encoder_file(encoder_name, pth)
        t0 = time.perf_counter()
        cache = convert_torch_encoder.main([encoder_name, str(pth), "--out-dir",
                                            str(root / "weights")])
        caches[encoder_name] = {"convert_s": time.perf_counter() - t0,
                                "mb": cache.stat().st_size / 1e6}
    saved_env = os.environ.get(WEIGHTS_DIR_ENV)
    os.environ[WEIGHTS_DIR_ENV] = str(root / "weights")
    try:
        # EfficientNet-B3 from its lukemelas cache: loaded bit for bit.
        struc = {"type": "U_Net", "encoder_name": "efficientnet-b3",
                 "encoder_weights": "imagenet", "in_channels": 1, "classes": 2}
        model = create_model_on_device(dev, struc)
        expected = expected_encoder(root / "weights" / "efficientnet-b3.vstpu",
                                    "efficientnet-b3")
        own = model.state_dict()
        caches["efficientnet-b3"]["loaded_equal"] = bool(
            model.pretrained_loaded and set(expected) <= set(own) and all(
                torch.equal(own[k].cpu(), v) for k, v in expected.items()))
        del model, own

        # 3. model-train-2d at the shipped settings' width on vessels.nxs,
        # its volume behind an external link, from the resnet34 cache.
        (root / cfg.SETTINGS_DIR).mkdir()
        (root / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN).write_text(
            settings_text(cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=1,
                          num_cyc_unfrozen=1, seed=0))
        trainers, frozen_after = [], {}

        class RecordedTrainer(train_2d_model.VolSeg2dTrainer):
            """Records the encoder of the model it creates and the frozen
            parameters at the end of the frozen phase."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.encoders_at_create = []
                trainers.append(self)

            def _create_model_and_optimiser(self, learning_rate, frozen=False):
                super()._create_model_and_optimiser(learning_rate, frozen)
                self.encoders_at_create.append(
                    (self.model.pretrained_loaded,
                     {n: v.detach().cpu().clone()
                      for n, v in self.model.state_dict().items()
                      if n.startswith("encoder.")}))

            def train_model(self, output_path, num_epochs, patience,
                            create=True, frozen=False):
                out = super().train_model(output_path, num_epochs, patience,
                                          create, frozen)
                if frozen:
                    names = frozen_parameter_names(self.model,
                                                   self.model_struc_dict)
                    frozen_after.update({
                        n: p.detach().cpu().clone()
                        for n, p in self.model.named_parameters() if n in names})
                return out

        train_2d_model.VolSeg2dTrainer = RecordedTrainer
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            train_2d_model.main(["--data", str(FIXTURE_DIR / "vessels.nxs"),
                                 "--labels", str(FIXTURE_DIR / "vessels_labels.h5"),
                                 "--data_dir", str(root)])
        finally:
            train_2d_model.VolSeg2dTrainer = RecordedTrainer.__bases__[0]
        torch.cuda.synchronize()
        res["train_main_s"] = time.perf_counter() - t0
    finally:
        if saved_env is None:
            del os.environ[WEIGHTS_DIR_ENV]
        else:
            os.environ[WEIGHTS_DIR_ENV] = saved_env
    res["launches"] = dict(kernels.LAUNCHES)
    trainer = trainers[0]
    expected = expected_encoder(root / "weights" / "resnet34.vstpu", "resnet34")
    loaded, at_create = trainer.encoders_at_create[0]
    caches["resnet34"]["loaded_equal"] = bool(
        loaded and set(at_create) >= set(expected)
        and all(torch.equal(at_create[k], v) for k, v in expected.items()))
    res["caches"] = caches
    for name, entry in caches.items():
        if not entry["loaded_equal"]:
            failures.append(f"the {name} encoder as loaded differs from the "
                            "converter's output")
    res["frozen_parameters"] = len(frozen_after)
    res["frozen_unchanged"] = bool(frozen_after) and all(
        torch.equal(v, at_create[n]) for n, v in frozen_after.items())
    if not res["frozen_unchanged"]:
        failures.append(f"{len(frozen_after)} frozen parameters moved in the "
                        "frozen epoch")
    for entry, count in res["launches"].items():
        if count != trainer.train_steps:
            failures.append(f"{entry} launched {count} times in the .nxs run's "
                            f"{trainer.train_steps} train steps")
    res.update({"train_steps": trainer.train_steps,
                "eval_scores": trainer.avg_eval_scores})
    ckpt = train_2d_model._model_output_path(trainer.settings, root)
    del trainers, trainer

    # 4. model-predict-2d on vessels.nxs in memory and slab-streamed from a
    # lazy source, and on the default-layout copy `utils/hdf5.write` makes.
    vol = arrays["vessels"]
    labels = {}
    for run, source, edits in (
            ("in_memory", FIXTURE_DIR / "vessels.nxs", {}),
            ("streamed", FIXTURE_DIR / "vessels.nxs",
             {"lazy_ingest_threshold": INTERCHANGE_LAZY_VOXELS,
              "streaming_threshold": INTERCHANGE_LAZY_VOXELS}),
            ("default_layout", root / "vessels_default.h5", {})):
        data_dir = root / run
        (data_dir / cfg.SETTINGS_DIR).mkdir(parents=True)
        (data_dir / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN).write_text(
            settings_text(cfg.PREDICTION_SETTINGS_FN, **edits))
        if run == "default_layout":
            hdf5.write(source, vol)
        t0 = time.perf_counter()
        predict_2d_model.main([str(ckpt), str(source), "--data_dir", str(data_dir)])
        res[f"predict_{run}_s"] = time.perf_counter() - t0
        labels[run], _ = hdf5.read(predict_2d_model.create_output_path(
            data_dir, source))
    res["predictions_equal"] = {
        run: bool(np.array_equal(labels[run], labels["in_memory"]))
        for run in ("streamed", "default_layout")}
    res["labels_shape"] = list(labels["in_memory"].shape)
    res["label_agreement_with_truth"] = float(
        (labels["in_memory"] == arrays["labels"]).mean())
    if labels["in_memory"].shape != vol.shape:
        failures.append(f"labels of shape {labels['in_memory'].shape}")
    for run, equal in res["predictions_equal"].items():
        if not equal:
            failures.append(f"{run} labels differ from the in-memory ones")

    # 5. spatial_partitions: 2 on one GPU raises the JAX package's error.
    settings = training_settings()
    settings.spatial_partitions = 2
    slices = [arrays["crop"][i] for i in range(4)]
    try:
        train_2d_model.VolSeg2dTrainer(slices, slices, 2, settings, device=dev)
        res["spatial_partitions_error"] = None
    except (ValueError, NotImplementedError) as e:
        res["spatial_partitions_error"] = f"{type(e).__name__}: {e}"
    count = torch.cuda.device_count()
    want = (f"ValueError: spatial_partitions=2 must divide the device count "
            f"({count})." if count % 2 else "NotImplementedError: ")
    if not (res["spatial_partitions_error"] or "").startswith(want):
        failures.append(f"spatial_partitions: 2 on {count} GPUs raised "
                        f"{res['spatial_partitions_error']!r}, not {want!r}")
    res["phase_s"] = time.perf_counter() - t_phase
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


VIRTUAL_LAZY_VOXELS = 100_000  # far below 256^3: lazy ingest and streaming
VIRTUAL_SLAB = 64  # slices a `LazyHDF5Volume` read of the 512^3 volume takes


def virtual_phase(dev, out_dir: Path):
    """LZF, scale-offset, n-bit, external raw storage and virtual datasets
    from h5py-written fixtures (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
        frozen_parameter_names,
    )
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
    from volume_segmantics_tpu_torch.scripts import predict_2d_model, train_2d_model
    from volume_segmantics_tpu_torch.utils import hdf5
    from volume_segmantics_tpu_torch.utils.base_data_utils import LazyHDF5Volume

    failures, res = [], {"phase": "virtual"}
    root = out_dir / "virtual"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()

    # 1. Every fixture equal to its array rebuilt here; the best of three
    # reads, in MB/s of the decoded array. The external raw data file is
    # found beside its HDF5 file through $HDF5_EXTFILE_PREFIX.
    arrays = fixture_arrays()
    reads = {}
    saved_prefix = os.environ.get(hdf5.EXTFILE_PREFIX_ENV)
    os.environ[hdf5.EXTFILE_PREFIX_ENV] = hdf5.ORIGIN
    try:
        for name, (internal, array) in VIRTUAL_READS.items():
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                with hdf5.File(FIXTURE_DIR / name) as f:
                    ds = f[internal]
                    got = ds[()]
                times.append(time.perf_counter() - t0)
            filters = [hdf5.FILTER_NAMES[fid] for fid, _, _ in ds._filters]
            reads[name] = {
                "s": min(times), "mb_per_s": got.nbytes / min(times) / 1e6,
                "filters": filters, "layout": ds._layout_class,
                "equal": bool(got.dtype == arrays[array].dtype
                              and np.array_equal(got, arrays[array]))}
            if not reads[name]["equal"]:
                failures.append(f"fixture {name}:{internal} differs from {array}")
    finally:
        if saved_prefix is None:
            del os.environ[hdf5.EXTFILE_PREFIX_ENV]
        else:
            os.environ[hdf5.EXTFILE_PREFIX_ENV] = saved_prefix
    res["reads"] = reads

    # 2. The 512^3 virtual dataset over the LZF tile: whole, then as lazy
    # slabs.
    copies = TILE_COPIES[1]
    tiled = np.tile(arrays["tile"], (copies,) * 3)
    path = FIXTURE_DIR / f"tile_{TILE_SIDE * copies}.h5"
    t0 = time.perf_counter()
    with hdf5.File(path) as f:
        ds = f["data"]
        whole = ds[()]
        seconds = time.perf_counter() - t0
        big = {"s": seconds, "mb_per_s": whole.nbytes / seconds / 1e6,
               "mappings": len(ds._mappings), "opened_sources": ds.opened_sources,
               "inflated_chunks": ds.inflated_chunks,
               "equal": bool(np.array_equal(whole, tiled))}
    del whole
    lazy = LazyHDF5Volume(path)
    try:
        slab_s, equal = [], True
        for z in range(0, lazy.shape[0], VIRTUAL_SLAB):
            t0 = time.perf_counter()
            part = lazy[z:z + VIRTUAL_SLAB]
            slab_s.append(time.perf_counter() - t0)
            equal &= bool(np.array_equal(part, tiled[z:z + VIRTUAL_SLAB]))
        big.update(slab=VIRTUAL_SLAB, slab_s=slab_s, slabs_s=sum(slab_s),
                   slabs_equal=equal, lazy_inflated_chunks=lazy.inflated_chunks)
    finally:
        lazy.close()
    res["vds_512"] = big
    if not (big["equal"] and big["slabs_equal"]):
        failures.append(f"the 512^3 virtual dataset differs from the tiled tile: "
                        f"whole {big['equal']}, slabs {big['slabs_equal']}")
    del tiled

    # 3. model-train-2d with the shipped settings on the stitched NeXus
    # volume (LZF and scale-offset sources) and scale-offset labels.
    (root / cfg.SETTINGS_DIR).mkdir()
    (root / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN).write_text(
        settings_text(cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=1,
                      num_cyc_unfrozen=1, seed=0))
    trainers, frozen_state = [], {}

    class RecordedTrainer(train_2d_model.VolSeg2dTrainer):
        """Records the frozen parameters of the model it creates for the
        frozen epoch, and whether they kept their bits through it."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

        def _frozen_parameters(self):
            names = frozen_parameter_names(self.model, self.model_struc_dict)
            return {n: p.detach().cpu().clone()
                    for n, p in self.model.named_parameters() if n in names}

        def _create_model_and_optimiser(self, learning_rate, frozen=False):
            super()._create_model_and_optimiser(learning_rate, frozen)
            if frozen:
                frozen_state["at_create"] = self._frozen_parameters()

        def train_model(self, output_path, num_epochs, patience, create=True,
                        frozen=False):
            out = super().train_model(output_path, num_epochs, patience, create,
                                      frozen)
            if frozen:
                after = self._frozen_parameters()
                frozen_state.update(count=len(after), unchanged=bool(after) and all(
                    torch.equal(v, frozen_state["at_create"][n])
                    for n, v in after.items()))
            return out

    train_2d_model.VolSeg2dTrainer = RecordedTrainer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_2d_model.main(["--data", str(FIXTURE_DIR / "stitched.nxs"),
                             "--labels", str(FIXTURE_DIR / "stitched_labels.h5"),
                             "--data_dir", str(root)])
    finally:
        train_2d_model.VolSeg2dTrainer = RecordedTrainer.__bases__[0]
    torch.cuda.synchronize()
    res["train_main_s"] = time.perf_counter() - t0
    res["launches"] = dict(kernels.LAUNCHES)
    trainer = trainers[0]
    losses = trainer.avg_train_losses + trainer.avg_valid_losses
    res.update({"train_steps": trainer.train_steps,
                "avg_train_losses": trainer.avg_train_losses,
                "eval_scores": trainer.avg_eval_scores,
                "frozen_parameters": frozen_state.get("count", 0),
                "frozen_unchanged": frozen_state.get("unchanged", False)})
    if not losses or not all(np.isfinite(losses)):
        failures.append(f"stitched run losses {losses}")
    if not trainer.avg_eval_scores or not all(np.isfinite(trainer.avg_eval_scores)):
        failures.append(f"stitched run eval scores {trainer.avg_eval_scores}")
    if not res["frozen_unchanged"]:
        failures.append(f"{res['frozen_parameters']} frozen parameters moved in "
                        "the frozen epoch of the stitched run")
    for entry, count in res["launches"].items():
        if count != trainer.train_steps:
            failures.append(f"{entry} launched {count} times in the stitched run's "
                            f"{trainer.train_steps} train steps")
    ckpt = train_2d_model._model_output_path(trainer.settings, root)
    del trainers, trainer

    # 4. model-predict-2d on the 256^3 virtual dataset over the tile in
    # memory, slab-streamed from a lazy source, and from a gzip copy of the
    # materialised volume: labels equal at every voxel.
    source = FIXTURE_DIR / f"tile_{TILE_SIDE * TILE_COPIES[0]}.h5"
    labels = {}
    for run, edits in (("in_memory", {}),
                       ("streamed", {"lazy_ingest_threshold": VIRTUAL_LAZY_VOXELS,
                                     "streaming_threshold": VIRTUAL_LAZY_VOXELS}),
                       ("materialised", {})):
        data_dir = root / run
        (data_dir / cfg.SETTINGS_DIR).mkdir(parents=True)
        (data_dir / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN).write_text(
            settings_text(cfg.PREDICTION_SETTINGS_FN, **edits))
        src = source
        if run == "materialised":
            src = root / "tile_256_gzip.h5"
            t0 = time.perf_counter()
            hdf5.write(src, hdf5.read(source)[0])
            res["materialise_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        predict_2d_model.main([str(ckpt), str(src), "--data_dir", str(data_dir)])
        res[f"predict_{run}_s"] = time.perf_counter() - t0
        labels[run], _ = hdf5.read(predict_2d_model.create_output_path(data_dir, src))
    res["predictions_equal"] = {
        run: bool(np.array_equal(labels[run], labels["in_memory"]))
        for run in ("streamed", "materialised")}
    res["labels_shape"] = list(labels["in_memory"].shape)
    res["foreground_share"] = float((labels["in_memory"] > 0).mean())
    if labels["in_memory"].shape != arrays["tile_256"].shape:
        failures.append(f"labels of shape {labels['in_memory'].shape}")
    for run, equal in res["predictions_equal"].items():
        if not equal:
            failures.append(f"{run} labels differ from the in-memory ones")

    # 4b. The %b virtual dataset over the same 256^3 volume as four Z
    # blocks, one file each from the port's writer: read whole (the best
    # of three, MB/s), then model-predict-2d: labels equal to the gzip
    # copy's. The unlimited virtual dataset: equal to its source, then to
    # the source rewritten larger.
    blocks_dir = root / "blocks"
    (blocks_dir / cfg.SETTINGS_DIR).mkdir(parents=True)
    (blocks_dir / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN).write_text(
        settings_text(cfg.PREDICTION_SETTINGS_FN))
    shutil.copy(FIXTURE_DIR / BLOCKS_VDS, blocks_dir)
    shutil.copy(FIXTURE_DIR / GROWING_VDS, blocks_dir)
    volume = arrays["tile_256"]
    t0 = time.perf_counter()
    write_block_sources(blocks_dir, volume)
    blocks = {"write_s": time.perf_counter() - t0, "times_s": []}
    for _ in range(3):
        t0 = time.perf_counter()
        with hdf5.File(blocks_dir / BLOCKS_VDS) as f:
            ds = f["data"]
            whole = ds[()]
            mappings = len(ds._mappings)
        blocks["times_s"].append(time.perf_counter() - t0)
    blocks.update(s=min(blocks["times_s"]),
                  mb_per_s=whole.nbytes / min(blocks["times_s"]) / 1e6,
                  shape=list(whole.shape), mappings=mappings,
                  equal=bool(np.array_equal(whole, volume)))
    del whole
    t0 = time.perf_counter()
    predict_2d_model.main([str(ckpt), str(blocks_dir / BLOCKS_VDS),
                           "--data_dir", str(blocks_dir)])
    blocks["predict_s"] = time.perf_counter() - t0
    block_labels, _ = hdf5.read(predict_2d_model.create_output_path(
        blocks_dir, Path(BLOCKS_VDS)))
    blocks["labels_equal_gzip"] = bool(np.array_equal(block_labels,
                                                      labels["materialised"]))
    if not (blocks["equal"] and blocks["labels_equal_gzip"]):
        failures.append(f"the %b virtual dataset: read equal {blocks['equal']}, "
                        f"labels equal {blocks['labels_equal_gzip']}")
    growing = []
    crop = arrays["crop_u2"]
    for source in (crop, np.concatenate([crop, crop[:8] + 1])):
        hdf5.write(blocks_dir / GROWING_SOURCE, source)
        got = hdf5.read(blocks_dir / GROWING_VDS)[0]
        growing.append({"shape": list(got.shape),
                        "equal": bool(np.array_equal(got, source))})
        if not growing[-1]["equal"]:
            failures.append(f"the unlimited virtual dataset over a source of "
                            f"{source.shape}: {growing[-1]}")
    res["blocks"], res["growing"] = blocks, growing
    del labels, block_labels

    # 5. szip: model-train-2d (0 + 1 epochs) on the vessels volume and its
    # labels as szip chunks, then model-predict-2d from the stitched run's
    # checkpoint on the szip copy of the volume and on its gzip copy.
    szip_dir = root / "szip"
    (szip_dir / cfg.SETTINGS_DIR).mkdir(parents=True)
    (szip_dir / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN).write_text(
        settings_text(cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=0,
                      num_cyc_unfrozen=1, seed=0))
    (szip_dir / cfg.SETTINGS_DIR / cfg.PREDICTION_SETTINGS_FN).write_text(
        settings_text(cfg.PREDICTION_SETTINGS_FN))
    szip, szip_slices = recorded_train_run(
        szip_dir, FIXTURE_DIR / "vessels_szip.h5",
        FIXTURE_DIR / "vessels_labels_szip.h5", "szip", failures)
    szip_labels = {}
    for run, src in (("szip", FIXTURE_DIR / "vessels_szip.h5"),
                     ("gzip", FIXTURE_DIR / "vessels_latest.h5")):
        t0 = time.perf_counter()
        predict_2d_model.main([str(ckpt), str(src), "--data_dir", str(szip_dir)])
        szip[f"predict_{run}_s"] = time.perf_counter() - t0
        szip_labels[run], _ = hdf5.read(
            predict_2d_model.create_output_path(szip_dir, src))
    szip["labels_equal"] = bool(np.array_equal(szip_labels["szip"],
                                               szip_labels["gzip"]))
    szip["labels_shape"] = list(szip_labels["szip"].shape)
    if not szip["labels_equal"] or (szip_labels["szip"].shape
                                    != arrays["vessels"].shape):
        failures.append(f"the szip volume's labels {szip['labels_shape']} "
                        "differ from the gzip copy's")
    res["szip"] = szip

    # 6. What the library writes beyond h5py's defaults: every fixture of
    # OPTION_READS equal to its array (the best of three reads, MB/s);
    # model-train-2d (0 + 1 epochs) on the vessels volume in a file of
    # 4-byte offsets and lengths with unfiltered partial edge chunks, and
    # its labels as h5py's bool: the slicer hands the trainer step 5's
    # arrays, the checkpoint's label codes are label_val_False and
    # label_val_True, and the run writes every output step 5's wrote.
    t_step = time.perf_counter()
    options = {"reads": {}}
    for name, (internal, array) in OPTION_READS.items():
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            with hdf5.File(FIXTURE_DIR / name) as f:
                got = f[internal][()]
                sizes = (f.offset_size, f.length_size)
            times.append(time.perf_counter() - t0)
        options["reads"][name] = {
            "s": min(times), "mb_per_s": got.nbytes / min(times) / 1e6,
            "sizes": sizes, "dtype": str(got.dtype),
            "equal": bool(got.dtype == arrays[array].dtype
                          and np.array_equal(got, arrays[array]))}
        if not options["reads"][name]["equal"]:
            failures.append(f"fixture {name}:{internal} differs from {array}")
    bool_dir = root / "bool"
    (bool_dir / cfg.SETTINGS_DIR).mkdir(parents=True)
    shutil.copy(szip_dir / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN,
                bool_dir / cfg.SETTINGS_DIR)
    run, slices = recorded_train_run(
        bool_dir, FIXTURE_DIR / "vessels_sizes_44_edges.h5",
        FIXTURE_DIR / "labels_bool.h5", "bool labels", failures)
    options.update(run)
    options["slices_equal_szip"] = slices == szip_slices
    if not options["slices_equal_szip"]:
        failures.append("the bool-label run's slices differ from the szip run's")
    (ckpt_file,) = bool_dir.glob("*_trained_2d_model.pytorch")
    options["label_codes"] = load_checkpoint(ckpt_file)["label_codes"]
    if options["label_codes"] != {"0": "label_val_False", "1": "label_val_True"}:
        failures.append(f"the bool-label run's codes {options['label_codes']}")
    if run["outputs"] != szip["outputs"]:
        failures.append(f"the bool-label run wrote {run['outputs']}, the szip "
                        f"run {szip['outputs']}")
    options["step_s"] = time.perf_counter() - t_step
    res["options"] = options
    res["launches"] = {entry: res["launches"][entry] + szip["launches"][entry]
                       + run["launches"][entry] for entry in res["launches"]}
    shutil.rmtree(root, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


def recorded_train_run(data_dir: Path, data: Path, labels: Path, tag: str,
                       failures: list):
    """`model-train-2d` on `data` and `labels` with the settings in
    `data_dir`: ({its seconds, the kernels' launches, the train steps, the
    eval scores, the files it wrote with their dates cut}, a digest of
    the slices the trainer was handed). Non-finite losses or a kernel
    launched other than once a train step go into `failures`."""
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.scripts import train_2d_model

    trainers, handed = [], []

    class Recorded(train_2d_model.VolSeg2dTrainer):
        def __init__(self, data, labels, *args, **kwargs):
            h = hashlib.sha256()
            for s in (*data, *labels):
                h.update(f"{s.shape}{s.dtype}".encode())
                h.update(np.ascontiguousarray(s).tobytes())
            handed.append(h.hexdigest())
            super().__init__(data, labels, *args, **kwargs)
            trainers.append(self)

    train_2d_model.VolSeg2dTrainer = Recorded
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_2d_model.main(["--data", str(data), "--labels", str(labels),
                             "--data_dir", str(data_dir)])
    finally:
        train_2d_model.VolSeg2dTrainer = Recorded.__bases__[0]
    torch.cuda.synchronize()
    (trainer,) = trainers
    run = {"train_main_s": time.perf_counter() - t0,
           "launches": dict(kernels.LAUNCHES), "train_steps": trainer.train_steps,
           "eval_scores": trainer.avg_eval_scores,
           "outputs": sorted(p.name.split("_", 1)[1] for p in data_dir.iterdir()
                             if p.is_file())}
    losses = trainer.avg_train_losses + trainer.avg_valid_losses
    if not losses or not all(np.isfinite(losses + trainer.avg_eval_scores)):
        failures.append(f"{tag} run losses {losses} eval {trainer.avg_eval_scores}")
    for entry, count in run["launches"].items():
        if count != trainer.train_steps:
            failures.append(f"{entry} launched {count} times in the {tag} run's "
                            f"{trainer.train_steps} train steps")
    return run, handed[0]


PARALLEL_STEPS_ONE = 10  # NCCL world 1: DP steps, then as many plain ones (20
# until the spatial phase came)
PARALLEL_STEPS_TWO = 6  # two gloo ranks on one card, float32 (10 before (d))
SUBMESH_STEPS = 2  # (2b): the mesh over rank 0 of two, against one process
PARALLEL_LR = 1e-4  # world 1: bit for bit at any rate
# Two ranks against one process: Adam moves an element whose gradient is
# within float32 noise by 2 x lr either way, and over 10 steps at 1e-4 the
# losses drifted 1.4e-3 apart (first card run); at 1e-6 the steps stay
# linear, as `tests/torch_parallel_steps.py` takes 1e-5 for its two.
PARALLEL_LR_TWO = 1e-6
PARALLEL_TRAIN_SHAPE = (48, 96, 96)  # model-train-2d over two ranks
PARALLEL_TIMEOUT_S = 600  # a hung rank fails the phase, not the call


def digest(state: dict) -> str:
    """A hash of a state_dict's bytes: equal digests, equal tensors."""
    h = hashlib.sha256()
    for name, t in state.items():
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def model_from_state(struc, state, dev):
    """`struc`'s model on `dev` holding `state`, built on the meta device
    (no initialisation: every tensor is loaded)."""
    from volume_segmantics_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        model = create_model(struc)
    model = model.to_empty(device=dev)
    model.load_state_dict(state)
    return model


def dp_run(state, images, masks, mesh, steps, compute_dtype, dev, lr, dp=True,
           seed=3, side=S, digests=False, struc=STRUC):
    """`steps` seeded DiceLoss train steps of `struc`'s model from `state`
    on this rank's rows of the global batch (augmentation on, to `side`):
    the data-parallel step over `mesh` (its space partitions too), or with
    `dp` False the plain one. Returns the losses, each step's synchronised
    ms, the kernel launches, the first step's gradients, parameters and
    running statistics, the final state and, with `digests`, the state's
    digest after each step."""
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel.train import (
        build_dp_train_step,
        build_train_step,
        make_base_optimizer,
    )

    model = model_from_state(struc, state, dev)
    optimizer = make_base_optimizer(model.parameters())
    gens = (torch.Generator(dev).manual_seed(seed),
            torch.Generator(dev).manual_seed(seed + 1))
    common = dict(num_labels=2, image_size=side, compute_dtype=compute_dtype,
                  augment=True, generator=gens[0], dropout_generator=gens[1])
    loss_fn = get_loss_fn(loss_settings("DiceLoss"))
    step = (build_dp_train_step(model, loss_fn, optimizer, mesh=mesh, **common)
            if dp else build_train_step(model, loss_fn, optimizer, **common))
    rows = mesh.rows(images.shape[0]) if dp else slice(None)
    x = torch.from_numpy(images[rows]).to(dev)
    y = torch.from_numpy(masks[rows]).to(dev)
    out = {"losses": [], "ms": [], "digests": []}
    kernels.reset_launch_counts()
    for k in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["losses"].append(step(x, y, lr).item())
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        if digests:
            out["digests"].append(digest(model.state_dict()))
        if k == 0:
            sd = model.state_dict()
            out["grads1"] = {n: p.grad.clone() for n, p in model.named_parameters()}
            out["params1"] = {n: sd[n].clone() for n in out["grads1"]}
            out["stats1"] = {n: v.clone() for n, v in sd.items()
                             if n.endswith(("running_mean", "running_var"))}
    out["launches"] = dict(kernels.LAUNCHES)
    out["final"] = {n: v.clone() for n, v in model.state_dict().items()}
    out["model"] = model
    return out


def _bn_act_float64(self, x):
    """BnAct's training forward in the input's own precision, running
    statistics updated alike (the port's casts to float32)."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
    mul = torch.rsqrt(var + self.eps) * self.weight
    y = x * mul[:, None, None] + (self.bias - mean * mul)[:, None, None]
    if self.act == "relu":
        return torch.relu(y)
    return torch.nn.functional.silu(y) if self.act == "silu" else y


def float64_first_step(state, images, masks, dev, seed=3):
    """The first step's gradients and running statistics in float64 (the
    augmentation drawn as the steps draw it, in float32)."""
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.models.layers import BnAct
    from volume_segmantics_tpu_torch.ops.augment import augment_batch_u8
    from volume_segmantics_tpu_torch.parallel.train import normalise

    model = model_from_state(STRUC, state, dev).double().train()
    imgs, msks = augment_batch_u8(torch.Generator(dev).manual_seed(seed),
                                  torch.from_numpy(images).to(dev),
                                  torch.from_numpy(masks).to(dev), S)
    targets = torch.nn.functional.one_hot(msks.long(), 2).permute(0, 3, 1, 2)
    forward, BnAct.forward = BnAct.forward, _bn_act_float64
    try:
        get_loss_fn(loss_settings("DiceLoss"))(
            model(normalise(imgs.double())), targets.double()).backward()
    finally:
        BnAct.forward = forward
    stats = {n: v for n, v in model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return {n: p.grad for n, p in model.named_parameters()}, stats


def float64_first_loss(struc, state, images, masks, dev, seed=3) -> float:
    """The first `dp_run` step's loss of `struc`'s model in float64: the
    same augmentation draws (in float32) and dropout masks, BatchNorm in
    float64."""
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.models.layers import (
        BnAct,
        set_dropout_generator,
    )
    from volume_segmantics_tpu_torch.ops.augment import augment_batch_u8
    from volume_segmantics_tpu_torch.parallel.train import normalise

    model = model_from_state(struc, state, dev).double().train()
    set_dropout_generator(model, torch.Generator(dev).manual_seed(seed + 1))
    imgs, msks = torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev)
    imgs, msks = augment_batch_u8(torch.Generator(dev).manual_seed(seed),
                                  imgs, msks, images.shape[-1])
    targets = torch.nn.functional.one_hot(msks.long(), 2).permute(0, 3, 1, 2)
    forward, BnAct.forward = BnAct.forward, _bn_act_float64
    try:
        with torch.no_grad():
            return get_loss_fn(loss_settings("DiceLoss"))(
                model(normalise(imgs.double())), targets.double()).item()
    finally:
        BnAct.forward = forward


def against_one_process(got, ref, grads64, stats64, covered=0.25) -> dict:
    """`tests/torch_parallel_cases.py:against_one_process` on the card: the
    2-rank run against the one-process run on the global batch, each
    figure a ratio to its allowance: the losses (1e-5 relative; <= 1
    passes), the first step's gradients (10x the one-process float32 noise
    against float64, on the tensors where that is below a tenth of their
    largest gradient; <= 3 passes, and a factor 2 gives > 10), running
    statistics (the larger of 1e-4 and 10x that noise; <= 1) and the
    parameters where the first gradient stands 10x clear of the two runs'
    difference (1e-6), more than `covered` of the trainable elements."""
    res = {"loss_ratio": max(abs(a - b) / (1e-5 * abs(b))
                             for a, b in zip(got["losses"], ref["losses"])),
           "grad_ratio": 0.0, "stats_ratio": 0.0, "param_err": 0.0,
           "n_clear": 0, "n_trainable": 0}
    fractions = []  # [name, share clear, elements] of the large tensors
    for n, g in ref["grads1"].items():
        noise = max(1e-7, 10 * (g.double() - grads64[n]).abs().max().item())
        if noise < 0.1 * g.abs().max().item():
            res["grad_ratio"] = max(res["grad_ratio"], (got["grads1"][n] - g)
                                    .abs().max().item() / noise)
        clear = g.abs() >= max(1e-6, 10 * (got["grads1"][n] - g).abs().max().item())
        if clear.any():
            res["param_err"] = max(res["param_err"], (
                got["params1"][n][clear] - ref["params1"][n][clear]).abs().max().item())
        res["n_clear"] += int(clear.sum())
        res["n_trainable"] += g.numel()
        if g.numel() >= 100_000:
            fractions.append([n, int(clear.sum()) / g.numel(), g.numel()])
    for n, v in ref["stats1"].items():
        floor = max(1e-4, 10 * (v.double() - stats64[n]).abs().max().item())
        res["stats_ratio"] = max(res["stats_ratio"], (got["stats1"][n] - v)
                                 .abs().max().item() / floor)
    res["ok"] = bool(res["loss_ratio"] <= 1 and res["grad_ratio"] <= 3
                     and res["stats_ratio"] <= 1 and res["param_err"] <= 1e-6
                     and res["n_clear"] > covered * res["n_trainable"])
    res["least_clear"] = sorted(fractions, key=lambda f: f[1])[:3]
    return res


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's and cuDNN's deterministic algorithms, cuDNN's autotuner
    off, for the block; yields the warnings it records, among them those of
    any operation that has no deterministic implementation."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def parallel_one_rank(rank, work):
    """Parallel phase (1): NCCL at world size 1, the DP step against the plain one
    from the same weights and seeds, bf16."""
    from volume_segmantics_tpu_torch.parallel.mesh import get_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    blob = torch.load(Path(work, "in.pt"), weights_only=False)
    mesh = get_mesh(device=dev)
    dp = dp_run(blob["state"], blob["images"], blob["masks"], mesh,
                PARALLEL_STEPS_ONE, torch.bfloat16, dev, PARALLEL_LR)
    plain = dp_run(blob["state"], blob["images"], blob["masks"], mesh,
                   PARALLEL_STEPS_ONE, torch.bfloat16, dev, PARALLEL_LR,
                   dp=False)
    (Path(work) / "one.json").write_text(json.dumps({
        "world": mesh.size, "backend": torch.distributed.get_backend(),
        "dp_losses": dp["losses"], "plain_losses": plain["losses"],
        "dp_step_ms": statistics.median(dp["ms"][1:]),
        "plain_step_ms": statistics.median(plain["ms"][1:]),
        "dp_launches": dp["launches"], "plain_launches": plain["launches"],
        "states_equal": digest(dp["final"]) == digest(plain["final"])}))


def parallel_pair_rank(rank, work, ckpt, backend):
    """Parallel phase (2)-(4) as one rank of two: DP steps against one process;
    multi-host prediction; `model-train-2d`. Gloo ranks share cuda:0,
    NCCL ranks take cuda:0 and cuda:1."""
    import torch.distributed as dist

    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
        VolSeg2dPredictor,
    )
    from volume_segmantics_tpu_torch.models.pretrained import WEIGHTS_DIR_ENV
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel import multihost_predict as mh
    from volume_segmantics_tpu_torch.parallel.mesh import Mesh, get_mesh
    from volume_segmantics_tpu_torch.scripts import train_2d_model

    # (4) starts from a random encoder, whatever cache a phase running
    # beside this one points the parent at when the ranks start.
    os.environ.pop(WEIGHTS_DIR_ENV, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    work = Path(work)
    blob = torch.load(work / "in.pt", weights_only=False)
    res = {"rank": rank}

    # (2): float32 DP steps on this rank's rows against one process, every
    # run under deterministic algorithms, so that the comparison sees the
    # steps' arithmetic and not run-to-run noise (with cuDNN's defaults one
    # whole-script card run found 11% of the trainable elements clear of
    # the two runs' difference where others found 37-43%).
    mesh = get_mesh(device=dev)
    with deterministic_algorithms() as caught:
        run = dp_run(blob["state"], blob["images"], blob["masks"], mesh,
                     PARALLEL_STEPS_TWO, torch.float32, dev, PARALLEL_LR_TWO)
        res.update(losses=run["losses"], step_ms=statistics.median(run["ms"][1:]),
                   launches=run["launches"], digest=digest(run["final"]))
        if rank == 0:
            ref = dp_run(blob["state"], blob["images"], blob["masks"], Mesh(),
                         PARALLEL_STEPS_TWO, torch.float32, dev, PARALLEL_LR_TWO,
                         dp=False)
            res["against_one_process"] = against_one_process(
                run, ref, *float64_first_step(blob["state"], blob["images"],
                                              blob["masks"], dev))
            res["one_process_losses"] = ref["losses"]
    res["nondeterministic"] = sorted({str(w.message)[:160] for w in caught})
    del run
    torch.cuda.empty_cache()

    # (2b): a mesh over the first rank alone (`get_mesh(n_devices=1)`, a
    # group both ranks create): rank 0's DP steps against one process's,
    # the first step's gradients and the state after each step bit for bit;
    # rank 1, outside it, raises at its step, then waits at a barrier until
    # rank 0's two runs are done, so that no sweep of (3) shares the card
    # with them. Both runs take deterministic algorithms, so that what
    # differs is the steps' arithmetic, not run-to-run noise.
    sub = get_mesh(n_devices=1, device=dev)
    res["submesh"] = {"member": sub.member, "size": sub.size}
    if sub.member:
        with deterministic_algorithms() as caught:
            run = dp_run(blob["state"], blob["images"], blob["masks"], sub,
                         SUBMESH_STEPS, torch.float32, dev, PARALLEL_LR_TWO,
                         digests=True)
            ref = dp_run(blob["state"], blob["images"], blob["masks"], Mesh(),
                         SUBMESH_STEPS, torch.float32, dev, PARALLEL_LR_TWO,
                         dp=False, digests=True)
        res["submesh"].update(
            losses=run["losses"], one_process_losses=ref["losses"],
            launches=run["launches"],
            equal=digest(run["final"]) == digest(ref["final"]),
            steps_equal=[a == b for a, b in zip(run["digests"], ref["digests"])],
            grads1_equal=all(torch.equal(g, ref["grads1"][n])
                             for n, g in run["grads1"].items()),
            nondeterministic=sorted({str(w.message)[:160] for w in caught}))
        del run, ref
    else:
        from volume_segmantics_tpu_torch.data.losses import get_loss_fn
        from volume_segmantics_tpu_torch.parallel.train import (
            build_dp_train_step,
            make_base_optimizer,
        )

        model = model_from_state(STRUC, blob["state"], dev)
        step = build_dp_train_step(
            model, get_loss_fn(loss_settings("DiceLoss")),
            make_base_optimizer(model.parameters()), mesh=sub, image_size=S,
            compute_dtype=torch.float32)
        try:
            step(torch.from_numpy(blob["images"]).to(dev),
                 torch.from_numpy(blob["masks"]).to(dev), PARALLEL_LR_TWO)
        except ValueError as e:
            res["submesh"]["error"] = str(e)
        del model, step
    torch.cuda.empty_cache()
    dist.barrier()

    # (3): each rank sweeps its half of the 256^3 volume's Z slices.
    vol = np.load(work / "vessels.npy")
    start, stop = mh.local_slice_range(vol.shape[0])
    predictor = VolSeg2dPredictor(ckpt, prediction_settings(), device=dev)
    t0 = time.perf_counter()
    part = mh.predict_local_block_to_hdf5(predictor, vol[start:stop],
                                          work / "pred", output_probs=True)
    res.update(multihost_s=time.perf_counter() - t0, part=str(part),
               block=(start, stop))
    del predictor
    torch.cuda.empty_cache()

    # (4): model-train-2d in the group.
    trainers, digests = [], []

    class Recorded(train_2d_model.VolSeg2dTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

        def _load_in_weights(self, output_path):
            digests.append(digest(self.model.state_dict()))
            return super()._load_in_weights(output_path)

    train_2d_model.VolSeg2dTrainer = Recorded
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    train_2d_model.main(["--data", str(work / "cli" / "train_data.h5"),
                         "--labels", str(work / "cli" / "train_labels.h5"),
                         "--data_dir", str(work / "cli")], device=dev)
    torch.cuda.synchronize()
    (trainer,) = trainers
    res["cli"] = {"main_s": time.perf_counter() - t0,
                  "mesh": [trainer.mesh.rank, trainer.mesh.size],
                  "train_steps": trainer.train_steps,
                  "launches": dict(kernels.LAUNCHES),
                  "digests_before_load": digests,
                  "eval_scores": trainer.avg_eval_scores,
                  "median_lr_find_step_ms": 1e3 * statistics.median(
                      trainer.lr_find_step_seconds)}
    res["cli"]["world"] = dist.get_world_size()
    (work / f"pair_{backend}_rank{rank}.json").write_text(json.dumps(res))


def parallel_phase(model_file: Path, out_dir: Path):
    """Data-parallel training and prediction over ranks in child processes
    (see the module doc)."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
        VolSeg2dPredictor,
    )
    from volume_segmantics_tpu_torch.models.registry import create_model
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel import multihost_predict as mh
    from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks
    from volume_segmantics_tpu_torch.utils import hdf5
    from volume_segmantics_tpu_torch.utils.base_data_utils import Axis

    t_phase = time.perf_counter()
    failures, res = [], {"phase": "parallel"}
    work = out_dir / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    (work / "cli" / cfg.SETTINGS_DIR).mkdir(parents=True)
    vol, truth = make_vessel_volume((P, P, P), seed=7)
    np.save(work / "vessels.npy", vol)
    torch.manual_seed(11)  # the global batch: N Z slices of the volume
    torch.save({"state": create_model(STRUC).state_dict(),
                "images": vol[:N].copy(), "masks": truth[:N].copy()},
               work / "in.pt")
    data, labels = make_vessel_volume(PARALLEL_TRAIN_SHAPE, seed=3)
    hdf5.write(work / "cli" / "train_data.h5", data, chunks=True)
    hdf5.write(work / "cli" / "train_labels.h5", labels, chunks=True)
    (work / "cli" / cfg.SETTINGS_DIR / cfg.TRAIN_SETTINGS_FN).write_text(
        settings_text(cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=1,
                      num_cyc_unfrozen=1, seed=0))
    launches = {entry: 0 for _, _, entry, _, _ in KERNELS}
    res["inputs_s"] = time.perf_counter() - t_phase

    # (1): one NCCL rank, the DP step against the plain one, bit for bit.
    t0 = time.perf_counter()
    spawn_ranks(parallel_one_rank, 1, args=(str(work),), backend="nccl",
                timeout=PARALLEL_TIMEOUT_S)
    one = json.loads((work / "one.json").read_text())
    one["spawn_s"] = time.perf_counter() - t0
    res["nccl_world_1"] = one
    if one["dp_losses"] != one["plain_losses"] or not one["states_equal"]:
        failures.append("world-1 DP step differs from the plain step")
    for entry in launches:
        if one["dp_launches"][entry] != PARALLEL_STEPS_ONE:
            failures.append(f"{entry} launched {one['dp_launches'][entry]} "
                            f"times in {PARALLEL_STEPS_ONE} world-1 DP steps")
        launches[entry] += one["dp_launches"][entry]

    # (2)-(4): two gloo ranks on cuda:0; (5) again over NCCL on two GPUs.
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    if len(backends) == 1:
        res["nccl_two_gpus"] = ("not run: torch.cuda.device_count() is "
                                f"{torch.cuda.device_count()}")
    for backend in backends:
        t0 = time.perf_counter()
        spawn_ranks(parallel_pair_rank, 2,
                    args=(str(work), str(model_file), backend),
                    backend=backend, timeout=PARALLEL_TIMEOUT_S)
        ranks = [json.loads((work / f"pair_{backend}_rank{r}.json").read_text())
                 for r in range(2)]
        pair = {"spawn_s": time.perf_counter() - t0,
                "step_ms": [r["step_ms"] for r in ranks],
                "losses": ranks[0]["losses"],
                "one_process_losses": ranks[0]["one_process_losses"],
                "against_one_process": ranks[0]["against_one_process"],
                "multihost_s": [r["multihost_s"] for r in ranks],
                "cli": [r["cli"] for r in ranks]}
        res[f"two_ranks_{backend}"] = pair
        tag = f"{backend} pair"
        if not pair["against_one_process"]["ok"]:
            failures.append(f"{tag}: DP steps against one process "
                            f"{pair['against_one_process']}")
        if ranks[0]["losses"] != ranks[1]["losses"] or \
                ranks[0]["digest"] != ranks[1]["digest"]:
            failures.append(f"{tag}: the ranks' steps differ")
        inside, outside = pair["submesh"] = [r["submesh"] for r in ranks]
        if not (inside["member"] and inside["equal"] and all(inside["steps_equal"])
                and inside["grads1_equal"]
                and inside["losses"] == inside["one_process_losses"]):
            failures.append(f"{tag}: the mesh over rank 0 against one process "
                            f"{inside}")
        if outside["member"] or "not in this mesh" not in outside.get("error", ""):
            failures.append(f"{tag}: rank 1 outside the mesh over rank 0 {outside}")
        for entry in launches:
            if inside["launches"][entry] != SUBMESH_STEPS:
                failures.append(f"{tag}: {entry} launched "
                                f"{inside['launches'][entry]} times in "
                                f"{SUBMESH_STEPS} steps on the mesh over rank 0")
            launches[entry] += inside["launches"][entry]
        cli = pair["cli"]
        if [c["mesh"] for c in cli] != [[0, 2], [1, 2]]:
            failures.append(f"{tag}: model-train-2d meshes {[c['mesh'] for c in cli]}")
        if cli[0]["digests_before_load"] != cli[1]["digests_before_load"]:
            failures.append(f"{tag}: the ranks' weights differ before a load")
        if not cli[0]["eval_scores"][-1] >= 0.5:
            failures.append(f"{tag}: model-train-2d last eval score "
                            f"{cli[0]['eval_scores'][-1]} < 0.5")
        ckpts = sorted((work / "cli").glob("*_U_Net_trained_2d_model.pytorch"))
        csvs = sorted((work / "cli").glob("*_train_stats.csv"))
        if len(ckpts) != 1 or len(csvs) != 1:
            failures.append(f"{tag}: {len(ckpts)} checkpoints, {len(csvs)} CSVs")
        for r in ranks:
            for entry in launches:
                if r["launches"][entry] != PARALLEL_STEPS_TWO:
                    failures.append(f"{tag} rank {r['rank']}: {entry} launched "
                                    f"{r['launches'][entry]} times in "
                                    f"{PARALLEL_STEPS_TWO} DP steps")
                if r["cli"]["launches"][entry] != r["cli"]["train_steps"]:
                    failures.append(
                        f"{tag} rank {r['rank']}: {entry} launched "
                        f"{r['cli']['launches'][entry]} times in "
                        f"{r['cli']['train_steps']} model-train-2d steps")
                launches[entry] += r["launches"][entry] + r["cli"]["launches"][entry]
        # (3)'s partials against the one-process Z sweep.
        parts = [r["part"] for r in ranks]
        stitched = mh.stitch_partial_predictions(parts)
        probs = np.concatenate([hdf5.read(p_, "/probs")[0] for p_ in parts])
        attrs = []
        for p_ in parts:
            with hdf5.File(p_) as f:
                attrs.append((int(f["/data"].attrs["global_start"]),
                               int(f["/data"].attrs["global_slices"])))
        pair["partial_attrs"] = attrs
        if attrs != [(0, P), (P // 2, P)]:
            failures.append(f"{tag}: partial attributes {attrs}")
        one_dev = VolSeg2dPredictor(model_file, prediction_settings(),
                                    device="cuda:0")
        ref = one_dev._predict_single_axis(vol, True, Axis.Z)
        pair["multihost_vs_one_process"] = near_tie_check(
            "LOW", (stitched, probs), ref)
        if not pair["multihost_vs_one_process"]["ok"]:
            failures.append(f"{tag}: stitched partials against one process "
                            f"{pair['multihost_vs_one_process']}")
        for stale in ckpts + csvs + [Path(p_) for p_ in parts]:
            stale.unlink()
        print(json.dumps({"phase": "parallel", "pair": backend,
                          **{k: v for k, v in pair.items() if k != "cli"}}),
              flush=True)

    # (6): the predictor over [cuda:0, cuda:0] against one device, MEDIUM,
    # float32 (TF32 off): at bf16 the two batch sizes' cuDNN algorithms put
    # max-probabilities 2e-3 apart (first card run), past the rule's 1e-3.
    f32 = prediction_settings(compute_dtype="float32")
    one_dev = VolSeg2dPredictor(model_file, f32, device="cuda:0")
    two_dev = VolSeg2dPredictor(model_file, f32, devices=["cuda:0", "cuda:0"])
    timings = {}
    for name, predictor in (("one_device", one_dev), ("two_devices", two_dev)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predictor._predict_3_ways_max_probs(vol, True)
        timings[name] = time.perf_counter() - t0
        if name == "one_device":
            ref = out
    res["predictor_two_devices"] = {
        "n_dev": two_dev.n_dev, "seconds": timings,
        **near_tie_check("MEDIUM", out, ref)}
    if two_dev.n_dev != 2 or not res["predictor_two_devices"]["ok"]:
        failures.append(f"two-device MEDIUM {res['predictor_two_devices']}")
    shutil.rmtree(work, ignore_errors=True)
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


SPATIAL_STEPS = 3  # (a): 1 x 2 gloo ranks on one card, float32 (5 before (d))
SPATIAL_LR = 1e-6  # as PARALLEL_LR_TWO: Adam's steps stay linear
SPATIAL_MEMORY = (1024, 4, 2)  # (b): image side, global batch, bf16 steps
SPATIAL_MEMORY_RATIO = 0.7  # a space rank's peak against one process's
# (c): model-train-2d, 0 + 1 epochs: 108 slices, 7 steps an epoch, 42
# LR-finder steps, so 49 steps a rank.
SPATIAL_TRAIN_SHAPE = (12, 48, 48)
# (d): every other decoder on ResNet-34 and U-Net on the other encoders
# (the registry's widths), over the 1 x 2 mesh against one process, at
# side S; then DeepLabV3 and PAN at sides their x8 and x4 heads do not
# divide (S - 4 and S - 2: the third entry, the rows and columns cut off),
# whose logits the head resizes back to the input with half-pixel
# centres, on the top-left crop of the images.
SPATIAL_PAIRS = (("LinkNet", "resnet34", 0), ("FPN", "resnet34", 0),
                 ("DeepLabV3", "resnet34", 0), ("DeepLabV3_Plus", "resnet34", 0),
                 ("PAN", "resnet34", 0), ("MA_Net", "resnet34", 0),
                 ("U_Net", "efficientnet-b3", 0), ("U_Net", "efficientnet-b4", 0),
                 ("U_Net", "timm-resnest50d", 0), ("U_Net", "timm-resnest101e", 0),
                 ("DeepLabV3", "resnet34", 4), ("PAN", "resnet34", 2))
SPATIAL_PAIR_BATCH = 4
SPATIAL_PAIR_STEPS = 2
SPATIAL_PAIR_RTOL = 1e-5  # first train loss, relative (as (a)), at least
# Later losses: Adam's first update moves every parameter by about lr
# whatever its gradient, so gradients at float32 noise move some 2 x lr
# apart; PAN's second loss lay 8.2e-6 from one process's on an H100.
SPATIAL_PAIR_LATER_RTOL = 1e-4
SPATIAL_PAIR_EVAL_ATOL = 1e-4  # eval loss and MeanIoU, each from its own weights


def spatial_rank(rank, work, device, pairs_only=False):
    """Spatial phase (a)-(d), or (d) alone, as one of two gloo ranks
    sharing `device` (cuda:0 on the card) on a 1 data x 2 space mesh (see
    the module doc)."""
    import torch.distributed as dist

    from volume_segmantics_tpu_torch.models.pretrained import WEIGHTS_DIR_ENV
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel.mesh import Mesh, get_mesh
    from volume_segmantics_tpu_torch.scripts import train_2d_model

    # (c) starts from a random encoder, whatever cache a phase running
    # beside this one points the parent at when the ranks start.
    os.environ.pop(WEIGHTS_DIR_ENV, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    work = Path(work)
    blob = torch.load(work / "in.pt", weights_only=False)
    mesh = get_mesh(device=dev, space=2)
    res = {"rank": rank, "mesh": [mesh.data_size, mesh.space_size,
                                  mesh.space_index]}
    if pairs_only:
        res["pairs"], res["pairs_s"] = timed_pairs(rank, mesh, blob, dev)
        (work / f"rank{rank}.json").write_text(json.dumps(res))
        return

    # (a): float32 spatial steps against one process from the same state.
    run = dp_run(blob["state"], blob["images"], blob["masks"], mesh,
                 SPATIAL_STEPS, torch.float32, dev, SPATIAL_LR, digests=True)
    res.update(losses=run["losses"], step_ms=statistics.median(run["ms"][1:]),
               launches=run["launches"], digests=run["digests"])
    if rank == 0:
        ref = dp_run(blob["state"], blob["images"], blob["masks"], Mesh(),
                     SPATIAL_STEPS, torch.float32, dev, SPATIAL_LR, dp=False)
        # The band split moves float32 sums more than the batch split:
        # its first card run compared 18% of the elements (two DP ranks:
        # more than 25%), every ratio far inside its allowance.
        res["against_one_process"] = against_one_process(
            run, ref, *float64_first_step(blob["state"], blob["images"],
                                          blob["masks"], dev), covered=0.1)
        res.update(one_process_losses=ref["losses"],
                   one_process_step_ms=statistics.median(ref["ms"][1:]))
        del ref
    del run
    torch.cuda.empty_cache()

    # (b): peak memory of a space rank against one process, bf16.
    side, n, steps = SPATIAL_MEMORY
    reps = (1, side // S, side // S)
    big = [np.tile(blob[k][:n], reps) for k in ("images", "masks")]

    def peak_run(on, dp):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        got = dp_run(blob["state"], *big, on, steps, torch.bfloat16, dev,
                     SPATIAL_LR, dp=dp, side=side)
        torch.cuda.synchronize()
        out = {"peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "step_ms": got["ms"], "losses": got["losses"],
               "launches": got["launches"]}
        del got
        torch.cuda.empty_cache()
        return out

    res["memory"] = peak_run(mesh, True)
    dist.barrier()
    if rank == 0:
        res["memory_one_process"] = peak_run(Mesh(), False)
    dist.barrier()

    # (c): model-train-2d with spatial_partitions: 2 in the group.
    trainers, digests = [], []

    class Recorded(train_2d_model.VolSeg2dTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

        def _load_in_weights(self, output_path):
            digests.append(digest(self.model.state_dict()))
            return super()._load_in_weights(output_path)

    train_2d_model.VolSeg2dTrainer = Recorded
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    train_2d_model.main(["--data", str(work / "cli" / "train_data.h5"),
                         "--labels", str(work / "cli" / "train_labels.h5"),
                         "--data_dir", str(work / "cli")], device=dev)
    torch.cuda.synchronize()
    (trainer,) = trainers
    res["cli"] = {"main_s": time.perf_counter() - t0,
                  "mesh": [trainer.mesh.data_size, trainer.mesh.space_size,
                           trainer.mesh.rank],
                  "train_steps": trainer.train_steps,
                  "launches": dict(kernels.LAUNCHES),
                  "digests_before_load": digests,
                  "eval_scores": trainer.avg_eval_scores,
                  "median_lr_find_step_ms": 1e3 * statistics.median(
                      trainer.lr_find_step_seconds)}
    res["pairs"], res["pairs_s"] = timed_pairs(rank, mesh, blob, dev)
    (work / f"rank{rank}.json").write_text(json.dumps(res))


def timed_pairs(rank, mesh, blob, dev):
    """`spatial_pairs` and its seconds."""
    t0 = time.perf_counter()
    return spatial_pairs(rank, mesh, blob, dev), time.perf_counter() - t0


def spatial_pairs(rank, mesh, blob, dev):
    """Spatial phase (d) on this rank: for each of `SPATIAL_PAIRS`, the
    spatial train steps and eval step from the pair's seeded state and
    this rank's peak memory; then, for every other pair (rank r takes
    pairs r, r + 2, ...: the two ranks' references run side by side on
    the card), the one process's steps, eval step and float64 first loss
    from the same state."""
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.data.metrics import mean_iou
    from volume_segmantics_tpu_torch.models.registry import create_model
    from volume_segmantics_tpu_torch.parallel.mesh import Mesh
    from volume_segmantics_tpu_torch.parallel.train import build_dp_eval_step

    def crop(side):
        return tuple(np.ascontiguousarray(blob[k][:SPATIAL_PAIR_BATCH, :side, :side])
                     for k in ("images", "masks"))

    def evaluate(model, on, images, masks):
        step = build_dp_eval_step(model, get_loss_fn(loss_settings("DiceLoss")),
                                  mean_iou, num_labels=2, mesh=on,
                                  compute_dtype=torch.float32)
        rows = on.rows(images.shape[0])
        loss, score = step(torch.from_numpy(images[rows]).to(dev),
                           torch.from_numpy(masks[rows]).to(dev),
                           images.shape[0])
        return [loss.item(), score.item()]

    out, states = [], {}
    for i, (model_type, encoder, cut) in enumerate(SPATIAL_PAIRS):
        struc = dict(STRUC, type=model_type, encoder_name=encoder)
        side = blob["images"].shape[-1] - cut
        torch.manual_seed(11)
        state = create_model(struc).state_dict()
        if i % mesh.size == rank:
            states[i] = struc, state, side
        images, masks = crop(side)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        run = dp_run(state, images, masks, mesh, SPATIAL_PAIR_STEPS,
                     torch.float32, dev, SPATIAL_LR, side=side, digests=True,
                     struc=struc)
        res = {"type": model_type, "encoder": encoder, "side": side,
               "losses": run["losses"],
               "step_ms": run["ms"], "digests": run["digests"],
               "launches": run["launches"],
               "eval": evaluate(run["model"], mesh, images, masks)}
        torch.cuda.synchronize()
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del run, state
        torch.cuda.empty_cache()
        out.append(res)
    for i, (struc, state, side) in states.items():
        images, masks = crop(side)
        ref = dp_run(state, images, masks, Mesh(), SPATIAL_PAIR_STEPS,
                     torch.float32, dev, SPATIAL_LR, dp=False, side=side,
                     struc=struc)
        out[i].update(one_process_losses=ref["losses"],
                      one_process_step_ms=ref["ms"],
                      one_process_eval=evaluate(ref["model"], Mesh(), images,
                                                masks))
        del ref
        # FPN's GroupNorm runs in float32 whatever its input.
        out[i]["first_loss64"] = None if struc["type"] == "FPN" else (
            float64_first_loss(struc, state, images, masks, dev))
        torch.cuda.empty_cache()
    return out


def spatial_phase(dev, out_dir: Path, pairs_only=False):
    """Spatial partitioning over two gloo ranks in child processes on `dev`
    (cuda:0 on the card; see the module doc): (a)-(d), or with
    `pairs_only` (d) alone."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.models.registry import create_model
    from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks
    from volume_segmantics_tpu_torch.scripts import predict_2d_model
    from volume_segmantics_tpu_torch.utils import hdf5

    t_phase = time.perf_counter()
    failures, res = [], {"phase": "spatial", "card": nvidia_smi_line()}
    work = out_dir / "spatial"
    shutil.rmtree(work, ignore_errors=True)
    (work / "cli" / cfg.SETTINGS_DIR).mkdir(parents=True)
    vol, truth = make_vessel_volume((N, S, S), seed=7)
    model = create_model(STRUC, generator=torch.Generator().manual_seed(11))
    torch.save({"state": model.state_dict(), "images": vol, "masks": truth},
               work / "in.pt")
    del model
    data, labels = make_vessel_volume(SPATIAL_TRAIN_SHAPE, seed=3)
    hdf5.write(work / "cli" / "train_data.h5", data, chunks=True)
    hdf5.write(work / "cli" / "train_labels.h5", labels, chunks=True)
    settings = work / "cli" / cfg.SETTINGS_DIR
    (settings / cfg.TRAIN_SETTINGS_FN).write_text(settings_text(
        cfg.TRAIN_SETTINGS_FN, num_cyc_frozen=0, num_cyc_unfrozen=1, seed=0,
        spatial_partitions=2))
    (settings / cfg.PREDICTION_SETTINGS_FN).write_text(
        settings_text(cfg.PREDICTION_SETTINGS_FN))
    res["inputs_s"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0) if dev.type == "cuda" else dev
    spawn_ranks(spatial_rank, 2, args=(str(work), str(dev), pairs_only),
                backend="gloo", timeout=PARALLEL_TIMEOUT_S)
    res["spawn_s"] = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    res["meshes"] = [r["mesh"] for r in ranks]
    if res["meshes"] != [[1, 2, 0], [1, 2, 1]]:
        failures.append(f"meshes {res['meshes']}")
    if not pairs_only:
        one = ranks[0]["against_one_process"]
        mem_one = ranks[0]["memory_one_process"]
        res.update(
            step_ms=[r["step_ms"] for r in ranks],
            one_process_step_ms=ranks[0]["one_process_step_ms"],
            losses=ranks[0]["losses"],
            one_process_losses=ranks[0]["one_process_losses"],
            against_one_process=one,
            memory={"side": SPATIAL_MEMORY[0], "batch": SPATIAL_MEMORY[1],
                    "rank_peak_gib": [r["memory"]["peak_gib"] for r in ranks],
                    "one_process_peak_gib": mem_one["peak_gib"],
                    "rank_step_ms": [r["memory"]["step_ms"] for r in ranks],
                    "one_process_step_ms": mem_one["step_ms"],
                    "losses": ranks[0]["memory"]["losses"],
                    "one_process_losses": mem_one["losses"]},
            cli=[r["cli"] for r in ranks])
        mem = res["memory"]
        mem["ratio"] = max(mem["rank_peak_gib"]) / mem["one_process_peak_gib"]

        # (a)
        if not one["ok"]:
            failures.append(f"spatial steps against one process {one}")
        if ranks[0]["digests"] != ranks[1]["digests"] or \
                ranks[0]["losses"] != ranks[1]["losses"]:
            failures.append("the ranks' states differ after a spatial step")
        # (b)
        if not mem["ratio"] <= SPATIAL_MEMORY_RATIO:
            failures.append(f"a space rank's peak is {mem['ratio']:.3f} of one "
                            f"process's (limit {SPATIAL_MEMORY_RATIO})")
        if not all(np.isfinite(mem["losses"] + mem["one_process_losses"])):
            failures.append(f"1024 losses {mem['losses']} "
                            f"{mem['one_process_losses']}")
        # (c)
        cli = res["cli"]
        if [c["mesh"] for c in cli] != [[1, 2, 0], [1, 2, 1]]:
            failures.append(f"model-train-2d meshes {[c['mesh'] for c in cli]}")
        if cli[0]["digests_before_load"] != cli[1]["digests_before_load"] or \
                not cli[0]["digests_before_load"]:
            failures.append("the ranks' weights differ before a load")
        if not all(np.isfinite(cli[0]["eval_scores"])):
            failures.append(f"model-train-2d eval scores {cli[0]['eval_scores']}")
        ckpts = sorted((work / "cli").glob("*_U_Net_trained_2d_model.pytorch"))
        csvs = sorted((work / "cli").glob("*_train_stats.csv"))
        if len(ckpts) != 1 or len(csvs) != 1:
            failures.append(f"{len(ckpts)} checkpoints, {len(csvs)} CSVs")
        else:
            t0 = time.perf_counter()
            predict_2d_model.main([str(ckpts[0]), str(work / "cli" / "train_data.h5"),
                                   "--data_dir", str(work / "cli")])
            res["predict_main_s"] = time.perf_counter() - t0
            out = predict_2d_model.create_output_path(work / "cli",
                                                      Path("train_data.h5"))
            predicted, _ = hdf5.read(out)
            res["predicted_shape"] = list(predicted.shape)
            res["predicted_mean_iou"] = volume_mean_iou(predicted, labels, dev)
            if predicted.shape != labels.shape or predicted.max() > 1:
                failures.append(f"predicted labels {predicted.shape} "
                                f"max {predicted.max()}")

    # (d)
    res["pairs_s"], res["pairs"] = ranks[0]["pairs_s"], []
    for i, (mine, other) in enumerate(zip(ranks[0]["pairs"], ranks[1]["pairs"])):
        # The rank that ran the pair's one-process reference.
        mine = dict(mine, **{k: v for k, v in ranks[i % 2]["pairs"][i].items()
                             if k.startswith(("one_process", "first_loss64"))})
        name = f"{mine['type']}/{mine['encoder']}/{mine['side']}"
        pair = {"pair": name, "losses": mine["losses"],
                "one_process_losses": mine["one_process_losses"],
                "eval": mine["eval"], "one_process_eval": mine["one_process_eval"],
                "step_ms": [mine["step_ms"], other["step_ms"]],
                "one_process_step_ms": mine["one_process_step_ms"],
                "peak_gib": [mine["peak_gib"], other["peak_gib"]]}
        pair["loss_rel_err"] = [
            abs(a - b) / abs(b) for a, b in zip(mine["losses"],
                                                mine["one_process_losses"])]
        # BatchNorm over few values (ResNeSt's split attention over the
        # batch's pooled values) amplifies float32 rounding: the allowance
        # is at least twice the one process's first-step distance from
        # float64.
        first = mine["one_process_losses"][0]
        pair["loss64_rel_dist"] = (0.0 if mine["first_loss64"] is None else
                                   abs(first - mine["first_loss64"]) / abs(first))
        rtol = max(SPATIAL_PAIR_RTOL, 2 * pair["loss64_rel_dist"])
        pair["loss_rtol"] = [rtol] + [max(rtol, SPATIAL_PAIR_LATER_RTOL)] * (
            len(mine["losses"]) - 1)
        pair["eval_abs_err"] = max(
            abs(a - b) for a, b in zip(mine["eval"], mine["one_process_eval"]))
        res["pairs"].append(pair)
        if not all(e <= t for e, t in zip(pair["loss_rel_err"],
                                          pair["loss_rtol"])):
            failures.append(f"{name}: spatial losses {mine['losses']} against "
                            f"{mine['one_process_losses']}")
        if not pair["eval_abs_err"] <= SPATIAL_PAIR_EVAL_ATOL:
            failures.append(f"{name}: spatial eval {mine['eval']} against "
                            f"{mine['one_process_eval']}")
        if mine["digests"] != other["digests"] or \
                mine["losses"] != other["losses"] or mine["eval"] != other["eval"]:
            failures.append(f"{name}: the ranks differ after a spatial step")
        if not all(np.isfinite(mine["losses"] + mine["eval"])):
            failures.append(f"{name}: losses {mine['losses']} eval {mine['eval']}")

    launches = {entry: 0 for _, _, entry, _, _ in KERNELS}
    for r in ranks:
        runs = [(f"{p['type']}/{p['encoder']}/{p['side']} steps", p["launches"],
                 SPATIAL_PAIR_STEPS) for p in r["pairs"]]
        if not pairs_only:
            runs += [("spatial steps", r["launches"], SPATIAL_STEPS),
                     ("1024 steps", r["memory"]["launches"], SPATIAL_MEMORY[2]),
                     ("model-train-2d steps", r["cli"]["launches"],
                      r["cli"]["train_steps"])]
        for what, counted, steps in runs:
            for entry in launches:
                if counted[entry] != steps:
                    failures.append(f"rank {r['rank']}: {entry} launched "
                                    f"{counted[entry]} times in {steps} {what}")
                launches[entry] += counted[entry]
    shutil.rmtree(work, ignore_errors=True)
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    res["failures"] = failures
    print(json.dumps(res), flush=True)
    return res


KERNELS = (
    ("K1", "warp_u8", "volseg_warp_u8", "volume_segmantics_tpu_torch/ops/csrc/warp.cu",
     "volume_segmantics_tpu/ops/warp.py:420"),
    ("K2", "clahe_luts", "volseg_clahe_luts",
     "volume_segmantics_tpu_torch/ops/csrc/clahe.cu",
     "volume_segmantics_tpu/ops/clahe.py:346"),
    ("K3", "clahe_blend", "volseg_clahe_blend",
     "volume_segmantics_tpu_torch/ops/csrc/clahe.cu",
     "volume_segmantics_tpu/ops/clahe.py:367"),
)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default="chip_smoke_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from volume_segmantics_tpu_torch.ops import kernels

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(filename=out_dir / "chip_smoke.log", level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({
        "phase": "preflight", "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
    }), flush=True)

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "library": str(kernels.build_dir())}), flush=True)

    data, labels = make_vessel_volume((64, S, S), seed=1)
    images = torch.from_numpy(data[:N].copy()).to(dev)  # N Z slices, S x S
    masks = torch.from_numpy(labels[:N].copy()).to(dev)
    bw = bandwidth(torch.cuda.get_device_name(0))
    kres = kernel_phase(images, masks, bw, dev)

    with tempfile.TemporaryDirectory() as tmp:
        model_out = Path(tmp) / "vessels_U_Net_trained_2d_model.pytorch"
        summary = slice_phase(dev, model_out)
        predicted = predict_phase(model_out, dev)
        cli = cli_phase(dev, out_dir)
        losses = losses_phase(images, masks, dev)
        ckpt = checkpoint_phase(model_out, dev, out_dir)
        large = large_phase(model_out, dev, out_dir)
        archs = architectures_phase(images, masks, dev, out_dir)
        encoders = encoders_phase(images, masks, dev, out_dir)
        formats = formats_phase(dev, out_dir, cli)
        # The spatial and parallel phases' ranks step beside each other and
        # beside the interchange, virtual, sides and pretrained phases (the
        # card and the host idle through most of each), in child processes
        # that count their own launches and ignore the encoder caches these
        # phases point this process at.
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            spatial_run = pool.submit(spatial_phase, dev, out_dir)
            parallel_run = pool.submit(parallel_phase, model_out, out_dir)
            interchange = interchange_phase(dev, out_dir)
            virtual = virtual_phase(dev, out_dir)
            sides = sides_phase(dev, out_dir)
            pretrained = pretrained_phase(model_out, dev, out_dir, cli)
            parallel = parallel_run.result()
            spatial = spatial_run.result()
    sweep = train_batch_sweep(images, masks, dev)
    counted = (summary, cli, losses, pretrained, archs, encoders, formats,
               sides, interchange, virtual, parallel, spatial)
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(phase["launches"][entry] for phase in counted),
         "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["kernel_ms"],
         "plain_ms": kres[k]["plain_ms"], "bound_ms": kres[k]["bound_ms"],
         "bound_by": "bytes", "library_ms": None}
        for k, name, entry, source, replaces in KERNELS
    ]}
    failed = [k for k in kres if not kres[k]["ok"]] + [
        f for phase in (summary, predicted, cli, losses, ckpt, large, pretrained,
                        archs, encoders, formats, sides, interchange, virtual,
                        parallel, spatial, sweep)
        for f in phase["failures"]]
    if failed:
        print(json.dumps({"failed": failed}), file=sys.stderr)
        return 1
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
