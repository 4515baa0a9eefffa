#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``iv_slam_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It drives the port only (no JAX, nothing of ``iv_slam_tpu``):

  1. prints the card's name and power limit (nvidia-smi) and builds the
     CUDA kernels from ``iv_slam_tpu_torch/csrc``;
  2. kernel phase: records the inputs that one KITTI-sized frame hands each
     kernel's wrapper, then holds each kernel bit for bit against its plain
     PyTorch version on the card at those inputs (K1 also at threshold 20
     and on a level-0-sized noise image at threshold 0, K2 also at
     keypoints 0-5 and 18-19 px from the canvas edges, K3 on the main
     path's own canvas views, at clip-limit window centers, at base offsets
     0-15 and at the extreme values) and times kernel and plain version with
     CUDA events;
  3. slice phase: StereoFrontend at KITTI-00 geometry (376x1241, 2000
     features, 8 levels, FAST 20/7) through process() and through
     submit()/collect() at depth 3, with every launch counter set to 0 just
     before and read just after; checks slot fill, the 20 px disparity of
     the test pair and repeatability; then equality of every Frame field
     with the CPU path (plain versions) on a small pair;
  4. tracking phase, at bench.py's full-loop world and configuration
     (tests/synth_world.py PlaneWorld, seed 11, 376x1241, 2000 features),
     frames from the card's StereoFrontend (K1-K3 on every frame, counted;
     K4, the pose LM, twice a fused step, counted):
     (a) a map from frame 0 (MapStore, DeviceMap.sync), then FusedTracker
     steps over frames 1-14 of the accelerating path with the motion model,
     each held to the reference's limits (>= 20 motion matches, >= 30
     inliers), and the ATE of the tracked poses; (b) a map of 5 keyframes at
     their ground-truth poses 16 m apart (live rung 16384, so the local
     search compacts the table), 14 frames tracked between two of them,
     each pose held against ground truth and both compaction overflows to 0;
     one step of (b) again on the CPU path (same inputs), compared; host
     syncs inside a step (CUDA sync debug mode); K4 held bit for bit
     against its plain twin on the card at the two pose-LM calls of that
     step (its table of pose_cap rows), then timed with CUDA events, its
     bound counting the trials the LM took on those inputs;
  5. full loop, the main path end to end: the first 60 frames of bench.py's
     120-frame world through System(cfg, 376, 1241) on the card (fused
     tracking, the other switches at their defaults: unchained,
     single-threaded, synchronous local BA), K1-K3 counted (once a frame);
     fails on a lost frame, an ATE above 0.5 m or a T_CAP/F_CAP overflow;
     prints fps over frames 15-60, the ATE and per-stage host medians (its
     state after 20, 30, 40 and 60 frames and the card's busy share over
     the first 30 are phases 14's and 15's unchained, inline run); then one recorded triangulation,
     fuse and local-BA call of the run again on the CPU path (compared) and
     the BA again on the card (bit-equal);
  6. introspection, at full width: the FCN (MobileNetV2-dilated +
     C1-DeepSup, net input 512x512) with seeded weights from an explicit
     torch.Generator, its head centred on the loop's first image so that
     the uint8 cost map spans the range; (a) the cost map of the 376x1241
     left image: its quantiles (fails if one value covers more than 90% of
     the pixels), the card against the CPU path (prediction max error,
     uint8 map within 1), two card runs bit-equal; (b) the frontend with
     that cost map: every Frame field of the card equal to the CPU path's,
     the attached FCN equal to the explicit cost map, K1-K3 once a frame on
     the quality path, no host sync inside a frame; (c) the first 30
     frames of bench.py's loop through System with the FCN attached (fails
     on a lost frame, an ATE above 0.5 m or a cap overflow), beside phase
     5's ATE and frames/s over the same frames;
  7. loop closing, at bench.py's LC world and configuration
     (tests/synth_world.py DistinctTerrainWorld, seed 3, 320x240, 1.45 laps
     of a 6 m circle; 800 features, 8 levels, fused tracking, unchained,
     single-threaded, synchronous local BA): a vocabulary trained by the
     port (k=10, L=6, seed 0) on the descriptors of every third of the
     first 61 frames;
     K1-K3 held bit for bit against their plain versions on the inputs of
     LC-world frames 0 and 60 (320x240, levels down to 89x67) and FAST on
     noise at 320x240, before the runs; (a) the first 20 frames without a
     vocabulary, the control (beside (b)'s ATE over the same frames), and
     (b) the first 60 frames with it attached and use_bow and loop
     closing on, each failing on a lost
     frame, an ATE above 0.5 m or a cap overflow, K1-K3 counted; the first
     20 frames of (b) again on the CPU path (the same keyframes, points,
     observations, keyframe database and loop-closing state, poses within
     2e-3); the correction path (Sim3 RANSAC and LM, loop fuse, essential
     graph, deferred global BA) on a manufactured revisit, card against
     CPU path; the 1M-leaf synthesized vocabulary's device descent against
     the host descent;
  8. mono and RGB-D at the sensors' published settings (settings/
     EuRoC_mono.yaml: 752x480, 1000 features; settings/TUM1.yaml: 640x480,
     bf 40, DepthMapFactor 5000, 1000 features; loaded through
     config.load_reference_yaml, distortion set to zero for the ideal
     pinhole renderer), fused tracking: (a) K1 and K2 bit for bit against
     their plain versions on the inputs of each world's frame 0 and FAST on
     noise at each size; (b) mono, 30 frames of tests/test_mono_rgbd.py's
     TwoPlaneWorld path through System.track_mono: it initialises, stays OK,
     moves along the ground truth (direction cosine > 0.95), K1/K2/K3
     launches 30/30/0, and every search_for_initialization and
     initialize_mono call again on the CPU path with the card's draws (the
     same model, hypotheses, inliers and is_good set, R, t and the good
     points within 1e-4); (c) RGB-D, 30 frames of a TwoPlaneWorld seen from 2.5 m (depth
     as TUM's uint16 at 1/5000) through System.track_rgbd: no frame lost,
     ATE below 0.5 m, launches 30/30/0;
  9. training-data generation at KITTI geometry (settings/KITTI00-02.yaml,
     2000 features) on tests/test_introspection_helps.py's ReflectionWorld
     (seed 5) and serpentine path, GT poses on every frame: (a) supervised
     (ref_kf_epipolar_normalized), 40 frames: no frame lost, heatmaps
     (uint8, 360x1240) and the dataset's JSON files written, one
     process_frame_supervised call again on the CPU path (the same scored
     keypoints and verdict, errors within 1e-4 relative, heatmap within 1),
     the GP's device time (CUDA events), the heatmaps' mean inside and
     outside the band; (b) unsupervised with ba_mode="constrained", 40
     frames: no frame lost, masks and keypoint quality labels written, one
     constrained BA solve again on the CPU path (points within 1e-4 m,
     labels within 1e-3); K1-K3 counted in both (once a frame);
 10. FCN training, the model zoo, export and the multi-process paths:
     (a) a dataset from phase 9 (b)'s heatmaps and masks beside its left
     images written as PNG, the last 8 frames as the validation session,
     every PNG read back by the port's reader equal to what was written;
     (b) the flagship recipe at full width on the card (MobileNetV2-dilated
     + C1-DeepSup, 512x512, batch 8, lr 0.02, 3 epochs): per epoch the
     train and validation loss, the step's median ms (CUDA events),
     samples/s, peak memory, the step's convolution operations against 67
     TFLOP/s; every loss finite, 10 steps on one batch lower its loss; (c)
     one step at 512x512, batch 8, card against CPU path from the same
     weights and batch (loss, parameters, running statistics), and a
     checkpoint saved and restored into a fresh Trainer bit-equal; (d) the
     trained net's cost-map inference exported to TorchScript at KITTI
     geometry and loaded on the card, its map of a phase 9 frame bit-equal
     to the eager one; (e) the trained net attached to System on phase 9's
     world for 20 frames (0 lost, K1-K3 once a frame, ATE below 0.5 m);
     (f) one training step of every zoo encoder up to 50 layers but
     ResNet-18-dilated with c1 (ResNeXt-101 and HRNetV2 included) and every decoder on
     resnet50dilated at 512x512, batch 8 (step ms, peak memory), each card
     against CPU path at 64x64, batch 2, in float64; (g) two ranks on the one
     card through gloo, the split-batch step against the one-rank step;
     (h) ShardedReplay over 16 frames of the full loop's world with phase
     7's vocabulary, bit-equal to StereoFrontend.process, bow_nodes equal
     to the host descent, K1-K3 once a frame; (i) ShardedDatagen over
     phase 9's 40 frames, one pair card against CPU path;
 11. the dataset drivers, through the port alone (its PNG writer, no cv2):
     (a) the full loop's 60 frames written as a KITTI layout (every row
     Paeth-filtered, times.txt, a KITTI-format GT file), every file decoded
     back equal to the rendered image, the decode's ms a pair, the row
     unfilter's ms a pair beside its plain NumPy version's and its build
     time; (b) run_stereo in process over the first 30 with --fused_tracking
     --profile_stages: 0 failures, ATE < 0.5 m, every output file, its
     Trajectory_KITTI_000.txt bit-equal to phase 5's in-memory trajectory
     after as many frames,
     K1-K3 once a frame; (c) --rectify_images with identity LEFT./RIGHT.
     blocks bit-identical to no rectification over 12 frames, and remap's
     ms a pair at settings/EuRoC_stereo.yaml's maps, host and card (equal);
     (d) run_mono and run_rgbd on 20 frames of phase 8's worlds written as
     TUM layouts (colour PNGs; 16-bit depth), each trajectory bit-equal to
     System in memory on the rendered frames; (e) extract_octtree on a
     KITTI frame, card against CPU path, K1 and K2 launched once; (f)
     evaluate_batch over (b)'s and (d)'s outputs, its ATE equal to
     stats.json's;
 12. the product's claims (tests/torch_claims.py, the JAX package's four
     end-to-end checks with their inputs and gates), K1-K3 first held bit
     for bit against their plain versions on the inputs of the pinned IV
     world's first frame (320x240, 4 levels), every run counting K1-K3 once
     a frame: (c) tests/test_full_cycle.py; (d) tests/test_kitti_e2e.py
     (run_stereo at 1241x376, everything on). A gate that the JAX package
     misses too on the same pixels (torch_claims.JAX_MISSES) is left to
     claims_smoke.py, which also runs every IV cycle of
     tests/test_introspection_helps.py (the pinned case, which this phase
     ran as its (a) before phase 15 needed the time, and the three
     robustness cases) and the C++ oracle of tests/test_parity_ate.py on
     seqA (this phase's (b) until the script outgrew its time limit) and
     seqB;
 13. the drawing half, on phase 11's KITTI layout: (a) run_stereo over its
     first 20 frames without a viewer flag and with --enable_viewer
     --live_viewer_port, while client threads read 5 MJPEG parts of
     frame.mjpg and of map.mjpg (each decoded by the port's decoder to its
     drawer's size) and POST a show_points toggle to /control: the two
     trajectories bit-equal, 0 failures, K1-K3 once a frame; both runs'
     frames/s, FrameDrawer's and MapDrawer's host ms and the encode ms of a
     1241x376 frame and of the 800x800 map; (b) training-data generation
     with --logging_level 1 over phase 9's first 10 ReflectionWorld frames
     written as a KITTI layout: a debug .jpg in each supervised debug
     directory for each qualifying frame (at least 3), each decoding, and
     save_frame's ms; (c) the JPEG codec on every 4th pair of phase 11's frames (encode
     at quality 95, decode, mean abs error within 3 grey levels), the ms a
     pair, the C entropy coder's decode beside its plain Python version's
     (bit-equal);
 14. the thread architecture (the reference's System.cc:172-197), on phase
     5's frames and phase 7's LC world: (a) the first 30 frames three ways,
     inline (phase 5's run, read after 30 frames), the LocalMapping worker
     with the async local BA (bench.py's threading) and the async local BA
     alone (its helper thread): each 0 lost frames, ATE < 0.5 m, K1-K3
     once a frame, each threaded run's cross-ATE to the inline run < 0.10
     m, no worker exception and at least 2 events on the worker, K1-K3's
     outputs on frames submitted while the worker had events queued
     bit-equal to their plain versions; each run's frames/s, keyframes,
     map points, largest pending count, local-BA merges at the per-frame
     poll and at a forced join, the median event's host ms and the card's
     busy share (NVML utilization.gpu sampled by nvidia-smi); (b) the
     first 20 frames through the worker without the async BA, each
     kick_async waiting for the worker's queue: bit-equal to phase 5's run
     after 20 frames (keyframe stamps, map points, trajectory); (c) 30
     frames of the LC world with the vocabulary, use_bow and loop closing
     on, through the worker and the async BA: 0 lost, ATE < 0.5 m, the
     worker's post-event hook running loop closing at every event;
 15. the pipeline (the reference's TPU-link switches), on phase 5's frames:
     (a) chained tracking at depth 1 and 2 over the first 40 frames,
     single-threaded with synchronous BA, beside phase 5's state there: 0
     lost, |dATE| < 0.02 m and keyframes within 1
     (tests/test_chained_tracking.py:78-80), speculations consumed and
     re-dispatched, frames/s over frames 15-40, K1-K3 once a frame and
     bit-equal to their plain versions on 3 frames in flight; the first 8
     frames of depth 1 on the CPU path: the returned poses and the map bit
     for bit; (b) bench.py's configuration (prewarm, the async local BA,
     the worker, chained depth 2) over 60 frames: full_loop_ramp_s
     (bench.py:298-349), frames/s over frames 15-60, ATE, cross-ATE to the
     inline run < 0.10 m, no walk or worker exception; (c) the probed link
     RTT and its family, then link_rtt_ms pinned at 0 and 100 over 20
     threaded, chained frames each (worker serialized): 0 lost, positions
     within 1e-3 m; (d) two fresh processes of this script (one with
     prewarm), each its full_loop_ramp_s and the time to its first tracked
     frame; (e) host-to-device copies of a fused step, a chained step and a
     keyframe event, counted at the dispatcher, and torch.profiler's
     Memcpy HtoD events beside them (run with the profiling phases of 16);
     (f) the DBoW2 text parser in C against
     its plain version on a k=10 L=5 vocabulary (111,111 nodes): equal
     arrays, both times;
 16. from torch.profiler, after every phase that times the host: each
     kernel's device time, the tracking step's device time and kernel
     launches, a profile of whole frames, one keyframe event (device ms,
     launches, host syncs), and the FCN's and a weighted frame's device
     time and launches;
 17. prints one {"tracking": {...}} line, one {"full_loop": {...}} line, one
     {"introspection": {...}} line, one {"loop_closing": {...}} line, one
     {"mono_rgbd": {...}} line, one {"datagen": {...}} line, one
     {"training": {...}} line, one {"drivers": {...}} line, one
     {"claims": {...}} line, one {"drawing": {...}} line, one {"threads":
     {...}} line, one {"pipeline": {...}} line, one {"kernels": [...]} line
     (with each kernel's launches on the introspection, loop-closing, mono,
     RGB-D, datagen, replay, sharded-datagen, run_stereo, run_mono,
     run_rgbd, extract_octtree, claims, viewer, worker and chained runs
     too) and, last, the status line.

A phase that fails is reported and the script exits 1 without a result.
With no CUDA device, or run outside a checkout, it exits 2 at once.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

H, W = 376, 1241                      # KITTI-00 image geometry
SMALL_H, SMALL_W = 240, 320           # CPU-vs-GPU comparison pair
DISPARITY = 20                        # of the test pair, in pixels
N_PROCESS, N_PIPE, DEPTH = 60, 60, 3  # frames through process / submit+collect

# tracking phase: bench.py's full-loop world and camera
FX = 718.856
N_TRACK_A = 14          # frames tracked after frame 0 in part (a)
KF_EVERY_B = 20         # part (b): a keyframe every 20 frames (16 m at 0.8 m/frame)
N_KF_B, N_TRACK_B = 5, 14
STEP_PROFILE_ITERS = 1   # 2 until PR 13 needed the time for phase 14
PROFILE_TRIES = 4       # profiler sessions a kernel gets to show one event a call

# full loop: bench.py's bench_full_loop (n_frames, ramp), its 120 frames
# cut to the deepest frame another phase reads it at (N_BENCH), since the
# script outgrew its time limit on a slow host
N_LOOP, RAMP = 60, 15
# the thread architecture (phase 14): frames of (a)'s three runs, of (b)'s
# serialized worker and of (c)'s LC-world run; the cross-ATE gate of a
# threaded run against the inline one (tests/test_threaded_mapping.py:60);
# frames whose kernel outputs the worker's run records (60, 30, 40 until
# phase 15 needed the time; N_THR 40 until the script outgrew its limit)
N_THR, N_THR_SERIAL, N_THR_LC = 30, 20, 30
# frames of phase 6 (c)'s loop with the FCN and of phase 11 (b)'s
# run_stereo: phase 5's first N_THR, beside its state there (120, then 60
# and 40, until phases 14 and 15 needed the time)
N_INTRO_LOOP = N_DRV = N_THR
THR_CROSS_ATE = 0.10
THR_RECORD_FRAMES = 3
RECORD_CALL = 4         # the 4th call of each keyframe-event function is recorded (the
                        # 5th until phase 5 was cut to 60 frames, which may hold 4 BAs)
TRI_MAX_ULP = 4         # card vs CPU limit on a triangulated coordinate

# introspection: the FCN's input size (the reference's net_hw,
# iv_slam_tpu/slam/frame.py:282), its weights' seed, frames counted on the
# quality path of (b)
NET_HW = (512, 512)
FCN_SEED = 6
N_INTRO_FRAMES = 10

# loop closing: bench.py's LC world (bench.py:378-413) and configuration
# (bench.py:463-471), frames of each run, frames held card against CPU
N_LC, N_LC_CPU = 240, 20
# frames of run (b): the first quarter of bench.py's 240-frame path (240
# until phase 14 needed the time, 120 until the script outgrew its limit;
# no loop closes on this world, and the correction runs on a manufactured
# revisit), rendered with its next frame, which lc_kernels checks
N_LC_RUN = 60
# frames of the control run (a), without a vocabulary: the first N_LC_CPU
# (240 until the claims phase needed the time; no loop closes on this
# world, and the control stands beside run (b)'s first N_LC_CPU frames;
# N_LC_CPU was 60 until the drawing phase needed the time, 30 until the
# script outgrew its limit)
N_LC_CONTROL = N_LC_CPU
LC_H, LC_W = 240, 320
LC_POSE_ATOL = 2e-3     # card vs CPU path over N_LC_CPU frames (translation m, rotation)

# mono and RGB-D (phase 8): tests/test_mono_rgbd.py's world seed, frames of
# each run; the RGB-D world's seed, platform (x0, x1, y0, y1 in m, 1 m high)
# and ground texture (px/m: 517 / (2.5 m * 200) = 1.03 image px a texture
# px); the card-vs-CPU limit on the initializer's R, t and triangulated
# points: both solve in float64 (R and t agree to ~1e-8) and round once, so
# a far point's coordinate may round to the next float32 (1.53e-5 on an
# "NVIDIA H100 80GB HBM3, 700.00 W": one ulp at ~150 baselines); the
# parallax check keeps points within ~160 baselines, where a few ulps stay
# below 1e-4
MONO_SEED, N_MONO = 23, 30   # 60, then 40, each until the script outgrew its limit
RGBD_SEED, N_RGBD = 29, 30
RGBD_PLATFORM = (-0.6, 0.6, -0.45, 0.45)
RGBD_TEX_PX_PER_M = 200.0
INIT_ATOL = 1e-4

# training-data generation (phase 9): frames of the supervised and the
# unsupervised run, the frame whose supervised call is held card against
# CPU path (its normalized errors within DG_ERR_TOL relative), and the
# constrained-BA call held the same way (N_DG_SUP 60 until the script
# outgrew its limit)
N_DG_SUP, N_DG_UNSUP = 40, 40
DG_RECORD, DG_ERR_TOL, DG_BA_RECORD = 30, 1e-4, 1
# the band's blend over the ground (ReflectionWorld's default is 0.65): at
# KITTI geometry the tracker drops the default band's points within a few
# frames, no frame's bad-match share reaches the 5% a training frame needs
# and nothing is written (this phase on the CPU path: 0 of 60 frames); at
# 0.75 the first frames qualify (7 of 40) and the band's points are culled
# after
DG_BAND_ALPHA = 0.75

# FCN training (phase 10): validation frames (one batch: a partial batch is
# dropped), epochs and batch of the flagship recipe's run, frames of the
# trained net's loop, frames of the replay. Card against CPU path on one
# step: the tolerances tests/test_torch_train.py holds the port to against
# JAX (loss 1e-5 relative, parameters 2e-3 after a step at lr 0.02,
# running means 1e-5, running variances 1e-4 relative). The zoo's pairs at
# ZOO_CHECK_HW, batch 2, compare in float64: in float32 the BatchNorms
# over their small maps are ill-conditioned (on an "NVIDIA H100 80GB HBM3,
# 700.00 W" the card and the CPU path parted by up to 1.8e-4 in the loss
# and 9% in the update's largest entry for the C1 pairs at 128x128), so
# float32 shows mostly that noise; in float64 they agree to 2.1e-13 (loss,
# relative) and 7.6e-12 (the update, of its largest entry) at 128x128, to
# 8.4e-13 and 1.3e-11 at 64x64, held to 1e-8 and 1e-6. The zoo is cut at
# 50 layers (ZOO_SKIP: the 101-layer ResNets, whose blocks the 18- and
# 50-layer ones run; ResNeXt and HRNet have one depth each and stay) and
# checked at 64x64 (128x128 until phase 14 needed the time); ResNet-18
# dilated is out too (its blocks are ResNet-18's, its dilation
# ResNet-50-dilated's), and the trained net's loop (e) is 20 frames (30),
# since the script outgrew its limit
TR_VAL, TR_EPOCHS, TR_BATCH, TR_LOOP, N_REPLAY = 8, 3, 8, 20, 16
TR_LOSS_RTOL, TR_PARAM_ATOL, TR_MEAN_ATOL, TR_VAR_RTOL = 1e-5, 2e-3, 1e-5, 1e-4
TR_STATS_ATOL = 1e-5
ZOO_LOSS_RTOL, ZOO_UPDATE_RTOL = 1e-8, 1e-6
ZOO_CHECK_HW = (64, 64)
ZOO_SKIP = ("resnet101", "resnet101dilated", "resnet18dilated")

# the dataset drivers (phase 11): frames of the rectification runs and of
# the mono and RGB-D driver runs; extract_octtree's card-vs-CPU angle limit
# (degrees; kernel 2 is bit-equal to its plain version, so 0 is expected);
# evaluate_batch against stats.json (m: evaluate_batch reads the trajectory
# back from its 10-digit text)
N_RECT, N_DRV_MR = 12, 20
OCT_ANGLE_TOL = 5e-3
EVAL_ATE_ATOL = 1e-6

# the drawing half (phase 13): frames of the viewer runs over phase 11's
# KITTI layout, MJPEG parts each client reads from each stream, frames of
# the debug-image run on phase 9's world (the fewest that give
# DBG_MIN_QUALIFYING training frames there), the JPEG quality of the codec's
# round trip (cv2.imwrite's default) and its limit on the mean absolute
# error of a decoded frame (grey levels)
N_VIEW, N_PARTS = 20, 5
N_DBG, DBG_MIN_QUALIFYING = 10, 3
CODEC_QUALITY, CODEC_MAE = 95, 3.0

# the product's claims (phase 12, tests/torch_claims.py): the pinned IV
# case of tests/test_introspection_helps.py gives phase 12's kernel checks
# their inputs; its IV cycle (here until phase 15 needed the time), the
# C++ oracle on seqA (here until the script outgrew its limit), the three
# robustness cases and seqB run in claims_smoke.py
CLAIMS_CASE = "reflection-seed5"

# the pipeline (phase 15): frames of (a)'s chained runs, read beside phase
# 5's state after as many; frames of the card-vs-CPU check of (a); frames
# whose kernel outputs (a) records; frames of (b) (bench.py's
# configuration); frames of each of (c)'s link-profile runs and their
# agreement (tests/test_link_adaptive.py:204); frames each cold process of
# (d) tracks (bench.py's ramp); the chained gates of
# tests/test_chained_tracking.py:78-80 (ATE against the unchained run,
# keyframes); the vocabulary of (f). N_LINK was 25 until the script
# outgrew its limit
N_CHAIN, N_CHAIN_CPU, CHAIN_RECORD_FRAMES = 40, 8, 3
N_BENCH, N_LINK, N_COLD = 60, 20, RAMP
CHAIN_ATE_GATE, CHAIN_KF_GATE, LINK_ATOL = 0.02, 1, 1e-3
VOCAB_KL = (10, 5)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the float32
# rate outside the tensor cores, used for these kernels' 32-bit scalar ops
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12

FRONTEND_KERNELS = ("fast_score", "orient_brief", "sad_windows")   # K1-K3

# the pose LM's least work (K4), in float operations an edge, counted from
# its plain twin's arithmetic: an iteration's rows (residual 36, chi2 and
# IRLS weight 10, Jacobian 70, the 3 x 43 products and 3 x 42 tree
# additions); a trial's cost (residual 36, chi2 6, Huber 6, the sum 1),
# once a round at its start and once for each trial an iteration takes
# (the trials after the one where the loop stops are never needed); a
# round's reclassification (residual 36, chi2 6, compare and mask 2). The
# ten 6x6 solves and exponentials an iteration (under 1,000 operations)
# are left out.
LM_ROW_OPS = 36 + 10 + 70 + 3 * 43 + 3 * 42
LM_COST_OPS = 36 + 6 + 6 + 1
LM_CLASSIFY_OPS = 36 + 6 + 2

# K1's least work a pixel, in two-input operations on the ring bytes: the
# 16 circular 9-window minima and maxima, 42 each (suffix and prefix runs
# inside ring halves 0-7 and 8-15, then one a window); 15 maxima of the
# minima and 15 minima of the maxima over the arcs; 2 differences with the
# center; max, -1, compare, select. tests/test_torch_fast.py computes FAST
# that way, counting, and holds the count to this.
FAST_OPS_PER_PX = 2 * 42 + 2 * 15 + 2 + 4


def test_pair(h, w, seed=0):
    """bench.py's _test_pair, with the right view cut 20 px to the right of
    the left one (bench.py cuts it 20 px to the left: a disparity of -20,
    which the matcher's window [uL - bf/b, uL] rightly never matches)."""
    import cv2

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(h, w + 64)).astype(np.float32)
    base = cv2.GaussianBlur(base, (5, 5), 1.2)
    for _ in range(300):
        y, x = rng.integers(10, h - 16), rng.integers(10, w + 40)
        base[y:y + 8, x:x + 8] = rng.uniform(0, 255)
    left = np.clip(base[:, 32:32 + w], 0, 255).astype(np.uint8)
    right = np.clip(base[:, 32 + DISPARITY:32 + DISPARITY + w], 0, 255).astype(np.uint8)
    return left, right


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def host_ms(fn) -> float:
    """Host ms of one call of a host function."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def event_ms(torch, fn, iters=50, warmup=3) -> float:
    """Mean milliseconds per call of fn() between CUDA events around iters
    back-to-back calls: the device time plus any gaps the host leaves
    between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class GpuBusy:
    """The card's busy share over a block: NVML's utilization.gpu (the share
    of each sample period in which a kernel ran), sampled every 100 ms by
    nvidia-smi in a child process that the block's end stops. share is None
    when nvidia-smi gave no sample."""

    def __enter__(self):
        import threading

        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def read():
            for line in self.proc.stdout:
                try:
                    self.samples.append(float(line.strip()) / 100.0)
                except ValueError:
                    pass

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def stop(self):
        """End the sampling (once; a second call does nothing)."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.reader.join(timeout=10)
            # the first sample covers the time before the block
            xs = self.samples[1:]
            self.n = len(xs)
            self.share = float(np.mean(xs)) if xs else None


class HostToDeviceCount:
    """Counts the host-to-device copies that PyTorch ops issue inside a
    block, at the dispatcher: a copy from a CPU tensor into a CUDA one
    (``to``, ``copy_``) and a tensor made on the card from host data
    (``torch.tensor``/``as_tensor``, which reach the dispatcher as
    ``lift_fresh`` of their CUDA result)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        count = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.__name__
                if name.startswith("_to_copy") or name.startswith("copy_"):
                    src = args[1] if name.startswith("copy_") else args[0]
                    if src.device.type == "cpu" and out.device.type == "cuda":
                        count.n += 1
                elif name.startswith("lift_fresh") and out.device.type == "cuda":
                    count.n += 1
                return out

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


def dev_us(e) -> float:
    return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))


def device_ms(torch, fn, iters=20, warmup=3):
    """(mean device milliseconds, kernel launches) per call of fn(): the
    summed durations and the count of the kernels it launches, from
    torch.profiler (no host gaps)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    us = sum(dev_us(e) for e in rows)
    n = sum(e.count for e in rows if not e.key.startswith(("Memcpy", "Memset")))
    return us / 1e3 / iters, n / iters


def require(ok, what) -> None:
    """A check of the run (not an assert: those vanish under python -O)."""
    if not ok:
        raise RuntimeError(str(what))


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_operations(rounds, n_valid: int) -> int:
    """The pose LM's least operations: rounds holds, for each round, the
    edges of its set and the trials each of its iterations took."""
    return sum(n * (LM_COST_OPS + sum(LM_ROW_OPS + t * LM_COST_OPS for t in trials))
               + n_valid * LM_CLASSIFY_OPS for n, trials in rounds)


def lm_bytes(n: int) -> int:
    """The pose LM's least bytes for n edges: its inputs read once (T0, Xw,
    obs, inv_sigma2, qual, valid, the intrinsics) and its outputs written
    once (T, inlier, chi2, n_inliers)."""
    return 64 + 12 * n + 12 * n + 4 * n + 4 * n + n + 20 + 64 + n + 4 * n + 4


def touched(torch, canvas, flat_idx) -> int:
    """Distinct bytes of a uint8 canvas that the flat indices reach: what a
    function reading those pixels must move at the least."""
    seen = torch.zeros(canvas.numel(), dtype=torch.bool, device=canvas.device)
    seen[flat_idx.reshape(-1)] = True
    return int(seen.sum())


def window_indices(torch, canvas, yc, xc, half_h, half_w):
    """(N, (2 half_h + 1) (2 half_w + 1)) flat indices of the windows
    centred at (yc, xc), clamped to the canvas."""
    R, C = canvas.shape
    dev = canvas.device
    dy = torch.arange(-half_h, half_h + 1, device=dev)
    dx = torch.arange(-half_w, half_w + 1, device=dev)
    rows = (yc.long()[:, None] + dy[None, :]).clamp(0, R - 1)
    cols = (xc.long()[:, None] + dx[None, :]).clamp(0, C - 1)
    return (rows[:, :, None] * C + cols[:, None, :]).reshape(len(yc), -1)


def loop_path(n):
    """bench.py's full-loop camera path (bench.py:275-283): Twc per frame,
    accelerating from standstill to 0.8 m a frame."""
    import synth_world

    out, x = [], 0.0
    for i in range(n):
        x += min(0.1 * i, 0.8)
        out.append(synth_world.camera_pose(np.array([x, 0.1 * np.sin(i * 0.3), 0.0],
                                                    np.float32),
                                           height=15.0, yaw=0.01 * np.sin(i * 0.2)))
    return out


def seeded_fcn(torch, models, seed):
    """An IntrospectionNet with weights drawn from torch.Generator(seed):
    convolutions He-normal, BatchNorm affine terms and running statistics
    near the identity."""
    g = torch.Generator().manual_seed(seed)
    net = models.IntrospectionNet()
    rnd = lambda t: torch.randn(t.shape, generator=g)  # noqa: E731
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(rnd(mod.weight) * (2.0 / fan_in) ** 0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.copy_(1.0 + 0.1 * rnd(mod.weight))
                mod.bias.copy_(0.1 * rnd(mod.bias))
                mod.running_mean.copy_(0.1 * rnd(mod.running_mean))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=g))
    return net


def stage_ms(timer, name):
    """The host milliseconds of stage `name` in a utils.profiling.StageTimer
    (the stage_timer of Tracking, LocalMapping and LoopClosing)."""
    return [t * 1e3 for t in timer.samples.get(name, [])]


def median_ms(timer, name):
    v = stage_ms(timer, name)
    return float(np.median(v)) if v else None


def clone(x):
    if hasattr(x, "clone"):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*(clone(v) for v in x)) if hasattr(x, "_fields") else tuple(
            clone(v) for v in x)
    return x


def to_cpu(x):
    if hasattr(x, "cpu"):
        return x.cpu()
    if isinstance(x, tuple):
        return type(x)(*(to_cpu(v) for v in x)) if hasattr(x, "_fields") else tuple(
            to_cpu(v) for v in x)
    return x


class Smoke:
    def __init__(self, torch, port):
        self.torch = torch
        self.port = port
        self.failures = []
        self.kernels = {}
        self.fps = {}
        self.trk = None
        self.intro = None
        self.lc = None
        self.mr = None
        self.dg = None
        self.tr = None
        self.drv = None
        self.cl = None
        self.vw = None
        self.thr = None
        self.ch = None

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)
            return out
        except Exception as e:  # every phase is reported, then the run fails
            traceback.print_exc()
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
            print(f"[{name}] FAILED: {e}", flush=True)
            return None

    def counters(self):
        """The frontend's kernels' wrappers (K1-K3: once a frame); K4's,
        twice a fused step, is counted by the tracking phase."""
        ops = self.port["ops"]
        return {"fast_score": ops.fast_cuda, "orient_brief": ops.finish_cuda,
                "sad_windows": ops.stereo_cuda}

    def frontend_checked(self):
        """K1-K3 held against their plain versions at phase 2."""
        return all(n in self.kernels for n in FRONTEND_KERNELS)

    # ---- phase 1 ---------------------------------------------------------
    def build(self):
        kern = self.port["kernels"]
        dt = kern.build(verbose=True)
        print(f"build: {len(kern.SOURCES)} sources in {dt:.2f} s (nvcc, sm_90a, in parallel)")
        self.unfilter_build_s = kern.build(kern.HOST_SOURCES)
        print(f"build: the host C sources {list(kern.HOST_SOURCES)} (PNG row unfilter, JPEG "
              f"entropy coder, vocabulary parser and descent; host C compiler, in parallel) "
              f"in {self.unfilter_build_s:.2f} s")
        for name in kern.SOURCES:
            for ln in kern.build_log.get(name, "").splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"  ptxas {name}: {ln.strip()}")

    # ---- phase 2 ---------------------------------------------------------
    def record_inputs(self, run, n_sad=1):
        """The inputs one frame (``run()``, a frontend's process call) hands
        each wrapper: K1 and K2 once, K3 n_sad times (0 for one image)."""
        ops = self.port["ops"]
        rec = {"fast_score": [], "orient_brief": [], "sad_windows": []}
        orig = (ops.fast_cuda.fast_score_levels, ops.finish_cuda.orient_brief,
                ops.stereo_cuda.sad_windows)

        def fast(levels, th):
            rec["fast_score"].append(([lv.clone() for lv in levels], th))
            return orig[0](levels, th)

        def ob(raw, blur, yx):
            rec["orient_brief"].append((raw.clone(), blur.clone(), yx.clone()))
            return orig[1](raw, blur, yx)

        def sad(cl, cr, yc, xl, xr):
            # the canvases are [0] and [1] of one (2, R, C) tensor: keep it
            # whole, so that K3 is checked on views at the same offsets
            R, C = cl.shape
            require(cl.is_contiguous() and cr.data_ptr() == cl.data_ptr() + R * C,
                    "SAD canvases are not [0] and [1] of one (2, R, C) tensor")
            both = self.torch.as_strided(cl, (2, R, C), (R * C, C, 1)).clone()
            rec["sad_windows"].append(
                (both, cr.data_ptr() % 16) + tuple(t.clone() for t in (yc, xl, xr)))
            return orig[2](cl, cr, yc, xl, xr)

        ops.fast_cuda.fast_score_levels, ops.finish_cuda.orient_brief = fast, ob
        ops.stereo_cuda.sad_windows = sad
        try:
            run()
        finally:
            (ops.fast_cuda.fast_score_levels, ops.finish_cuda.orient_brief,
             ops.stereo_cuda.sad_windows) = orig
        self.torch.cuda.synchronize()
        want = {"fast_score": 1, "orient_brief": 1, "sad_windows": n_sad}
        require({k: len(v) for k, v in rec.items()} == want,
                ({k: len(v) for k, v in rec.items()}, want))
        return rec

    # Each check holds a kernel bit-equal to its plain version on the
    # inputs of rec, and returns the largest difference. With main (phase
    # 2's KITTI frame) it also times the kernel and registers it for the
    # kernels line; noise_hw is the canvas of the noise case.
    def check_fast(self, rec, noise_hw=(H, W), main=True):
        torch, ops = self.torch, self.port["ops"]
        fc = ops.fast_cuda
        (levels, th), = rec["fast_score"]
        noise = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, size=(1,) + tuple(noise_hw), dtype=np.uint8)).to(levels[0].device)
        cases = [(levels, t) for t in sorted({th, 20})] + [([noise], 0)]
        worst = 0
        for lvs, t in cases:
            ks = fc.fast_score_levels(lvs, t)
            for lv, k in zip(lvs, ks):
                p = ops.fast.fast_score(lv, t)
                torch.cuda.synchronize()
                err = int((k.to(torch.int32) - p.to(torch.int32)).abs().max())
                worst = max(worst, err)
                require(k.dtype == torch.int16 and torch.equal(k, p),
                        f"FAST kernel != plain at {tuple(lv.shape)}, threshold {t}: "
                        f"max err {err}")
        shapes = ", ".join(f"{tuple(lv.shape)}" for lv in levels)
        print(f"K1 fast_score: 1 launch/frame over {shapes}; thresholds "
              f"{sorted({th, 20})} and noise {(1,) + tuple(noise_hw)} at 0: bit-equal")
        if not main:
            return float(worst)
        fns = (lambda: fc.fast_score_levels(levels, th),
               lambda: [ops.fast.fast_score(lv, th) for lv in levels])
        px = sum(lv.numel() for lv in levels)
        bnd, by = bound_ms(px * 3, px * FAST_OPS_PER_PX)
        self.kernels["fast_score"] = dict(
            name="fast_score", route="cuda", source="iv_slam_tpu_torch/csrc/fast_score.cu",
            replaces="iv_slam_tpu/ops/fast_pallas.py:77", max_abs_err=float(worst),
            bound_ms=bnd, bound_by=by, library_ms=None, fns=fns, launches_per_frame=1,
            event_ms=event_ms(torch, fns[0]), plain_event_ms=event_ms(torch, fns[1], iters=10))

    def check_orient_brief(self, rec, main=True):
        torch, ops = self.torch, self.port["ops"]
        raw, blur, yx = rec["orient_brief"][0]
        # the main path's keypoints, then keypoints 0-5 and 18-19 px from
        # every edge and corner of the canvas, where the patch and the staged
        # window are cut or clamped at the border
        R, C = raw.shape
        near = lambda n: (0, 2, 5, 18, 19, n - 20, n - 19, n - 6, n - 3, n - 1)
        edge = [(r, c) for r in near(R) for c in near(C)]
        yx_e = torch.cat([yx, torch.tensor(edge, dtype=torch.int32, device=yx.device)])
        ang, desc = ops.finish_cuda.orient_brief(raw, blur, yx_e)
        ang_p, desc_p = ops.finish_cuda.orient_brief_plain(raw, blur, yx_e)
        torch.cuda.synchronize()
        err = max(float((ang - ang_p).abs().max()),
                  float((desc.to(torch.int32) - desc_p.to(torch.int32)).abs().max()))
        require(torch.equal(ang, ang_p), f"angles differ: max err {err}")
        require(torch.equal(desc, desc_p),
                f"descriptors differ in {int((desc != desc_p).sum())} bytes")
        if not main:
            print(f"K2 orient_brief: canvas {tuple(raw.shape)}, {yx.shape[0]} keypoints + "
                  f"{len(edge)} at the canvas edges: angles and descriptors bit-equal")
            return err
        fns = (lambda: ops.finish_cuda.orient_brief(raw, blur, yx),
               lambda: ops.finish_cuda.orient_brief_plain(raw, blur, yx))
        n = yx.shape[0]
        ext = ops.orient.row_extents()
        mask_px = int(np.sum(2 * ext + 1))
        # moments: 3 ops per masked pixel; rBRIEF: per pattern point 2 mul,
        # 1 add, rint, 2 offsets; per bit a compare and a shift-or
        ops_per_kp = 3 * mask_px + 512 * 6 + 256 * 2
        # bytes: the circular patches of the raw canvas and the rotated
        # pattern points of the blurred one that these keypoints reach,
        # the keypoints, the outputs and the pattern and extent tables
        half = ops.orient.HALF_PATCH
        square = window_indices(torch, raw, yx[:, 0], yx[:, 1], half, half)
        circle = (torch.arange(-half, half + 1, device=raw.device)[None, :].abs()
                  <= torch.as_tensor(ext, device=raw.device)[:, None]).reshape(-1)
        raw_b = touched(torch, raw, square[:, circle])
        blur_b = touched(torch, blur, ops.brief.pattern_indices(*blur.shape, yx, ang[:n]))
        n_bytes = raw_b + blur_b + yx.numel() * 4 + n * (4 + 32) + 512 * 2 + 31 * 4
        bnd, by = bound_ms(n_bytes, n * ops_per_kp)
        print(f"K2 orient_brief: canvas {tuple(raw.shape)}, {n} keypoints + {len(edge)} "
              f"at the canvas edges: angles and descriptors bit-equal; bound reads "
              f"{raw_b} raw + {blur_b} blurred canvas bytes of {raw.numel()} each, "
              f"{n_bytes} bytes in all")
        self.kernels["orient_brief"] = dict(
            name="orient_brief", route="cuda", source="iv_slam_tpu_torch/csrc/orient_brief.cu",
            replaces="iv_slam_tpu/ops/finish_pallas.py:83", max_abs_err=err,
            bound_ms=bnd, bound_by=by, library_ms=None, fns=fns, launches_per_frame=1,
            event_ms=event_ms(torch, fns[0]), plain_event_ms=event_ms(torch, fns[1], iters=10))

    def check_sad(self, rec, main=True):
        torch, ops = self.torch, self.port["ops"]
        canvas, main_mod16, yc, xl, xr = rec["sad_windows"][0]
        cl, cr = canvas[0], canvas[1]  # views, as the main path hands them over
        R, C = cl.shape
        w, l = ops.stereo_cuda._W, ops.stereo_cuda._L
        dev = cl.device
        mod16 = cr.data_ptr() % 16
        require(mod16 == main_mod16,
                f"right view at {mod16} mod 16, the main path's at {main_mod16}")

        # the main path's centers and the 8 clip-limit corners match_stereo
        # allows (tests/test_stereo_pallas.py)
        lim = [(y, a, b) for y in (w, R - w - 1) for a in (w, C - w - 1)
               for b in (w + l, C - w - l - 1)]
        yc_e, xl_e, xr_e = (torch.cat([v, torch.tensor(e, dtype=torch.int32, device=dev)])
                            for v, e in zip((yc, xl, xr), zip(*lim)))
        # the top of the range: left patches 255 around a center of 0, right
        # windows 0 around a center of 255, at the main path's centers
        ext = torch.stack([torch.full_like(cl, 255), torch.zeros_like(cr)])
        rows = yc_e.long()
        ext[0, rows, xl_e.long()] = 0
        for d in range(-l, l + 1):
            ext[1, rows, xr_e.long() + d] = 255
        cases = [("main-path views", canvas), ("extreme values", ext)]
        for off in range(16):  # the same canvas at every base offset mod 16
            buf = torch.empty(off + canvas.numel(), dtype=torch.uint8, device=dev)
            buf[off:] = canvas.reshape(-1)
            cases.append((f"base offset {off}", buf[off:].view(canvas.shape)))
        err, top = 0.0, None
        for what, c in cases:
            k = ops.stereo_cuda.sad_windows(c[0], c[1], yc_e, xl_e, xr_e)
            p = ops.stereo_cuda.sad_windows_plain(c[0], c[1], yc_e, xl_e, xr_e)
            torch.cuda.synchronize()
            e = float((k - p).abs().max())
            err = max(err, e)
            require(torch.equal(k, p), f"SAD kernel != plain on {what}: max err {e}")
            if what == "extreme values":
                top = int(k.max())
        if not main:
            print(f"K3 sad_windows: canvas {tuple(canvas.shape)}, {yc.shape[0]} keypoints + "
                  f"{len(lim)} clip-limit centers, at base offsets 0-15 and at the extreme "
                  f"values: bit-equal (largest extreme SAD {top})")
            return err
        fns = (lambda: ops.stereo_cuda.sad_windows(cl, cr, yc, xl, xr),
               lambda: ops.stereo_cuda.sad_windows_plain(cl, cr, yc, xl, xr))
        n = yc.shape[0]
        # bytes: the 11x11 left windows and 11x21 right strips these
        # centers reach, the centers and the output
        left_b = touched(torch, cl, window_indices(torch, cl, yc, xl, w, w))
        right_b = touched(torch, cr, window_indices(torch, cr, yc, xr, w, w + l))
        n_bytes = left_b + right_b + 3 * n * 4 + n * 11 * 4
        bnd, by = bound_ms(n_bytes, n * 11 * 121 * 4)
        print(f"K3 sad_windows: canvas {tuple(canvas.shape)}, right view at byte "
              f"{cr.storage_offset()} ({mod16} mod 16, as on the main path); {n} keypoints "
              f"+ {len(lim)} clip-limit centers on those views, at base offsets 0-15 and at "
              f"the extreme values: bit-equal (largest extreme SAD {top}); bound reads "
              f"{left_b} left + {right_b} right canvas bytes of {cl.numel()} each, "
              f"{n_bytes} bytes in all")
        self.kernels["sad_windows"] = dict(
            name="sad_windows", route="cuda", source="iv_slam_tpu_torch/csrc/sad_windows.cu",
            replaces="iv_slam_tpu/ops/stereo_pallas.py:88", max_abs_err=err,
            bound_ms=bnd, bound_by=by, library_ms=None, fns=fns, launches_per_frame=1,
            event_ms=event_ms(torch, fns[0]), plain_event_ms=event_ms(torch, fns[1], iters=10))

    # ---- phase 3 ---------------------------------------------------------
    def drive_slice(self, fe, left, right):
        """The main path: process() and pipelined submit()/collect()."""
        torch = self.torch
        mods = self.counters()
        for m in mods.values():
            m.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = [fe.process(left, right, float(i)) for i in range(N_PROCESS)]
        torch.cuda.synchronize()
        t_proc = time.perf_counter() - t0

        handles, q = [], []
        t0 = time.perf_counter()
        for i in range(N_PIPE + DEPTH):
            if i < N_PIPE:
                h = fe.submit(left, right)
                fe.prefetch_host(h)
                q.append(h)
                handles.append(h)
            if len(q) > DEPTH or i >= N_PIPE:
                frames.append(fe.collect(q.pop(0), float(N_PROCESS + i)))
        torch.cuda.synchronize()
        t_pipe = time.perf_counter() - t0
        launches = {k: m.launches for k, m in mods.items()}

        n_frames = N_PROCESS + N_PIPE
        want = {"fast_score": n_frames, "orient_brief": n_frames,
                "sad_windows": n_frames}
        print(f"launches over {n_frames} frames: {launches} (expected {want})")
        for k, v in launches.items():
            self.kernels[k]["launches"] = v
        require(launches == want, f"launch counts {launches} != {want}")

        card = torch.cuda.get_device_name(0)
        self.fps = {"process_fps": N_PROCESS / t_proc, "pipelined_fps": N_PIPE / t_pipe}
        print(f"frontend 376x1241 on {card}: process {self.fps['process_fps']:.2f} "
              f"frames/s ({N_PROCESS} frames), submit/collect depth {DEPTH} "
              f"{self.fps['pipelined_fps']:.2f} frames/s ({N_PIPE} frames)")

        # every frame: slots filled, matches at the pair's disparity, and the
        # same numbers as the first frame (the pair never changes)
        cap = fe.extractor.capacity
        right_valid = torch.stack([h.kr.valid.sum() for h in handles]).cpu().numpy()
        f0 = frames[0]
        for fr in frames:
            require(fr.xy.shape == (cap, 2) and np.isfinite(fr.xy).all()
                    and np.isfinite(fr.u_right).all() and np.isfinite(fr.depth).all(),
                    f"frame {fr.frame_id}: wrong shape or a value not finite")
            for name in ("xy", "octave", "valid", "u_right", "depth"):
                require(np.array_equal(getattr(fr, name), getattr(f0, name)),
                        f"frame {fr.frame_id}: {name} differs from frame 0")
        n_left = int(f0.valid.sum())
        matched = f0.u_right >= 0
        disp = float(np.median(f0.xy[matched, 0] - f0.u_right[matched]))
        share = matched.sum() / max(n_left, 1)
        print(f"slots: left {n_left}/{cap}, right {int(right_valid.min())}/{cap}; "
              f"stereo: {int(matched.sum())} matched ({share:.1%}), median disparity "
              f"{disp:.3f} px (pair: {DISPARITY}), depth > 0 at {int((f0.depth > 0).sum())}")
        require(n_left >= 0.9 * cap and right_valid.min() >= 0.9 * cap, "slots not filled")
        require(abs(disp - DISPARITY) < 0.5, f"median disparity {disp}")
        require(share >= 0.3, f"only {share:.1%} of keypoints matched")

    def cpu_vs_gpu(self):
        """Every Frame field of the card's path (kernels) equals the CPU
        path's (plain versions) on a small pair; exact."""
        torch, port = self.torch, self.port
        cfg = port["config"].Config()
        cfg.camera = port["config"].CameraConfig(width=SMALL_W, height=SMALL_H)
        cfg.orb = port["config"].ORBConfig(n_features=500, n_levels=4, ini_th_fast=20,
                                           min_th_fast=7)
        left, right = test_pair(SMALL_H, SMALL_W, seed=1)
        out = {}
        for dev in ("cuda", "cpu"):
            fe = port["frame"].StereoFrontend(cfg, SMALL_H, SMALL_W, device=dev)
            h = fe.submit(left, right)
            fr = fe.collect(h, 0.0)
            out[dev] = {f: getattr(fr.kp, f).cpu().numpy() for f in fr.kp._fields}
            out[dev].update(u_right=fr.u_right, depth=fr.depth,
                            host_pack=h.host_pack.cpu().numpy())
        bad = {f: int(np.sum(out["cuda"][f] != out["cpu"][f])) for f in out["cpu"]
               if not np.array_equal(out["cuda"][f], out["cpu"][f])}
        n_match = int((out["cpu"]["u_right"] >= 0).sum())
        print(f"small pair {SMALL_H}x{SMALL_W}: card vs CPU path, {n_match} stereo "
              f"matches; mismatching elements: {bad or 'none'}")
        require(not bad and n_match > 50, f"mismatches {bad}, {n_match} matches")

    def device_times(self):
        """Each kernel's and plain version's device time per frame, from
        torch.profiler: the first profiling of the process, after every
        phase that times the host (the host runs slower once the profiler
        has been active). Each wrapper call launches one kernel, so the
        profile must hold one kernel a call: fewer would mean lost events
        and a time too low. The profiler has returned sessions with no
        kernel events, or one kernel short of the count, on an H100 (for K3
        once; for K2 twice in a row after phase 10), so a kernel is profiled
        up to PROFILE_TRIES times before the check fails."""
        for k in self.kernels.values():
            kern, plain = k.pop("fns")
            want = k["launches_per_frame"]
            for attempt in range(PROFILE_TRIES):
                k["ms"], per_call = device_ms(self.torch, kern)
                if per_call == want:
                    break
                print(f"{k['name']}: profile {attempt + 1} held {per_call} kernels a call, "
                      f"not {want} (events lost)")
            require(per_call == want,
                    f"{k['name']}: profiled {per_call} kernels a call, not {want}")
            k["plain_ms"], _ = device_ms(self.torch, plain, iters=k.pop("plain_iters", 5))

    def profile(self, fe, left, right):
        """Device time by kernel over a few pipelined frames (informational)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fe.process(left, right, 0.0)
        torch.cuda.synchronize()
        n = 3
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            hs = [fe.submit(left, right) for _ in range(n)]
            for h in hs:
                fe.collect(h, 0.0)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        rows = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and dev_us(e) > 0]
        rows.sort(key=dev_us, reverse=True)
        busy = sum(dev_us(e) for e in rows) / 1e3 / n
        count = sum(e.count for e in rows) / n
        # the profiler slows the host many times over: the busy share is
        # taken against the frame time of the unprofiled pipelined run
        frame_ms = 1e3 / self.fps["pipelined_fps"] if self.fps else float("nan")
        print(f"profile ({n} frames): {count:.0f} device kernels/frame, device busy "
              f"{busy:.2f} ms/frame = {busy / frame_ms:.1%} of the unprofiled "
              f"{frame_ms:.2f} ms/frame (wall under the profiler {wall:.1f} ms/frame)")
        for e in rows[:8]:
            print(f"  {dev_us(e) / 1e3 / n:8.3f} ms/frame  {e.count // n:5d}x  {e.key[:90]}")

    # ---- phase 4: tracking ------------------------------------------------
    def tracking_setup(self):
        """bench.py's full-loop world (bench.py:265-290) and configuration,
        the card's frontend and tracker, and a counter of the step's
        launches of K1-K3 (every frame goes through the frontend)."""
        torch, port = self.torch, self.port
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import synth_world

        world = synth_world.PlaneWorld(
            np.random.default_rng(11), tex_size=8192, res=40.0, fx=FX, fy=FX,
            cx=W / 2.0, cy=H / 2.0, w=W, h=H, baseline=0.54)
        cfg = port["config"].Config()
        cfg.camera = port["config"].CameraConfig(
            fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=0.54 * FX, width=W, height=H,
            th_depth=35.0, fps=10.0)
        cfg.orb = port["config"].ORBConfig(n_features=2000, n_levels=8, ini_th_fast=20,
                                           min_th_fast=7)
        fe = port["frame"].StereoFrontend(cfg, H, W)
        tr = port["fused"].FusedTracker(cfg, H, W)
        self.trk = SimpleNamespace(world=world, cfg=cfg, fe=fe, tr=tr, synth=synth_world,
                                   frames=0, step_ms=[], n_motion=[], n_final=[],
                                   record=None, out={})
        for m in self.counters().values():
            m.launches = 0
        port["pose_opt_cuda"].launches = 0
        print(f"tracking: frame capacity {fe.extractor.capacity}, pose-LM table "
              f"{port['fused'].pose_cap(fe.extractor.capacity)} rows, local-search "
              f"table {port['fused'].LOCAL_CAP} rows")

    def _frame(self, Twc, i, pose_cw=None):
        t = self.trk
        left, right = t.world.render_stereo(Twc)
        fr = t.fe.process(left, right, 0.1 * i)
        t.frames += 1
        if pose_cw is not None:
            fr.set_pose(pose_cw)
        return fr

    def _add_keyframe(self, m, fr):
        """A keyframe and its stereo points, through the MapStore calls of
        Tracking._stereo_initialization (tracking.py:677-695)."""
        cam = self.trk.cfg.camera
        kf = m.add_keyframe(fr)
        for i in np.nonzero(fr.valid & (fr.depth > 0))[0]:
            pid = m.add_point(fr.unproject_stereo(i, cam.fx, cam.fy, cam.cx, cam.cy), kf, 1.0)
            m.add_observation(pid, kf, int(i))
            fr.map_pt[i] = pid
            m.compute_distinctive_descriptor(pid)
            m.update_normal_and_depth(pid)

    def _track(self, m, dmap, fr, last, T_pred, record=False):
        """One step through FusedTracker.track, read as Tracking._track_fused
        reads its host pack (tracking.py:808-865); fails the phase below the
        reference's limits of 20 motion matches and 30 inliers."""
        torch, t = self.torch, self.trk
        po = self.port["pose_opt"]
        if record:  # keep this step's inputs for the CPU comparison, and
            # its pose-LM calls' inputs for K4's check
            orig, orig_lm = t.tr._step, po.pose_optimization
            t.tr._step = lambda *a: (setattr(t, "record", [x.clone() for x in a]),
                                     orig(*a))[1]
            t.lm_record = []

            def lm(*a, **kw):
                t.lm_record.append((clone(a), dict(kw)))
                return orig_lm(*a, **kw)

            po.pose_optimization = lm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res, flat = t.tr.track(fr, last, last.map_pt, T_pred, dmap)
            out = flat.cpu().numpy()
        finally:
            if record:
                del t.tr._step
                po.pose_optimization = orig_lm
        t.step_ms.append((time.perf_counter() - t0) * 1e3)
        n = fr.map_pt.shape[0]
        pack, small = out[:10 * n].reshape(n, 10), out[10 * n:]
        assign = pack[:, 7].astype(np.int32)
        T = small[:16].reshape(4, 4).astype(np.float32)
        n_motion, n_final, n_gate, ovf = (int(v) for v in small[16:20])
        good = assign >= 0
        n_inliers = int(np.count_nonzero(m.pt_n_obs[assign[good]] > 0))
        require(np.isfinite(T).all() and np.isfinite(pack).all(),
                f"frame {fr.frame_id}: a value not finite")
        require(n_motion >= 20 and n_inliers >= 30,
                f"frame {fr.frame_id}: lost ({n_motion} motion matches, {n_inliers} inliers)")
        fr.set_pose(T)
        fr.map_pt[:] = assign
        t.n_motion.append(n_motion)
        t.n_final.append(n_final)
        if record:
            t.record_out = (T, assign, n_motion, n_final)
        return n_motion, n_final, n_gate, ovf

    def track_a(self):
        """(a) the start of a session: a map from frame 0, then the motion
        model over the accelerating path of bench.py."""
        t, port = self.trk, self.port
        gt = loop_path(N_TRACK_A + 1)
        x = float(gt[-1][0, 3])
        m = port["map_store"].MapStore(n_levels=8, scale_factor=1.2)
        dmap = port["device_map"].DeviceMap()
        last = self._frame(gt[0], 0, np.eye(4, dtype=np.float32))
        self._add_keyframe(m, last)
        dmap.sync(m)
        est = [last.pose.copy()]
        velocity = np.eye(4, dtype=np.float32)
        rows = []
        for i in range(1, N_TRACK_A + 1):
            fr = self._frame(gt[i], i)
            rows.append(self._track(m, dmap, fr, last, velocity @ last.pose))
            velocity = fr.pose @ np.linalg.inv(last.pose)
            est.append(fr.pose.copy())
            last = fr
        ate = port["trajectory"].ate_rmse([np.linalg.inv(T) for T in est], gt)
        # a lost or wrong track: a nadir view of a plane 15 m away trades a
        # tilt of 1 degree for 0.26 m of shift, so the gate is loose
        require(ate < 0.25, f"ATE {ate} m")
        require(all(r[3] == 0 for r in rows), f"overflow in (a): {rows}")
        t.out.update(a_frames=N_TRACK_A, a_points=m.n_points, a_ate_m=ate,
                     a_path_m=float(x))
        print(f"tracking (a): map of {m.n_points} points from frame 0 (rung {dmap.live_cap}); "
              f"{N_TRACK_A} frames over {x:.1f} m, n_motion "
              f"{[r[0] for r in rows]}, n_final {[r[1] for r in rows]}; ATE {ate:.4f} m")

    def track_b(self):
        """(b) the 16k live rung: keyframes at their ground-truth poses, 16 m
        apart, and frames tracked between two of them."""
        t, port = self.trk, self.port

        def twc(i):
            return t.synth.camera_pose(np.array([0.8 * i, 0.1 * np.sin(i * 0.3), 0.0],
                                                np.float32),
                                       height=15.0, yaw=0.01 * np.sin(i * 0.2))

        m = port["map_store"].MapStore(n_levels=8, scale_factor=1.2)
        dmap = port["device_map"].DeviceMap()
        kfs = {}
        for k in range(N_KF_B):
            i = k * KF_EVERY_B
            kfs[i] = self._frame(twc(i), i, np.linalg.inv(twc(i)))
            self._add_keyframe(m, kfs[i])
        dmap.sync(m)
        require(dmap.live_cap == 16384, f"live rung {dmap.live_cap} ({m.n_points} points)")
        last = kfs[KF_EVERY_B]
        velocity = np.linalg.inv(twc(KF_EVERY_B)) @ twc(KF_EVERY_B - 1)
        rows, errs = [], []
        for j in range(1, N_TRACK_B + 1):
            i = KF_EVERY_B + j
            fr = self._frame(twc(i), i)
            rows.append(self._track(m, dmap, fr, last, velocity @ last.pose,
                                    record=j == N_TRACK_B // 2))
            velocity = fr.pose @ np.linalg.inv(last.pose)
            # estimated Tcw times true Twc: I when exact; the angle from
            # atan2 in float64 (arccos of a float32 trace reads 0 below 0.02 deg)
            d = fr.pose.astype(np.float64) @ twc(i)
            r = d[:3, :3]
            vee = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
            ang = np.arctan2(np.linalg.norm(vee) / 2.0, (np.trace(r) - 1.0) / 2.0)
            errs.append((float(np.linalg.norm(d[:3, 3])), float(np.degrees(ang))))
            last = fr
        n_gate = [r[2] for r in rows]
        ovf = [r[3] for r in rows]
        local_ovf = [max(g - port["fused"].LOCAL_CAP, 0) for g in n_gate]
        print(f"tracking (b): {N_KF_B} keyframes, {m.n_points} points, live rung "
              f"{dmap.live_cap}; {N_TRACK_B} frames: n_gate {n_gate} (cap "
              f"{port['fused'].LOCAL_CAP}), local-search overflow {local_ovf}, "
              f"pose-LM overflow {ovf}, n_motion "
              f"{[r[0] for r in rows]}, n_final {[r[1] for r in rows]}")
        print("  error against ground truth (m, deg): "
              + ", ".join(f"({e[0]:.4f}, {e[1]:.4f})" for e in errs))
        require(max(n_gate) <= port["fused"].LOCAL_CAP and max(ovf) == 0,
                f"an overflow: n_gate {n_gate}, pose-LM {ovf}")
        max_t, max_r = max(e[0] for e in errs), max(e[1] for e in errs)
        require(max_t < 0.5 and max_r < 2.0, f"pose error {max_t} m, {max_r} deg")
        t.out.update(b_frames=N_TRACK_B, b_points=m.n_points, b_live_rung=dmap.live_cap,
                     b_n_gate_max=max(n_gate), b_overflow_local=max(local_ovf),
                     b_overflow_pose=max(ovf), b_max_err_m=max_t, b_max_err_deg=max_r)

    def track_launches(self):
        """K1-K3 ran once on every frame of the tracking phase, K4 twice on
        every fused step."""
        t = self.trk
        launches = {k: m.launches for k, m in self.counters().items()}
        want = {k: t.frames for k in launches}
        lm, steps = self.port["pose_opt_cuda"].launches, len(t.step_ms)
        print(f"tracking: launches over its {t.frames} frames: {launches}; K4 pose_lm "
              f"{lm} over its {steps} fused steps")
        require(launches == want, f"launch counts {launches} != {want}")
        require(lm == 2 * steps, f"K4 launched {lm} times in {steps} fused steps, not 2 a step")
        t.out["frontend_launches"] = launches
        t.out["pose_lm_launches"] = lm
        t.pose_lm_launches = lm

    def check_pose_lm(self):
        """K4 bit-equal to its plain twin on the card at the two pose-LM calls
        of the recorded step of (b), then timed: device ms a fused step (both
        calls), the bound from these inputs, the trials the LM took."""
        torch, t, port = self.torch, self.trk, self.port
        po = port["pose_opt"]
        calls = t.lm_record
        require(len(calls) == 2, f"{len(calls)} pose-LM calls recorded in a fused step, not 2")
        cap = port["fused"].pose_cap(t.fe.extractor.capacity)
        rounds, n_bytes, n_ops, err, rows = [], 0, 0, 0.0, []
        orig_round = po._lm_round

        def lm_round(*a):
            T, trials = orig_round(*a)
            rounds.append((int(a[6].sum()), [int(v) for v in trials.cpu()]))
            return T, trials

        for i, (a, kw) in enumerate(calls):
            n = a[1].shape[0]
            require(a[0].device.type == "cuda" and n == cap,
                    f"call {i + 1}: {n} edges on {a[0].device}, not the main path's {cap}")
            got = po.pose_optimization(*a, **kw)
            rounds.clear()
            po._lm_round = lm_round
            try:
                ref = po.pose_optimization_plain(*a, **kw)
            finally:
                po._lm_round = orig_round
            torch.cuda.synchronize()
            for f in got._fields:
                g, r = getattr(got, f), getattr(ref, f)
                require(g.dtype == r.dtype and g.shape == r.shape,
                        f"call {i + 1}: {f} {g.dtype} {tuple(g.shape)} != {r.dtype} "
                        f"{tuple(r.shape)}")
                e = float((g.double() - r.double()).abs().max()) if g.numel() else 0.0
                err = max(err, e)
                require(torch.equal(g, r), f"call {i + 1}: K4 != plain in {f}: max err {e}")
            n_valid = int(a[5].sum())
            n_bytes += lm_bytes(n)
            n_ops += lm_operations(rounds, n_valid)
            trials = [v for _, tr in rounds for v in tr]
            rows.append(dict(edges=n, valid=n_valid, n_rounds=kw.get("n_rounds"),
                             round_edges=[r[0] for r in rounds],
                             trials_per_iteration_mean=float(np.mean(trials)),
                             trials_per_iteration_max=max(trials),
                             n_inliers=int(got.n_inliers)))
        bnd, by = bound_ms(n_bytes, n_ops)
        fns = (lambda: [po.pose_optimization(*a, **kw) for a, kw in calls],
               lambda: [po.pose_optimization_plain(*a, **kw) for a, kw in calls])
        print(f"K4 pose_lm: the two pose-LM calls of a fused step of (b), {cap}-edge tables "
              f"({[r['valid'] for r in rows]} valid edges, trials an iteration "
              f"{[r['trials_per_iteration_mean'] for r in rows]} on average): T, inlier, "
              f"chi2 and n_inliers bit-equal to the plain twin on the card; bound "
              f"{n_bytes} bytes, {n_ops} operations a fused step")
        t.out["pose_lm_calls"] = rows
        self.kernels["pose_lm"] = dict(
            name="pose_lm", route="cuda", source="iv_slam_tpu_torch/csrc/pose_lm.cu",
            replaces=None, launches=t.pose_lm_launches, max_abs_err=err,
            bound_ms=bnd, bound_by=by, library_ms=None, fns=fns, launches_per_frame=2,
            plain_iters=2, event_ms=event_ms(torch, fns[0], iters=20),
            plain_event_ms=event_ms(torch, fns[1], iters=3, warmup=1))

    def track_cpu_vs_card(self):
        """One recorded step of (b) again on the CPU path, same inputs."""
        torch, t, port = self.torch, self.trk, self.port
        require(t.record is not None, "no step was recorded")
        tr_cpu = port["fused"].FusedTracker(t.cfg, H, W, device="cpu")
        t0 = time.perf_counter()
        res, _ = tr_cpu._step(*(x.cpu() for x in t.record))
        cpu_s = time.perf_counter() - t0
        T, assign, n_motion, n_final = t.record_out
        same = float(np.mean(res.assign_map.numpy() == assign))
        dT = float(np.abs(res.T.numpy() - T).max())
        eq = (int(res.n_motion) == n_motion, int(res.n_final) == n_final)
        print(f"tracking: one step of (b), card vs CPU path: assign_map equal at "
              f"{same:.2%}, n_motion {n_motion} vs {int(res.n_motion)}, n_final "
              f"{n_final} vs {int(res.n_final)}, max |dT| {dT:.3g} (CPU step {cpu_s:.1f} s)")
        t.out["cpu_vs_card"] = dict(assign_equal=same, n_motion_equal=eq[0],
                                    n_final_equal=eq[1], max_abs_dT=dT)
        require(same >= 0.99 and dT <= 1e-4, f"card and CPU differ: {same}, {dT}")

    def track_step_syncs(self):
        """Host syncs inside one step (CUDA sync debug mode), on the
        recorded step's inputs."""
        import warnings

        torch, t = self.torch, self.trk
        t.tr._step(*t.record)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t.tr._step(*t.record)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        torch.cuda.synchronize()
        print(f"tracking step: {len(syncs)} host syncs inside the step")
        require(not syncs, f"host syncs inside the step, at: {sorted(set(syncs))}")
        t.out["host_syncs_in_step"] = len(syncs)

    def track_step_profile(self):
        """The step's device time and launches from torch.profiler, on the
        recorded step's inputs, beside its host time from the tracking
        phases."""
        from torch.profiler import ProfilerActivity, profile

        torch, t = self.torch, self.trk
        step = lambda: t.tr._step(*t.record)  # noqa: E731
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_PROFILE_ITERS):
                step()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        kern = [e for e in rows if not e.key.startswith(("Memcpy", "Memset"))]
        busy = sum(dev_us(e) for e in rows) / 1e3 / STEP_PROFILE_ITERS
        launches = sum(e.count for e in kern) / STEP_PROFILE_ITERS
        copies = sum(e.count for e in rows
                     if e.key.startswith(("Memcpy", "Memset"))) / STEP_PROFILE_ITERS
        host = float(np.median(t.step_ms))
        print(f"tracking step: host {host:.2f} ms (median of {len(t.step_ms)}, track() to "
              f"the host pack read), device {busy:.3f} ms, {launches:.0f} kernel launches "
              f"and {copies:.0f} copies a step")
        rows.sort(key=dev_us, reverse=True)
        for e in rows[:6]:
            print(f"  {dev_us(e) / 1e3 / STEP_PROFILE_ITERS:8.3f} ms/step  "
                  f"{e.count // STEP_PROFILE_ITERS:5d}x  {e.key[:90]}")
        t.out.update(frames_tracked=len(t.step_ms),
                     median_n_motion=float(np.median(t.n_motion)),
                     median_n_final=float(np.median(t.n_final)),
                     host_ms_per_step=host, device_ms_per_step=busy,
                     kernel_launches_per_step=launches, copies_per_step=copies)

    # ---- phase 5: the full loop ---------------------------------------------
    def full_loop(self):
        """bench.py's full loop (bench.py:238-296) through System on the card,
        every frame's frontend submitted while the previous frame tracks;
        one call each of triangulate_event_compact, the indexed fuse and
        ba_solve is recorded (inputs and output) for the comparisons below."""
        torch, port, t = self.torch, self.port, self.trk
        gt = loop_path(N_LOOP)
        pairs = [t.world.render_stereo(T) for T in gt]
        cfg = copy.deepcopy(t.cfg)
        cfg.system.fused_tracking = True
        s = port["system"].System(cfg, H, W)
        tr = s.tracking
        timer = self.port["profiling"].StageTimer()
        tr.stage_timer = tr.local_mapping.stage_timer = timer
        rec, calls = {}, {}
        hooks = (("triangulate", port["triangulate"], "triangulate_event_compact"),
                 ("fuse", port["match"], "fuse_into_keyframes_compact_indexed"),
                 ("ba", port["local_ba"], "ba_solve"))
        origs = {name: getattr(mod, fn) for name, mod, fn in hooks}

        def recorder(name):
            def call(*args, **kw):
                calls[name] = calls.get(name, 0) + 1
                if calls[name] != RECORD_CALL:
                    return origs[name](*args, **kw)
                args_c = clone(args)
                out = origs[name](*args, **kw)
                rec[name] = (args_c, kw, clone(out))
                return out
            return call

        for name, mod, fn in hooks:
            setattr(mod, fn, recorder(name))
        for m in self.counters().values():
            m.launches = 0
        frame_ms, submit_ms = [], []
        # the inline run of phase 14 (a) and (b) and 15 (a) and (b) is this
        # run's first N_THR, N_THR_SERIAL, N_CHAIN and N_BENCH frames
        events = self._thr_events(tr.local_mapping)
        busy = GpuBusy().__enter__()
        inline = {}
        try:
            handle = s.submit_frontend(*pairs[0])
            torch.cuda.synchronize()
            t_first, t_start = time.perf_counter(), None
            for i in range(N_LOOP):
                cur = handle
                if i + 1 == N_THR:   # the first N_THR frames' launches
                    launches_thr = {k: m.launches for k, m in self.counters().items()}
                if i + 1 < N_LOOP:
                    t0 = time.perf_counter()
                    handle = s.submit_frontend(*pairs[i + 1])
                    submit_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                s.track_stereo(*pairs[i], timestamp=0.1 * i, frontend_handle=cur)
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                if i == RAMP - 1:
                    torch.cuda.synchronize()
                    t_start = time.perf_counter()
                if i + 1 == N_THR:
                    torch.cuda.synchronize()
                    t_thr = time.perf_counter()
                    busy.stop()
                    inline[N_THR] = dict(
                        self._thr_state(s), fps=(N_THR - RAMP) / (t_thr - t_start),
                        fps_all=N_THR / (t_thr - t_first), events=list(events),
                        frontend_launches=launches_thr, device_busy_share=busy.share,
                        device_busy_samples=busy.n)
                if i + 1 == N_THR_SERIAL:
                    inline[N_THR_SERIAL] = self._thr_state(s)
                if i + 1 in (N_CHAIN, N_BENCH):
                    torch.cuda.synchronize()
                    inline[i + 1] = dict(
                        self._thr_state(s),
                        fps=(i + 1 - RAMP) / (time.perf_counter() - t_start))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t_start
        finally:
            busy.stop()
            for name, mod, fn in hooks:
                setattr(mod, fn, origs[name])
        t.thr_inline = inline
        launches = {k: m.launches for k, m in self.counters().items()}
        fps = (N_LOOP - RAMP) / elapsed
        est = s.trajectory_twc()
        ate = port["trajectory"].ate_rmse(est, gt)
        ate_window = port["trajectory"].ate_rmse(est[RAMP:], gt[RAMP:])
        c = np.stack([g[:3, 3] for g in gt])
        path_m = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
        lm = tr.local_mapping
        m = tr.map
        fused = [a + b for a, b in zip(stage_ms(timer, "fused_dispatch"),
                                       stage_ms(timer, "fused_readback"))]
        events = ("lm_cull_points", "lm_triangulate", "lm_fuse", "lm_local_ba",
                  "lm_cull_keyframes")
        out = dict(
            frames=N_LOOP, keyframes=int(m.n_keyframes),
            keyframes_alive=int(m.kf_alive[:m.n_keyframes].sum()),
            map_points=int(m.n_points), map_points_alive=int(m.pt_alive[:m.n_points].sum()),
            failures=int(s.failure_count), state=s.state.name,
            full_loop_fps=fps, full_loop_ate_m=ate, ate_m_after_ramp=ate_window,
            path_m=path_m, frontend_launches=launches,
            host_ms_median=dict(
                frame=float(np.median(frame_ms)), submit=float(np.median(submit_ms)),
                frontend=median_ms(timer, "frontend"),
                fused_step=float(np.median(fused)) if fused else None,
                keyframe_event=median_ms(timer, "keyframe_event"),
                **{k[3:]: median_ms(timer, k) for k in events}),
            keyframe_events=len(stage_ms(timer, "keyframe_event")),
            fused_steps=len(fused), ba_rungs=[list(r) if r else None for r in lm.ba_rungs],
            cap_overflows=dict(lm.overflows), recorded=sorted(rec))
        t.loop = out
        t.loop_sys, t.loop_rec, t.loop_gt, t.loop_pairs = s, rec, gt, pairs
        t.loop_next = N_LOOP
        print(f"full loop: {N_LOOP} frames over {path_m:.1f} m through System on the card: "
              f"{out['keyframes']} keyframes ({out['keyframes_alive']} alive), "
              f"{out['map_points']} map points ({out['map_points_alive']} alive), "
              f"{out['failures']} failures, state {out['state']}; ATE {ate:.4f} m (frames "
              f"{RAMP}-{N_LOOP}: {ate_window:.4f}); {fps:.3f} frames/s over frames "
              f"{RAMP}-{N_LOOP}")
        print(f"  host ms (median): {json.dumps(out['host_ms_median'])}")
        print(f"  keyframe events {out['keyframe_events']}, BA rungs {out['ba_rungs']}, "
              f"overflows {out['cap_overflows']}, K1-K3 launches {launches}")
        want = {k: N_LOOP for k in launches}
        require(launches == want, f"launch counts {launches} != {want}")
        require(s.failure_count == 0 and s.state.name == "OK",
                f"{s.failure_count} failures, state {s.state.name}")
        require(ate < 0.5, f"ATE {ate} m")
        require(not any(lm.overflows.values()), f"cap overflow: {lm.overflows}")
        require(len(rec) == 3, f"recorded only {sorted(rec)} (calls {calls})")

    def loop_cpu_vs_card(self):
        """The recorded keyframe-event calls again on the CPU path, same
        inputs: triangulated rows and fuse triples equal, BA poses within
        1e-4 and inlier flags >= 99% equal."""
        port, t = self.port, self.trk
        rec = t.loop_rec
        args, kw, card = rec["triangulate"]
        cpu = port["triangulate"].triangulate_event_compact(*to_cpu(args), **kw).numpy()
        card = card.cpu().numpy()
        n = int(card[-2])
        rows, rows_c = card[:-2].reshape(-1, 6), cpu[:-2].reshape(-1, 6)
        idx_equal = np.array_equal(rows[:, :3], rows_c[:, :3]) and np.array_equal(card[-2:],
                                                                                 cpu[-2:])
        dX = float(np.abs(rows[:, 3:] - rows_c[:, 3:]).max())
        # the largest difference in units of the last place of the larger side
        ulp = np.spacing(np.maximum(np.abs(rows[:, 3:]), np.abs(rows_c[:, 3:])))
        dX_ulp = float((np.abs(rows[:, 3:] - rows_c[:, 3:]) / ulp).max())
        x_equal = float(np.mean(rows[:n, 3:] == rows_c[:n, 3:])) if n else 1.0
        args, kw, card_f = rec["fuse"]
        cpu_f = port["match"].fuse_into_keyframes_compact_indexed(*to_cpu(args), **kw).numpy()
        card_f = card_f.cpu().numpy()
        fuse_equal = np.array_equal(cpu_f, card_f)
        (prob, K), kw, res = rec["ba"]
        res_c = port["ba_core"].ba_solve(to_cpu(prob), to_cpu(K), **kw)
        valid = prob.e_valid.cpu().numpy()
        dT = float((res.kf_pose.cpu() - res_c.kf_pose).abs().max())
        dP = float((res.pt_pos.cpu() - res_c.pt_pos).abs().max())
        agree = float(np.mean(res.e_inlier.cpu().numpy()[valid]
                              == res_c.e_inlier.numpy()[valid]))
        rung = (prob.kf_pose.shape[0], prob.pt_pos.shape[0], prob.e_obs.shape[0])
        print(f"full loop, recorded calls card vs CPU path: triangulation ({n} rows, "
              f"{int(card[-1])} matched) index columns and counts equal {idx_equal}, "
              f"X bit-equal {x_equal:.2%}, max |dX| {dX:.3g} ({dX_ulp:.0f} ulp); fuse ({int(card_f[-1])} "
              f"triples) equal {fuse_equal}; local BA at rung {rung} ({int(valid.sum())} "
              f"edges): max |dT| {dT:.3g}, max |dX| {dP:.3g}, inlier flags equal {agree:.2%}")
        t.loop["cpu_vs_card"] = dict(
            triangulate_rows=n, triangulate_index_equal=idx_equal, triangulate_X_equal=x_equal,
            triangulate_max_abs_dX=dX, triangulate_max_ulp_dX=dX_ulp, fuse_triples=int(card_f[-1]), fuse_equal=fuse_equal,
            ba_rung=list(rung), ba_max_abs_dT=dT, ba_max_abs_dX=dP, ba_inlier_equal=agree)
        # float64 eigh rounded once: X bit-equal but for a value at a rounding
        # boundary (numerics.py), so at most a few ulp apart
        require(idx_equal and dX_ulp <= TRI_MAX_ULP and x_equal >= 0.99,
                f"triangulation differs: index columns equal {idx_equal}, max {dX_ulp} ulp, "
                f"{x_equal:.2%} of X bit-equal")
        require(fuse_equal, "fuse triples differ")
        require(dT <= 1e-4 and agree >= 0.99, f"BA differs: {dT}, {agree}")

    def loop_ba_repeatable(self):
        """The recorded local-BA problem solved again on the card: bit-equal
        to the loop's solve."""
        port, t, torch = self.port, self.trk, self.torch
        (prob, K), kw, res = t.loop_rec["ba"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = port["ba_core"].ba_solve(prob, K, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        same = {f: bool(torch.equal(getattr(res, f), getattr(res2, f))) for f in res._fields}
        print(f"full loop, local BA again on the card ({ms:.1f} ms host): bit-equal {same}")
        t.loop["ba_repeat_bit_equal"] = same
        t.loop["ba_host_ms"] = ms
        require(all(same.values()), f"BA not repeatable: {same}")

    def _track_next(self):
        """Track the next frames of the loop's path on phase 5's System
        until one is neither lost nor made a keyframe by tracking (at most
        3): the frame a keyframe event is then forced on."""
        t = self.trk
        s = t.loop_sys
        tr = s.tracking
        for _ in range(3):
            i, t.loop_next = t.loop_next, t.loop_next + 1
            s.track_stereo(*t.world.render_stereo(loop_path(i + 1)[-1]), timestamp=0.1 * i)
            if tr.current.frame_id != tr.last_kf_frame_id:
                break
        require(tr.current.frame_id != tr.last_kf_frame_id and s.state.name == "OK",
                "3 extra frames were keyframes already, or lost")

    def keyframe_event_profile(self):
        """One more frame of the loop's path, tracked, then a keyframe event
        forced on it under torch.profiler and CUDA sync debug mode: its
        device ms, kernel launches and host syncs."""
        import warnings

        from torch.profiler import ProfilerActivity, profile

        torch, t = self.torch, self.trk
        tr = t.loop_sys.tracking
        self._track_next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    tr._create_new_keyframe()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
        rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        kern = [e for e in rows if not e.key.startswith(("Memcpy", "Memset"))]
        busy = sum(dev_us(e) for e in rows) / 1e3
        launches = sum(e.count for e in kern)
        print(f"keyframe event (profiled): device {busy:.2f} ms, {launches} kernel launches, "
              f"{len(syncs)} host syncs, wall under the profiler {wall:.0f} ms; BA rung "
              f"{tr.local_mapping.ba_rungs[-1]}")
        rows.sort(key=dev_us, reverse=True)
        for e in rows[:6]:
            print(f"  {dev_us(e) / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:90]}")
        # the recorded local BA alone
        (prob, K), kw, _ = t.loop_rec["ba"]
        ba_ms, ba_launches = device_ms(
            torch, lambda: self.port["ba_core"].ba_solve(prob, K, **kw), iters=2, warmup=1)
        rung = (prob.kf_pose.shape[0], prob.pt_pos.shape[0], prob.e_obs.shape[0])
        print(f"local BA (the recorded problem, rung {rung}): device {ba_ms:.2f} ms, "
              f"{ba_launches:.0f} kernel launches a solve")
        htod = sum(e.count for e in rows if e.key.startswith("Memcpy HtoD"))
        t.loop["keyframe_event_profile"] = dict(device_ms=busy, kernel_launches=launches,
                                                host_syncs=len(syncs), htod=htod,
                                                ba_device_ms=ba_ms,
                                                ba_kernel_launches=ba_launches)

    # ---- phase 6: introspection ---------------------------------------------
    def intro_setup(self):
        """Seeded FCN weights on the card, the head (conv_last) scaled and
        shifted so that the raw prediction on the loop's first left image
        has median 0.5 and a 10-90% spread of 0.3: sigmoid(20 (x - 0.5))
        then spans the uint8 range (a random head sends it to one end)."""
        torch, models, t = self.torch, self.port["models"], self.trk
        net = seeded_fcn(torch, models, FCN_SEED).cuda()
        left, right = t.loop_pairs[0]
        rgb = torch.from_numpy(np.ascontiguousarray(np.stack([left] * 3, axis=-1))).cuda()
        pred = models.predict(net, rgb[None], NET_HW).double().cpu().flatten()
        q10, q50, q90 = (float(v) for v in torch.quantile(
            pred, torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64)))
        a = 0.3 / max(q90 - q10, 1e-6)
        head = net.decoder.conv_last
        with torch.no_grad():
            head.weight.mul_(a)
            head.bias.copy_(0.5 + (head.bias - q50) * a)
        self.intro = SimpleNamespace(net=net, left=left, right=right, rgb=rgb, out={})
        print(f"introspection: FCN of {sum(p.numel() for p in net.parameters())} parameters, "
              f"seed {FCN_SEED}, net input {NET_HW}; raw prediction quantiles 10/50/90 "
              f"{q10:.4g}/{q50:.4g}/{q90:.4g} before the head was centred (x{a:.4g})")

    def intro_fcn(self):
        """(a) the cost map of the 376x1241 left image: non-degenerate, the
        card against the CPU path, and repeatable on the card."""
        torch, models, it = self.torch, self.port["models"], self.intro
        cost = models.inference_cost_map(it.net, it.rgb, (H, W), NET_HW)
        pred = models.predict(it.net, it.rgb[None], NET_HW)
        cost2 = models.inference_cost_map(it.net, it.rgb, (H, W), NET_HW)
        pred2 = models.predict(it.net, it.rgb[None], NET_HW)
        net_cpu = copy.deepcopy(it.net).cpu()
        t0 = time.perf_counter()
        cost_cpu = models.inference_cost_map(net_cpu, it.rgb.cpu(), (H, W), NET_HW)
        cpu_s = time.perf_counter() - t0
        pred_cpu = models.predict(net_cpu, it.rgb.cpu()[None], NET_HW)
        c = cost.cpu().numpy()
        qs = np.percentile(c, [0, 10, 25, 50, 75, 90, 100]).tolist()
        top = float(np.bincount(c.ravel(), minlength=256).max() / c.size)
        d = np.abs(c.astype(int) - cost_cpu.numpy().astype(int))
        perr = float((pred.cpu() - pred_cpu).abs().max())
        repeat = bool(torch.equal(cost, cost2) and torch.equal(pred, pred2))
        print(f"introspection (a): cost map {tuple(c.shape)} quantiles 0/10/25/50/75/90/100 "
              f"{qs}, most common value on {top:.2%} of the pixels; card vs CPU path "
              f"(CPU {cpu_s:.1f} s): prediction max abs err {perr:.3g}, cost map max |d| "
              f"{int(d.max())} on {float((d > 0).mean()):.3%} of the pixels; two card runs "
              f"bit-equal {repeat}")
        it.cost = cost
        it.out.update(cost_quantiles=qs, cost_top_value_share=top, pred_max_abs_err=perr,
                      cost_max_abs_diff=int(d.max()), cost_diff_share=float((d > 0).mean()),
                      card_repeatable=repeat)
        require(top <= 0.9, f"degenerate cost map: one value on {top:.2%} of the pixels")
        require(int(d.max()) <= 1, f"card and CPU cost maps differ by {int(d.max())}")
        require(repeat, "the card's cost map is not repeatable")

    def intro_frontend(self):
        """(b) the frontend with the cost map, card against the CPU path,
        the attached FCN against the explicit cost map, K1-K3 counted on the
        quality path, host syncs inside a frame."""
        import warnings

        torch, port, it, t = self.torch, self.port, self.intro, self.trk
        StereoFrontend = port["frame"].StereoFrontend
        cfg = t.cfg

        def fields(fr, h):
            out = {f: getattr(fr.kp, f).cpu().numpy() for f in fr.kp._fields}
            out.update(u_right=fr.u_right, depth=fr.depth, qual_score=fr.qual_score,
                       xy_host=fr.xy, valid_host=fr.valid, host_pack=h.host_pack.cpu().numpy())
            return out

        def run(fe, cost):
            h = fe.submit(it.left, it.right, cost)
            return fields(fe.collect(h, 0.0), h)

        card = run(StereoFrontend(cfg, H, W), it.cost)
        t0 = time.perf_counter()
        cpu = run(StereoFrontend(cfg, H, W, device="cpu"), it.cost.cpu())
        cpu_s = time.perf_counter() - t0
        fe = StereoFrontend(cfg, H, W)
        fe.attach_introspection(it.net, NET_HW)
        att = run(fe, None)
        bad = {f: int(np.sum(card[f] != cpu[f])) for f in cpu
               if not np.array_equal(card[f], cpu[f])}
        bad_att = [f for f in card if not np.array_equal(card[f], att[f])]
        valid = card["valid_host"]
        q = card["qual_score"][valid]
        print(f"introspection (b): frontend {H}x{W} with the cost map, card vs CPU path (CPU "
              f"{cpu_s:.1f} s): {int(valid.sum())} keypoints, quality {q.min():.4f}-"
              f"{q.max():.4f} (mean {q.mean():.4f}), {int((card['u_right'] >= 0).sum())} "
              f"stereo matches; mismatching elements: {bad or 'none'}; attached FCN vs "
              f"explicit cost map: mismatching fields {bad_att or 'none'}")
        require(not bad, f"card and CPU path differ: {bad}")
        require(not bad_att, f"attached FCN differs from the explicit cost map: {bad_att}")
        require(valid.sum() >= 0.9 * fe.extractor.capacity, "slots not filled")

        mods = self.counters()
        for m in mods.values():
            m.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_INTRO_FRAMES):
            fe.collect(fe.submit(it.left, it.right), float(i))
        torch.cuda.synchronize()
        fps_fcn = N_INTRO_FRAMES / (time.perf_counter() - t0)
        launches = {k: m.launches for k, m in mods.items()}
        want = {k: N_INTRO_FRAMES for k in launches}
        # the same frames without introspection, in the same process
        plain = StereoFrontend(cfg, H, W)
        plain.collect(plain.submit(it.left, it.right), 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_INTRO_FRAMES):
            plain.collect(plain.submit(it.left, it.right), float(i))
        torch.cuda.synchronize()
        fps_plain = N_INTRO_FRAMES / (time.perf_counter() - t0)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                h = fe.submit(it.left, it.right)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        fe.collect(h, 0.0)
        print(f"introspection (b): K1-K3 launches over {N_INTRO_FRAMES} weighted frames "
              f"{launches}; {len(syncs)} host syncs inside a frame (submit with the FCN); "
              f"submit+collect {fps_fcn:.2f} frames/s with the FCN attached, {fps_plain:.2f} "
              f"without introspection")
        it.fe = fe
        it.out.update(frontend_card_vs_cpu_equal=not bad, attached_equal_explicit=not bad_att,
                      quality_path_launches=launches, host_syncs_in_frame=len(syncs),
                      keypoint_quality_mean=float(q.mean()), frontend_fps_fcn=fps_fcn,
                      frontend_fps_plain=fps_plain)
        require(launches == want, f"launch counts {launches} != {want}")
        require(not syncs, f"host syncs inside a frame, at: {sorted(set(syncs))}")

    def intro_loop(self):
        """(c) The first N_INTRO_LOOP frames of bench.py's loop through
        System with the FCN attached: every frame's cost map from the FCN
        on the card; beside phase 5's run over the same frames."""
        torch, port, it, t = self.torch, self.port, self.intro, self.trk
        cfg = copy.deepcopy(t.cfg)
        cfg.system.fused_tracking = True
        s = port["system"].System(cfg, H, W)
        s.tracking.frontend.attach_introspection(it.net, NET_HW)
        timer = self.port["profiling"].StageTimer()
        s.tracking.stage_timer = s.tracking.local_mapping.stage_timer = timer
        pairs, gt = t.loop_pairs, t.loop_gt
        submit_ms = []
        for m in self.counters().values():
            m.launches = 0
        quals = []
        handle = s.submit_frontend(*pairs[0])
        torch.cuda.synchronize()
        for i in range(N_INTRO_LOOP):
            cur = handle
            if i + 1 < N_INTRO_LOOP:
                t0 = time.perf_counter()
                handle = s.submit_frontend(*pairs[i + 1])
                submit_ms.append((time.perf_counter() - t0) * 1e3)
            s.track_stereo(*pairs[i], timestamp=0.1 * i, frontend_handle=cur)
            if i == RAMP - 1:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            fr = s.tracking.current
            if fr.xy is not None:
                quals.append(float(fr.qual_score[fr.valid].mean()))
        torch.cuda.synchronize()
        fps = (N_INTRO_LOOP - RAMP) / (time.perf_counter() - t_start)
        launches = {k: m.launches for k, m in self.counters().items()}
        ate_rmse = port["trajectory"].ate_rmse
        ate = ate_rmse(s.trajectory_twc(), gt[:N_INTRO_LOOP])
        lm, m = s.tracking.local_mapping, s.tracking.map
        plain = t.thr_inline[N_INTRO_LOOP]
        plain_ate = ate_rmse(list(plain["twc"]), gt[:N_INTRO_LOOP])
        fused = [a + b for a, b in zip(stage_ms(timer, "fused_dispatch"),
                                       stage_ms(timer, "fused_readback"))]
        host = dict(submit=float(np.median(submit_ms)),
                    fused_step=float(np.median(fused)) if fused else None,
                    keyframe_event=median_ms(timer, "keyframe_event"))
        out = dict(frames=N_INTRO_LOOP, failures=int(s.failure_count), state=s.state.name,
                   host_ms_median=host, keyframe_events=len(stage_ms(timer, "keyframe_event")),
                   fps=fps, fps_without_introspection=plain["fps"], ate_m=ate,
                   ate_m_without_introspection=plain_ate,
                   keyframes=int(m.n_keyframes), map_points=int(m.n_points),
                   map_points_alive=int(m.pt_alive[:m.n_points].sum()),
                   keypoint_quality_mean=float(np.mean(quals)) if quals else None,
                   frontend_launches=launches, cap_overflows=dict(lm.overflows))
        it.out["loop"] = out
        for k, v in launches.items():
            self.kernels[k]["launches_introspection"] = v
        print(f"introspection (c): {N_INTRO_LOOP} frames through System with the FCN attached: "
              f"{out['failures']} failures, state {out['state']}, {out['keyframes']} "
              f"keyframes, {out['map_points']} map points ({out['map_points_alive']} alive); "
              f"ATE {ate:.4f} m (without introspection, phase 5: {plain_ate:.4f} m); "
              f"{fps:.3f} frames/s over frames {RAMP}-{N_INTRO_LOOP} (phase 5: "
              f"{plain['fps']:.3f}); mean keypoint quality "
              f"{out['keypoint_quality_mean']}; K1-K3 launches {launches}; host ms "
              f"(median) {json.dumps(host)} (without introspection, phase 5: "
              f"{json.dumps({k: t.loop['host_ms_median'][k] for k in host})})")
        want = {k: N_INTRO_LOOP for k in launches}
        require(launches == want, f"launch counts {launches} != {want}")
        require(s.failure_count == 0 and s.state.name == "OK",
                f"{s.failure_count} failures, state {s.state.name}")
        require(ate < 0.5, f"ATE {ate} m")
        require(not any(lm.overflows.values()), f"cap overflow: {lm.overflows}")

    def intro_profile(self):
        """The FCN's and one weighted frame's device ms and launches."""
        torch, models, it = self.torch, self.port["models"], self.intro
        fcn_ms, fcn_n = device_ms(
            torch, lambda: models.inference_cost_map(it.net, it.rgb, (H, W), NET_HW), iters=5)
        frame_ms, frame_n = device_ms(
            torch, lambda: it.fe.collect(it.fe.submit(it.left, it.right), 0.0), iters=2,
            warmup=1)
        loop = it.out["loop"]
        share = fcn_ms / (1e3 / loop["fps"])
        print(f"introspection: FCN {fcn_ms:.3f} ms device, {fcn_n:.0f} kernel launches a "
              f"frame; a weighted frontend frame {frame_ms:.3f} ms device, {frame_n:.0f} "
              f"launches; the FCN's device time is {share:.2%} of the loop's "
              f"{1e3 / loop['fps']:.1f} ms frame")
        it.out.update(fcn_device_ms=fcn_ms, fcn_launches=fcn_n, frame_device_ms=frame_ms,
                      frame_launches=frame_n, fcn_share_of_loop_frame=share)

    # ---- phase 7: loop closing ----------------------------------------------
    def lc_setup(self):
        """bench.py's LC world (_lc_world(240)): DistinctTerrainWorld, seed 3,
        320x240, fx = fy = 400, baseline 0.5, 1.45 laps of a 6 m circle with
        the yaw following the path, its first N_LC_RUN + 1 frames; its
        configuration (bench.py:463-471); and the vocabulary of
        _lc_corpus_vocab (bench.py:416-445): the port's Vocabulary.train(k=10,
        L=6, seed=0) on the port's own descriptors of every third rendered
        frame's left image, extracted on the card."""
        torch, port = self.torch, self.port
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import synth_world

        t0 = time.perf_counter()
        world = synth_world.DistinctTerrainWorld(
            np.random.default_rng(3), tex_size=8192, res=60.0, fx=400.0, fy=400.0,
            cx=160.0, cy=120.0, w=LC_W, h=LC_H, baseline=0.5)
        pairs, gt = [], []
        for i in range(N_LC_RUN + 1):
            ang = 2.9 * np.pi * i / N_LC
            Twc = synth_world.camera_pose(
                np.array([6.0 * np.sin(ang), 6.0 * (1 - np.cos(ang)), 0.0], np.float32),
                height=10.0, yaw=ang)
            pairs.append(world.render_stereo(Twc))
            gt.append(Twc)
        render_s = time.perf_counter() - t0
        # the renderer's cv2 and numpy round differently between versions
        # (1 gray level on ~3% of pixels), and the LC world's ATE follows
        # the pixels: ATEs of two machines compare only on equal digests
        digest = hashlib.sha1()
        for left, right in pairs:
            digest.update(left.tobytes())
            digest.update(right.tobytes())
        C = port["config"]
        cfg = C.Config()
        cfg.camera = C.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                                    width=LC_W, height=LC_H, th_depth=35.0, fps=4.0)
        cfg.orb = C.ORBConfig(n_features=800, n_levels=8)
        cfg.system.fused_tracking = True
        t0 = time.perf_counter()
        ext = port["extractor"].OrbExtractor(cfg.orb, LC_H, LC_W)
        descs = []
        for left, _right in pairs[::3]:
            kp = ext(torch.as_tensor(left).cuda())
            descs.append(kp.desc[kp.valid].cpu().numpy())
        corpus = np.concatenate(descs)
        voc = port["vocabulary"].Vocabulary.train(corpus, k=10, L=6, seed=0)
        train_s = time.perf_counter() - t0
        self.lc = SimpleNamespace(pairs=pairs, gt=gt, cfg=cfg, voc=voc, out={})
        self.lc.out.update(world_render_s=render_s, world_sha1=digest.hexdigest()[:16],
                           vocabulary_train_s=train_s,
                           corpus_descriptors=len(corpus), lc_voc_words=voc.n_words,
                           lc_voc_nodes=len(voc.node_desc))
        print(f"loop closing: world {N_LC_RUN + 1} frames of {N_LC} rendered in {render_s:.1f} s "
              f"(images' sha1 "
              f"{digest.hexdigest()[:16]}); vocabulary "
              f"k=10 L=6 trained on {len(corpus)} descriptors of {len(descs)} frames in "
              f"{train_s:.1f} s: {voc.n_words} words, {len(voc.node_desc)} nodes")

    def lc_kernels(self):
        """K1-K3 bit-equal to their plain versions at the LC world's shapes,
        before its runs: the inputs that frames 0 and N_LC_RUN hand each
        wrapper through the LC configuration's frontend (320x240, 8 levels
        down to 89x67), and FAST on noise at (1, LC_H, LC_W)."""
        lc = self.lc
        fe = self.port["frame"].StereoFrontend(lc.cfg, LC_H, LC_W)
        errs = {"fast_score": 0.0, "orient_brief": 0.0, "sad_windows": 0.0}
        for i in (0, N_LC_RUN):
            rec = self.record_inputs(lambda: fe.process(*lc.pairs[i], 0.0))
            print(f"loop closing, K1-K3 on the inputs of LC-world frame {i}:")
            for name, check in (("fast_score", lambda r: self.check_fast(
                    r, noise_hw=(LC_H, LC_W), main=False)),
                                ("orient_brief", lambda r: self.check_orient_brief(r, main=False)),
                                ("sad_windows", lambda r: self.check_sad(r, main=False))):
                errs[name] = max(errs[name], check(rec))
        lc.out["kernels_at_lc_shapes"] = dict(frames=[0, N_LC_RUN], max_abs_err=errs,
                                              bit_equal=True)
        for name, e in errs.items():
            if name in self.kernels:
                self.kernels[name]["max_abs_err"] = max(self.kernels[name]["max_abs_err"], e)

    def _lc_drive(self, voc, device=None, n=None, snapshot_at=None):
        """One run of the LC world through System (fused tracking, unchained,
        single-threaded, synchronous local BA), with the vocabulary attached
        and use_bow and loop closing on when voc is given. Returns (System,
        frames/s over the run as bench.py counts it, the snapshot after
        frame snapshot_at, the stage timer)."""
        torch, port, lc = self.torch, self.port, self.lc
        cfg = copy.deepcopy(lc.cfg)
        cfg.system.use_bow = cfg.system.enable_loop_closing = voc is not None
        s = port["system"].System(cfg, LC_H, LC_W, device=device)
        timer = self.port["profiling"].StageTimer()
        s.tracking.stage_timer = s.tracking.local_mapping.stage_timer = timer
        if voc is not None:
            s.attach_vocabulary(voc)
            s.tracking.loop_closing.stage_timer = timer
        snap = None
        n = N_LC_RUN if n is None else n
        t0 = time.perf_counter()
        for i in range(n):
            s.track_stereo(*lc.pairs[i], timestamp=i * 0.1)
            if snapshot_at is not None and i == snapshot_at - 1:
                snap = self._lc_snapshot(s)
        if device is None:
            torch.cuda.synchronize()
        return s, n / (time.perf_counter() - t0), snap, timer

    def _lc_snapshot(self, s):
        """What the card and the CPU path must agree on: map sizes, the
        keyframe database, the loop-closing state, the poses."""
        tr = s.tracking
        m = tr.map
        lc = getattr(tr, "loop_closing", None)
        return dict(
            keyframes=int(m.n_keyframes), points=int(m.n_points),
            points_alive=int(m.pt_alive[:m.n_points].sum()),
            obs=sum(len(o) for o in m.pt_obs[:m.n_points]),
            lost=int(sum(tr.lost_flags)), kfdb=list(tr.kfdb.bow) if lc else [],
            loops=lc.n_loops_closed if lc else 0,
            groups=[(sorted(g), c) for g, c in lc.consistent_groups] if lc else [],
            twc=np.stack(tr.trajectory_poses()))

    def lc_loops(self):
        """(a) the control run, no vocabulary, over the first N_LC_CONTROL
        frames; (b) the vocabulary attached and loop closing on, N_LC_RUN
        frames, with its ATE over the control's frames beside. Each fails on
        a lost frame, an ATE above 0.5 m or a cap overflow; K1-K3 are
        counted over each run."""
        port, lc = self.port, self.lc
        ate_rmse = port["trajectory"].ate_rmse
        lc.runs = {}
        for name, voc, n in (("a_control", None, N_LC_CONTROL),
                             ("b_loop_closing", lc.voc, N_LC_RUN)):
            for m in self.counters().values():
                m.launches = 0
            s, fps, snap, timer = self._lc_drive(
                voc, n=n, snapshot_at=N_LC_CPU if voc is not None else None)
            launches = {k: m.launches for k, m in self.counters().items()}
            tr = s.tracking
            est = s.trajectory_twc()
            ate = ate_rmse(est, lc.gt[:n][-len(est):])
            lm, m = tr.local_mapping, tr.map
            loop_c = getattr(tr, "loop_closing", None)
            run = dict(frames=n, fps=fps, ate_m=ate, lost_frames=int(sum(tr.lost_flags)),
                       failures=int(s.failure_count), keyframes=int(m.n_keyframes),
                       map_points=int(m.n_points),
                       map_points_alive=int(m.pt_alive[:m.n_points].sum()),
                       lc_loops_closed=loop_c.n_loops_closed if loop_c else None,
                       kfdb_keyframes=len(tr.kfdb.bow) if loop_c else None,
                       frontend_launches=launches, cap_overflows=dict(lm.overflows),
                       host_ms_median=dict(
                           **{k: median_ms(timer, k) for k in (
                               "frontend", "track", "keyframe_event", "lc_bow", "lc_detect",
                               "lc_sim3", "lc_correct")}),
                       lc_stage_calls={k: len(stage_ms(timer, k)) for k in
                                       ("lc_bow", "lc_detect", "lc_sim3", "lc_correct")})
            lc.runs[name] = run
            if voc is not None:
                lc.snap_card = snap
                twc = list(snap["twc"])
                run["ate_m_control_frames"] = ate_rmse(twc, lc.gt[:N_LC_CONTROL][-len(twc):])
                for k, v in launches.items():
                    self.kernels[k]["launches_loop_closing"] = v
            print(f"loop closing ({name}): {n} frames, {run['fps']:.3f} frames/s, ATE "
                  f"{ate:.4f} m (over the first {N_LC_CONTROL} frames "
                  f"{run.get('ate_m_control_frames', ate):.4f} m), {run['lost_frames']} lost, "
                  f"{run['keyframes']} keyframes, "
                  f"{run['map_points']} map points, loops closed {run['lc_loops_closed']}, "
                  f"K1-K3 launches {launches}; host ms (median) "
                  f"{json.dumps(run['host_ms_median'])}; LC stage calls "
                  f"{run['lc_stage_calls']}; overflows {run['cap_overflows']}")
            want = {k: n for k in launches}
            require(launches == want, f"{name}: launch counts {launches} != {want}")
            require(run["lost_frames"] == 0 and s.failure_count == 0,
                    f"{name}: {run['lost_frames']} lost frames, {s.failure_count} failures")
            require(ate <= 0.5, f"{name}: ATE {ate} m")
            require(not any(lm.overflows.values()), f"{name}: cap overflow {lm.overflows}")
        lc.out.update(runs=lc.runs)

    def lc_cpu_vs_card(self):
        """The first N_LC_CPU frames of run (b) on the CPU path: the same
        keyframes, points, observations, keyframe database and loop-closing
        state as the card at that frame, poses within LC_POSE_ATOL."""
        lc = self.lc
        s, fps, snap, _ = self._lc_drive(lc.voc, device="cpu", n=N_LC_CPU,
                                         snapshot_at=N_LC_CPU)
        card = lc.snap_card
        same = {k: card[k] == snap[k] for k in card if k != "twc"}
        dT = float(np.abs(card["twc"] - snap["twc"]).max())
        lc.out["cpu_vs_card"] = dict(frames=N_LC_CPU, equal=same, max_abs_pose_diff=dT,
                                     cpu_fps=fps, keyframes=card["keyframes"],
                                     points=card["points"], kfdb=len(card["kfdb"]))
        print(f"loop closing, run (b) frames 0-{N_LC_CPU - 1} card vs CPU path: equal "
              f"{same}; max |pose diff| {dT:.3g} ({card['keyframes']} keyframes, "
              f"{card['points']} points, {len(card['kfdb'])} in the keyframe database); CPU "
              f"path {fps:.2f} frames/s")
        require(all(same.values()), f"card and CPU path differ: {same}")
        require(dT <= LC_POSE_ATOL, f"poses differ by {dT}")

    def lc_correction(self):
        """The correction path on the card (the LC world closes no loop, as
        bench.py's TPU record shows for the reference): a revisit of 120
        landmarks seen by two keyframes as disjoint point sets
        (tests/test_loop_closing.py's scenario) through _compute_sim3 (BoW
        matching, Sim3 RANSAC, Sim3 window search, Sim3 LM) and
        _correct_loop (propagation, loop fuse, essential graph, the deferred
        global BA merged by collect_gba), twice on the card (the first call
        pays the solver libraries' start-up) and on the CPU path: the two
        card runs bit-equal; the same loop keyframe, verified matches, live
        points and observations as the CPU path, poses within 1e-4, points
        within 1e-3."""
        port = self.port
        out = []
        for dev in ("cuda", "cuda", "cpu"):   # the card cold, then warm
            m, voc, cfg = self._revisit_map(dev)
            lc = port["loop_closing"].LoopClosing(
                cfg, m, voc, port["keyframe_db"].KeyFrameDatabase(voc), dev)
            lc.stage_timer = timer = self.port["profiling"].StageTimer()
            for k in (0, 1):
                lc.bow.ensure(k)
            with timer.time("lc_sim3"):
                match = lc._compute_sim3(1, [0], True)
            require(match is not None, f"{dev}: no Sim3 accepted")
            with timer.time("lc_correct"):
                lc._correct_loop(1, match[0], match[1], match[2], fix_scale=True)
                merged = lc.collect_gba()
            out.append((m, match, merged, timer))
        (m0, _, _, t0), (mc, gc, merged_c, tc), (mp, gp, merged_p, tp) = out
        n = mc.n_points
        repeat = bool(np.array_equal(m0.kf_pose[:2], mc.kf_pose[:2])
                      and np.array_equal(m0.pt_pos[:n], mc.pt_pos[:n]))
        same = dict(loop_kf=gc[0] == gp[0], matched=gc[2] == gp[2], merged=merged_c == merged_p,
                    alive=bool(np.array_equal(mc.pt_alive[:n], mp.pt_alive[:n])),
                    obs=mc.pt_obs[:n] == mp.pt_obs[:n])
        dT = float(np.abs(mc.kf_pose[:2] - mp.kf_pose[:2]).max())
        alive = mc.pt_alive[:n]
        dX = float(np.abs(mc.pt_pos[:n][alive] - mp.pt_pos[:n][alive]).max())
        self.lc.out["correction_card_vs_cpu"] = dict(
            equal=same, max_abs_pose_diff=dT, max_abs_point_diff=dX,
            matched=len(gc[2]), points_alive=int(alive.sum()),
            card_repeatable=repeat,
            card_first_ms=dict(sim3=median_ms(t0, "lc_sim3"),
                               correct=median_ms(t0, "lc_correct")),
            card_ms=dict(sim3=median_ms(tc, "lc_sim3"), correct=median_ms(tc, "lc_correct")),
            cpu_ms=dict(sim3=median_ms(tp, "lc_sim3"), correct=median_ms(tp, "lc_correct")))
        print(f"loop closing, correction on a revisit, card vs CPU path: equal {same}; max "
              f"|pose diff| {dT:.3g}, max |point diff| {dX:.3g}; {len(gc[2])} verified "
              f"matches, {int(alive.sum())} points alive after the fuse; two card runs "
              f"bit-equal {repeat}; card ms sim3 {median_ms(t0, 'lc_sim3'):.1f} (first "
              f"call), {median_ms(tc, 'lc_sim3'):.1f} (second), correct "
              f"{median_ms(t0, 'lc_correct'):.1f} / {median_ms(tc, 'lc_correct'):.1f}; CPU "
              f"path sim3 {median_ms(tp, 'lc_sim3'):.1f}, correct "
              f"{median_ms(tp, 'lc_correct'):.1f}")
        require(all(same.values()), f"correction differs: {same}")
        require(repeat, "two card runs of the correction differ")
        require(dT <= 1e-4 and dX <= 1e-3, f"correction poses {dT}, points {dX}")

    def _revisit_map(self, dev):
        """Keyframe 0 at the origin and keyframe 1 offset by (0.1, 0.02,
        0.05) m over the same 120 landmarks, registered as two disjoint
        point sets (an unrecognized revisit), keypoint tensors on dev."""
        torch, port = self.torch, self.port
        rng = np.random.default_rng(17)
        C = port["config"]
        cfg = C.Config()
        cfg.camera = C.CameraConfig(fx=400, fy=400, cx=160, cy=120, bf=200, width=320,
                                    height=240)
        m = port["map_store"].MapStore(n_levels=8, scale_factor=1.2)
        n, cap = 120, 256
        Xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                       rng.uniform(6, 14, n)], 1).astype(np.float32)
        descs = rng.integers(0, 256, (n, 32)).astype(np.uint8)
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, 3] = [0.1, 0.02, 0.05]
        for k, T in enumerate((np.eye(4, dtype=np.float32), T1)):
            pc = Xw @ T[:3, :3].T + T[:3, 3]
            uv = np.stack([400 * pc[:, 0] / pc[:, 2] + 160, 400 * pc[:, 1] / pc[:, 2] + 120], 1)
            valid = np.arange(cap) < n
            pad = lambda a: np.concatenate([a, np.zeros((cap - n,) + a.shape[1:], a.dtype)])  # noqa: E731
            kp = port["extractor"].Keypoints(
                xy=torch.as_tensor(pad(uv.astype(np.float32))).to(dev),
                response=torch.zeros(cap, device=dev),
                octave=torch.zeros(cap, dtype=torch.int32, device=dev),
                angle=torch.zeros(cap, device=dev),
                desc=torch.as_tensor(pad(descs)).to(dev),
                valid=torch.as_tensor(valid).to(dev),
                yx_level=torch.zeros((cap, 2), dtype=torch.int32, device=dev))
            f = port["frame"].Frame(frame_id=k, timestamp=float(k), kp=kp,
                                    u_right=np.full(cap, -1.0, np.float32),
                                    depth=np.full(cap, -1.0, np.float32),
                                    qual_score=np.ones(cap, np.float32), pose=T)
            kf = m.add_keyframe(f)
            for i in range(n):
                pos = Xw[i] if k == 0 else Xw[i] + rng.normal(0, 0.01, 3).astype(np.float32)
                pid = m.add_point(pos, kf)
                m.add_observation(pid, kf, i)
                f.map_pt[i] = pid
                m.pt_desc[pid] = descs[i]
                m.update_normal_and_depth(pid)
        voc = port["vocabulary"].Vocabulary.train(descs, k=6, L=3, seed=3)
        return m, voc, cfg

    def lc_1m(self):
        """bench.py's lc1m vocabulary, Vocabulary.synthesize(k=10, L=6,
        seed=0) (~1.1M nodes): the device descent on the card equals the
        host descent on the 800 descriptors of one LC-world frame; both
        timed."""
        torch, port, lc = self.torch, self.port, self.lc
        t0 = time.perf_counter()
        voc = port["vocabulary"].Vocabulary.synthesize(k=10, L=6, seed=0)
        synth_s = time.perf_counter() - t0
        fe = port["frame"].StereoFrontend(lc.cfg, LC_H, LC_W)
        fr = fe.process(*lc.pairs[0], 0.0)
        desc = fr.kp.desc
        t0 = time.perf_counter()
        host = voc.transform_words(desc.cpu().numpy())
        host_ms = (time.perf_counter() - t0) * 1e3
        dev = voc.transform_words_device(desc)
        children, node_desc = port["bow"]._dev_tree(voc, desc.device)
        dev_ms = event_ms(torch, lambda: port["bow"].transform_words(
            children, node_desc, desc, voc.L), iters=20)
        equal = bool(np.array_equal(dev, host))
        lc.out["lc1m"] = dict(nodes=len(voc.node_desc), words=voc.n_words,
                              descriptors=int(desc.shape[0]), device_equals_host=equal,
                              device_descent_ms=dev_ms, host_descent_ms=host_ms,
                              synthesize_s=synth_s)
        print(f"loop closing, 1M-leaf vocabulary ({len(voc.node_desc)} nodes, synthesized "
              f"in {synth_s:.1f} s): device descent of {desc.shape[0]} descriptors "
              f"{dev_ms:.3f} ms (CUDA events), host descent {host_ms:.1f} ms; equal {equal}")
        require(equal, "device descent differs from the host descent")

    # ---- phase 8: mono and RGB-D -------------------------------------------
    def mr_setup(self):
        """The sensors' published settings through config.load_reference_yaml
        (settings/EuRoC_mono.yaml: 752x480, fx 458.654, 1000 features;
        settings/TUM1.yaml: 640x480, fx 517.306, bf 40, ThDepth 40,
        DepthMapFactor 5000, 1000 features), fused tracking, the distortion
        coefficients set to zero (the renderer is an ideal pinhole camera),
        and their worlds: the mono one tests/test_mono_rgbd.py's TwoPlaneWorld
        and path at those intrinsics, the RGB-D one a TwoPlaneWorld seen from
        2.5 m with a 1 m platform in view, 2 cm a frame, its depth handed over
        as TUM stores it (uint16, 5000 a metre)."""
        port = self.port
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import synth_world

        C = port["config"]
        t0 = time.perf_counter()
        mr = SimpleNamespace(out={})
        for sensor, yaml_name in (("mono", "EuRoC_mono.yaml"), ("rgbd", "TUM1.yaml")):
            cfg = C.load_reference_yaml(os.path.join(HERE, "settings", yaml_name))
            cam = cfg.camera
            dist = dict(k1=cam.k1, k2=cam.k2, p1=cam.p1, p2=cam.p2, k3=cam.k3)
            cam.k1 = cam.k2 = cam.p1 = cam.p2 = cam.k3 = 0.0
            cfg.system.sensor = sensor
            cfg.system.fused_tracking = True
            setattr(mr, sensor + "_cfg", cfg)
            print(f"{sensor}: settings/{yaml_name}: {cam.width}x{cam.height}, fx {cam.fx}, "
                  f"bf {cam.bf}, ThDepth {cam.th_depth}, DepthMapFactor "
                  f"{cam.depth_map_factor}, {cfg.orb.n_features} features, "
                  f"{cfg.orb.n_levels} levels, FAST {cfg.orb.ini_th_fast}/"
                  f"{cfg.orb.min_th_fast}; distortion {dist} set to 0 (the synthetic "
                  f"renderer is an ideal pinhole camera, and neither package undistorts "
                  f"keypoints while tracking)")
        cm, cr = mr.mono_cfg.camera, mr.rgbd_cfg.camera
        world = synth_world.TwoPlaneWorld(np.random.default_rng(MONO_SEED), fx=cm.fx, fy=cm.fy,
                                          cx=cm.cx, cy=cm.cy, w=cm.width, h=cm.height)
        mr.mono_gt = [synth_world.camera_pose(
            np.array([0.25 * i, 0.03 * np.sin(i * 0.5), 0.0], np.float32), height=10.0,
            yaw=0.01 * i) for i in range(N_MONO)]
        mr.mono_imgs = [world.render(T) for T in mr.mono_gt]
        world = synth_world.TwoPlaneWorld(
            np.random.default_rng(RGBD_SEED), height2=1.0, region=RGBD_PLATFORM,
            res=RGBD_TEX_PX_PER_M, fx=cr.fx, fy=cr.fy, cx=cr.cx, cy=cr.cy, w=cr.width,
            h=cr.height)
        mr.rgbd_gt = [synth_world.camera_pose(
            np.array([0.02 * i, 0.01 * np.sin(i * 0.2), 0.0], np.float32), height=2.5,
            yaw=0.002 * i) for i in range(N_RGBD)]
        mr.rgbd_imgs = [world.render(T) for T in mr.rgbd_gt]
        mr.rgbd_depth = [np.round(world.render_depth(T) * cr.depth_map_factor).astype(np.uint16)
                         for T in mr.rgbd_gt]
        z = world.render_depth(mr.rgbd_gt[0])
        tex_px = max(cr.fx / (2.5 * RGBD_TEX_PX_PER_M),
                     cr.fx / ((2.5 - 1.0) * 1000.0 / (RGBD_PLATFORM[1] - RGBD_PLATFORM[0])))
        mr.out.update(render_s=time.perf_counter() - t0, rgbd_texture_px_per_m=RGBD_TEX_PX_PER_M,
                      rgbd_image_px_per_texture_px=tex_px)
        print(f"mono world: TwoPlaneWorld seed {MONO_SEED}, {N_MONO} frames, 0.25 m a frame "
              f"at 10 m; RGB-D world: TwoPlaneWorld seed {RGBD_SEED} from 2.5 m, platform "
              f"1 m high over {RGBD_PLATFORM}, ground texture {RGBD_TEX_PX_PER_M} px/m "
              f"(at most {tex_px:.2f} image px a texture px), depth {z.min():.2f}-"
              f"{z.max():.2f} m, {N_RGBD} frames, 2 cm a frame; rendered in "
              f"{mr.out['render_s']:.1f} s")
        self.mr = mr

    def mr_kernels(self):
        """(a) K1 and K2 bit-equal to their plain versions on the inputs
        frame 0 of each world hands them through the sensor's frontend (one
        image: no K3), and FAST on noise at each size."""
        port, mr = self.port, self.mr
        F = port["frame"]
        errs = {"fast_score": 0.0, "orient_brief": 0.0}
        cm, cr = mr.mono_cfg.camera, mr.rgbd_cfg.camera
        mono = F.MonoFrontend(mr.mono_cfg, cm.height, cm.width)
        rgbd = F.RGBDFrontend(mr.rgbd_cfg, cr.height, cr.width)
        runs = (("mono", (cm.height, cm.width), lambda: mono.process(mr.mono_imgs[0], 0.0)),
                ("RGB-D", (cr.height, cr.width), lambda: rgbd.process(
                    mr.rgbd_imgs[0], mr.rgbd_depth[0], 0.0, 1.0 / cr.depth_map_factor)))
        for what, hw, run in runs:
            rec = self.record_inputs(run, n_sad=0)
            print(f"{what}, K1-K2 on the inputs of frame 0 ({(1,) + hw}):")
            errs["fast_score"] = max(errs["fast_score"],
                                     self.check_fast(rec, noise_hw=hw, main=False))
            errs["orient_brief"] = max(errs["orient_brief"],
                                       self.check_orient_brief(rec, main=False))
        mr.out["kernels_at_mono_rgbd_shapes"] = dict(max_abs_err=errs, bit_equal=True)
        for name, e in errs.items():
            if name in self.kernels:
                self.kernels[name]["max_abs_err"] = max(self.kernels[name]["max_abs_err"], e)

    def _mr_run(self, sensor):
        """One sensor's run through System on the card, K1-K3 counted.
        Returns (System, frames/s, states, launches, stage timer)."""
        torch, port, mr = self.torch, self.port, self.mr
        cfg = getattr(mr, sensor + "_cfg")
        cam = cfg.camera
        s = port["system"].System(cfg, cam.height, cam.width)
        timer = self.port["profiling"].StageTimer()
        s.tracking.stage_timer = s.tracking.local_mapping.stage_timer = timer
        for m in self.counters().values():
            m.launches = 0
        states = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sensor == "mono":
            for i, img in enumerate(mr.mono_imgs):
                s.track_mono(img, i / cam.fps)
                states.append(s.state.name)
        else:
            for i, img in enumerate(mr.rgbd_imgs):
                s.track_rgbd(img, mr.rgbd_depth[i], i / cam.fps,
                             depth_scale=1.0 / cam.depth_map_factor)
                states.append(s.state.name)
        torch.cuda.synchronize()
        fps = len(states) / (time.perf_counter() - t0)
        return s, fps, states, {k: m.launches for k, m in self.counters().items()}, timer

    def mr_mono(self):
        """(b) mono: it initialises, stays OK once OK, and moves along the
        ground truth's direction (cosine > 0.95, tests/test_mono_rgbd.py's
        gate); every call of search_for_initialization and initialize_mono
        is recorded and run again on the CPU path with the card's draws."""
        port, mr = self.port, self.mr
        match, init = port["match"], port["initializer"]
        origs = (match.search_for_initialization, init.initialize_mono)
        calls = []

        def search(*a, **kw):
            out = origs[0](*a, **kw)
            calls.append(("search", clone(a), kw, clone(out)))
            return out

        def initialize(*a, **kw):
            out = origs[1](*a, **kw)
            calls.append(("init", clone(a), kw, clone(out)))
            return out

        match.search_for_initialization, init.initialize_mono = search, initialize
        try:
            s, fps, states, launches, timer = self._mr_run("mono")
        finally:
            match.search_for_initialization, init.initialize_mono = origs
        require("OK" in states, f"never initialised: {states}")
        first_ok = states.index("OK")
        gt = mr.mono_gt
        est = s.trajectory_twc()
        d_est = est[-1][:3, 3] - est[first_ok - 1][:3, 3]
        d_gt = gt[-1][:3, 3] - gt[first_ok - 1][:3, 3]
        cos = float(d_est @ d_gt / max(np.linalg.norm(d_est) * np.linalg.norm(d_gt), 1e-9))
        ate = port["trajectory"].ate_rmse(est[first_ok - 1:], gt[first_ok - 1:],
                                          align_scale=True)
        m = s.tracking.map
        # the card's initializer calls again on the CPU path
        diffs, n_init_ok = [], 0
        for kind, args, kw, out in calls:
            if kind == "search":
                cpu = match.search_for_initialization(*to_cpu(args), **kw)
                diffs.append(dict(kind=kind, equal=bool(
                    torch_equal(out[0], cpu[0]) and int(out[1]) == int(cpu[1]))))
                continue
            cpu = init.initialize_mono(*to_cpu(args), **kw)
            same = {f: torch_equal(getattr(out, f), getattr(cpu, f)) for f in
                    ("ok", "used_homography", "best_h", "best_f", "inliers", "is_good")}
            # the points that triangulated (is_good): the other rows solve
            # degenerate systems (unmatched zero rows, no parallax) whose
            # null vector each library picks freely, and are never used
            good = cpu.is_good
            errs = dict(R=float((out.R.cpu() - cpu.R).abs().max()),
                        t=float((out.t.cpu() - cpu.t).abs().max()),
                        good_points=float((out.points.cpu()[good] - cpu.points[good])
                                          .abs().max()) if bool(good.any()) else 0.0,
                        all_points=float((out.points.cpu() - cpu.points).abs().max()))
            err = max(errs["R"], errs["t"], errs["good_points"])
            n_init_ok += int(bool(out.ok))
            diffs.append(dict(kind=kind, equal=all(same.values()), fields=same, max_abs_err=err,
                              errs=errs, ok=bool(out.ok), homography=bool(out.used_homography)))
        out = dict(frames=N_MONO, fps=fps, first_ok_frame=first_ok,
                   lost_after_init=int(sum(st != "OK" for st in states[first_ok:])),
                   direction_cosine=cos, ate_sim3_m=ate, keyframes=int(m.n_keyframes),
                   map_points=int(m.n_points), failures=int(s.failure_count),
                   frontend_launches=launches, init_calls_card_vs_cpu=diffs,
                   host_ms_median=dict(frontend=median_ms(timer, "frontend"),
                                       track=median_ms(timer, "track"),
                                       keyframe_event=median_ms(timer, "keyframe_event")))
        mr.out["mono"] = out
        for k, v in launches.items():
            self.kernels[k]["launches_mono"] = v
        print(f"mono: {N_MONO} frames, {fps:.3f} frames/s, initialised at frame {first_ok}, "
              f"{out['lost_after_init']} frames not OK after, direction cosine {cos:.5f}, "
              f"Sim3-aligned ATE {ate:.4f} m, {out['keyframes']} keyframes, "
              f"{out['map_points']} map points, K1-K3 launches {launches}; card vs CPU path: "
              f"{sum(d['kind'] == 'search' for d in diffs)} search_for_initialization calls, "
              f"equal {all(d['equal'] for d in diffs if d['kind'] == 'search')}; "
              f"initialize_mono calls {[(d['ok'], d['homography']) for d in diffs if d['kind'] == 'init']} "
              f"(ok, H), discrete outcomes equal "
              f"{all(d['equal'] for d in diffs if d['kind'] == 'init')}, max |d| of "
              f"R/t/good points {[d['errs'] for d in diffs if d['kind'] == 'init']}; "
              f"host ms (median) {json.dumps(out['host_ms_median'])}")
        want = {"fast_score": N_MONO, "orient_brief": N_MONO, "sad_windows": 0}
        require(launches == want, f"launch counts {launches} != {want}")
        require(out["lost_after_init"] == 0 and s.failure_count == 0,
                f"{out['lost_after_init']} frames not OK after initialisation")
        require(cos > 0.95, f"direction cosine {cos}")
        require(n_init_ok == 1, f"{n_init_ok} accepted initializations")
        require(all(d["equal"] for d in diffs), "an initializer call differs card vs CPU")
        require(all(d.get("max_abs_err", 0.0) <= INIT_ATOL for d in diffs),
                f"initializer R, t or points differ by more than {INIT_ATOL}")

    def mr_rgbd(self):
        """(c) RGB-D: no frame lost, ATE below 0.5 m."""
        port, mr = self.port, self.mr
        s, fps, states, launches, timer = self._mr_run("rgbd")
        est = s.trajectory_twc()
        ate = port["trajectory"].ate_rmse(est, mr.rgbd_gt)
        m = s.tracking.map
        lost = int(sum(st != "OK" for st in states))
        out = dict(frames=N_RGBD, fps=fps, ate_m=ate, lost_frames=lost,
                   failures=int(s.failure_count), keyframes=int(m.n_keyframes),
                   map_points=int(m.n_points), frontend_launches=launches,
                   cap_overflows=dict(s.tracking.local_mapping.overflows),
                   host_ms_median=dict(frontend=median_ms(timer, "frontend"),
                                       track=median_ms(timer, "track"),
                                       keyframe_event=median_ms(timer, "keyframe_event")))
        mr.out["rgbd"] = out
        for k, v in launches.items():
            self.kernels[k]["launches_rgbd"] = v
        print(f"RGB-D: {N_RGBD} frames, {fps:.3f} frames/s, ATE {ate:.4f} m, {lost} lost, "
              f"{out['keyframes']} keyframes, {out['map_points']} map points, K1-K3 launches "
              f"{launches}; host ms (median) {json.dumps(out['host_ms_median'])}")
        want = {"fast_score": N_RGBD, "orient_brief": N_RGBD, "sad_windows": 0}
        require(launches == want, f"launch counts {launches} != {want}")
        require(lost == 0 and s.failure_count == 0, f"{lost} lost frames")
        require(ate < 0.5, f"ATE {ate} m")

    # ---- phase 9: training-data generation ----------------------------------
    def dg_setup(self):
        """KITTI geometry (settings/KITTI00-02.yaml: 376x1241, fx 718.856,
        baseline 0.54, 2000 features, 8 levels, FAST 20/7), fused tracking,
        introspection training on (cfg.iv.enabled; gp.max_train_points at
        its default, 512), and tests/test_introspection_helps.py's world at
        that geometry: ReflectionWorld seed 5 (a static image-space band,
        blended at DG_BAND_ALPHA) on its serpentine path (0.1 m a frame, yaw
        amplitude 0.3), GT poses relative to the first camera, as KITTI's
        are."""
        port = self.port
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import synth_world

        cfg = port["config"].load_reference_yaml(os.path.join(HERE, "settings",
                                                              "KITTI00-02.yaml"))
        cfg.system.fused_tracking = True
        cfg.iv.enabled = True
        cam = cfg.camera
        t0 = time.perf_counter()
        world = synth_world.ReflectionWorld(np.random.default_rng(5), alpha=DG_BAND_ALPHA,
                                            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                                            w=cam.width, h=cam.height, baseline=cam.baseline)
        n = max(N_DG_SUP, N_DG_UNSUP)
        gt = [synth_world.camera_pose(
            np.array([0.1 * i, 0.03 * np.sin(i * 0.4), 0.0], np.float32), height=10.0,
            yaw=0.3 * np.sin(i * 0.3)) for i in range(n)]
        pairs = [world.render_stereo(T) for T in gt]
        gt_rel = [(np.linalg.inv(gt[0]) @ T).astype(np.float32) for T in gt]
        self.dg = SimpleNamespace(cfg=cfg, pairs=pairs, gt=gt_rel, band=world.bad_region_mask(),
                                  dirs={},
                                  out=dict(render_s=time.perf_counter() - t0,
                                           max_train_points=cfg.gp.max_train_points))
        self.dg.out["band_alpha"] = DG_BAND_ALPHA
        print(f"datagen: settings/KITTI00-02.yaml {cam.width}x{cam.height}, fx {cam.fx}, "
              f"baseline {cam.baseline:.4f}, {cfg.orb.n_features} features; ReflectionWorld "
              f"seed 5, band alpha {DG_BAND_ALPHA}, {n} frames rendered in "
              f"{self.dg.out['render_s']:.1f} s; GP max_train_points {cfg.gp.max_train_points}")

    def _dg_run(self, n, unsupervised):
        """One datagen run through System on the card into a temporary
        directory. Returns (System, frames/s, launches, timer, directory)."""
        import tempfile

        torch, port, dg = self.torch, self.port, self.dg
        cfg = copy.deepcopy(dg.cfg)
        cfg.iv.unsupervised_learning = unsupervised
        if unsupervised:
            cfg.iv.ba_mode = "constrained"
        cam = cfg.camera
        out = tempfile.mkdtemp(prefix="chip_smoke_datagen_")
        s = port["system"].System(cfg, cam.height, cam.width)
        s.enable_datagen(out)
        timer = self.port["profiling"].StageTimer()
        s.tracking.stage_timer = s.tracking.local_mapping.stage_timer = timer
        for m in self.counters().values():
            m.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            s.track_stereo(*dg.pairs[i], timestamp=i / cam.fps, gt_pose=dg.gt[i],
                           img_name=f"{i:06d}.png")
        torch.cuda.synchronize()
        fps = n / (time.perf_counter() - t0)
        s.tracking.datagen.finalize()
        return s, fps, {k: m.launches for k, m in self.counters().items()}, timer, out

    def dg_supervised(self):
        """(a) supervised, ref_kf_epipolar_normalized: no frame lost, at
        least one heatmap written with the JSON files, heatmaps uint8 at the
        GP grid's size; one process_frame_supervised call (frame
        DG_RECORD) made again on the CPU path on the same frame and map:
        the same scored keypoints, count and verdict, errors within
        DG_ERR_TOL, the uint8 heatmap within 1; the GP's device time on that
        call's inputs by CUDA events; the heatmaps' mean inside the band
        and outside it (printed, not gated)."""
        torch, port, dg = self.torch, self.port, self.dg
        DG = port["datagen"].DataGenerator
        gp = port["gp"]
        orig, orig_gp = DG.process_frame_supervised, gp.gp_grid_predict
        rec = {}

        def gp_rec(*a, **kw):
            out = orig_gp(*a, **kw)
            if rec.get("armed"):
                rec["gp"] = (clone(a), kw)
            return out

        def record(self_, frame, img_hw, prev_frame=None):
            rec["armed"] = frame.frame_id == DG_RECORD
            out = orig(self_, frame, img_hw, prev_frame)
            if rec.pop("armed"):
                cpu = DG(self_.cfg, self_.map, None, device="cpu")
                rec["card"], rec["cpu"] = out, orig(cpu, frame, img_hw, prev_frame)
            return out

        DG.process_frame_supervised, gp.gp_grid_predict = record, gp_rec
        try:
            s, fps, launches, timer, out_dir = self._dg_run(N_DG_SUP, False)
        finally:
            DG.process_frame_supervised, gp.gp_grid_predict = orig, orig_gp
        dg.dirs["supervised"] = out_dir
        tr = s.tracking
        gen = tr.datagen
        hm_dir = os.path.join(out_dir, "bad_region_heatmap")
        names = sorted(os.listdir(hm_dir)) if os.path.isdir(hm_dir) else []
        bny, bnx, out_h, out_w = gp.grid_shape(H, W)
        import cv2

        maps = [cv2.imread(os.path.join(hm_dir, nm), cv2.IMREAD_UNCHANGED) for nm in names]
        band = dg.band[:out_h, :out_w]
        inside = float(np.mean([m[band].mean() for m in maps])) if maps else None
        outside = float(np.mean([m[~band].mean() for m in maps])) if maps else None
        files = {f: os.path.exists(os.path.join(out_dir, f))
                 for f in ("keypoints.json", "img_names.json")}
        card, cpu = rec.get("card"), rec.get("cpu")
        require(card is not None and cpu is not None,
                f"frame {DG_RECORD} gave no supervised result to compare")
        same = dict(keep=bool(np.array_equal(card["keep"], cpu["keep"])),
                    n_scored=card["n_scored"] == cpu["n_scored"], good=card["good"] == cpu["good"])
        d_err = float(np.abs(card["norm_err"] - cpu["norm_err"]).max())
        scale = float(np.abs(cpu["norm_err"]).max())
        d_hm = int(np.abs(card["heatmap"].astype(int) - cpu["heatmap"].astype(int)).max())
        args, kw = rec["gp"]
        gp_ms = event_ms(torch, lambda: orig_gp(*args, **kw), iters=20)
        lost = int(sum(tr.lost_flags))
        out = dict(frames=N_DG_SUP, fps=fps, lost_frames=lost, heatmaps_written=len(names),
                   frames_scored=None, json_written=files, heatmap_shape=list(
                       maps[0].shape) if maps else None,
                   heatmap_dtype=str(maps[0].dtype) if maps else None,
                   heatmap_mean_in_band=inside, heatmap_mean_outside_band=outside,
                   card_vs_cpu=dict(frame=DG_RECORD, equal=same, max_abs_err_norm_err=d_err,
                                    norm_err_max=scale, heatmap_max_abs_diff=d_hm),
                   gp_device_ms=gp_ms, gp_points=int(args[0].shape[0]),
                   frontend_launches=launches,
                   host_ms_median=dict(datagen=median_ms(timer, "datagen"),
                                       frontend=median_ms(timer, "frontend"),
                                       track=median_ms(timer, "track"),
                                       keyframe_event=median_ms(timer, "keyframe_event")))
        out["frames_scored"] = len(stage_ms(timer, "datagen"))
        dg.out["supervised"] = out
        print(f"datagen (a) supervised: {N_DG_SUP} frames, {fps:.3f} frames/s, {lost} lost, "
              f"{len(names)} heatmaps written ({gen.n_saved} saved), files {files}, heatmaps "
              f"{out['heatmap_shape']} {out['heatmap_dtype']}; mean inside the band "
              f"{inside}, outside {outside}; frame {DG_RECORD} card vs CPU path: equal {same}, "
              f"max |d norm_err| {d_err:.3g} (values up to {scale:.3g}), heatmap max |d| "
              f"{d_hm}; GP ({out['gp_points']} points) {gp_ms:.3f} ms device (CUDA events); "
              f"K1-K3 launches {launches}; host ms (median) {json.dumps(out['host_ms_median'])}")
        want = {k: N_DG_SUP for k in launches}
        require(launches == want, f"launch counts {launches} != {want}")
        require(lost == 0 and s.failure_count == 0, f"{lost} lost frames")
        require(len(names) >= 1 and gen.n_saved == len(names), f"{len(names)} heatmaps written")
        require(all(files.values()), f"dataset files missing: {files}")
        require(all(m.dtype == np.uint8 and m.shape == (out_h, out_w) for m in maps),
                "a heatmap is not uint8 at the GP grid's size")
        require(all(same.values()), f"card and CPU path differ: {same}")
        require(d_err <= DG_ERR_TOL * (1.0 + scale), f"norm_err differs by {d_err}")
        require(d_hm <= 1, f"heatmaps differ by {d_hm}")
        for k, v in launches.items():
            self.kernels[k]["launches_datagen"] = v

    def dg_unsupervised(self):
        """(b) unsupervised with ba_mode="constrained": no frame lost, masks
        written, keypoint quality labels written by the constrained BA, and
        one of its solves (the DG_BA_RECORD-th) again on the CPU path on the
        same problem: points within 1e-4 m, labels within 1e-3."""
        port, dg = self.port, self.dg
        lba = port["local_ba"]
        orig_c, orig_solve = lba.constrained_local_bundle_adjustment, lba._solve
        rec = {"calls": 0}

        def solve(cfg, prob_np, device, **opts):
            res = orig_solve(cfg, prob_np, device, **opts)
            if rec.get("armed"):
                rec["solve"] = (cfg, prob_np, opts, to_cpu(res))
            return res

        def constrained(cfg, m, kf_id, device):
            rec["calls"] += 1
            rec["armed"] = rec["calls"] == DG_BA_RECORD
            try:
                return orig_c(cfg, m, kf_id, device)
            finally:
                rec["armed"] = False

        lba.constrained_local_bundle_adjustment, lba._solve = constrained, solve
        try:
            s, fps, launches, timer, out_dir = self._dg_run(N_DG_UNSUP, True)
        finally:
            lba.constrained_local_bundle_adjustment, lba._solve = orig_c, orig_solve
        dg.dirs["unsupervised"] = out_dir
        tr = s.tracking
        m = tr.map
        gen = tr.datagen
        n_masks = len(os.listdir(os.path.join(out_dir, "bad_region_heatmap_mask"))) \
            if os.path.isdir(os.path.join(out_dir, "bad_region_heatmap_mask")) else 0
        labelled = int(sum((m.kf_frames[k].qual_score != 1.0).sum()
                           for k in range(m.n_keyframes) if m.kf_frames[k] is not None))
        require("solve" in rec, f"only {rec['calls']} constrained BA calls")
        cfg, prob_np, opts, card = rec["solve"]
        cpu = orig_solve(cfg, prob_np, "cpu", **opts)
        n_pt = int(prob_np.pt_valid.sum())
        dX = float((card.pt_pos[:n_pt] - cpu.pt_pos[:n_pt]).abs().max())
        valid = prob_np.e_valid

        def labels(c2):
            scaled = np.clip((c2.numpy()[valid] - 1.0) / (7.815 - 1.0), 0.0, 1.0)
            return 2.0 * (1.0 / (1.0 + scaled)) - 1.0

        d_lab = float(np.abs(labels(card.e_chi2) - labels(cpu.e_chi2)).max())
        poses_fixed = bool(torch_equal(card.kf_pose, cpu.kf_pose))
        lost = int(sum(tr.lost_flags))
        out = dict(frames=N_DG_UNSUP, fps=fps, lost_frames=lost, saved=gen.n_saved,
                   masks_written=n_masks, keypoint_labels_written=labelled,
                   constrained_ba_calls=rec["calls"],
                   constrained_ba_card_vs_cpu=dict(call=DG_BA_RECORD, points=n_pt,
                                                   edges=int(valid.sum()),
                                                   max_abs_point_diff=dX,
                                                   max_abs_label_diff=d_lab,
                                                   poses_equal=poses_fixed),
                   frontend_launches=launches,
                   host_ms_median=dict(datagen=median_ms(timer, "datagen"),
                                       local_ba=median_ms(timer, "lm_local_ba"),
                                       track=median_ms(timer, "track"),
                                       keyframe_event=median_ms(timer, "keyframe_event")))
        dg.out["unsupervised_constrained"] = out
        print(f"datagen (b) unsupervised, constrained BA: {N_DG_UNSUP} frames, {fps:.3f} "
              f"frames/s, {lost} lost, {gen.n_saved} heatmaps and {n_masks} masks written, "
              f"{labelled} keypoint quality labels on {m.n_keyframes} keyframes, "
              f"{rec['calls']} constrained BA calls; call {DG_BA_RECORD} card vs CPU path "
              f"({n_pt} points, {int(valid.sum())} edges): max |d point| {dX:.3g} m, max "
              f"|d label| {d_lab:.3g}, poses equal {poses_fixed}; K1-K3 launches {launches}; "
              f"host ms (median) {json.dumps(out['host_ms_median'])}")
        want = {k: N_DG_UNSUP for k in launches}
        require(launches == want, f"launch counts {launches} != {want}")
        require(lost == 0 and s.failure_count == 0, f"{lost} lost frames")
        require(n_masks >= 1 and n_masks == gen.n_saved, f"{n_masks} masks written")
        require(labelled > 0, "no keypoint quality label written")
        require(dX <= 1e-4 and d_lab <= 1e-3 and poses_fixed,
                f"constrained BA differs card vs CPU: points {dX}, labels {d_lab}")
        for k, v in launches.items():
            self.kernels[k]["launches_datagen"] = self.kernels[k].get("launches_datagen", 0) + v


    # ---- phase 10: FCN training, zoo, export, multi-process paths -----------
    def tr_setup(self):
        """(a) A dataset from phase 9: run (b)'s heatmaps and masks, the last
        TR_VAL of them as the validation session (one whole batch, since a
        partial batch is dropped) and the rest as the training session,
        beside the left images phase 9 rendered, written as PNG under
        <raw>/<session>/image_0/<name>. Every PNG is read back by the port's
        dataset reader and must equal what was written."""
        import shutil
        import tempfile

        import cv2

        port, dg = self.port, self.dg
        tdata = port["train_data"]
        src = dg.dirs["unsupervised"]
        names = sorted(os.listdir(os.path.join(src, "bad_region_heatmap")))
        require(len(names) >= TR_VAL + 8, f"only {len(names)} heatmaps from phase 9 (b)")
        root = tempfile.mkdtemp(prefix="chip_smoke_train_")
        data_root, raw_root = os.path.join(root, "data"), os.path.join(root, "raw")
        split = {0: names[:-TR_VAL], 1: names[-TR_VAL:]}
        n_png = 0
        for sess, sel in split.items():
            gen = os.path.join(data_root, f"{sess:05d}", "generated_training_data")
            raw = os.path.join(raw_root, f"{sess:05d}", "image_0")
            os.makedirs(raw)
            for sub in ("bad_region_heatmap", "bad_region_heatmap_mask"):
                os.makedirs(os.path.join(gen, sub))
                for nm in sel:
                    shutil.copy(os.path.join(src, sub, nm), os.path.join(gen, sub, nm))
                    got = tdata.read_image(os.path.join(gen, sub, nm))
                    want = cv2.imread(os.path.join(src, sub, nm), cv2.IMREAD_UNCHANGED)
                    require(np.array_equal(got, want), f"{sub}/{nm} read back differs")
                    n_png += 1
            for nm in sel:
                left = dg.pairs[int(nm[:-4])][0]
                port["dataset_creator"].write_png(os.path.join(raw, nm), left)
                require(np.array_equal(tdata.read_image(os.path.join(raw, nm)), left),
                        f"image_0/{nm} read back differs")
                n_png += 1
        train_ds = tdata.ImageQualityDataset(data_root, raw_root, [0], NET_HW)
        val_ds = tdata.ImageQualityDataset(data_root, raw_root, [1], NET_HW)
        self.tr = SimpleNamespace(root=root, train_ds=train_ds, val_ds=val_ds, out=dict(
            train_frames=len(train_ds), val_frames=len(val_ds), pngs_read_back=n_png))
        print(f"training (a): {len(train_ds)} training and {len(val_ds)} validation frames "
              f"from phase 9 (b); {n_png} PNGs read back equal to what was written")

    def _trainer(self, ckpt, **kw):
        cfg = self.port["trainer"].TrainConfig(num_epochs=TR_EPOCHS, batch_size=TR_BATCH,
                                               input_hw=NET_HW, ckpt_dir=ckpt, **kw)
        return self.port["trainer"].Trainer(cfg)

    def tr_flagship(self):
        """(b) The flagship recipe at full width on the card: MobileNetV2-
        dilated + C1-DeepSup, 512x512, batch 8, lr 0.02, TR_EPOCHS epochs.
        Per epoch: train and validation loss, the step's median ms (CUDA
        events), samples a second, peak memory; the step's operations from
        the convolution shapes (forward x3) against the 67 TFLOP/s float32
        peak. Gates: every loss finite; 10 steps on one fixed batch lower
        its loss."""
        torch, tr = self.torch, self.tr
        trainer = self._trainer(os.path.join(tr.root, "ckpt"))
        orig = trainer.step
        events, epochs, logs = [], [], []

        def timed(batch):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(batch)
            b.record()
            events.append((a, b))
            return out

        def log(msg):
            torch.cuda.synchronize()
            epochs.append((len(events), time.perf_counter(), torch.cuda.max_memory_allocated()))
            logs.append(msg)

        trainer.step = timed
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = trainer.train(tr.train_ds, tr.val_ds, log_fn=log)
        peak = torch.cuda.max_memory_allocated()
        ms = [a.elapsed_time(b) for a, b in events]
        per_epoch, start, t_prev = [], 0, t0
        for e, (end, t_end, peak_e) in enumerate(epochs):
            med = float(np.median(ms[start:end]))
            per_epoch.append(dict(epoch=e, train_loss=hist.train_loss[e],
                                  val_loss=hist.val_loss[e], steps=end - start,
                                  step_ms_median=med, samples_per_s=TR_BATCH / med * 1e3,
                                  wall_s=t_end - t_prev, peak_memory_bytes=peak_e))
            start, t_prev = end, t_end
        flops = self._step_flops(trainer.net)
        med_all = float(np.median(ms[1:] if len(ms) > 1 else ms))
        share = flops / (med_all * 1e-3) / PEAK_OPS
        # 10 steps on one fixed batch of a fresh net lower its loss
        fresh = self._trainer(os.path.join(tr.root, "ckpt_fixed"))
        batch = next(tr.train_ds.batches(TR_BATCH, np.random.default_rng(0)))
        fixed = [float(fresh.step(batch)["loss"]) for _ in range(10)]
        tr.trainer, tr.batch = trainer, batch
        tr.out.update(flagship=dict(
            epochs=per_epoch, peak_memory_bytes=peak, step_flops=flops,
            step_ms_median=med_all, flop_share_of_67_tflops=share,
            fixed_batch_losses=fixed, best_epoch=hist.best_epoch, steps=trainer.state.step))
        for row in per_epoch:
            print(f"training (b) epoch {row['epoch']}: train {row['train_loss']:.5f} val "
                  f"{row['val_loss']:.5f}, {row['steps']} steps, step {row['step_ms_median']:.2f} "
                  f"ms median (CUDA events), {row['samples_per_s']:.1f} samples/s, "
                  f"{row['wall_s']:.2f} s wall, peak memory so far "
                  f"{row['peak_memory_bytes'] / 2**30:.3f} GiB")
        print(f"training (b): peak memory {peak / 2**30:.3f} GiB; a step is {flops / 1e12:.4f} "
              f"TFLOP (convolutions, forward x3), {share:.2%} of 67 TFLOP/s at "
              f"{med_all:.2f} ms; 10 steps on one batch: loss {fixed[0]:.5f} -> {fixed[-1]:.5f}")
        losses = hist.train_loss + hist.val_loss + fixed
        require(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
        require(fixed[-1] < fixed[0], f"10 steps on one batch did not lower its loss: {fixed}")

    def _step_flops(self, net):
        """Multiply-adds x 2 of every convolution of one forward at the
        training shape, x3 for forward and backward."""
        torch = self.torch
        total = [0]

        def hook(mod, inp, out):
            k = mod.weight[0].numel()           # (cin / groups) kh kw
            total[0] += 2 * k * out.numel()

        hs = [m.register_forward_hook(hook) for m in net.modules()
              if isinstance(m, torch.nn.Conv2d)]
        try:
            with torch.no_grad():
                net.eval()
                net(torch.zeros((TR_BATCH, 3) + NET_HW, device=next(net.parameters()).device))
        finally:
            for h in hs:
                h.remove()
        return 3 * total[0]

    def tr_card_vs_cpu(self):
        """(c) One training step at 512x512 with batch 8 on the card and on
        the CPU path from the trained weights and the same batch: loss,
        every parameter, every running statistic; then save, and restore
        into a fresh Trainer: bit-equal."""
        torch, tr = self.torch, self.tr
        ts = self.port["train_state"]
        net = tr.trainer.net
        out = {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(net).to(dev)
            state = ts.TrainState(m, *ts.make_optimizer(m, max_iters=TR_EPOCHS * 1000))
            loss = float(ts.train_step(state, tr.batch)["loss"])
            out[dev] = loss, {k: v.detach().cpu() for k, v in m.state_dict().items()}
        (l_card, card), (l_cpu, cpu) = out["cuda"], out["cpu"]
        d_p = d_m = d_v = 0.0
        for k, v in cpu.items():
            if k.endswith("running_var"):
                d_v = max(d_v, float(((card[k] - v).abs() / v.abs().clamp(min=1e-3)).max()))
            elif k.endswith("running_mean"):
                d_m = max(d_m, float((card[k] - v).abs().max()))
            elif not k.endswith("num_batches_tracked"):
                d_p = max(d_p, float((card[k] - v).abs().max()))
        d_loss = abs(l_card - l_cpu) / abs(l_cpu)
        path = os.path.join(tr.root, "roundtrip", "last")
        tr.trainer.save(path)
        back = self._trainer(os.path.join(tr.root, "ckpt2"))
        back.restore(path)
        a, b = tr.trainer.net.state_dict(), back.net.state_dict()
        same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        same = same and back.state.step == tr.trainer.state.step and back.history == \
            tr.trainer.history
        tr.out["card_vs_cpu"] = dict(loss_rel=d_loss, params_max_abs=d_p,
                                     running_mean_max_abs=d_m, running_var_max_rel=d_v,
                                     checkpoint_round_trip_bit_equal=same)
        print(f"training (c): one step at 512x512, batch 8, card vs CPU path: loss "
              f"{l_card:.7f} vs {l_cpu:.7f} ({d_loss:.3g} relative), params {d_p:.3g}, running "
              f"means {d_m:.3g}, running variances {d_v:.3g} relative; checkpoint round trip "
              f"bit-equal: {same}")
        require(d_loss <= TR_LOSS_RTOL and d_p <= TR_PARAM_ATOL and d_m <= TR_MEAN_ATOL
                and d_v <= TR_VAR_RTOL, "card and CPU path differ beyond the tolerance")
        require(same, "the checkpoint did not come back bit-equal")

    def tr_export(self):
        """(d) The trained net's cost-map inference exported to TorchScript
        at KITTI geometry, loaded on the card: its map of a phase 9 frame
        equals the eager map bit for bit."""
        torch, port, tr, dg = self.torch, self.port, self.tr, self.dg
        exp = port["export"]
        net = tr.trainer.net.eval()
        path = os.path.join(tr.root, "export", "introspection.pt")
        t0 = time.perf_counter()
        blob = exp.export_inference(net, path, (H, W), NET_HW)
        t_exp = time.perf_counter() - t0
        run = exp.load_inference(path)
        img = torch.from_numpy(np.ascontiguousarray(
            np.stack([dg.pairs[DG_RECORD][0]] * 3, -1))).cuda()
        got = run(img)
        want = port["models"].inference_cost_map(net, img, (H, W), NET_HW)
        same = torch_equal(got, want)
        ms_exp = event_ms(torch, lambda: run(img), iters=10)
        ms_eager = event_ms(torch, lambda: port["models"].inference_cost_map(
            net, img, (H, W), NET_HW), iters=10)
        tr.out["export"] = dict(bytes=len(blob), export_s=t_exp, bit_equal=same,
                                exported_ms=ms_exp, eager_ms=ms_eager)
        print(f"training (d): TorchScript export {len(blob)} bytes in {t_exp:.2f} s; cost map "
              f"of frame {DG_RECORD} bit-equal to eager: {same}; {ms_exp:.3f} ms exported, "
              f"{ms_eager:.3f} ms eager (CUDA events)")
        require(same, "the exported cost map differs from the eager one")

    def tr_loop(self):
        """(e) The trained net attached to System on phase 9's
        ReflectionWorld, TR_LOOP frames: 0 lost, K1-K3 once a frame, ATE
        below 0.5 m; frames/s and the cost map's mean inside the band
        against outside it (reported, not gated)."""
        torch, port, tr, dg = self.torch, self.port, self.tr, self.dg
        cfg = copy.deepcopy(dg.cfg)
        cfg.iv.enabled = False
        cam = cfg.camera
        net = tr.trainer.net.eval()
        s = port["system"].System(cfg, cam.height, cam.width)
        s.tracking.frontend.attach_introspection(net, NET_HW)
        for m in self.counters().values():
            m.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TR_LOOP):
            s.track_stereo(*dg.pairs[i], timestamp=i / cam.fps)
        torch.cuda.synchronize()
        fps = TR_LOOP / (time.perf_counter() - t0)
        launches = {k: m.launches for k, m in self.counters().items()}
        lost = int(sum(s.tracking.lost_flags))
        ate = port["trajectory"].ate_rmse(s.trajectory_twc(), dg.gt[:TR_LOOP])
        img = torch.from_numpy(np.ascontiguousarray(np.stack([dg.pairs[0][0]] * 3, -1))).cuda()
        cost = port["models"].inference_cost_map(net, img, (H, W), NET_HW).cpu().numpy()
        pred = port["models"].predict(net, img[None], NET_HW)
        pred = torch.nn.functional.interpolate(pred, size=(H, W), mode="bilinear")[0, 0]
        pred = pred.cpu().numpy()
        band = dg.band[:H, :W]
        inside, outside = float(cost[band].mean()), float(cost[~band].mean())
        p_in, p_out = float(pred[band].mean()), float(pred[~band].mean())
        tr.out["loop"] = dict(frames=TR_LOOP, fps=fps, lost_frames=lost, ate_m=ate,
                              frontend_launches=launches, cost_mean_in_band=inside,
                              cost_mean_outside_band=outside, pred_mean_in_band=p_in,
                              pred_mean_outside_band=p_out)
        print(f"training (e): the trained net in System, {TR_LOOP} frames of phase 9's world: "
              f"{lost} lost, ATE {ate:.4f} m, {fps:.3f} frames/s, K1-K3 launches {launches}; "
              f"cost map mean {inside:.2f} inside the band, {outside:.2f} outside; the "
              f"prediction before sharpening {p_in:.4f} inside, {p_out:.4f} outside")
        want = {k: TR_LOOP for k in launches}
        require(launches == want, f"launch counts {launches} != {want}")
        require(lost == 0 and s.failure_count == 0, f"{lost} lost frames")
        require(ate < 0.5, f"ATE {ate} m")

    def tr_zoo(self):
        """(f) One training step of every encoder but ZOO_SKIP's with c1 and
        of every decoder on resnet50dilated at 512x512, batch 8: step ms
        (CUDA events, after one warm-up step) and peak memory. Then each
        pair card against CPU path at ZOO_CHECK_HW, batch 2, from the same
        weights and batch: the loss and the parameter update (the PPM
        decoders with their dropout rate set to 0 there, so that both draw
        none). That comparison runs in float64: at that size and batch 2
        the small maps make BatchNorm ill-conditioned in float32 (see
        ZOO_*)."""
        torch, port = self.torch, self.port
        zoo, ts = port["zoo"], port["train_state"]
        pairs = [(e, "c1") for e in zoo.ENCODER_FC_DIM if e not in ZOO_SKIP] + [
            ("resnet50dilated", d) for d in ("c1_deepsup", "ppm", "ppm_deepsup", "upernet",
                                            "upernet_lite")]
        rng = np.random.default_rng(0)

        def batch(n, hw, stride):
            """Targets at the prediction's size: 1/8 for the dilated
            encoders, 1/32 for the plain ones, 1/4 for HRNet's map and for
            UPerNet (fused at the encoder's finest map)."""
            th, tw = hw[0] // stride, hw[1] // stride
            return dict(image=rng.normal(size=(n,) + hw + (3,)).astype(np.float32),
                        target=rng.uniform(size=(n, th, tw, 1)).astype(np.float32),
                        mask=np.ones((n, th, tw, 1), np.float32))

        rows = {}
        for enc, dec in pairs:
            stride = (4 if enc == "hrnetv2" or dec.startswith("upernet")
                      else 8 if enc.endswith("dilated") else 32)
            big, small = batch(TR_BATCH, NET_HW, stride), batch(2, ZOO_CHECK_HW, stride)
            # built and initialised on the card: the CPU's truncated-normal
            # draws took ~3-4 s a 50-layer model
            gen = torch.Generator(device="cuda").manual_seed(0)
            with torch.device("cuda"):
                model = port["models"].flax_init_(zoo.SegmentationModel(enc, dec).cuda(), gen)
            init = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            state = ts.TrainState(model, *ts.make_optimizer(model, max_iters=1000))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss_big = float(ts.train_step(state, big)["loss"])
            ms = event_ms(torch, lambda: ts.train_step(state, big), iters=1, warmup=0)
            peak = torch.cuda.max_memory_allocated()
            deltas, losses = {}, {}
            small64 = {k: v.astype(np.float64) for k, v in small.items()}
            for dev in ("cuda", "cpu"):
                m = zoo.SegmentationModel(enc, dec)
                m.load_state_dict(init)
                if hasattr(m.decoder, "dropout"):
                    m.decoder.dropout.p = 0.0
                m.to(dev, torch.float64)
                st = ts.TrainState(m, *ts.make_optimizer(m, max_iters=1000))
                losses[dev] = float(ts.train_step(st, small64)["loss"])
                sd = m.state_dict()
                deltas[dev] = {k: sd[k].detach().cpu() - init[k].double() for k in init
                               if not k.endswith(("num_batches_tracked", "running_mean",
                                                  "running_var"))}
            d_loss = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
            d_upd = max(float((deltas["cuda"][k] - deltas["cpu"][k]).abs().max())
                        for k in deltas["cpu"])
            scale = max(float(v.abs().max()) for v in deltas["cpu"].values())
            rows[f"{enc}+{dec}"] = dict(step_ms=ms, peak_memory_bytes=peak,
                                        loss=loss_big,
                                        card_vs_cpu_loss_rel=d_loss,
                                        card_vs_cpu_update_rel=d_upd / scale)
            print(f"training (f) {enc}+{dec}: step {ms:.2f} ms, peak {peak / 2**30:.3f} GiB; "
                  f"{ZOO_CHECK_HW} float64 card vs CPU: loss {d_loss:.3g} relative, update "
                  f"{d_upd / scale:.3g} of its largest ({scale:.3g})", flush=True)
            del state, model
            torch.cuda.empty_cache()
        self.tr.out["zoo"] = rows
        bad = {k: v for k, v in rows.items() if not (np.isfinite(v["loss"])
               and v["card_vs_cpu_loss_rel"] <= ZOO_LOSS_RTOL
               and v["card_vs_cpu_update_rel"] <= ZOO_UPDATE_RTOL)}
        require(not bad, f"zoo card vs CPU beyond tolerance: {bad}")

    def tr_dp(self):
        """(g) Two ranks on the one card through gloo: the trained net's
        step on a split batch against the one-rank step on the whole batch
        (same weights, same batch), within (c)'s tolerance."""
        torch, tr = self.torch, self.tr
        ts, mesh = self.port["train_state"], self.port["mesh"]
        work = os.path.join(tr.root, "dp")
        os.makedirs(work)
        torch.save(tr.trainer.net.state_dict(), os.path.join(work, "init.pt"))
        np.savez(os.path.join(work, "batch.npz"), **tr.batch)
        t0 = time.perf_counter()
        mesh.spawn(dp_rank_main, 2, work)
        t_dp = time.perf_counter() - t0
        got = torch.load(os.path.join(work, "rank0.pt"))
        m = copy.deepcopy(tr.trainer.net)
        m.load_state_dict(torch.load(os.path.join(work, "init.pt")))
        state = ts.TrainState(m, *ts.make_optimizer(m, max_iters=TR_EPOCHS * 1000))
        loss = float(ts.train_step(state, tr.batch)["loss"])
        want = {k: v.detach().cpu() for k, v in m.state_dict().items()}
        d_p = d_s = 0.0
        for k, v in want.items():
            if k.endswith(("running_mean", "running_var")):
                d_s = max(d_s, float((got["sd"][k] - v).abs().max()))
            elif not k.endswith("num_batches_tracked"):
                d_p = max(d_p, float((got["sd"][k] - v).abs().max()))
        d_loss = abs(got["loss"] - loss) / abs(loss)
        tr.out["data_parallel"] = dict(ranks=2, backend="gloo", loss_rel=d_loss, params_max_abs=d_p,
                                       running_stats_max_abs=d_s, wall_s=t_dp)
        print(f"training (g): 2 gloo ranks on one card against one rank: loss {d_loss:.3g} "
              f"relative, params {d_p:.3g}, running statistics {d_s:.3g} ({t_dp:.1f} s with "
              f"the ranks' start)")
        require(d_loss <= TR_LOSS_RTOL and d_p <= TR_PARAM_ATOL and d_s <= TR_STATS_ATOL,
                "the two-rank step differs from the one-rank step")

    def tr_replay(self):
        """(h) ShardedReplay over N_REPLAY frames of the full loop's world at
        KITTI geometry with phase 7's vocabulary: every frame bit-equal to
        StereoFrontend.process, bow_nodes equal to the host descent, K1-K3
        once a frame."""
        torch, port, t = self.torch, self.port, self.trk
        rep = port["replay"].ShardedReplay(t.cfg, H, W, vocabulary=self.lc.voc)
        lefts = np.stack([p[0] for p in t.loop_pairs[:N_REPLAY]])
        rights = np.stack([p[1] for p in t.loop_pairs[:N_REPLAY]])
        for m in self.counters().values():
            m.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = rep.process_batch(lefts, rights)
        fps = N_REPLAY / (time.perf_counter() - t0)
        launches = {k: m.launches for k, m in self.counters().items()}
        same = bow_same = True
        for i, rec in enumerate(recs):
            fr = rep.frontend.process(lefts[i], rights[i], 0.0)
            want = dict(xy=fr.xy, octave=fr.octave, valid=fr.valid, desc=fr.desc,
                        angle=fr.angle, u_right=fr.u_right, depth=fr.depth, qual=fr.qual_score)
            same &= all(np.array_equal(rec[k], want[k]) for k in want)
            v = rec["valid"]
            bow_same &= bool(np.array_equal(rec["bow_nodes"][v],
                                            self.lc.voc.transform_words(rec["desc"][v]))
                             and (rec["bow_nodes"][~v] == -1).all())
        self.tr.out["replay"] = dict(frames=N_REPLAY, fps=fps, bit_equal=same,
                                     bow_equal_host=bow_same, frontend_launches=launches)
        for k, v in launches.items():
            self.kernels[k]["launches_replay"] = v
        print(f"training (h): ShardedReplay, {N_REPLAY} frames at {H}x{W}: {fps:.3f} frames/s, "
              f"bit-equal to StereoFrontend.process: {same}, bow_nodes equal to the host "
              f"descent: {bow_same}, K1-K3 launches {launches}")
        want = {k: N_REPLAY for k in launches}
        require(launches == want, f"launch counts {launches} != {want}")
        require(same and bow_same, "ShardedReplay differs from the per-frame frontend")

    def tr_datagen(self):
        """(i) ShardedDatagen over phase 9's frames and GT poses: pairs
        scored, good frames, heatmaps written, pairs/s; one pair again on
        the CPU path: heatmap within 1, errors within 1e-5. The pairs score
        only keypoints with stereo depth in the previous frame, and the
        world's band, blended at one image position in both views, has
        none: the scored ground is clean (~0% bad). So, as
        tests/test_sharded_datagen.py does for its clean world, the lower
        bad-share gate of a training frame is lifted (MIN_BAD_PERCENT -1)
        for this run, and frames are written."""
        import tempfile

        torch, port, dg = self.torch, self.port, self.dg
        SD = port["sharded_datagen"].ShardedDatagen
        fe = port["feature_evaluator"]
        out = tempfile.mkdtemp(prefix="chip_smoke_sdg_")
        sdg = SD(dg.cfg, H, W, out_path=out)
        for m in self.counters().values():
            m.launches = 0
        gate = fe.MIN_BAD_PERCENT
        fe.MIN_BAD_PERCENT = -1.0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = sdg.process_session(dg.pairs[:N_DG_SUP], dg.gt[:N_DG_SUP])
            pps = stats["n_pairs"] / (time.perf_counter() - t0)
        finally:
            fe.MIN_BAD_PERCENT = gate
        launches = {k: m.launches for k, m in self.counters().items()}
        hm_dir = os.path.join(out, "bad_region_heatmap")
        written = len(os.listdir(hm_dir)) if os.path.isdir(hm_dir) else 0
        k = DG_RECORD
        card = sdg._pairs(dg.pairs, dg.gt, [k])[0]
        cpu = SD(dg.cfg, H, W, device="cpu")._pairs(dg.pairs, dg.gt, [k])[0]
        d_hm = int(np.abs(card["heatmap"].astype(int) - cpu["heatmap"].astype(int)).max())
        d_err = float(np.abs(card["err"] - cpu["err"]).max())
        same_sel = bool(np.array_equal(card["sel"], cpu["sel"]))
        self.tr.out["sharded_datagen"] = dict(
            frames=N_DG_SUP, pairs=stats["n_pairs"], good=stats["n_good"],
            heatmaps_written=written, mean_bad_pct=stats["mean_bad_pct"], pairs_per_s=pps,
            frontend_launches=launches, card_vs_cpu=dict(pair=k, heatmap_max_abs_diff=d_hm,
                                                         err_max_abs_diff=d_err,
                                                         same_rows=same_sel))
        for kk, v in launches.items():
            self.kernels[kk]["launches_sharded_datagen"] = v
        print(f"training (i): ShardedDatagen over {N_DG_SUP} frames: {stats['n_pairs']} pairs "
              f"scored, {stats['n_good']} good, {written} heatmaps written, mean bad share "
              f"{stats['mean_bad_pct']:.3f}%, {pps:.3f} pairs/s, K1-K3 launches {launches}; pair "
              f"{k - 1}->{k} card vs CPU: heatmap max |d| {d_hm}, errors max |d| {d_err:.3g}, "
              f"same rows {same_sel}")
        require(stats["n_pairs"] == N_DG_SUP - 1, f"{stats['n_pairs']} pairs scored")
        require(written >= 1 and written == stats["n_good"], f"{written} heatmaps written")
        require(d_hm <= 1 and d_err <= 1e-5 and same_sel, "card and CPU path differ")

    # ---- phase 11: the dataset drivers ----------------------------------------
    def drv_setup(self):
        """(a) The full loop's N_LOOP frames written as a KITTI layout by the
        port's PNG writer, every row Paeth-filtered (the decoder's slow
        case), with times.txt and a KITTI-format GT file; every file decoded
        back equal to the rendered image; the decode's median ms a pair, the
        row unfilter's ms a pair beside its plain NumPy version's."""
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        port, t = self.port, self.trk
        png = port["png"]
        root = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
        seq = os.path.join(root, "kitti00")
        for d in ("image_0", "image_1"):
            os.makedirs(os.path.join(seq, d))
        jobs = [(os.path.join(seq, d, f"{i:06d}.png"), img)
                for i, pair in enumerate(t.loop_pairs)
                for d, img in zip(("image_0", "image_1"), pair)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda job: png.write_png(job[0], job[1], filter_type=4), jobs))
        write_s = time.perf_counter() - t0
        with open(os.path.join(seq, "times.txt"), "w") as f:
            f.writelines(f"{0.1 * i!r}\n" for i in range(N_LOOP))
        gt_file = os.path.join(root, "kitti00.txt")
        np.savetxt(gt_file, np.stack([T[:3, :4].reshape(-1) for T in t.loop_gt]), fmt="%.9g")
        pair_ms, same = [], True
        for i in range(N_LOOP):
            t0 = time.perf_counter()
            dec = [port["datasets"].load_gray(p) for p, _ in jobs[2 * i:2 * i + 2]]
            pair_ms.append((time.perf_counter() - t0) * 1e3)
            same &= all(np.array_equal(a, b) for a, b in zip(dec, t.loop_pairs[i]))
        with open(jobs[0][0], "rb") as f:
            data = f.read()
        import zlib
        idat = b"".join(body for tag, body in png._chunks(data, jobs[0][0]) if tag == b"IDAT")
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, W + 1)
        filters = sorted(set(rows[:, 0].tolist()))
        unf_ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            png.unfilter(rows, 1)
            png.unfilter(rows, 1)
            unf_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        plain = png.unfilter_plain(rows, 1)
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(np.array_equal(plain, png.unfilter(rows, 1)), "unfilter != its plain version")
        self.drv = SimpleNamespace(root=root, seq=seq, gt_file=gt_file, out={})
        self.drv.out["decode"] = dict(
            frames=N_LOOP, shape=[H, W], filter_types=filters, all_equal=bool(same),
            write_s=write_s, decode_ms_pair_median=float(np.median(pair_ms)),
            unfilter_ms_pair_median=float(np.median(unf_ms)),
            unfilter_plain_ms_image=plain_ms,
            unfilter_build_s=self.unfilter_build_s)
        print(f"drivers (a): {2 * N_LOOP} PNGs of {W}x{H} (filter types {filters}) written in "
              f"{write_s:.2f} s; decoded equal to the rendered images: {same}; decode "
              f"{np.median(pair_ms):.3f} ms a pair (median, host), row unfilter "
              f"{np.median(unf_ms):.3f} ms a Paeth pair (its plain NumPy version "
              f"{plain_ms:.1f} ms an image); unfilter build {self.unfilter_build_s:.2f} s")
        require(filters == [4], f"filter types {filters}")
        require(same, "a decoded image differs from the rendered one")

    def _settings(self, path, extra=""):
        """The full loop's configuration as a reference settings YAML."""
        cam, orb = self.trk.cfg.camera, self.trk.cfg.orb
        keys = {"Camera.fx": cam.fx, "Camera.fy": cam.fy, "Camera.cx": cam.cx,
                "Camera.cy": cam.cy, "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0,
                "Camera.p2": 0.0, "Camera.width": cam.width, "Camera.height": cam.height,
                "Camera.fps": cam.fps, "Camera.bf": cam.bf, "ThDepth": cam.th_depth,
                "ORBextractor.nFeatures": orb.n_features,
                "ORBextractor.scaleFactor": orb.scale_factor,
                "ORBextractor.nLevels": orb.n_levels,
                "ORBextractor.iniThFAST": orb.ini_th_fast,
                "ORBextractor.minThFAST": orb.min_th_fast}
        with open(path, "w") as f:
            f.write("%YAML:1.0\n" + "".join(f"{k}: {v!r}\n" for k, v in keys.items()) + extra)
        return path

    def _drive(self, mod, argv):
        """A driver's main in process, K1-K3 counted: (stats, launches, s)."""
        torch = self.torch
        for m in self.counters().values():
            m.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = mod.main(argv)
        torch.cuda.synchronize()
        return stats, {k: m.launches for k, m in self.counters().items()}, \
            time.perf_counter() - t0

    def drv_stereo(self):
        """(b) run_stereo in process on the card over (a)'s first N_DRV
        frames with --fused_tracking --profile_stages: 0 failures, ATE < 0.5
        m, every output file; its configuration equal to the full loop's,
        and its Trajectory_KITTI_000.txt bit-equal to the trajectory System
        gave the full loop in memory after as many frames (PNG is lossless:
        the same frames); K1-K3 once a frame."""
        port, t, drv = self.port, self.trk, self.drv
        rs = port["run_stereo"]
        settings = self._settings(os.path.join(drv.root, "kitti.yaml"))
        out = os.path.join(drv.root, "results", "PORT", "kitti00")
        argv = ["--data_path", drv.seq, "--settings_path", settings,
                "--ground_truth_path", drv.gt_file, "--out_visualization_path", out,
                "--fused_tracking", "--profile_stages", "--end_frame", str(N_DRV)]
        dcfg = rs.make_config(rs.parse_args(argv))
        dcfg.camera.height, dcfg.camera.width = H, W
        require(dcfg == t.loop_sys.cfg, "run_stereo's configuration differs from the full "
                f"loop's:\n{dcfg}\n{t.loop_sys.cfg}")
        stats, launches, wall = self._drive(rs, argv)
        files = {f: os.path.exists(os.path.join(out, f))
                 for f in ("Trajectory_KITTI_000.txt", "KeyFrameTrajectory_TUM_000.txt",
                           "failure_log.txt", "stats.json")}
        mem = os.path.join(drv.root, "full_loop_in_memory.txt")
        port["trajectory"].save_kitti(mem, list(t.thr_inline[N_DRV]["twc"]))
        with open(mem, "rb") as a, open(os.path.join(out, "Trajectory_KITTI_000.txt"),
                                         "rb") as b:
            bit_equal = a.read() == b.read()
        drv.stereo_stats, drv.stereo_out = stats, out
        drv.out["run_stereo"] = dict(
            frames=stats["frames"], failures=stats["failures"], ate_m=stats["ate_rmse"],
            full_loop_ate_m=port["trajectory"].ate_rmse(list(t.thr_inline[N_DRV]["twc"]),
                                                        t.loop_gt[:N_DRV]),
            frames_per_s=stats["frames"] / wall,
            median_track_s=stats["median_track_s"], files=files,
            trajectory_bit_equal_to_full_loop=bit_equal, frontend_launches=launches)
        for k, v in launches.items():
            self.kernels[k]["launches_run_stereo"] = v
        print(f"drivers (b): run_stereo over {stats['frames']} frames: {stats['failures']} "
              f"failures, ATE {stats['ate_rmse']:.4f} m (full loop over as many frames "
              f"{drv.out['run_stereo']['full_loop_ate_m']:.4f} m), "
              f"{stats['frames'] / wall:.3f} frames/s (wall, decode-ahead loader), median "
              f"track {stats['median_track_s'] * 1e3:.1f} ms; files {files}; trajectory "
              f"bit-equal to the full loop's: {bit_equal}; K1-K3 launches {launches}")
        require(all(files.values()), f"missing output files: {files}")
        require(stats["failures"] == 0 and stats["ate_rmse"] < 0.5,
                f"{stats['failures']} failures, ATE {stats['ate_rmse']}")
        require(bit_equal, "run_stereo's trajectory differs from the full loop's")
        require(stats["frames"] == N_DRV, f"{stats['frames']} frames")
        require(launches == {k: N_DRV for k in launches}, f"launches {launches}")

    def drv_rectify(self):
        """(c) --rectify_images with identity LEFT./RIGHT. blocks over the
        first N_RECT frames: trajectory bit-identical to the run without the
        flag; remap's ms a pair at settings/EuRoC_stereo.yaml's maps
        (752x480) on the host (the loader's) and on the card, the card's
        result equal to the host's."""
        torch, port, drv = self.torch, self.port, self.drv
        rs, rect, C = port["run_stereo"], port["rectify"], port["config"]
        cam = self.trk.cfg.camera
        K = [cam.fx, 0.0, cam.cx, 0.0, cam.fy, cam.cy, 0.0, 0.0, 1.0]
        P = K[:3] + [0.0] + K[3:6] + [0.0] + K[6:] + [0.0]

        def block(side):
            def m(name, rows, cols, data):
                return (f"{side}.{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
                        f"   dt: d\n   data: [{', '.join(repr(float(v)) for v in data)}]\n")
            return (f"{side}.height: {H}\n{side}.width: {W}\n" + m("D", 1, 5, [0] * 5)
                    + m("K", 3, 3, K) + m("R", 3, 3, np.eye(3).ravel()) + m("P", 3, 4, P))

        settings = self._settings(os.path.join(drv.root, "kitti_rect.yaml"),
                                  block("LEFT") + block("RIGHT"))
        trajs = {}
        for flag in ([], ["--rectify_images"]):
            out = os.path.join(drv.root, "rect" + "".join(flag))
            stats, _, _ = self._drive(rs, ["--data_path", drv.seq, "--settings_path", settings,
                                           "--out_visualization_path", out, "--fused_tracking",
                                           "--end_frame", str(N_RECT), *flag])
            with open(os.path.join(out, "Trajectory_KITTI_000.txt"), "rb") as f:
                trajs[bool(flag)] = f.read()
            require(stats["frames"] == N_RECT and stats["failures"] == 0, f"stats {stats}")
        same = trajs[True] == trajs[False]
        doc = C._parse_opencv_yaml(os.path.join(HERE, "settings", "EuRoC_stereo.yaml"))
        maps = [rect.load_rectification_from_yaml(doc, s) for s in ("LEFT", "RIGHT")]
        rng = np.random.default_rng(0)
        pair = [rng.integers(0, 256, maps[0][0].shape, dtype=np.uint8) for _ in range(2)]
        host_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            host = [rect.remap(img, m) for img, m in zip(pair, maps)]
            host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_pair = [torch.as_tensor(img).cuda() for img in pair]
        dev_maps = [tuple(torch.as_tensor(a).cuda() for a in m) for m in maps]
        card = [rect.remap(img, m) for img, m in zip(dev_pair, dev_maps)]
        card_equal = all(np.array_equal(c.cpu().numpy(), h) for c, h in zip(card, host))
        card_ms = event_ms(torch, lambda: [rect.remap(img, m)
                                           for img, m in zip(dev_pair, dev_maps)], iters=20)
        drv.out["rectify"] = dict(
            frames=N_RECT, identity_bit_identical=same, euroc_shape=list(maps[0][0].shape),
            remap_host_ms_pair_median=float(np.median(host_ms)), remap_card_ms_pair=card_ms,
            card_equal_host=card_equal)
        print(f"drivers (c): identity rectification over {N_RECT} frames bit-identical to no "
              f"rectification: {same}; remap at EuRoC_stereo.yaml's maps "
              f"({maps[0][0].shape[1]}x{maps[0][0].shape[0]}): host {np.median(host_ms):.3f} ms "
              f"a pair (median), card {card_ms:.4f} ms a pair (CUDA events), card equal to "
              f"host {card_equal}")
        require(same, "identity rectification changed the trajectory")
        require(card_equal, "remap on the card differs from the host")

    def drv_mono_rgbd(self):
        """(d) run_mono and run_rgbd on the first N_DRV_MR frames of phase 8's
        worlds, written as a TUM mono layout (rgb.txt, colour PNGs) and a TUM
        RGB-D layout (associations, 16-bit depth PNGs at 5000 a metre), at
        phase 8's settings (distortion 0) without fused tracking (neither
        driver has the flag); each trajectory bit-equal to a System run in
        memory on the rendered frames with the driver's configuration."""
        port, mr, drv = self.port, self.mr, self.drv
        png = port["png"]
        n = N_DRV_MR

        def settings(name, yaml_name):
            with open(os.path.join(HERE, "settings", yaml_name)) as f:
                lines = [("%s: 0.0" % ln.split(":")[0]) if ln.split(":")[0].strip() in (
                    "Camera.k1", "Camera.k2", "Camera.k3", "Camera.p1", "Camera.p2")
                    else ln.rstrip("\n") for ln in f]
            path = os.path.join(drv.root, name)
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            return path

        res = {}
        for sensor in ("mono", "rgbd"):
            cam = getattr(mr, sensor + "_cfg").camera
            seq = os.path.join(drv.root, "tum_" + sensor)
            os.makedirs(os.path.join(seq, "rgb"))
            imgs = (mr.mono_imgs if sensor == "mono" else mr.rgbd_imgs)[:n]
            stamps = [i / cam.fps for i in range(n)]
            for i, img in enumerate(imgs):
                png.write_png(os.path.join(seq, "rgb", f"{i:04d}.png"),
                              np.repeat(img[..., None], 3, axis=-1), filter_type=4)
            if sensor == "mono":
                with open(os.path.join(seq, "rgb.txt"), "w") as f:
                    f.write("# timestamp filename\n")
                    f.writelines(f"{s!r} rgb/{i:04d}.png\n" for i, s in enumerate(stamps))
                mod = port["run_mono"]
                yaml_path = settings("mono.yaml", "EuRoC_mono.yaml")
                out = os.path.join(drv.root, "results", "PORT", "tum_mono")
                argv = ["--dataset", "tum", "--data_path", seq, "--settings_path", yaml_path,
                        "--out_visualization_path", out]
                traj_name = "Trajectory_KITTI_000.txt"
            else:
                os.makedirs(os.path.join(seq, "depth"))
                for i, dep in enumerate(mr.rgbd_depth[:n]):
                    png.write_png(os.path.join(seq, "depth", f"{i:04d}.png"), dep,
                                  filter_type=4)
                assoc = os.path.join(seq, "associations.txt")
                with open(assoc, "w") as f:
                    f.writelines(f"{s!r} rgb/{i:04d}.png {s!r} depth/{i:04d}.png\n"
                                 for i, s in enumerate(stamps))
                mod = port["run_rgbd"]
                yaml_path = settings("rgbd.yaml", "TUM1.yaml")
                out = os.path.join(drv.root, "rgbd_out")
                argv = ["--data_path", seq, "--association_file", assoc,
                        "--settings_path", yaml_path, "--out_visualization_path", out]
                traj_name = "CameraTrajectory.txt"
            stats, launches, wall = self._drive(mod, argv)
            cfg = mod.make_config(mod.parse_args(argv))
            cfg.camera.height, cfg.camera.width = imgs[0].shape
            s = port["system"].System(cfg, *imgs[0].shape)
            for i, img in enumerate(imgs):
                if sensor == "mono":
                    s.track_mono(img, stamps[i], img_name=f"{i:04d}.png")
                else:
                    s.track_rgbd(img, mr.rgbd_depth[i], stamps[i],
                                 depth_scale=1.0 / cfg.camera.depth_map_factor,
                                 img_name=f"{i:04d}.png")
            mem = os.path.join(drv.root, f"{sensor}_in_memory.txt")
            (s.save_trajectory_kitti if sensor == "mono" else s.save_trajectory_tum)(mem)
            with open(mem, "rb") as a, open(os.path.join(out, traj_name), "rb") as b:
                equal = a.read() == b.read()
            res[sensor] = dict(frames=stats["frames"], failures=stats["failures"],
                               frames_per_s=stats["frames"] / wall, state=s.state.name,
                               trajectory_bit_equal_in_memory=equal, frontend_launches=launches)
            for k, v in launches.items():
                self.kernels[k]["launches_run_" + sensor] = v
            print(f"drivers (d): run_{sensor} over {n} frames of phase 8's world: "
                  f"{stats['frames']} frames, {stats['failures']} failures, "
                  f"{stats['frames'] / wall:.3f} frames/s, state {s.state.name}; trajectory "
                  f"bit-equal to System in memory: {equal}; K1-K3 launches {launches}")
            require(equal, f"run_{sensor}'s trajectory differs from the in-memory run")
            require(launches == {"fast_score": n, "orient_brief": n, "sad_windows": 0},
                    f"launches {launches}")
        np.savetxt(os.path.join(drv.root, "tum_mono.txt"),
                   np.stack([T[:3, :4].reshape(-1) for T in mr.mono_gt[:n]]), fmt="%.9g")
        drv.out.update(res)

    def drv_octtree(self):
        """(e) extract_octtree on the full loop's first left image on the
        card against the CPU path: keypoints, order, responses, descriptors
        equal, angles within OCT_ANGLE_TOL degrees; K1 and K2 launched once."""
        torch, port = self.torch, self.port
        ex = port["extractor"].OrbExtractor(self.trk.cfg.orb, H, W)
        img = self.trk.loop_pairs[0][0]
        cpu = ex.extract_octtree(torch.as_tensor(img))
        for m in self.counters().values():
            m.launches = 0
        dev_img = torch.as_tensor(img).cuda()
        card = ex.extract_octtree(dev_img)
        torch.cuda.synchronize()
        launches = {k: m.launches for k, m in self.counters().items()}
        card_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            ex.extract_octtree(dev_img)
            torch.cuda.synchronize()
            card_ms.append((time.perf_counter() - t0) * 1e3)
        diffs = {}
        for f in card._fields:
            a, b = getattr(card, f).cpu(), getattr(cpu, f)
            diffs[f] = (float((a.double() - b.double()).abs().max()) if f == "angle"
                        else bool(torch.equal(a, b)))
        n_valid = int(cpu.valid.sum())
        self.drv.out["extract_octtree"] = dict(
            capacity=int(cpu.valid.numel()), valid=n_valid, fields=diffs,
            card_ms_median=float(np.median(card_ms)), launches=launches)
        for k, v in launches.items():
            self.kernels[k]["launches_octree"] = v
        print(f"drivers (e): extract_octtree at {W}x{H}, {n_valid} of {cpu.valid.numel()} "
              f"slots valid, card vs CPU path {diffs}, {np.median(card_ms):.2f} ms a call "
              f"(host clock, synced), K1-K3 launches {launches}")
        require(all(v for f, v in diffs.items() if f != "angle"), f"fields differ: {diffs}")
        require(diffs["angle"] <= OCT_ANGLE_TOL, f"angles differ by {diffs['angle']}")
        require(launches == {"fast_score": 1, "orient_brief": 1, "sad_windows": 0},
                f"launches {launches}")

    def drv_evaluate(self):
        """(f) evaluate_batch over (b)'s and (d)'s mono output directories:
        (b)'s ATE equal to its stats.json's (within EVAL_ATE_ATOL m: the
        trajectory passes through text). The layout stays for phase 13."""
        port, drv = self.port, self.drv
        out = os.path.join(drv.root, "evaluation.json")
        report = port["evaluate_batch"].main([
            "--results_root", os.path.join(drv.root, "results"), "--gt_root", drv.root,
            "--modes", "PORT", "--sessions", "kitti00", "tum_mono", "--out", out])
        with open(os.path.join(drv.stereo_out, "stats.json")) as f:
            want = json.load(f)["ate_rmse"]
        got = report["PORT"]["kitti00"]["ate_rmse"]
        drv.out["evaluate_batch"] = dict(ate_m=got, stats_json_ate_m=want,
                                         abs_diff=abs(got - want),
                                         mono_se3_ate_m=report["PORT"]["tum_mono"]["ate_rmse"])
        print(f"drivers (f): evaluate_batch ATE {got!r} m, stats.json {want!r} m "
              f"(|d| {abs(got - want):.3g}); mono (SE3, no scale) "
              f"{report['PORT']['tum_mono']['ate_rmse']:.4f} m")
        require(abs(got - want) <= EVAL_ATE_ATOL, f"ATE {got} != stats.json's {want}")


    # ---- phase 12: the product's claims --------------------------------------
    def cl_setup(self):
        """The claims' helper (tests/torch_claims.py), a work directory, and
        K1-K3 held bit for bit against their plain versions on the inputs
        that the pinned IV world's first eval frame hands each wrapper
        (320x240, 4 levels, 600 features) and FAST on noise at 320x240."""
        import tempfile

        sys.path.insert(0, os.path.join(HERE, "tests"))
        import torch_claims as tc

        self.cl = SimpleNamespace(tc=tc, work=tempfile.mkdtemp(prefix="chip_smoke_claims_"),
                                  out={}, launches={k: 0 for k in self.counters()})
        (pair,), _ = tc.make_frames(tc.iv_world(CLAIMS_CASE), 1, tc.STEP)
        fe = self.port["frame"].StereoFrontend(tc.iv_config(), tc.H, tc.W)
        rec = self.record_inputs(lambda: fe.process(*pair, 0.0))
        print(f"claims, K1-K3 on the inputs of {CLAIMS_CASE}'s first eval frame:")
        errs = {"fast_score": self.check_fast(rec, noise_hw=(tc.H, tc.W), main=False),
                "orient_brief": self.check_orient_brief(rec, main=False),
                "sad_windows": self.check_sad(rec, main=False)}
        self.cl.out["kernels_at_claims_shapes"] = dict(max_abs_err=errs, bit_equal=True)
        for name, e in errs.items():
            self.kernels[name]["max_abs_err"] = max(self.kernels[name]["max_abs_err"], e)

    def _cl_check(self, key, res, runs):
        """Count the K1-K3 launches of `res`'s sub-results `runs` (None: res
        itself) into the claims' total, and require every gate of `res`
        (K1-K3 once a frame among them) but those that the JAX package
        misses too (torch_claims.JAX_MISSES)."""
        tc = self.cl.tc
        for name in runs:
            for k, n in (res[name] if name else res)["launches"].items():
                self.cl.launches[k] += n
        missed = tc.JAX_MISSES.get(key, ())
        bad = [g for g in tc.failed(res) if g not in missed]
        res["gates_left_to_claims_smoke"] = [g for g in tc.failed(res) if g in missed]
        require(not bad, f"{key}: " + "; ".join(
            f"{g} ({json.dumps(res['gates'][g][1], default=float)})" for g in bad))

    def cl_cycle(self):
        """(c) tests/test_full_cycle.py on the card: datagen on 12 frames,
        2 epochs, 8 frames with the trained FCN at net_hw 256x256."""
        cl = self.cl
        res = cl.tc.full_cycle(os.path.join(cl.work, "cycle"), None)
        cl.out["full_cycle"] = res
        q = res.get("quality", {})
        print(f"claims (c) whole cycle: {res['heatmaps']} heatmaps, {res['dataset']} samples, "
              f"train losses {res.get('train', {}).get('train_loss')}, ON "
              f"{res.get('on', {}).get('failures')} failures; keypoint quality "
              f"{q.get('not_one')} of {q.get('n')} below 1 (min {q.get('min')}); gates "
              f"failed {cl.tc.failed(res)}; frames sha1 {res['frames_sha1'][:16]}")
        self._cl_check("full_cycle", res, [k for k in ("datagen", "on") if k in res])

    def cl_kitti(self):
        """(d) tests/test_kitti_e2e.py on the card: run_stereo at KITTI-00
        geometry with fused tracking, introspection, datagen and a k=8 L=3
        vocabulary at once; the JAX test's asserts."""
        cl = self.cl
        res = cl.tc.kitti_all_on(os.path.join(cl.work, "kitti"), None)
        cl.out["kitti_all_on"] = res
        print(f"claims (d) KITTI all on: {res['frames']} frames, {res['failures']} failures, "
              f"ATE {res['ate_m']:.4f} m, {res['frames_per_s']:.3f} frames/s; "
              f"{res['keypoints']} scored keypoints, {res['training_images']} training "
              f"images, {res['heatmaps']} heatmaps; gates failed {cl.tc.failed(res)}; frames "
              f"sha1 {res['frames_sha1'][:16]}")
        self._cl_check("kitti_all_on", res, [None])

    def claims_line(self):
        """The numbers of the {"claims": ...} line."""
        o = self.cl.out
        cyc, kit = o["full_cycle"], o["kitti_all_on"]

        def rate(r):
            return dict(frames_per_s=r["frames_per_s"], seconds=r["seconds"])

        return {
            "full_cycle": dict(heatmaps=cyc["heatmaps"], dataset=cyc["dataset"],
                               train_loss=cyc["train"]["train_loss"],
                               on_failures=cyc["on"]["failures"], quality=cyc["quality"],
                               gates_left_to_claims_smoke=cyc["gates_left_to_claims_smoke"],
                               datagen=rate(cyc["datagen"]), on=rate(cyc["on"]),
                               train_s=cyc["train"]["seconds"], frames_sha1=cyc["frames_sha1"]),
            "kitti_all_on": dict(frames=kit["frames"], failures=kit["failures"],
                                 ate_m=kit["ate_m"], keypoints=kit["keypoints"],
                                 training_images=kit["training_images"],
                                 heatmaps=kit["heatmaps"],
                                 gates_left_to_claims_smoke=kit["gates_left_to_claims_smoke"],
                                 **rate(kit), frames_sha1=kit["frames_sha1"]),
            "launches": self.cl.launches}


    # ---- phase 13: the drawing half ------------------------------------------
    def vw_viewer(self):
        """(a) run_stereo in process on the card over the first N_VIEW frames
        of phase 11's KITTI layout, once with no viewer flag and once with
        --enable_viewer --live_viewer_port, while client threads read
        N_PARTS parts of frame.mjpg and of map.mjpg (each decoded by the
        port's decoder to its drawer's size) and POST a show_points toggle to
        /control: the two trajectories bit-equal, 0 failures, K1-K3 once a
        frame in each run; both runs' frames/s, the drawers' and the
        encoding's host ms."""
        import socket
        import threading
        import urllib.request

        port, drv = self.port, self.drv
        rs, jpeg = port["run_stereo"], port["jpeg"]
        settings = self._settings(os.path.join(drv.root, "kitti_view.yaml"))
        base = ["--data_path", drv.seq, "--settings_path", settings, "--ground_truth_path",
                drv.gt_file, "--fused_tracking", "--end_frame", str(N_VIEW)]
        outs = {k: os.path.join(drv.root, "view", k) for k in ("plain", "viewer")}
        plain, l_plain, s_plain = self._drive(rs, base + ["--out_visualization_path",
                                                          outs["plain"]])
        with socket.socket() as so:
            so.bind(("127.0.0.1", 0))
            live_port = so.getsockname()[1]
        parts = {"frame": [], "map": []}
        posted = []

        def client(key):
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and len(parts[key]) < N_PARTS:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{live_port}/{key}.mjpg",
                                                timeout=30) as r:
                        while len(parts[key]) < N_PARTS:
                            if r.readline().strip() != b"--ivframe":
                                raise ValueError("no multipart boundary")
                            head = {}
                            while (line := r.readline().strip()):
                                k, v = line.decode().split(":", 1)
                                head[k.strip().lower()] = v.strip()
                            parts[key].append(r.read(int(head["content-length"])))
                            r.readline()
                except OSError:
                    time.sleep(0.05)
            if key == "frame":
                req = urllib.request.Request(
                    f"http://127.0.0.1:{live_port}/control",
                    data=json.dumps({"action": "show_points", "value": False}).encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
                with urllib.request.urlopen(req, timeout=30) as r:
                    posted.append((r.status, json.loads(r.read())))

        threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in parts]
        for t in threads:
            t.start()
        view, l_view, s_view = self._drive(
            rs, base + ["--out_visualization_path", outs["viewer"], "--enable_viewer",
                        "--live_viewer_port", str(live_port)])
        for t in threads:
            t.join(timeout=60)
        trajs = []
        for k in ("plain", "viewer"):
            with open(os.path.join(outs[k], "Trajectory_KITTI_000.txt"), "rb") as f:
                trajs.append(f.read())
        shapes = {k: sorted({jpeg.decode(p, "bgr").shape for p in v}) for k, v in parts.items()}
        want = {"frame": [(H, W, 3)], "map": [(800, 800, 3)]}
        enc = {}
        for k in parts:
            img = jpeg.decode(parts[k][-1], "bgr") if parts[k] else None
            enc[k] = float(np.median([host_ms(lambda: jpeg.encode(img, 80))
                                      for _ in range(5)])) if img is not None else None
        v = view.get("viewer", {})
        self.vw = SimpleNamespace(out={})
        self.vw.out["viewer"] = dict(
            frames=N_VIEW, plain_frames_per_s=N_VIEW / s_plain,
            viewer_frames_per_s=N_VIEW / s_view,
            plain_median_track_ms=plain["median_track_s"] * 1e3,
            viewer_median_track_ms=view["median_track_s"] * 1e3,
            frame_drawer_ms_median=v.get("frame_ms_median"),
            map_drawer_ms_median=v.get("map_ms_median"), map_draws=v.get("map_calls"),
            publish_ms_median=v.get("publish_ms_median"),
            encode_ms_frame_1241x376=enc["frame"], encode_ms_map_800x800=enc["map"],
            parts_read={k: len(p) for k, p in parts.items()},
            part_shapes={k: [list(x) for x in sh] for k, sh in shapes.items()},
            control_post=posted[0][0] if posted else None,
            trajectory_bit_equal=trajs[0] == trajs[1],
            failures=[plain["failures"], view["failures"]],
            launches_plain=l_plain, launches_viewer=l_view)
        for k, n in l_view.items():
            self.kernels[k]["launches_viewer"] = n
        print(f"drawing (a): run_stereo over {N_VIEW} frames: {N_VIEW / s_plain:.3f} frames/s "
              f"plain, {N_VIEW / s_view:.3f} with --enable_viewer --live_viewer_port (wall); "
              f"FrameDrawer {v.get('frame_ms_median', float('nan')):.2f} ms, MapDrawer "
              f"{v.get('map_ms_median', float('nan')):.2f} ms ({v.get('map_calls')} maps), "
              f"publish (encoding) {v.get('publish_ms_median', float('nan')):.2f} ms (host "
              f"medians); encode {enc['frame']} ms a 1241x376 BGR frame, {enc['map']} ms the "
              f"800x800 map; parts read {self.vw.out['viewer']['parts_read']}, shapes {shapes}; "
              f"/control POST {posted[0][0] if posted else None}; trajectories bit-equal: "
              f"{trajs[0] == trajs[1]}; K1-K3 launches {l_plain} / {l_view}; on {card_line()}")
        require(trajs[0] == trajs[1], "the viewer run's trajectory differs from the plain run's")
        require(plain["failures"] == 0 and view["failures"] == 0,
                f"failures {plain['failures']}, {view['failures']}")
        require(all(len(p) >= N_PARTS for p in parts.values()), f"parts {parts.keys()}")
        require(shapes == want, f"streamed JPEGs decode to {shapes}, not {want}")
        require(posted and posted[0][0] == 200 and posted[0][1]["options"]["show_points"] is False,
                f"/control POST {posted}")
        for launches in (l_plain, l_view):
            require(launches == {k: N_VIEW for k in launches}, f"launches {launches}")

    def vw_debug(self):
        """(b) run_stereo with --create_ivslam_dataset --logging_level 1 on
        the card over phase 9's first N_DBG ReflectionWorld frames written
        as a KITTI layout with GT poses: each debug subdirectory that the
        supervised mode fills holds a .jpg for each qualifying frame (at
        least DBG_MIN_QUALIFYING), each decoding to its image's size;
        save_frame's host ms."""
        port, dg = self.port, self.dg
        png, jpeg = port["png"], port["jpeg"]
        root = os.path.join(self.drv.root, "debug")
        seq = os.path.join(root, "seq")
        for d in ("image_0", "image_1"):
            os.makedirs(os.path.join(seq, d))
        for i in range(N_DBG):
            for d, img in zip(("image_0", "image_1"), dg.pairs[i]):
                png.write_png(os.path.join(seq, d, f"{i:06d}.png"), img)
        with open(os.path.join(seq, "times.txt"), "w") as f:
            f.writelines(f"{i / dg.cfg.camera.fps!r}\n" for i in range(N_DBG))
        gt_file = os.path.join(root, "gt.txt")
        np.savetxt(gt_file, np.stack([T[:3, :4].reshape(-1) for T in dg.gt[:N_DBG]]), fmt="%.9g")
        out = os.path.join(root, "out")
        stats, launches, wall = self._drive(port["run_stereo"], [
            "--data_path", seq, "--settings_path", os.path.join(HERE, "settings",
                                                               "KITTI00-02.yaml"),
            "--ground_truth_path", gt_file, "--out_visualization_path", out, "--fused_tracking",
            "--create_ivslam_dataset", "--logging_level", "1"])
        v = stats.get("viewer", {})
        n_q = v.get("debug_calls", 0)
        files, shapes = {}, set()
        for d in ("bad_region_heatmap_vis", "epipolar_err_vec"):
            names = sorted(os.listdir(os.path.join(out, d)))
            files[d] = len(names)
            for nm in names:
                shapes.add((d, jpeg.read_jpeg(os.path.join(out, d, nm), "bgr").shape))
        self.vw.out["debug_images"] = dict(
            frames=N_DBG, qualifying=n_q, files=files, shapes=sorted(map(list, shapes)),
            save_frame_ms_median=v.get("debug_ms_median"), failures=stats["failures"],
            frames_per_s=N_DBG / wall, launches=launches)
        print(f"drawing (b): datagen run_stereo --logging_level 1 over {N_DBG} ReflectionWorld "
              f"frames: {n_q} qualifying frames, files {files}, decoded shapes {sorted(shapes)}, "
              f"save_frame {v.get('debug_ms_median', float('nan')):.2f} ms a frame (host "
              f"median), {stats['failures']} failures, K1-K3 launches {launches}; on "
              f"{card_line()}")
        require(n_q >= DBG_MIN_QUALIFYING, f"{n_q} qualifying frames")
        require(all(n == n_q for n in files.values()), f"debug files {files} for {n_q} frames")
        require(stats["failures"] == 0, f"{stats['failures']} failures")
        require(launches == {k: N_DBG for k in launches}, f"launches {launches}")

    def vw_codec(self):
        """(c) the JPEG codec on every 4th pair of phase 11's frames: each image encoded at
        CODEC_QUALITY and decoded again (shape kept, mean absolute error
        within CODEC_MAE grey levels); the ms a pair of encoding and of
        decoding with the C entropy coder, and of decoding with its plain
        Python version (one pair; bit-equal to the C coder's)."""
        port, t = self.port, self.trk
        jpeg = port["jpeg"]
        enc_ms, dec_ms, maes = [], [], []
        pairs = t.loop_pairs[::4]
        for left, right in pairs:
            t0 = time.perf_counter()
            data = [jpeg.encode(im, CODEC_QUALITY) for im in (left, right)]
            t1 = time.perf_counter()
            dec = [jpeg.decode(d, "gray") for d in data]
            t2 = time.perf_counter()
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
            maes += [float(np.abs(a.astype(np.int16) - b).mean()) for a, b in
                     zip(dec, (left, right))]
            require(all(a.shape == b.shape for a, b in zip(dec, (left, right))), "shape")
        t0 = time.perf_counter()
        plain = [jpeg.decode(d, "gray", coder="plain") for d in data]
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = all(np.array_equal(a, b) for a, b in zip(plain, dec))
        self.vw.out["codec"] = dict(
            images=2 * len(pairs), quality=CODEC_QUALITY, shape=[H, W],
            bytes_per_image=float(np.mean([len(d) for d in data])),
            encode_ms_pair_median=float(np.median(enc_ms)),
            decode_ms_pair_median=float(np.median(dec_ms)), plain_decode_ms_pair=plain_ms,
            plain_equal_to_c=same, mae_max=max(maes))
        print(f"drawing (c): {2 * len(pairs)} KITTI frames through the JPEG codec at "
              f"quality {CODEC_QUALITY}: encode {np.median(enc_ms):.2f} ms a pair, decode "
              f"{np.median(dec_ms):.2f} ms a pair with the C entropy coder, {plain_ms:.1f} ms "
              f"with its plain Python version (equal: {same}); mean abs error at most "
              f"{max(maes):.3f} grey levels; host clock, on {card_line()}")
        require(same, "the plain coder's decode differs from the C coder's")
        require(max(maes) <= CODEC_MAE, f"mean abs error {max(maes)}")


    # ---- phase 14: the thread architecture ---------------------------------
    def _thr_run(self, n, threaded, asy, serialize=False, record=False):
        """The first n frames of phase 5's loop through System on the card,
        driven as phase 5 drives them (frame i + 1's frontend submitted
        before frame i tracks), fused tracking, with the LocalMapping worker
        (threaded) and the async local BA (asy). serialize: each kick_async
        waits for the worker's queue. record: the three wrappers' inputs
        and outputs on up to
        THR_RECORD_FRAMES frames submitted while the worker had events
        queued (the last frame otherwise). Returns (the run's numbers, its
        trajectory, the records)."""
        torch, port, t = self.torch, self.port, self.trk
        ops = port["ops"]
        cfg = copy.deepcopy(t.cfg)
        cfg.system.fused_tracking = True
        cfg.system.threaded_local_mapping = threaded
        cfg.system.async_local_ba = asy
        s = port["system"].System(cfg, H, W)
        tr = s.tracking
        lm = tr.local_mapping
        events = self._thr_events(lm)
        merges = {"poll": 0, "join": 0}
        apply_ba = lm.apply_pending_ba

        def counted_merge(only_if_ready=False):
            done = apply_ba(only_if_ready)
            if done:
                merges["poll" if only_if_ready else "join"] += 1
            return done

        lm.apply_pending_ba = counted_merge
        if serialize:
            kick = lm.kick_async

            def kick_and_wait(run_ba=True):
                kick(run_ba=run_ba)
                lm._q.join()

            lm.kick_async = kick_and_wait
        pairs = t.loop_pairs[:n]
        rec, recording = [], [False]
        wrappers = ((ops.fast_cuda, "fast_score_levels"), (ops.finish_cuda, "orient_brief"),
                    (ops.stereo_cuda, "sad_windows"))
        origs = [getattr(mod, fn) for mod, fn in wrappers]

        def recorder(j):
            def call(*args):
                out = origs[j](*args)
                if recording[0]:
                    rec[-1][j].append((clone(args), clone(out)))
                return out
            return call

        if record:
            for j, (mod, fn) in enumerate(wrappers):
                setattr(mod, fn, recorder(j))
        for m in self.counters().values():
            m.launches = 0
        pending = []
        try:
            with GpuBusy() as busy:
                handle = s.submit_frontend(*pairs[0])
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                for i in range(n):
                    cur = handle
                    if i + 1 < n:
                        recording[0] = record and len(rec) < THR_RECORD_FRAMES and (
                            lm.pending_count() > 0 or i + 2 == n)
                        if recording[0]:
                            rec.append(([], [], [], i + 1, lm.pending_count()))
                        handle = s.submit_frontend(*pairs[i + 1])
                        recording[0] = False
                    s.track_stereo(*pairs[i], timestamp=0.1 * i, frontend_handle=cur)
                    pending.append(lm.pending_count())
                    if i == RAMP - 1:
                        torch.cuda.synchronize()
                        t_ramp = time.perf_counter()
                torch.cuda.synchronize()
                t_end = time.perf_counter()
                est = s.trajectory_twc()       # joins the worker, merges a pending BA
                torch.cuda.synchronize()
        finally:
            for (mod, fn), f in zip(wrappers, origs):
                setattr(mod, fn, f)
        state = self._thr_state(s, est)
        out = dict(
            frames=n, threaded_local_mapping=threaded, async_local_ba=asy,
            serialized=serialize, fps=(n - RAMP) / (t_end - t_ramp),
            fps_all=n / (t_end - t_start),
            ate_m=port["trajectory"].ate_rmse(est, t.loop_gt[:n]),
            **{k: v for k, v in state.items() if k != "twc"},
            **self._thr_event_stats(events), max_pending=max(pending),
            ba_merges_at_poll=merges["poll"], ba_merges_at_join=merges["join"],
            device_busy_share=busy.share, device_busy_samples=busy.n,
            frontend_launches={k: m.launches for k, m in self.counters().items()})
        s.shutdown()
        require(lm._worker is None, "shutdown left the worker running")
        return out, est, rec

    def _thr_events(self, lm):
        """Time each keyframe event of LocalMapping lm (its _process_one
        wrapped); returns the list it fills with (host ms, on the worker)."""
        import threading

        events, process = [], lm._process_one
        tracking_thread = threading.get_ident()

        def timed_event(kf_id, run_ba=True):
            t0 = time.perf_counter()
            process(kf_id, run_ba)
            events.append(((time.perf_counter() - t0) * 1e3,
                           threading.get_ident() != tracking_thread))

        lm._process_one = timed_event
        return events

    @staticmethod
    def _thr_event_stats(events):
        return dict(keyframe_events=len(events),
                    worker_events=sum(1 for _, on_worker in events if on_worker),
                    event_host_ms_median=(float(np.median([e for e, _ in events]))
                                          if events else None))

    @staticmethod
    def _thr_state(s, twc=None):
        """A System's map and trajectory now: what (a) and (b) compare."""
        tr = s.tracking
        m, lm = tr.map, tr.local_mapping
        exc = lm.worker_exc
        return dict(
            twc=np.stack(s.trajectory_twc() if twc is None else twc),
            lost_frames=int(sum(tr.lost_flags)), failures=int(s.failure_count),
            keyframes=int(m.n_keyframes), keyframes_alive=int(m.kf_alive[:m.n_keyframes].sum()),
            kf_stamps=[float(v) for v in m.kf_timestamp[:m.n_keyframes]],
            map_points=int(m.n_points), map_points_alive=int(m.pt_alive[:m.n_points].sum()),
            cap_overflows=dict(lm.overflows), worker_exc=None if exc is None else repr(exc))

    def _thr_check_kernels(self, rec):
        """Each recorded wrapper output of the threaded run against the plain
        version on the same inputs: bit-equal."""
        torch, ops = self.torch, self.port["ops"]
        for fast_calls, ob_calls, sad_calls, frame_i, pend in rec:
            require((len(fast_calls), len(ob_calls), len(sad_calls)) == (1, 1, 1),
                    f"frame {frame_i}: wrapper calls {len(fast_calls)}, {len(ob_calls)}, "
                    f"{len(sad_calls)}")
            (levels, th), ks = fast_calls[0]
            for lv, k in zip(levels, ks):
                require(torch.equal(k, ops.fast.fast_score(lv, th)),
                        f"frame {frame_i}: FAST kernel != plain at {tuple(lv.shape)}")
            args, (ang, desc) = ob_calls[0]
            ang_p, desc_p = ops.finish_cuda.orient_brief_plain(*args)
            require(torch.equal(ang, ang_p) and torch.equal(desc, desc_p),
                    f"frame {frame_i}: orient_brief != plain")
            args, k = sad_calls[0]
            require(torch.equal(k, ops.stereo_cuda.sad_windows_plain(*args)),
                    f"frame {frame_i}: SAD kernel != plain")
            torch.cuda.synchronize()
        return [(r[3], r[4]) for r in rec]

    def thr_runs(self):
        """(a) The first N_THR frames three ways in one process: inline
        (phase 5's run, its state after N_THR frames), the LocalMapping
        worker with the async local BA (bench.py's threading), and the
        async local BA alone (its helper thread). Each: 0 lost frames, ATE
        < 0.5 m, K1-K3 once a frame; each threaded run within THR_CROSS_ATE
        of the inline run; the worker's run: no worker exception and at
        least 2 keyframe events, K1-K3's outputs on frames submitted while
        it had events queued bit-equal to their plain versions."""
        t = self.trk
        ate_rmse = self.port["trajectory"].ate_rmse
        inl = dict(t.thr_inline[N_THR])
        est_inline = list(inl.pop("twc"))
        runs = {"inline": dict(
            frames=N_THR, threaded_local_mapping=False, async_local_ba=False,
            serialized=False, run="phase 5's first frames",
            ate_m=ate_rmse(est_inline, t.loop_gt[:N_THR]),
            **{k: v for k, v in inl.items() if k != "events"},
            **self._thr_event_stats(inl["events"]), max_pending=0, ba_merges_at_poll=0,
            ba_merges_at_join=0)}
        self.thr = SimpleNamespace(out={})
        for name, threaded, asy in (("worker_async_ba", True, True), ("async_ba", False, True)):
            run, est, rec = self._thr_run(N_THR, threaded, asy, record=threaded)
            run["cross_ate_m"] = ate_rmse(est, est_inline)
            if rec:
                run["kernels_bit_equal_on_frames"] = self._thr_check_kernels(rec)
                for k, v in run["frontend_launches"].items():
                    self.kernels[k]["launches_threads"] = v
            runs[name] = run
        for name, run in runs.items():
            print(f"threads (a) {name}: {N_THR} frames, {run['fps']:.3f} frames/s over "
                  f"frames {RAMP}-{N_THR} ({run['fps_all']:.3f} over all), ATE "
                  f"{run['ate_m']:.4f} m, cross-ATE to inline {run.get('cross_ate_m', 0.0):.4f} "
                  f"m, {run['lost_frames']} lost, {run['keyframes']} keyframes, "
                  f"{run['map_points']} map points, {run['keyframe_events']} keyframe events "
                  f"({run['worker_events']} on the worker; median "
                  f"{run['event_host_ms_median']} host ms), largest pending "
                  f"{run['max_pending']}, local-BA merges {run['ba_merges_at_poll']} at the "
                  f"per-frame poll and {run['ba_merges_at_join']} at a forced join, device busy "
                  f"{run['device_busy_share']} ({run['device_busy_samples']} NVML samples), "
                  f"K1-K3 launches {run['frontend_launches']}, worker exception "
                  f"{run['worker_exc']}; on {card_line()}")
            if "kernels_bit_equal_on_frames" in run:
                print(f"  K1-K3 outputs of the worker's run bit-equal to their plain "
                      f"versions on frames (frame, events queued at its submit) "
                      f"{run['kernels_bit_equal_on_frames']}")
        self.thr.out["a"] = runs
        for name, run in runs.items():
            want = {k: N_THR for k in run["frontend_launches"]}
            require(run["frontend_launches"] == want,
                    f"{name}: launch counts {run['frontend_launches']} != {want}")
            require(run["lost_frames"] == 0 and run["failures"] == 0,
                    f"{name}: {run['lost_frames']} lost, {run['failures']} failures")
            require(run["ate_m"] < 0.5, f"{name}: ATE {run['ate_m']} m")
            require(not any(run["cap_overflows"].values()), f"{name}: cap overflow")
            require(run["worker_exc"] is None, f"{name}: worker exception {run['worker_exc']}")
            if name != "inline":
                require(run["cross_ate_m"] < THR_CROSS_ATE,
                        f"{name}: cross-ATE {run['cross_ate_m']} m to the inline run")
        require(runs["worker_async_ba"]["worker_events"] >= 2,
                f"the worker ran {runs['worker_async_ba']['worker_events']} keyframe events")

    def thr_serialized(self):
        """(b) The first N_THR_SERIAL frames through the worker without the
        async BA, each kick_async waiting for the worker's queue: bit-equal
        to the inline run (phase 5's) after as many frames (keyframe stamps,
        map points, trajectory)."""
        run, est, _ = self._thr_run(N_THR_SERIAL, True, False, serialize=True)
        snap = self.trk.thr_inline[N_THR_SERIAL]
        twc = np.stack(est)
        same = dict(kf_stamps=run["kf_stamps"] == snap["kf_stamps"],
                    map_points=run["map_points"] == snap["map_points"],
                    trajectory=np.array_equal(twc, snap["twc"]))
        run["bit_equal_to_inline"] = same
        run["max_pose_diff"] = float(np.abs(twc - snap["twc"]).max())
        self.thr.out["b"] = run
        print(f"threads (b) serialized worker: {N_THR_SERIAL} frames, {run['worker_events']} "
              f"keyframe events on the worker, {run['keyframes']} keyframes, "
              f"{run['map_points']} map points; against the inline run: {same}, largest pose "
              f"difference {run['max_pose_diff']}")
        require(run["worker_exc"] is None, f"worker exception {run['worker_exc']}")
        require(run["worker_events"] >= 1, "the worker ran no keyframe event")
        require(all(same.values()), f"serialized worker != inline: {same}")

    def thr_loop_closing(self):
        """(c) The first N_THR_LC frames of phase 7's LC world with its
        vocabulary attached, use_bow and loop closing on, through the worker
        (and the async local BA): 0 lost, ATE < 0.5 m, and the worker's
        post-event hook ran loop closing at every event whose keyframe was
        alive (and at least 2)."""
        torch, port, lc = self.torch, self.port, self.lc
        cfg = copy.deepcopy(lc.cfg)
        cfg.system.use_bow = cfg.system.enable_loop_closing = True
        cfg.system.threaded_local_mapping = cfg.system.async_local_ba = True
        s = port["system"].System(cfg, LC_H, LC_W)
        s.attach_vocabulary(lc.voc)
        tr = s.tracking
        lm, lcl = tr.local_mapping, tr.loop_closing
        hook, process_kf = lm.post_kf_hook, lcl.process_keyframe
        seen = {"events": 0, "lc": 0, "culled": 0}

        def counted_hook(kf_id):
            seen["events"] += 1
            if not tr.map.kf_alive[kf_id]:
                seen["culled"] += 1
            hook(kf_id)

        def counted_process(*a, **kw):
            seen["lc"] += 1
            return process_kf(*a, **kw)

        lm.post_kf_hook, lcl.process_keyframe = counted_hook, counted_process
        for m in self.counters().values():
            m.launches = 0
        t0 = time.perf_counter()
        for i in range(N_THR_LC):
            s.track_stereo(*lc.pairs[i], timestamp=i * 0.1)
        est = s.trajectory_twc()
        torch.cuda.synchronize()
        fps = N_THR_LC / (time.perf_counter() - t0)
        launches = {k: m.launches for k, m in self.counters().items()}
        exc = lm.worker_exc
        ate = port["trajectory"].ate_rmse(est, lc.gt[:N_THR_LC])
        run = dict(frames=N_THR_LC, fps=fps, ate_m=ate, lost_frames=int(sum(tr.lost_flags)),
                   failures=int(s.failure_count), keyframes=int(tr.map.n_keyframes),
                   hook_events=seen["events"], loop_closing_calls=seen["lc"],
                   events_on_culled_keyframes=seen["culled"],
                   kfdb_keyframes=len(tr.kfdb.bow), loops_closed=lcl.n_loops_closed,
                   frontend_launches=launches, worker_exc=None if exc is None else repr(exc))
        s.shutdown()
        self.thr.out["c"] = run
        print(f"threads (c) LC world through the worker: {N_THR_LC} frames, {fps:.3f} "
              f"frames/s, ATE {ate:.4f} m, {run['lost_frames']} lost, {run['keyframes']} "
              f"keyframes, the hook ran {seen['events']} times, loop closing "
              f"{seen['lc']} times ({seen['culled']} events on culled keyframes), keyframe "
              f"database {run['kfdb_keyframes']}, loops closed {run['loops_closed']}, K1-K3 "
              f"launches {launches}")
        require(lm._worker is None, "shutdown left the worker running")
        require(exc is None, f"worker exception {exc!r}")
        require(run["lost_frames"] == 0 and run["failures"] == 0,
                f"{run['lost_frames']} lost, {run['failures']} failures")
        require(ate < 0.5, f"ATE {ate} m")
        require(seen["events"] >= 2, f"the hook ran {seen['events']} times")
        require(seen["lc"] == seen["events"] - seen["culled"],
                f"loop closing ran {seen['lc']} times for {seen['events']} events "
                f"({seen['culled']} on culled keyframes)")
        want = {k: N_THR_LC for k in launches}
        require(launches == want, f"launch counts {launches} != {want}")


    # ---- phase 15: the pipeline: chained tracking, prewarm, the link -------
    def _ch_run(self, n, depth, threaded=False, asy=False, prewarm=False, rtt=None,
                serialize=False, record=False, device=None):
        """The first n frames of phase 5's loop through a chained System
        (chain_depth `depth`), driven as phase 5 drives them (frame i + 1's
        frontend submitted before frame i tracks); threaded/asy: the worker
        and the async local BA; prewarm: the warm-up walk, joined at frame
        RAMP - 1 as bench.py joins it (its core awaited first); rtt: a
        pinned link_rtt_ms; serialize: each kick_async waits for the
        worker's queue; record: K1-K3's inputs and outputs on up to
        CHAIN_RECORD_FRAMES frames; device: the CPU path for "cpu" (no
        timing). Returns the run's numbers, its trajectory (flushed), the
        poses the first N_CHAIN_CPU calls returned with the map after them,
        and the records."""
        torch, port, t = self.torch, self.port, self.trk
        ops = port["ops"]
        cpu = device == "cpu"
        cfg = copy.deepcopy(t.cfg)
        cfg.system.fused_tracking = True
        cfg.system.chained_tracking = True
        cfg.system.chain_depth = depth
        cfg.system.threaded_local_mapping = threaded
        cfg.system.async_local_ba = asy
        cfg.system.prewarm = prewarm
        cfg.system.link_rtt_ms = rtt
        sync = (lambda: None) if cpu else torch.cuda.synchronize
        t_sys = time.perf_counter()
        s = port["system"].System(cfg, H, W, device=device)
        tr = s.tracking
        lm = tr.local_mapping
        if serialize:
            kick = lm.kick_async

            def kick_and_wait(run_ba=True):
                kick(run_ba=run_ba)
                lm._q.join()

            lm.kick_async = kick_and_wait
        heads = {"processed": 0, "consumed": 0, "respeculated": 0}
        head, respec = tr._process_chain_head, tr._respeculate_queue

        def counted_head():
            pose = head()
            heads["processed"] += 1
            heads["consumed"] += bool(tr._used_spec)
            return pose

        def counted_respec():
            heads["respeculated"] += 1
            return respec()

        tr._process_chain_head, tr._respeculate_queue = counted_head, counted_respec
        pw = s._prewarm_thread
        if pw is not None:
            pw.core_ready.wait()
        pairs = t.loop_pairs[:n]
        rec, recording = [], [False]
        wrappers = ((ops.fast_cuda, "fast_score_levels"), (ops.finish_cuda, "orient_brief"),
                    (ops.stereo_cuda, "sad_windows"))
        origs = [getattr(mod, fn) for mod, fn in wrappers]

        def recorder(j):
            def call(*args):
                out = origs[j](*args)
                if recording[0]:
                    rec[-1][j].append((clone(args), clone(out)))
                return out
            return call

        if record:
            for j, (mod, fn) in enumerate(wrappers):
                setattr(mod, fn, recorder(j))
        for m in self.counters().values():
            m.launches = 0
        returned, first = [], {}
        t_first = ramp_s = None
        try:
            handle = s.submit_frontend(*pairs[0])
            sync()
            t_start = time.perf_counter()
            for i in range(n):
                cur = handle
                if i + 1 < n:
                    # frames 2.. of the record: chained frames in flight
                    recording[0] = record and 2 <= i + 1 < 2 + CHAIN_RECORD_FRAMES
                    if recording[0]:
                        rec.append(([], [], [], i + 1, len(tr._pendq)))
                    handle = s.submit_frontend(*pairs[i + 1])
                    recording[0] = False
                pose = s.track_stereo(*pairs[i], timestamp=0.1 * i, frontend_handle=cur)
                if i < N_CHAIN_CPU:
                    returned.append(None if pose is None else np.array(pose))
                if i + 1 == N_CHAIN_CPU:
                    m = tr.map
                    first = dict(poses=returned, kf_stamps=[float(v) for v in
                                                            m.kf_timestamp[:m.n_keyframes]],
                                 map_points=int(m.n_points),
                                 pt_pos=np.array(m.pt_pos[:m.n_points]))
                if i == 0:
                    sync()
                    t_first = time.perf_counter() - t_sys
                if i == RAMP - 1:
                    if pw is not None:
                        pw.join()     # the walk is idle before the window
                    sync()
                    ramp_s = time.perf_counter() - t_sys
                    t_ramp = time.perf_counter()
            sync()
            t_end = time.perf_counter()
            est = s.trajectory_twc()    # flushes the chain, joins the worker
            sync()
        finally:
            for (mod, fn), f in zip(wrappers, origs):
                setattr(mod, fn, f)
        state = self._thr_state(s, est)
        exc = None if pw is None else pw.exc
        out = dict(
            frames=n, chain_depth=depth, threaded_local_mapping=threaded, async_local_ba=asy,
            prewarm=prewarm, link_rtt_ms=s.link_rtt_ms,
            monolithic=lm.monolithic_device, serialized=serialize,
            ate_m=port["trajectory"].ate_rmse(est, t.loop_gt[:n]),
            **{k: v for k, v in state.items() if k != "twc"},
            heads_processed=heads["processed"], speculations_consumed=heads["consumed"],
            heads_redispatched=heads["processed"] - heads["consumed"],
            queue_respeculations=heads["respeculated"],
            frontend_launches={k: m.launches for k, m in self.counters().items()},
            prewarm_exc=None if exc is None else repr(exc))
        if not cpu:
            out.update(fps=(n - RAMP) / (t_end - t_ramp), fps_all=n / (t_end - t_start),
                       full_loop_ramp_s=ramp_s, first_frame_s=t_first)
        s.shutdown()
        require(lm._worker is None, "shutdown left the worker running")
        return out, est, first, rec

    def _ch_print(self, name, run):
        fps = (f"{run['fps']:.3f} frames/s over frames {RAMP}-{run['frames']} "
               f"({run['fps_all']:.3f} over all), " if "fps" in run else "")
        print(f"pipeline {name}: {run['frames']} frames, depth {run['chain_depth']}, {fps}ATE "
              f"{run['ate_m']:.4f} m, {run['lost_frames']} lost, {run['keyframes']} keyframes, "
              f"{run['map_points']} map points; {run['heads_processed']} frames through the "
              f"pipeline, {run['speculations_consumed']} speculations consumed, "
              f"{run['heads_redispatched']} re-dispatched at consumption, "
              f"{run['queue_respeculations']} queue re-speculations; link "
              f"{run['link_rtt_ms']} ms (monolithic {run['monolithic']}); K1-K3 launches "
              f"{run['frontend_launches']}; on {card_line()}")

    def ch_chained(self):
        """(a) Chained tracking at depth 1 and 2 over the first N_CHAIN
        frames, single-threaded with synchronous BA, beside phase 5's
        unchained run after N_CHAIN frames: 0 lost, |dATE| <
        CHAIN_ATE_GATE, keyframes within CHAIN_KF_GATE, K1-K3 once a frame
        and bit-equal to their plain versions on CHAIN_RECORD_FRAMES frames
        in flight; the first N_CHAIN_CPU frames of depth 1 again on the CPU
        path: the poses each call returned and the map after them equal bit
        for bit."""
        t = self.trk
        inl = t.thr_inline[N_CHAIN]
        ate_rmse = self.port["trajectory"].ate_rmse
        ate_u = ate_rmse(list(inl["twc"]), t.loop_gt[:N_CHAIN])
        self.ch = SimpleNamespace(out={"a": {"unchained": dict(
            frames=N_CHAIN, run="phase 5's first frames", fps=inl["fps"], ate_m=ate_u,
            keyframes=inl["keyframes"], map_points=inl["map_points"],
            lost_frames=inl["lost_frames"])}})
        runs = self.ch.out["a"]
        firsts = {}
        for depth in (1, 2):
            run, est, first, rec = self._ch_run(N_CHAIN, depth, record=depth == 1)
            run["cross_ate_m"] = ate_rmse(est, list(inl["twc"]))
            if rec:
                run["kernels_bit_equal_on_frames"] = self._thr_check_kernels(rec)
                for k, v in run["frontend_launches"].items():
                    self.kernels[k]["launches_chained"] = v
            runs[f"depth{depth}"], firsts[depth] = run, first
            self._ch_print(f"(a) chained depth {depth}", run)
        u = runs["unchained"]
        print(f"pipeline (a) unchained (phase 5): {u['fps']:.3f} frames/s over frames "
              f"{RAMP}-{N_CHAIN}, ATE {ate_u:.4f} m, {u['keyframes']} keyframes")
        cpu, _, cpu_first, _ = self._ch_run(N_CHAIN_CPU, 1, device="cpu")
        card = firsts[1]
        same = dict(
            poses=all((a is None and b is None) or (a is not None and b is not None
                                                      and np.array_equal(a, b))
                      for a, b in zip(card["poses"], cpu_first["poses"])),
            kf_stamps=card["kf_stamps"] == cpu_first["kf_stamps"],
            map_points=card["map_points"] == cpu_first["map_points"],
            pt_pos=np.array_equal(card["pt_pos"], cpu_first["pt_pos"]))
        runs["card_vs_cpu_first_frames"] = dict(frames=N_CHAIN_CPU, bit_equal=same,
                                               returned_poses=sum(p is not None
                                                                  for p in card["poses"]))
        print(f"pipeline (a) card vs CPU path over the first {N_CHAIN_CPU} chained frames: "
              f"{same}")
        require(all(same.values()), f"chained card != CPU path: {same}")
        for depth in (1, 2):
            run = runs[f"depth{depth}"]
            want = {k: N_CHAIN for k in run["frontend_launches"]}
            require(run["frontend_launches"] == want,
                    f"depth {depth}: launch counts {run['frontend_launches']} != {want}")
            require(run["lost_frames"] == 0 and run["failures"] == 0,
                    f"depth {depth}: {run['lost_frames']} lost, {run['failures']} failures")
            require(abs(run["ate_m"] - ate_u) < CHAIN_ATE_GATE,
                    f"depth {depth}: ATE {run['ate_m']} m against unchained {ate_u} m")
            require(abs(run["keyframes"] - u["keyframes"]) <= CHAIN_KF_GATE,
                    f"depth {depth}: {run['keyframes']} keyframes, unchained {u['keyframes']}")
            require(run["speculations_consumed"] > 0, f"depth {depth}: no speculation used")

    def ch_bench(self):
        """(b) bench.py's configuration (bench.py:292-296): prewarm, the
        async local BA, the worker and chained tracking at depth 2, over
        the first N_BENCH frames: full_loop_ramp_s as bench.py defines it
        (System's construction to the end of frame RAMP - 1, the walk's
        core awaited before the first frame and the walk joined there),
        frames/s over frames RAMP-N_BENCH, ATE and cross-ATE to the
        inline run (phase 5's, after as many frames) < THR_CROSS_ATE; 0
        lost, no worker or walk exception, K1-K3 once a frame."""
        t = self.trk
        run, est, _, _ = self._ch_run(N_BENCH, 2, threaded=True, asy=True, prewarm=True)
        inl = t.thr_inline[N_BENCH]
        run["cross_ate_m"] = self.port["trajectory"].ate_rmse(est, list(inl["twc"]))
        run["inline_fps"] = inl["fps"]
        self.ch.out["b"] = run
        self._ch_print("(b) bench.py's configuration", run)
        print(f"  full_loop_ramp_s {run['full_loop_ramp_s']:.2f} (first frame after "
              f"{run['first_frame_s']:.2f} s), cross-ATE to the inline run "
              f"{run['cross_ate_m']:.4f} m, inline {inl['fps']:.3f} frames/s; prewarm "
              f"exception {run['prewarm_exc']}, worker exception {run['worker_exc']}")
        want = {k: N_BENCH for k in run["frontend_launches"]}
        require(run["frontend_launches"] == want,
                f"launch counts {run['frontend_launches']} != {want}")
        require(run["prewarm_exc"] is None, f"prewarm: {run['prewarm_exc']}")
        require(run["worker_exc"] is None, f"worker exception {run['worker_exc']}")
        require(run["lost_frames"] == 0 and run["failures"] == 0,
                f"{run['lost_frames']} lost, {run['failures']} failures")
        require(run["ate_m"] < 0.5, f"ATE {run['ate_m']} m")
        require(run["cross_ate_m"] < THR_CROSS_ATE, f"cross-ATE {run['cross_ate_m']} m")

    def ch_link(self):
        """(c) The link: the probed host<->device round trip and the family
        it selects; then link_rtt_ms pinned at 0 and at 100, N_LINK
        threaded, chained frames each (the worker serialized, so that the
        two runs take the same steps and differ only in the families'
        program shapes): 0 lost each, trajectories within LINK_ATOL."""
        from iv_slam_tpu_torch.utils import linkprobe

        cfg = self.trk.cfg
        rtt = linkprobe.probe_rtt_ms(force=True, device=self.trk.tr.device)
        high = rtt > cfg.system.link_rtt_threshold_ms
        runs = {"probe": dict(rtt_ms=rtt, threshold_ms=cfg.system.link_rtt_threshold_ms,
                              family="monolithic" if high else "chunked")}
        ests = {}
        try:
            for name, pin in (("chunked", 0.0), ("monolithic", 100.0)):
                run, ests[name], _, _ = self._ch_run(N_LINK, 2, threaded=True, asy=True,
                                                     rtt=pin, serialize=True)
                runs[name] = run
                self._ch_print(f"(c) link_rtt_ms {pin}", run)
        finally:
            linkprobe.set_rtt_ms(None)
        diff = float(np.abs(np.stack([T[:3, 3] for T in ests["chunked"]])
                            - np.stack([T[:3, 3] for T in ests["monolithic"]])).max())
        runs["max_position_diff_m"] = diff
        self.ch.out["c"] = runs
        print(f"pipeline (c) probed RTT {rtt:.4f} ms (threshold "
              f"{cfg.system.link_rtt_threshold_ms} ms): the {runs['probe']['family']} family; "
              f"pinned 0 vs 100 ms: largest position difference {diff:.2e} m")
        require(not runs["chunked"]["monolithic"] and runs["monolithic"]["monolithic"],
                "the pinned RTTs did not select the two families")
        for name in ("chunked", "monolithic"):
            require(runs[name]["lost_frames"] == 0 and runs[name]["failures"] == 0,
                    f"{name}: {runs[name]['lost_frames']} lost")
            require(runs[name]["worker_exc"] is None, f"{name}: {runs[name]['worker_exc']}")
        require(diff < LINK_ATOL, f"the families' trajectories differ by {diff} m")

    def ch_cold(self):
        """(d) Cold start: this script again in two fresh processes (this
        one is warm), one with prewarm and one without, each tracking the
        first N_COLD frames in bench.py's configuration: its
        full_loop_ramp_s and the time from its launch to its first tracked
        frame."""
        import tempfile

        work = tempfile.mkdtemp(prefix="chip_smoke_cold_")
        path = os.path.join(work, "pairs.npy")
        np.save(path, np.stack([np.stack(p) for p in self.trk.loop_pairs[:N_COLD]]))
        runs = {}
        try:
            for name in ("prewarm", "plain"):
                t0 = time.time()
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--cold-start", name, path,
                     repr(t0)], capture_output=True, text=True, timeout=600, cwd=HERE)
                require(proc.returncode == 0, f"cold start ({name}) exited "
                        f"{proc.returncode}: {proc.stderr[-3000:]}")
                runs[name] = json.loads(proc.stdout.strip().splitlines()[-1])
                runs[name]["process_s"] = time.time() - t0
                r = runs[name]
                print(f"pipeline (d) cold start, {name}: full_loop_ramp_s "
                      f"{r['full_loop_ramp_s']:.2f}, first tracked frame "
                      f"{r['first_frame_s']:.2f} s after the launch (System built after "
                      f"{r['system_s']:.2f} s), {r['lost_frames']} lost, process "
                      f"{r['process_s']:.1f} s, prewarm exception {r['prewarm_exc']}")
        finally:
            import shutil

            shutil.rmtree(work, ignore_errors=True)
        self.ch.out["d"] = runs
        for name, r in runs.items():
            require(r["lost_frames"] == 0 and r["prewarm_exc"] is None,
                    f"cold start {name}: {r['lost_frames']} lost, {r['prewarm_exc']}")

    def ch_uploads(self):
        """(e) Host-to-device copies of one fused step from host state
        (track: the ids and poses in one packed copy), one chained step
        (track_chained: none) and one keyframe event with its local BA, on
        phase 5's System after the keyframe-event profile: its last two
        frames for the steps, then one more frame of the path tracked and
        a keyframe forced on it. Counted at the dispatcher
        (HostToDeviceCount); torch.profiler's Memcpy HtoD events of the
        step's packed upload alone stand beside it (the CUDA driver writes a
        small pinned copy into the command stream, and CUPTI then reports
        no memcpy for it: the profiler undercounts)."""
        from torch.profiler import ProfilerActivity, profile

        from iv_slam_tpu_torch.utils import argpack

        torch, t = self.torch, self.trk
        s = t.loop_sys
        tr = s.tracking
        fr, last = tr.current, tr.last_frame
        dev = fr.kp.xy.device
        res, _ = tr._fused.track(fr, last, last.map_pt, tr.velocity @ last.pose, tr._dmap)
        T_prev = torch.as_tensor(last.pose, device=dev)
        torch.cuda.synchronize()

        def copies(fn):
            with HostToDeviceCount() as c:
                fn()
            torch.cuda.synchronize()
            return c.n

        step = copies(lambda: tr._fused.track(fr, last, last.map_pt, tr.velocity @ last.pose,
                                              tr._dmap))
        chained = copies(lambda: tr._fused.track_chained(fr, fr, res.assign_map, res.T,
                                                         T_prev, tr._dmap))
        host = [np.asarray(last.map_pt, np.int32), np.asarray(last.pose, np.float32),
                np.asarray(last.pose, np.float32)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            argpack.upload(host, dev)
            torch.cuda.synchronize()
        upload_prof = sum(e.count for e in prof.key_averages()
                          if e.device_type.name == "CUDA" and e.key.startswith("Memcpy HtoD"))
        upload_disp = copies(lambda: argpack.upload(host, dev))
        if fr.frame_id == tr.last_kf_frame_id:
            # the keyframe forced on it by the profile: record its trajectory
            # entry against it, as tracking records a frame after its own
            # keyframe decision, so that the next frame's motion model
            # starts from its pose
            tr.rel_poses[-1] = (fr.pose @ np.linalg.inv(tr.map.kf_pose[tr.ref_kf])).astype(
                np.float32)
            tr.rel_refs[-1] = tr.ref_kf
        self._track_next()
        n_ba = len(tr.local_mapping.ba_rungs)
        event = copies(tr._create_new_keyframe)
        rungs = tr.local_mapping.ba_rungs
        out = dict(fused_step_htod=step, chained_step_htod=chained, keyframe_event_htod=event,
                   keyframe_event_ba_rung=rungs[-1] if len(rungs) > n_ba else None,
                   step_upload_htod=upload_disp, step_upload_htod_profiler=upload_prof,
                   keyframe_event_htod_profiler=t.loop["keyframe_event_profile"]["htod"])
        self.ch.out["e"] = out
        print(f"pipeline (e) host-to-device copies (dispatcher): {step} a fused step, "
              f"{chained} a chained step, {event} a keyframe event (BA rung "
              f"{out['keyframe_event_ba_rung']}); torch.profiler: {upload_prof} Memcpy HtoD "
              f"for the step's packed upload (the dispatcher: {upload_disp}), "
              f"{out['keyframe_event_htod_profiler']} for the profiled keyframe event")
        require(chained == 0, f"the chained step copied {chained} times to the card")
        require(step == 1, f"the fused step copied {step} times to the card")

    def ch_vocab(self):
        """(f) The vocabulary's C parser (csrc/vocab_native.c) against its
        plain version on a DBoW2 text file of Vocabulary.synthesize(*VOCAB_KL):
        the arrays equal; both times (host clock)."""
        import tempfile

        voc_mod = self.port["vocabulary"]
        voc = voc_mod.Vocabulary.synthesize(*VOCAB_KL)
        work = tempfile.mkdtemp(prefix="chip_smoke_voc_")
        path = os.path.join(work, "voc.txt")
        try:
            voc.save_dbow2_text(path)
            voc_mod.parse_vocab_text(path)      # built and loaded before the clock
            t0 = time.perf_counter()
            got = voc_mod.parse_vocab_text(path)
            c_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = voc_mod.parse_vocab_text_plain(path)
            plain_s = time.perf_counter() - t0
            size = os.path.getsize(path)
        finally:
            import shutil

            shutil.rmtree(work, ignore_errors=True)
        equal = got[:4] == want[:4] and all(
            a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got[4:], want[4:]))
        self.ch.out["f"] = dict(k=VOCAB_KL[0], L=VOCAB_KL[1], nodes=len(got[4]), bytes=size,
                                c_s=c_s, plain_s=plain_s, equal=equal)
        print(f"pipeline (f) DBoW2 text, k={VOCAB_KL[0]} L={VOCAB_KL[1]} ({len(got[4])} nodes, "
              f"{size / 1e6:.1f} MB): C parser {c_s:.3f} s, plain {plain_s:.3f} s, equal "
              f"{equal}")
        require(equal, "the C parser's arrays differ from the plain version's")


def cold_start(mode, pairs_path, t_launch) -> int:
    """phase 15 (d) in a fresh process: bench.py's configuration (fused,
    chained at depth 2, the worker, the async local BA; prewarm when mode
    is "prewarm") over the given pairs; prints one JSON line."""
    t_launch = float(t_launch)
    import torch

    sys.path.insert(0, HERE)
    from iv_slam_tpu_torch import config
    from iv_slam_tpu_torch.slam import system

    pairs = np.load(pairs_path)
    cfg = config.Config()
    cfg.camera = config.CameraConfig(fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=0.54 * FX,
                                     width=W, height=H, th_depth=35.0, fps=10.0)
    cfg.orb = config.ORBConfig(n_features=2000, n_levels=8, ini_th_fast=20, min_th_fast=7)
    cfg.system.fused_tracking = cfg.system.chained_tracking = True
    cfg.system.chain_depth = 2
    cfg.system.threaded_local_mapping = cfg.system.async_local_ba = True
    cfg.system.prewarm = mode == "prewarm"
    t_sys = time.perf_counter()
    system_s = time.time() - t_launch
    s = system.System(cfg, H, W)
    pw = s._prewarm_thread
    if pw is not None:
        pw.core_ready.wait()
    handle = s.submit_frontend(*pairs[0])
    first = ramp = None
    for i in range(len(pairs)):
        cur = handle
        if i + 1 < len(pairs):
            handle = s.submit_frontend(*pairs[i + 1])
        s.track_stereo(*pairs[i], timestamp=0.1 * i, frontend_handle=cur)
        if i == 0:
            torch.cuda.synchronize()
            first = time.time() - t_launch
        if i == len(pairs) - 1:
            if pw is not None:
                pw.join()
            torch.cuda.synchronize()
            ramp = time.perf_counter() - t_sys
    s.trajectory_twc()
    exc = None if pw is None else pw.exc
    out = dict(mode=mode, frames=len(pairs), full_loop_ramp_s=ramp, first_frame_s=first,
               system_s=system_s, lost_frames=int(sum(s.tracking.lost_flags)),
               prewarm_exc=None if exc is None else repr(exc))
    s.shutdown()
    print(json.dumps(out))
    return 0

def dp_rank_main(rank, world, port_no, work):
    """A rank of phase 10 (g): joins the gloo group on card 0, loads the
    weights and the batch, takes one step on its half, and rank 0 saves the
    loss and the weights."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from iv_slam_tpu_torch.models import IntrospectionNet, set_process_group
    from iv_slam_tpu_torch.parallel import mesh
    from iv_slam_tpu_torch.train import train_state as ts

    dp = mesh.init_data_parallel(rank, world, port_no, torch.device("cuda", 0))
    try:
        net = IntrospectionNet()
        net.load_state_dict(torch.load(os.path.join(work, "init.pt"), map_location="cpu"))
        net.cuda()
        set_process_group(net, dist.group.WORLD)
        state = ts.TrainState(net, *ts.make_optimizer(net, max_iters=TR_EPOCHS * 1000))
        with np.load(os.path.join(work, "batch.npz")) as z:
            batch = {k: z[k] for k in z.files}
        loss = float(ts.train_step(state, batch, dp)["loss"])
        if rank == 0:
            torch.save({"loss": loss, "sd": {k: v.cpu() for k, v in net.state_dict().items()}},
                       os.path.join(work, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def torch_equal(a, b) -> bool:
    """Tensors equal in shape and value, wherever each lives."""
    return bool(a.shape == b.shape and (a.cpu() == b.cpu()).all())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "iv_slam_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(iv_slam_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from iv_slam_tpu_torch import _kernels, config, models
    from iv_slam_tpu_torch.introspection import datagen
    from iv_slam_tpu_torch.io import trajectory
    from iv_slam_tpu_torch.ops import (brief, fast, fast_cuda, finish_cuda, orient,
                                       stereo_cuda)
    from iv_slam_tpu_torch.ops import bow, extractor, gp, match, triangulate
    from iv_slam_tpu_torch.slam import (device_map, frame, fused_track, keyframe_db,
                                        loop_closing, map_store, system, vocabulary)
    from iv_slam_tpu_torch.solvers import ba_core, initializer, local_ba, pose_opt, pose_opt_cuda
    from iv_slam_tpu_torch.introspection import dataset_creator, feature_evaluator
    from iv_slam_tpu_torch.models import export, zoo
    from iv_slam_tpu_torch.parallel import datagen as sharded_datagen
    from iv_slam_tpu_torch.parallel import mesh, replay
    from iv_slam_tpu_torch.train import data as train_data
    from iv_slam_tpu_torch.train import train_state, trainer
    from iv_slam_tpu_torch.io import datasets, jpeg, png, rectify
    from iv_slam_tpu_torch.examples import evaluate_batch, run_mono, run_rgbd, run_stereo
    from iv_slam_tpu_torch.utils import profiling

    ops = SimpleNamespace(brief=brief, fast=fast, fast_cuda=fast_cuda,
                          finish_cuda=finish_cuda, orient=orient, stereo_cuda=stereo_cuda)
    port = {"kernels": _kernels, "config": config, "frame": frame, "ops": ops,
            "fused": fused_track, "map_store": map_store, "device_map": device_map,
            "trajectory": trajectory, "system": system, "match": match,
            "triangulate": triangulate, "local_ba": local_ba, "ba_core": ba_core,
            "models": models, "extractor": extractor, "bow": bow,
            "vocabulary": vocabulary, "keyframe_db": keyframe_db,
            "loop_closing": loop_closing, "initializer": initializer, "datagen": datagen,
            "gp": gp, "dataset_creator": dataset_creator, "export": export, "zoo": zoo,
            "sharded_datagen": sharded_datagen, "mesh": mesh, "replay": replay,
            "train_data": train_data, "train_state": train_state, "trainer": trainer,
            "feature_evaluator": feature_evaluator, "datasets": datasets, "png": png,
            "jpeg": jpeg,
            "rectify": rectify, "run_stereo": run_stereo, "run_mono": run_mono,
            "run_rgbd": run_rgbd, "evaluate_batch": evaluate_batch, "profiling": profiling,
            "pose_opt": pose_opt, "pose_opt_cuda": pose_opt_cuda}

    card = card_line()
    print(f"card: {card}", flush=True)
    smoke = Smoke(torch, port)
    smoke.phase("build", smoke.build)
    if smoke.failures:
        print("\n".join(["FAILED"] + smoke.failures))
        return 1

    cfg = config.Config()
    cfg.camera = config.CameraConfig(width=W, height=H)
    cfg.orb = config.ORBConfig(n_features=2000, n_levels=8, ini_th_fast=20, min_th_fast=7)
    left, right = test_pair(H, W)
    fe = frame.StereoFrontend(cfg, H, W)
    rec = smoke.phase("record main-path inputs", smoke.record_inputs,
                      lambda: fe.process(left, right, 0.0))
    if rec is not None:
        smoke.phase("K1 fast_score vs plain", smoke.check_fast, rec)
        smoke.phase("K2 orient_brief vs plain", smoke.check_orient_brief, rec)
        smoke.phase("K3 sad_windows vs plain", smoke.check_sad, rec)
        del rec
    if smoke.frontend_checked():
        smoke.phase("slice", smoke.drive_slice, fe, left, right)
    else:
        smoke.failures.append("slice: skipped, a kernel check failed")
    smoke.phase("card vs CPU path", smoke.cpu_vs_gpu)
    # tracking before any profiling: the profiler slows the host for the
    # rest of the process, and the tracking phase times host steps
    n_fail = len(smoke.failures)
    smoke.phase("tracking setup", smoke.tracking_setup)
    for name, fn in (("tracking (a) start of a session", smoke.track_a),
                     ("tracking (b) 16k live rung", smoke.track_b),
                     ("tracking frontend launches", smoke.track_launches),
                     ("tracking card vs CPU path", smoke.track_cpu_vs_card),
                     ("tracking step syncs", smoke.track_step_syncs),
                     ("K4 pose_lm vs plain at the fused step's inputs", smoke.check_pose_lm)):
        if len(smoke.failures) > n_fail:
            smoke.failures.append(f"{name}: skipped, an earlier tracking phase failed")
        else:
            smoke.phase(name, fn)
    # the full loop, also before any profiling
    n_fail = len(smoke.failures)
    for name, fn in (("full loop", smoke.full_loop),
                     ("full loop card vs CPU path", smoke.loop_cpu_vs_card),
                     ("full loop BA repeatable", smoke.loop_ba_repeatable)):
        if smoke.trk is None or len(smoke.failures) > n_fail:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    loop_ok = len(smoke.failures) == n_fail
    # introspection, also before any profiling
    n_fail = len(smoke.failures)
    for name, fn in (("introspection setup", smoke.intro_setup),
                     ("introspection (a) FCN", smoke.intro_fcn),
                     ("introspection (b) weighted frontend", smoke.intro_frontend),
                     ("introspection (c) loop with the FCN", smoke.intro_loop)):
        if not loop_ok or len(smoke.failures) > n_fail:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    intro_ok = loop_ok and len(smoke.failures) == n_fail
    # loop closing, also before any profiling
    n_fail = len(smoke.failures)
    for name, fn in (("loop closing setup", smoke.lc_setup),
                     ("loop closing K1-K3 at the LC world's shapes", smoke.lc_kernels),
                     ("loop closing (a) control, (b) with loop closing", smoke.lc_loops),
                     ("loop closing (b) card vs CPU path", smoke.lc_cpu_vs_card),
                     ("loop closing correction card vs CPU path", smoke.lc_correction),
                     ("loop closing 1M-leaf descent", smoke.lc_1m)):
        if not loop_ok or len(smoke.failures) > n_fail:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    # mono and RGB-D, then training-data generation, also before any profiling
    for group in ((("mono/RGB-D setup", smoke.mr_setup),
                   ("mono/RGB-D (a) K1-K2 at 752x480 and 640x480", smoke.mr_kernels),
                   ("mono/RGB-D (b) mono", smoke.mr_mono),
                   ("mono/RGB-D (c) RGB-D", smoke.mr_rgbd)),
                  (("datagen setup", smoke.dg_setup),
                   ("datagen (a) supervised", smoke.dg_supervised),
                   ("datagen (b) unsupervised, constrained BA", smoke.dg_unsupervised))):
        n_fail = len(smoke.failures)
        for name, fn in group:
            if not loop_ok or len(smoke.failures) > n_fail:
                smoke.failures.append(f"{name}: skipped, an earlier phase failed")
            else:
                smoke.phase(name, fn)
    # phase 10: training, the zoo, export and the multi-process paths, also
    # before any profiling; (c)-(e) and (g) need (b)'s trained net
    n_fail = len(smoke.failures)
    dg_ok = loop_ok and smoke.dg is not None and "unsupervised" in smoke.dg.dirs
    for name, fn, needs in (("training (a) dataset from phase 9", smoke.tr_setup, "dg"),
                            ("training (b) flagship recipe", smoke.tr_flagship, "a"),
                            ("training (c) card vs CPU path", smoke.tr_card_vs_cpu, "b"),
                            ("training (d) TorchScript export", smoke.tr_export, "b"),
                            ("training (e) trained net in the loop", smoke.tr_loop, "b"),
                            ("training (f) model zoo", smoke.tr_zoo, None),
                            ("training (g) two ranks", smoke.tr_dp, "b"),
                            ("training (h) ShardedReplay", smoke.tr_replay, "lc"),
                            ("training (i) ShardedDatagen", smoke.tr_datagen, "dg")):
        ok = {None: loop_ok, "dg": dg_ok, "lc": loop_ok and smoke.lc is not None,
              "a": smoke.tr is not None,
              "b": smoke.tr is not None and hasattr(smoke.tr, "trainer")}[needs]
        if not ok:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    # phase 11: the dataset drivers, on phase 5's frames and phase 8's
    # worlds, also before any profiling
    n_fail = len(smoke.failures)
    mr_ok = loop_ok and smoke.mr is not None and hasattr(smoke.mr, "rgbd_depth")
    for name, fn, ok in (("drivers (a) PNG decode", smoke.drv_setup, loop_ok),
                         ("drivers (b) run_stereo", smoke.drv_stereo, True),
                         ("drivers (c) rectification", smoke.drv_rectify, True),
                         ("drivers (d) run_mono, run_rgbd", smoke.drv_mono_rgbd, mr_ok),
                         ("drivers (e) extract_octtree", smoke.drv_octtree, loop_ok),
                         ("drivers (f) evaluate_batch", smoke.drv_evaluate, mr_ok)):
        if not ok or smoke.drv is None and fn != smoke.drv_setup \
                or len(smoke.failures) > n_fail:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    # phase 12: the product's claims, also before any profiling; each run
    # stands alone
    for name, fn in (("claims setup", smoke.cl_setup),
                     ("claims (c) whole cycle", smoke.cl_cycle),
                     ("claims (d) KITTI all on", smoke.cl_kitti)):
        if not smoke.frontend_checked() or smoke.cl is None and fn != smoke.cl_setup:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    # phase 13: the drawing half, on phase 11's layout and phase 9's world,
    # also before any profiling; then phase 11's layout goes
    for name, fn in (("drawing (a) viewer runs", smoke.vw_viewer),
                     ("drawing (b) debug images", smoke.vw_debug),
                     ("drawing (c) JPEG codec", smoke.vw_codec)):
        if smoke.drv is None or smoke.vw is None and fn != smoke.vw_viewer \
                or fn == smoke.vw_debug and smoke.dg is None:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    if smoke.drv is not None:
        import shutil

        shutil.rmtree(smoke.drv.root, ignore_errors=True)
    # phase 14: the thread architecture, on phase 5's frames and phase 7's
    # LC world, also before any profiling
    for name, fn, ok in (("threads (a) inline, worker, async BA", smoke.thr_runs,
                          lambda: loop_ok and smoke.frontend_checked()),
                         ("threads (b) serialized worker", smoke.thr_serialized,
                          lambda: smoke.thr is not None),
                         ("threads (c) LC world through the worker", smoke.thr_loop_closing,
                          lambda: smoke.lc is not None and smoke.thr is not None)):
        if not ok():
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    # phase 15: the pipeline (chained tracking, prewarm, the link, the
    # vocabulary's C parser), on phase 5's frames, also before any
    # profiling; (e), the uploads, runs with the profiling phases
    for name, fn in (("pipeline (a) chained tracking", smoke.ch_chained),
                     ("pipeline (b) bench.py's configuration", smoke.ch_bench),
                     ("pipeline (c) the link", smoke.ch_link),
                     ("pipeline (d) cold start", smoke.ch_cold),
                     ("pipeline (f) the vocabulary's C parser", smoke.ch_vocab)):
        if not loop_ok or not smoke.frontend_checked() or smoke.ch is None and \
                fn != smoke.ch_chained:
            smoke.failures.append(f"{name}: skipped, an earlier phase failed")
        else:
            smoke.phase(name, fn)
    if smoke.frontend_checked() and "pose_lm" in smoke.kernels:
        smoke.phase("kernel device times", smoke.device_times)
    else:
        smoke.failures.append("kernel device times: skipped, a kernel check failed")
    if smoke.trk is not None and smoke.trk.record is not None:
        smoke.phase("tracking step profile", smoke.track_step_profile)
    else:
        smoke.failures.append("tracking step profile: skipped, no step was recorded")
    smoke.phase("profile", smoke.profile, fe, left, right)
    if loop_ok:
        smoke.phase("keyframe event profile", smoke.keyframe_event_profile)
    if smoke.ch is not None:
        smoke.phase("pipeline (e) uploads", smoke.ch_uploads)
    else:
        smoke.failures.append("pipeline (e) uploads: skipped, an earlier phase failed")
    if intro_ok:
        smoke.phase("introspection profile", smoke.intro_profile)

    if smoke.failures:
        print("\n".join(["FAILED"] + smoke.failures))
        return 1
    for name, n in smoke.cl.launches.items():
        smoke.kernels[name]["launches_claims"] = n
    for k in (smoke.kernels[n] for n in FRONTEND_KERNELS):
        print(f"{k['name']}: max abs err {k['max_abs_err']}, {k['launches']} launches, "
              f"device {k['ms']:.4f} ms/frame (events {k['event_ms']:.4f}), plain "
              f"{k['plain_ms']:.4f} ms/frame (events {k['plain_event_ms']:.4f}), bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), {k['launches_introspection']} "
              f"launches on the introspection loop, {k['launches_loop_closing']} on the "
              f"loop-closing loop, {k['launches_mono']} on the mono run, "
              f"{k['launches_rgbd']} on the RGB-D run, {k['launches_datagen']} on the datagen "
              f"runs, {k['launches_replay']} on the replay, {k['launches_sharded_datagen']} on "
              f"the sharded datagen, {k['launches_run_stereo']} on run_stereo, "
              f"{k['launches_run_mono']} on run_mono, {k['launches_run_rgbd']} on run_rgbd, "
              f"{k['launches_octree']} on extract_octtree, {k['launches_claims']} on the "
              f"claims runs, {k['launches_viewer']} on the viewer run, "
              f"{k['launches_threads']} on the worker's run, {k['launches_chained']} on the "
              f"chained run, on {card}")
    k = smoke.kernels["pose_lm"]
    print(f"pose_lm: max abs err {k['max_abs_err']}, {k['launches']} launches over the "
          f"tracking phase's fused steps (2 a step), device {k['ms']:.4f} ms/fused step "
          f"(events {k['event_ms']:.4f}), plain {k['plain_ms']:.4f} ms/fused step (events "
          f"{k['plain_event_ms']:.4f}), bound {k['bound_ms']:.5f} ms ({k['bound_by']}), "
          f"on {card}")
    order = ("name", "route", "source", "replaces", "launches", "launches_per_frame",
             "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "event_ms", "plain_event_ms",
             "launches_introspection", "launches_loop_closing", "launches_mono",
             "launches_rgbd", "launches_datagen", "launches_replay",
             "launches_sharded_datagen", "launches_run_stereo", "launches_run_mono",
             "launches_run_rgbd", "launches_octree", "launches_claims", "launches_viewer",
             "launches_threads", "launches_chained")
    # K4 is counted on the tracking phase only: its other launches_* are None
    kernels = [{k: smoke.kernels[n].get(k) for k in order}
               for n in FRONTEND_KERNELS + ("pose_lm",)]
    print(json.dumps({"frontend": smoke.fps,
                      "card": card}))
    print(json.dumps({"tracking": dict(smoke.trk.out, card=card)}))
    print(json.dumps({"full_loop": dict(smoke.trk.loop, card=card)}))
    print(json.dumps({"introspection": dict(smoke.intro.out, card=card)}))
    print(json.dumps({"loop_closing": dict(
        smoke.lc.out, card=card, configuration=dict(
            unchained=True, single_threaded=True, sync_local_ba=True, fused_tracking=True,
            n_features=800, n_levels=8, fps=4.0, vocabulary="trained k=10 L=6 seed=0"))},
        default=float))
    print(json.dumps({"mono_rgbd": dict(smoke.mr.out, card=card)}, default=float))
    print(json.dumps({"datagen": dict(smoke.dg.out, card=card)}, default=float))
    print(json.dumps({"training": dict(smoke.tr.out, card=card)}, default=float))
    print(json.dumps({"drivers": dict(smoke.drv.out, card=card)}, default=float))
    print(json.dumps({"claims": dict(smoke.claims_line(), card=card)}, default=float))
    print(json.dumps({"drawing": dict(smoke.vw.out, card=card)}, default=float))
    print(json.dumps({"threads": dict(smoke.thr.out, card=card)}, default=float))
    print(json.dumps({"pipeline": dict(smoke.ch.out, card=card)}, default=float))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-start"]:
        sys.exit(cold_start(*sys.argv[2:5]))
    sys.exit(main())
